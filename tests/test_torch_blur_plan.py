"""The launch plan of the blur kernel (`csrc/blur.cu` behind
`gaussian_blur_batch`) and its block decomposition, on the CPU.

The kernel cannot run here, so its index arithmetic is held through a
pure-torch emulation of what the blocks do under `blur_plan`: each block
takes its band of one sample in chunks of BLUR_RUN rows; input rows go to
ring slots (y % slots) as 16-byte granule spans, the next chunk's rows
arriving while a chunk computes; the H pass runs one column element and
the chunk's 8 rows a thread over a table of clamped row offsets, into a
skewed, edge-padded mid plane per channel (two mid buffers, H pass of
chunk c beside W pass of chunk c - 1); the W pass runs 8 pixels a thread
from the mid planes. The emulation checks that every row it reads is the
row the ring slot holds, and it is held against `gaussian_blur_batch_plain`
and against the JAX package's Pallas blur in interpret mode on the same
numpy inputs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.ops.pallas_blur import gaussian_blur_batch as jax_blur
from moco_tpu_torch.ops import _build, blur
from moco_tpu_torch.ops.blur import (
    BLUR_FIXED_RADIUS,
    BLUR_MAX_SMEM,
    BLUR_RUN,
    BlurPlan,
    blur_plan,
    blur_taps,
    skew,
)

NAN = float("nan")


def _covers_once(plan: BlurPlan):
    rows = [y for band in range(plan.bands) for y in plan.band_rows(band)]
    assert rows == list(range(plan.h))                 # every row once, in band order
    assert all(len(plan.band_rows(band)) for band in range(plan.bands))  # no band empty
    for band in range(plan.bands):                     # bands are whole chunks but the last
        assert plan.band_rows(band).start % BLUR_RUN == 0


def test_plan_at_the_224px_batch():
    """The MoCo-v2 step's call: [256, 224, 224, 3] bf16 at R = 11. One
    block a sample (256 of the 264 slots of a wave of 2 blocks an SM), the
    taps in registers, 16-byte stores, 111 KB of shared memory: a ring of
    38 rows of 1360 bytes and two mid buffers of 3 x 8 planes of 308
    floats (308 = 3 * 28 runs mod 32)."""
    plan = blur_plan(256, 224, 224, 11, 2)
    _covers_once(plan)
    assert (plan.bands, plan.rows_per_band, plan.fixed, plan.packed) == (1, 224, True, True)
    assert (plan.slots, plan.slot_pitch, plan.mid_pitch, plan.runs) == (38, 1360, 308, 28)
    assert plan.mid_pitch % 32 == 3 * plan.runs % 32
    assert plan.smem_bytes == 111148 and plan.blocks_per_sm == 2
    assert plan.blocks == 256 and plan.capacity == 264
    assert len(plan.chunks(0)) == 28


def test_plan_in_f32_holds_one_block_an_sm():
    plan = blur_plan(256, 224, 224, 11, 4)
    assert plan.slot_pitch == 2704 and plan.blocks_per_sm == 1 and plan.bands == 1
    _covers_once(plan)


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("radius,b,h,w", [(1, 3, 37, 53), (2, 2, 32, 32), (11, 4, 64, 40),
                                          (11, 2, 5, 7), (1, 70000, 2, 2)])
def test_plan_at_the_card_tests_shapes(radius, b, h, w, elem):
    """Small batches split into bands of whole chunks to fill the wave (no
    more blocks than slots, unless one band a sample is already more);
    the taps go to registers at R = 11 only; 16-byte stores only where a
    row is a whole number of 16-byte granules; 70000 samples are 70000
    blocks on the grid's x axis."""
    plan = blur_plan(b, h, w, radius, elem)
    _covers_once(plan)
    assert plan.fixed == (radius == BLUR_FIXED_RADIUS)
    assert plan.packed == (w * 3 * elem % 16 == 0)
    assert plan.blocks <= plan.capacity or plan.bands == 1
    if b * 2 <= plan.capacity and h > BLUR_RUN:
        assert plan.bands > 1
    expected_bands = {(3, 37): 5, (2, 32): 4, (4, 64): 8, (2, 5): 1, (70000, 2): 1}[(b, h)]
    assert plan.bands == expected_bands
    if b == 70000:
        assert plan.blocks == 70000 > 65535


def test_plan_follows_output_alignment():
    assert blur_plan(2, 16, 224, 11, 2, out_align=16).packed
    assert not blur_plan(2, 16, 224, 11, 2, out_align=8).packed
    assert not blur_plan(2, 16, 223, 11, 2).packed     # a row of 1338 bytes


def test_plan_fills_the_card_it_is_given():
    """An H100 PCIe (114 SMs) gets bands for its own wave."""
    plan = blur_plan(8, 224, 224, 11, 2, sms=114)
    assert plan.capacity == 228 and plan.blocks <= 228 and plan.bands == 28
    _covers_once(plan)


def test_plan_refuses_rows_too_wide_and_empty_batches():
    with pytest.raises(ValueError, match=str(BLUR_MAX_SMEM)):
        blur_plan(1, 64, 2000, 11, 2)
    with pytest.raises(ValueError):
        blur_plan(0, 8, 8, 1, 2)
    with pytest.raises(ValueError):
        blur_plan(1, 8, 8, 1, 8)


def test_plans_are_frozen_records():
    with pytest.raises(dataclasses.FrozenInstanceError):
        blur_plan(4, 64, 40, 11, 2).bands = 3


def _emulate(plan: BlurPlan, images: torch.Tensor, taps: torch.Tensor, head: int = 0):
    """The kernel's blocks on f32 images [B, H, W, 3]: ring slots, row
    table, H pass into skewed padded mid planes, W pass in runs of 8,
    every sum in tap order. `head` is the byte offset of sample 0 in its
    16-byte granule (elements of plan.elem bytes)."""
    b, h, w, _ = images.shape
    r, w3, run = plan.radius, 3 * w, BLUR_RUN
    win = run + 2 * r
    out = torch.full_like(images, NAN)
    gather = torch.tensor([[skew(run * i + j) for j in range(win)] for i in range(plan.runs)])
    for blk in range(plan.blocks):
        sample, band = divmod(blk, plan.bands)
        rows = plan.band_rows(band)
        img = images[sample].reshape(h, w3)
        w_t = taps[sample]
        s_head = (head + sample * h * plan.row_bytes) % 16
        ring = torch.full((plan.slots, w3), NAN)
        held = [None] * plan.slots

        def copy_rows(y0, y1):
            for y in range(y0, y1):
                first = s_head + y * plan.row_bytes
                g0 = first & ~15
                n = (first + plan.row_bytes + 15 - g0) >> 4     # granules of the row
                assert n * 16 <= plan.slot_pitch
                assert (first & 15) + plan.row_bytes <= n * 16
                ring[y % plan.slots] = img[y]
                held[y % plan.slots] = y

        def need_hi(c0):
            return min(c0 + run + r, h)

        mids = [torch.full((run, 3, plan.mid_pitch), NAN) for _ in range(2)]
        chunks = plan.chunks(band)
        copy_rows(max(rows.start - r, 0), need_hi(rows.start))
        have = need_hi(rows.start)
        for c in range(len(chunks) + 1):
            c0 = rows.start + c * run
            if c + 1 < len(chunks):           # lands while chunk c computes
                nxt = need_hi(c0 + run)
                copy_rows(have, nxt)
                have = nxt
            if c > 0:                          # W pass of chunk c - 1, 8 pixels a thread
                p0, buf = c0 - run, mids[(c - 1) % 2]
                for t in range(min(run, rows.stop - p0)):
                    window = buf[t][:, gather]         # [3, runs, win]: skew(8i + j)
                    o = torch.zeros(run, 3, plan.runs)
                    for j in range(win):
                        for u in range(run):
                            if 0 <= j - u <= 2 * r:
                                o[u] = o[u] + w_t[j - u] * window[:, :, j]
                    px = o.permute(2, 0, 1).reshape(plan.runs * run, 3)  # pixel 8i + u
                    out[sample, p0 + t] = px[:w]
            if c < len(chunks):                # H pass of chunk c
                ys = [min(max(c0 - r + j, 0), h - 1) for j in range(win)]
                assert all(held[y % plan.slots] == y for y in ys)  # the slot holds the row
                window = ring[[y % plan.slots for y in ys]]       # [win, W*3]
                acc = torch.zeros(run, w3)
                for j in range(win):
                    for t in range(run):
                        if 0 <= j - t <= 2 * r:
                            acc[t] = acc[t] + w_t[j - t] * window[j]
                buf = mids[c % 2]
                buf.fill_(NAN)
                x = torch.arange(w3) // 3
                ch = torch.arange(w3) % 3
                for t in range(run):
                    buf[t, ch, (x + r) + ((x + r) >> 3)] = acc[t]
                    for p in range(r):         # the edge columns repeated
                        buf[t, ch[:3], skew(p)] = acc[t, :3]
                        buf[t, ch[-3:], skew(w + r + p)] = acc[t, -3:]
    assert not bool(out.isnan().any())         # every output written, from written values
    return out


def _inputs(b, h, w, radius, seed, identity_every=2):
    rng = np.random.RandomState(seed)
    images = rng.randn(b, h, w, 3).astype(np.float32)
    sigma = torch.from_numpy(rng.uniform(0.1, 2.0, b).astype(np.float32))
    apply = torch.from_numpy(np.arange(b) % identity_every != identity_every - 1)
    return images, blur_taps(sigma, apply, radius)


CASES = {
    "h_below_chunk": (2, 5, 7, 2),      # H < BLUR_RUN, odd W
    "h_ragged": (2, 13, 9, 3),          # H not a multiple of BLUR_RUN
    "radius_over_h": (2, 4, 6, 6),      # R >= H: every window row clamped
    "odd_w_bands": (3, 37, 53, 1),      # the card test's shape, 5 bands of a sample
    "fixed_radius": (2, 24, 20, 11),    # the R = 11 instantiation
}


@pytest.mark.parametrize("name", list(CASES))
def test_decomposition_matches_plain_and_pallas(name):
    b, h, w, radius = CASES[name]
    images, taps = _inputs(b, h, w, radius, seed=len(name))
    plan = blur_plan(b, h, w, radius, 4)
    _covers_once(plan)
    got = _emulate(plan, torch.from_numpy(images), taps).numpy()
    plain = blur.gaussian_blur_batch_plain(torch.from_numpy(images), taps, radius).numpy()
    pallas = np.asarray(jax_blur(jnp.asarray(images), jnp.asarray(taps.numpy()), radius,
                                 interpret=True))
    # f32, the same tap order; only the rounding of the separate multiply
    # and add may differ: ~1e-7
    np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", ["three_bands", "one_band", "generic_at_11"])
def test_forced_plans_decompose_the_same(variant):
    """Other bandings than the plan's own, and the run-time-radius
    instantiation at R = 11, give the same values (the C entry point takes
    any plan that covers the image)."""
    b, h, w, radius = 2, 40, 12, 11
    images, taps = _inputs(b, h, w, radius, seed=9)
    plan = blur_plan(b, h, w, radius, 4)
    forced = {"three_bands": dataclasses.replace(plan, bands=3, rows_per_band=16),
              "one_band": dataclasses.replace(plan, bands=1, rows_per_band=h),
              "generic_at_11": dataclasses.replace(plan, fixed=False)}[variant]
    _covers_once(forced)
    got = _emulate(forced, torch.from_numpy(images), taps).numpy()
    plain = blur.gaussian_blur_batch_plain(torch.from_numpy(images), taps, radius).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("head", [0, 2, 6, 14])
def test_unaligned_samples_take_the_same_copy(head):
    """Rows of an odd width (bf16 W = 7: 42 bytes) starting 2, 6 or 14
    bytes into a granule: every row's granule span fits its slot."""
    b, h, w, radius = 2, 11, 7, 2
    images, taps = _inputs(b, h, w, radius, seed=head)
    plan = blur_plan(b, h, w, radius, 2)
    got = _emulate(plan, torch.from_numpy(images), taps, head=head).numpy()
    plain = blur.gaussian_blur_batch_plain(torch.from_numpy(images), taps, radius).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-6)


def test_identity_taps_give_the_input_bit_for_bit():
    b, h, w, radius = 3, 10, 9, 3
    images, taps = _inputs(b, h, w, radius, seed=3, identity_every=1)
    assert bool((taps[:, radius] == 1.0).all())
    got = _emulate(blur_plan(b, h, w, radius, 4), torch.from_numpy(images), taps)
    assert torch.equal(got, torch.from_numpy(images))


def _refusing_library():
    raise AssertionError("the library was loaded: a launch was attempted")


@pytest.mark.parametrize("bad", ["shape", "bands", "fixed", "packed"])
def test_wrapper_refuses_a_plan_that_does_not_cover(monkeypatch, bad):
    """A plan for another batch, with bands that miss rows, the R = 11
    instantiation at another radius, or 16-byte stores into rows that do
    not allow them raises before the kernel library is even loaded."""
    monkeypatch.setattr(_build, "load_library", _refusing_library)
    images = torch.zeros(2, 16, 7, 3)
    taps = blur_taps(torch.ones(2), torch.ones(2, dtype=torch.bool), 1)
    plan = blur_plan(2, 16, 7, 1, 4)
    wrong = {"shape": dataclasses.replace(plan, h=15),
             "bands": dataclasses.replace(plan, bands=1, rows_per_band=8),
             "fixed": dataclasses.replace(plan, fixed=True),
             "packed": dataclasses.replace(plan, packed=True)}[bad]
    before = (blur.gaussian_blur_batch.launches, dict(blur.gaussian_blur_batch.routes))
    with pytest.raises(ValueError, match="plan refused"):
        blur._launch_blur(images, taps, 1, wrong)
    assert (blur.gaussian_blur_batch.launches, blur.gaussian_blur_batch.routes) == before
