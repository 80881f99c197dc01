"""The launch plan of the bf16 forward band kernel (`csrc/conv3x3_fwd.cu`,
behind `bn_relu_conv3x3` and `bn_relu_conv3x3_s2`) and its band
decomposition, on the CPU.

The kernel cannot run here, so its index arithmetic is held through a
pure-torch emulation of what each block does: the plan's M tile of
consecutive output pixels, the zero-padded z band of the input rows it
reads (per image, even padded columns before odd ones at stride 2), one
base offset per output pixel plus nine constant tap offsets, K-chunks of 64
or 32 channels and N tiles, each zero past K and N. The emulation is held against
`bn_relu_conv3x3_plain` / `_s2_plain` and against the JAX package's Pallas
kernels in interpret mode on the same numpy inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.ops import pallas_fused_conv3x3
from moco_tpu_torch.ops import fused_conv3x3
from moco_tpu_torch.ops.fused_conv3x3 import (
    DW_BAND_SMEM_LIMIT,
    DW_BAND_SMS,
    FWD_SM_SMEM,
    FWD_STAGING_BYTES,
    FWD_W_STAGES,
    Fwd3x3Plan,
    conv3x3_fwd_plan,
)

# [B, H, W, K, N] and stride of the seven R50 batch-256 forwards
R50_SHAPES = {"layer1": ((256, 56, 56, 64, 64), 1), "layer2": ((256, 28, 28, 128, 128), 1),
              "layer3": ((256, 14, 14, 256, 256), 1), "layer4": ((256, 7, 7, 512, 512), 1),
              "layer2_s2": ((256, 56, 56, 128, 128), 2), "layer3_s2": ((256, 28, 28, 256, 256), 2),
              "layer4_s2": ((256, 14, 14, 512, 512), 2)}
TAPS = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)]


@pytest.mark.parametrize("name", list(R50_SHAPES))
def test_plan_fits_the_card_at_r50_shapes(name):
    shape, stride = R50_SHAPES[name]
    plan = conv3x3_fwd_plan(*shape, stride)
    assert plan.smem_bytes <= DW_BAND_SMEM_LIMIT
    assert plan.blocks >= DW_BAND_SMS                   # at least one full wave
    assert plan.bn == (64 if plan.n <= 64 else 128)     # N tiles sized to N
    assert plan.tiles_n * plan.bn - plan.n < plan.bn
    assert plan.bm * plan.bn == 128 * 128               # 64 f32 accumulators a thread
    assert plan.blocks_per_sm == 2                      # two blocks share each SM
    assert 2 * (plan.smem_bytes + 1024) <= FWD_SM_SMEM
    # 64-channel chunks where they let two blocks share an SM, else 32
    deep = Fwd3x3Plan(*shape, stride, plan.bn, 64, plan.band_rows)
    assert plan.bk == (64 if deep.blocks_per_sm == 2 else 32)
    assert plan.smem_bytes == max(
        plan.band_rows * plan.wp * (plan.bk + 8) * 2 +
        FWD_W_STAGES * plan.bk * (plan.bn + 8) * 2, FWD_STAGING_BYTES) + \
        4 * (plan.band_rows + plan.bm)
    # the band holds the largest M tile's rows (every tile, sampled)
    step = max(1, plan.tiles_m // 97)
    assert max(len(plan.row_sources(t)) for t in range(0, plan.tiles_m, step)) <= \
        plan.band_rows
    assert any(len(plan.row_sources(t)) == plan.band_rows for t in range(plan.tiles_m))


def test_plan_packs_small_images_into_one_m_tile():
    """Layer 4's 7x7 outputs (49 pixels) fill a 128-pixel M tile with the
    bands of three or four images."""
    for shape, stride in (R50_SHAPES["layer4"], R50_SHAPES["layer4_s2"]):
        plan = conv3x3_fwd_plan(*shape, stride)
        images = [{img for img, _ in plan.row_sources(t)} for t in range(plan.tiles_m)]
        assert min(len(i) for i in images) >= 3


def _check_tiles(plan):
    """Every output pixel lies in exactly one M tile; every band row of a
    tile belongs to one image's segment of consecutive rows; and every tap
    of every pixel reads the band pixel of its input row and column."""
    hw = plan.ho * plan.wo
    covered = []
    for tile in range(plan.tiles_m):
        p0, p1, *_ = plan.tile_span(tile)
        covered += range(p0, p1 + 1)
        rows = plan.row_sources(tile)
        assert len(rows) <= plan.band_rows
        for (img, ir), (img2, ir2) in zip(rows, rows[1:]):  # segments of one image each
            assert (img2 == img and ir2 == ir + 1) or (img2 == img + 1 and ir2 == -1)
        assert all(-1 <= ir <= plan.h for _, ir in rows)
        bases = plan.bases(tile)
        for m, p in enumerate(range(p0, p1 + 1)):
            img, r, c = p // hw, p % hw // plan.wo, p % plan.wo
            for di, dj in TAPS:
                q = bases[m] + plan.tap_offset(di, dj)
                assert 0 <= q < len(rows) * plan.wp
                assert rows[q // plan.wp] == (img, plan.stride * r + di)
                assert q % plan.wp == plan.slot(plan.stride * c + dj + 1)
    assert covered == list(range(plan.m))


SMALL = [((3, 7, 7, 8, 24), 1),     # one tile packs three images
         ((2, 29, 28, 24, 40), 1),  # tiles end mid-row and mid-image
         ((6, 7, 7, 16, 72), 1),    # 128 x 128 tiles over 2.6 images each, the last partial
         ((1, 9, 10, 72, 80), 1),   # K past one chunk, N past one 64 tile
         ((1, 1, 1, 8, 8), 1),      # a 1x1 image: every tap but the centre is padding
         ((2, 8, 8, 16, 24), 2),
         ((3, 14, 14, 24, 80), 2),  # layer 4's 14x14 -> 7x7: images packed in a tile
         ((2, 30, 28, 8, 16), 2),   # a tile that ends mid-image
         ((1, 4, 6, 72, 40), 2),
         ((2, 2, 2, 8, 8), 2)]      # 1x1 outputs


@pytest.mark.parametrize("shape,stride", SMALL)
def test_tiles_cover_every_pixel_and_taps_read_their_pixels(shape, stride):
    _check_tiles(conv3x3_fwd_plan(*shape, stride))


@pytest.mark.parametrize("name", ["layer2", "layer4", "layer2_s2", "layer4_s2"])
def test_tile_geometry_at_r50_widths(name):
    """The same checks at an R50 geometry, over the first batch of tiles
    (the spans repeat with the image)."""
    (_, h, w, k, n), stride = R50_SHAPES[name]
    _check_tiles(conv3x3_fwd_plan(4, h, w, k, n, stride))


@pytest.mark.parametrize("name", list(R50_SHAPES))
def test_ldmatrix_phase_touches_eight_bank_groups(name):
    """The output pixels of one row inside an ldmatrix phase (8 M rows from
    a multiple of 8) read distinct 16-byte bank groups at every tap, under
    the 144-byte pitch and, at stride 2, the even/odd column split; where
    the row is at least 15 wide some phase lies wholly inside one row."""
    shape, stride = R50_SHAPES[name]
    plan = conv3x3_fwd_plan(*shape, stride)
    bases = plan.bases(0)
    whole = 0
    for m0 in range(0, plan.bm, 8):
        by_row = {}
        for m in range(m0, m0 + 8):
            by_row.setdefault(m // plan.wo, []).append(m)
        whole += len(by_row) == 1
        for pixels in by_row.values():
            for di, dj in TAPS:
                groups = {((bases[m] + plan.tap_offset(di, dj)) * plan.pitch * 2 // 16) % 8
                          for m in pixels}
                assert len(groups) == len(pixels), (m0, di, dj)
    assert whole > 0 or plan.wo < 15


@pytest.mark.parametrize("bk", [64, 32])
def test_stride2_without_the_column_split_would_conflict(bk):
    """The interleaved layout (slot = padded column) puts stride-2 reads two
    pixels apart: 8 rows in 4 bank groups."""
    groups = {((58 + 2 * c + 1) * (bk + 8) * 2 // 16) % 8 for c in range(8)}
    assert len(groups) == 4


def test_plan_rejects_bands_too_large_for_shared_memory():
    with pytest.raises(ValueError):
        conv3x3_fwd_plan(2, 8, 1000, 64, 64, 1)
    with pytest.raises(ValueError):
        conv3x3_fwd_plan(2, 7, 8, 64, 64, 2)  # odd H at stride 2


def _emulate(plan, x, a, b, w):
    """What the blocks of the band kernel compute, in f32: per M tile, the
    zero-padded z band (channels padded with zeros to whole K-chunks); per
    N tile and K-chunk, tap (di, dj) multiplies the band's rows at
    `bases + tap_offset(di, dj)` by W's [bk, bn] tile (zeros past K and N);
    the epilogue keeps the tile's real pixels and channels."""
    bsz, h, wd, k = x.shape
    n = w.shape[-1]
    kpad, npad = plan.k_chunks * plan.bk, plan.tiles_n * plan.bn
    z = torch.zeros(bsz, h, wd, kpad)
    z[..., :k] = torch.relu(x.float() * a + b)
    wt = torch.zeros(9, kpad, npad)
    wt[:, :k, :n] = w.float().reshape(9, k, n)
    slots = torch.tensor([plan.slot(c + 1) for c in range(wd)])
    y = torch.zeros(plan.m, npad)
    for tile in range(plan.tiles_m):
        p0, p1, *_ = plan.tile_span(tile)
        band = torch.zeros(plan.band_rows * plan.wp, kpad)
        for j, (img, ir) in enumerate(plan.row_sources(tile)):
            if 0 <= ir < h:
                band[j * plan.wp + slots] = z[img, ir]
        base = torch.tensor(plan.bases(tile))
        for nt in range(plan.tiles_n):
            ns = slice(nt * plan.bn, (nt + 1) * plan.bn)
            acc = torch.zeros(plan.bm, plan.bn)
            for c in range(plan.k_chunks):
                ks = slice(c * plan.bk, (c + 1) * plan.bk)
                for tap, (di, dj) in enumerate(TAPS):
                    acc += band[base + plan.tap_offset(di, dj), ks] @ wt[tap, ks, ns]
            y[p0:p1 + 1, ns] = acc[:p1 - p0 + 1]
    return y[:, :n].reshape(bsz, plan.ho, plan.wo, n)


@pytest.mark.parametrize("bk", [64, 32])
@pytest.mark.parametrize("shape,stride", SMALL)
def test_band_decomposition_matches_plain_and_pallas(shape, stride, bk):
    bsz, h, wd, k, n = shape
    rng = np.random.RandomState(bsz * 1000 + h * 10 + wd + stride)
    x = rng.randn(bsz, h, wd, k).astype(np.float32)
    a = (1.0 + 0.1 * rng.randn(k)).astype(np.float32)
    b = (0.1 * rng.randn(k)).astype(np.float32)
    w = (0.1 * rng.randn(3, 3, k, n)).astype(np.float32)
    xt, at, bt, wt = (torch.from_numpy(v) for v in (x, a, b, w))
    plan = dataclasses.replace(conv3x3_fwd_plan(bsz, h, wd, k, n, stride), bk=bk)
    got = _emulate(plan, xt, at, bt, wt)
    if stride == 1:
        plain_fn, pallas_fn = fused_conv3x3.bn_relu_conv3x3_plain, \
            pallas_fused_conv3x3.bn_relu_conv3x3
    else:
        plain_fn, pallas_fn = fused_conv3x3.bn_relu_conv3x3_s2_plain, \
            pallas_fused_conv3x3.bn_relu_conv3x3_s2
    plain = plain_fn(xt, at, bt, wt, torch.float32)
    pallas = torch.from_numpy(np.array(pallas_fn(*map(jnp.asarray, (x, a, b, w)),
                                                 out_dtype=jnp.float32, interpret=True)))
    # f32 sums of the same products in another order: 1e-5 of sum |z||w|
    tol = 1e-5 * plain_fn(xt, at, bt, wt.abs(), torch.float32) + 1e-6
    for ref in (plain, pallas):
        assert got.shape == ref.shape
        assert bool(((got - ref).abs() <= tol).all()), float((got - ref).abs().max())


def test_k_chunk_and_n_tile_masking():
    """K = 72 takes two 64-deep K-chunks (the second 8 deep) or three 32-deep
    ones, and N = 80 one 128-wide tile; N = 200 two, the second 72 wide."""
    plan = conv3x3_fwd_plan(1, 9, 10, 72, 80, 1)
    assert (plan.bk, plan.k_chunks, plan.bn, plan.tiles_n) == (64, 2, 128, 1)
    assert dataclasses.replace(plan, bk=32).k_chunks == 3
    plan = conv3x3_fwd_plan(1, 9, 10, 72, 200, 1)
    assert (plan.k_chunks, plan.bn, plan.tiles_n) == (2, 128, 2)
    x = torch.randn(1, 9, 10, 72, generator=torch.Generator().manual_seed(0))
    a, b = torch.ones(72), torch.zeros(72)
    w = torch.randn(3, 3, 72, 200, generator=torch.Generator().manual_seed(1))
    got = _emulate(plan, x, a, b, w)
    ref = fused_conv3x3.bn_relu_conv3x3_plain(x, a, b, w, torch.float32)
    tol = 1e-5 * fused_conv3x3.bn_relu_conv3x3_plain(x, a, b, w.abs(), torch.float32) + 1e-6
    assert bool(((got - ref).abs() <= tol).all())


@pytest.mark.parametrize("stride", [1, 2])
def test_band_padding_is_zero_in_z_not_relu_of_b(stride):
    """x = 0 and b = 1 give z = 1 inside the image; the band's padding must
    hold 0, so a 1x1 output of a 1x1 (or 2x2) image sees only the taps that
    land inside it."""
    size = stride
    x, a, b = torch.zeros(1, size, size, 8), torch.ones(8), torch.ones(8)
    w = torch.ones(3, 3, 8, 8)
    got = _emulate(conv3x3_fwd_plan(1, size, size, 8, 8, stride), x, a, b, w)
    inside = 1 if stride == 1 else 4   # stride 2 reads rows and columns 0, 1 of the 2x2 image
    torch.testing.assert_close(got, torch.full((1, 1, 1, 8), 8.0 * inside))
    plain = fused_conv3x3.bn_relu_conv3x3_plain if stride == 1 else \
        fused_conv3x3.bn_relu_conv3x3_s2_plain
    torch.testing.assert_close(plain(x, a, b, w, torch.float32), got)


def test_plan_is_a_frozen_record():
    """conv3x3_fwd_plan caches its plans, so a plan must not change."""
    plan = conv3x3_fwd_plan(2, 8, 8, 16, 24, 1)
    assert isinstance(plan, Fwd3x3Plan)
    with pytest.raises(Exception):
        plan.bn = 128
