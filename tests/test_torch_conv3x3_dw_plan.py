"""The launch plan of the bf16 `conv3x3_dw` band kernel
(`csrc/conv3x3_dw.cu`) and its band decomposition, on the CPU.

The kernel cannot run here, so its index arithmetic is held through a
pure-torch emulation of what each block does: the plan's bands of one slab,
the zero-padded z band in shared memory, the contraction over padded output
pixels q = r*(W + 2) + c with dy 0 for c >= W, the nine tap offsets into the
band, and the slab partials summed in slab order. The emulation is held
against `conv3x3_dw_plain` and against the JAX package's Pallas kernel in
interpret mode on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.ops import pallas_fused_conv3x3
from moco_tpu_torch.ops import fused_conv3x3
from moco_tpu_torch.ops.fused_conv3x3 import (
    DW_BAND_PITCH,
    DW_BAND_SCRATCH_LIMIT,
    DW_BAND_SMEM_LIMIT,
    DW_BAND_SMS,
    DW_BAND_STAGES,
    DW_BAND_TILE,
    Dw3x3Plan,
    conv3x3_dw_plan,
)

R50_SHAPES = {"layer1": (256, 56, 56, 64, 64), "layer2": (256, 28, 28, 128, 128),
              "layer3": (256, 14, 14, 256, 256), "layer4": (256, 7, 7, 512, 512)}


def _band_rows(plan):
    """(image, output row) of every row each band covers, band by band."""
    out = []
    for band in range(plan.bands):
        img, row0 = plan.band_origin(band)
        out.append([(img, r) for r in range(row0, min(row0 + plan.rows, plan.h))])
    return out


def _assert_bands_tile_the_rows(plan):
    covered = [row for rows in _band_rows(plan) for row in rows]
    assert sorted(covered) == [(i, r) for i in range(plan.bsz) for r in range(plan.h)]
    for band in range(plan.bands):
        img, row0 = plan.band_origin(band)
        assert 0 <= row0 < plan.h and img < plan.bsz   # starts inside its image
    slabs = [list(plan.slab_bands(s)) for s in range(plan.slabs)]
    assert [b for s in slabs for b in s] == list(range(plan.bands))
    assert all(slabs)                                   # no slab is empty


@pytest.mark.parametrize("name", list(R50_SHAPES))
def test_plan_fits_the_card_at_r50_shapes(name):
    plan = conv3x3_dw_plan(*R50_SHAPES[name])
    assert plan.smem_bytes <= DW_BAND_SMEM_LIMIT
    assert plan.blocks >= DW_BAND_SMS
    assert plan.slabs * 9 * plan.k * plan.n * 4 <= DW_BAND_SCRATCH_LIMIT
    assert plan.q_pad % 16 == 0 and plan.q_pad >= plan.rows * (plan.w + 2)
    # the last pixel a tap reads lies inside the stage's z region
    assert plan.q_pad - 1 + plan.tap_offset(1, 1) == plan.z_pix - 1
    assert plan.z_pix >= (plan.rows + 2) * (plan.w + 2)
    assert plan.smem_bytes == 2 * DW_BAND_TILE * 4 + \
        DW_BAND_STAGES * (plan.z_pix + plan.q_pad) * DW_BAND_PITCH * 2
    _assert_bands_tile_the_rows(plan)


def _plan(shape, rows):
    """The plan's own choice, or a band height forced to reach an edge (with
    one slab per band, as the plan gives when bands are fewer than SMs)."""
    if rows is None:
        return conv3x3_dw_plan(*shape)
    plan = Dw3x3Plan(*shape, rows=rows, slabs=1)
    return Dw3x3Plan(*shape, rows=rows, slabs=plan.bands)


@pytest.mark.parametrize("shape,rows", [((3, 7, 5, 8, 24), 3), ((1, 29, 28, 24, 40), None),
                                        ((2, 57, 56, 64, 64), None), ((3, 6, 7, 40, 8), 4),
                                        ((1, 1, 1, 8, 8), None)])
def test_bands_cover_every_row_once(shape, rows):
    plan = _plan(shape, rows)
    _assert_bands_tile_the_rows(plan)
    assert plan.smem_bytes <= DW_BAND_SMEM_LIMIT


def test_plan_mid_image_band_end():
    """The plan's own rows need not divide H: here the last band of each
    image is short."""
    plan = conv3x3_dw_plan(1, 29, 28, 24, 40)
    assert plan.h % plan.rows != 0


def test_plan_rejects_images_too_wide_for_shared_memory():
    with pytest.raises(ValueError):
        conv3x3_dw_plan(1, 4, 1000, 8, 8)       # one band of one row exceeds shared memory


def _emulate(plan, x, a, b, dy):
    """What the blocks of the band kernel compute, in f32: for each slab,
    for each band, the zero-padded z band flattened to z_pix pixels and the
    padded dy band to q_pad pixels, tap (di, dj) contracting
    z[q + tap_offset(di, dj)] against dy[q]; the slab partials summed in
    slab order. All K and N at once (the tiles only split the columns)."""
    bsz, h, w, k = x.shape
    n = dy.shape[-1]
    wp = w + 2
    z = torch.relu(x.float() * a + b)
    parts = []
    for slab in range(plan.slabs):
        acc = torch.zeros(9, k, n)
        for band in plan.slab_bands(slab):
            img, row0 = plan.band_origin(band)
            zb = torch.zeros(plan.z_pix, k)
            for j in range(plan.rows + 2):
                ir = row0 - 1 + j
                if 0 <= ir < h:
                    zb[j * wp + 1:j * wp + 1 + w] = z[img, ir]
            db = torch.zeros(plan.q_pad, n)
            for r in range(plan.rows):
                if row0 + r < h:
                    db[r * wp:r * wp + w] = dy[img, row0 + r].float()
            for di in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    off = plan.tap_offset(di, dj)
                    acc[(di + 1) * 3 + dj + 1] += zb[off:off + plan.q_pad].t() @ db
        parts.append(acc)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out.reshape(3, 3, k, n)


EMULATED = [((3, 7, 5, 8, 24), 3),      # H not a multiple of R: the last band ends mid-image
            ((1, 7, 7, 24, 40), None),  # one band per image
            ((3, 6, 7, 40, 8), 4),
            ((1, 5, 5, 40, 40), 2),
            ((3, 4, 7, 8, 8), 1)]       # one row per band: both halo rows from other bands


@pytest.mark.parametrize("shape,rows", EMULATED)
def test_band_decomposition_matches_plain_and_pallas(shape, rows):
    bsz, h, w, k, n = shape
    rng = np.random.RandomState(bsz * 100 + h * 10 + w)
    x = rng.randn(bsz, h, w, k).astype(np.float32)
    a = (1.0 + 0.1 * rng.randn(k)).astype(np.float32)
    b = (0.1 * rng.randn(k)).astype(np.float32)
    dy = rng.randn(bsz, h, w, n).astype(np.float32)
    xt, at, bt, dyt = (torch.from_numpy(v) for v in (x, a, b, dy))
    plan = _plan(shape, rows)
    got = _emulate(plan, xt, at, bt, dyt)
    plain = fused_conv3x3.conv3x3_dw_plain(xt, at, bt, dyt)
    pallas = torch.from_numpy(np.array(pallas_fused_conv3x3.conv3x3_dw(
        *map(jnp.asarray, (x, a, b, dy)), interpret=True)))
    # f32 sums of the same products in another order: 1e-5 of sum |z||dy|
    tol = 1e-5 * fused_conv3x3.conv3x3_dw_plain(xt, at, bt, dyt.abs()) + 1e-6
    for ref in (plain, pallas):
        assert got.shape == ref.shape
        assert bool(((got - ref).abs() <= tol).all()), float((got - ref).abs().max())


def test_band_padding_is_zero_in_z_not_relu_of_b():
    """x = 0 and b = 1 give z = 1 inside the image; the band's padding must
    hold 0, so on a 1x1 image every tap but the centre has dW = 0."""
    x, a, b = torch.zeros(1, 1, 1, 8), torch.ones(8), torch.ones(8)
    dy = torch.ones(1, 1, 1, 8)
    got = _emulate(conv3x3_dw_plan(1, 1, 1, 8, 8), x, a, b, dy)
    want = torch.zeros(3, 3, 8, 8)
    want[1, 1] = 1.0
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(fused_conv3x3.conv3x3_dw_plain(x, a, b, dy), want)
