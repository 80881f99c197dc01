"""The port's fused BN->ReLU->conv kernels' plain versions (what a CPU
tensor takes) against the JAX package's Pallas kernels in interpret mode,
on the same numpy inputs, at the shapes of `tests/test_fused_conv.py` and
`tests/test_fused_conv3x3.py`; and the wrappers' input checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.ops import pallas_fused_conv, pallas_fused_conv3x3
from moco_tpu_torch.ops import fused_conv, fused_conv3x3

# f32 products of O(1) terms summed in another order: ~1e-6. The JAX tests'
# own tolerances: 1e-5 for the forwards, 1e-4 for the dW reductions.
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
DW_TOL = dict(rtol=1e-4, atol=1e-4)


def _affine(rng, k):
    a = (1.0 + 0.1 * rng.randn(k)).astype(np.float32)
    b = (0.1 * rng.randn(k)).astype(np.float32)
    return a, b


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("m,k,n", [(128, 64, 256), (96, 24, 40)])
def test_bn_relu_matmul_matches_pallas(m, k, n):
    rng = np.random.RandomState(m + k + n)
    x = rng.randn(m, k).astype(np.float32)
    a, b = _affine(rng, k)
    w = (0.05 * rng.randn(k, n)).astype(np.float32)
    want = pallas_fused_conv.bn_relu_matmul(*map(jnp.asarray, (x, a, b, w)),
                                            out_dtype=jnp.float32, interpret=True)
    got = fused_conv.bn_relu_matmul(*_t(x, a, b, w), out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("m,k,n", [(256, 64, 128), (96, 24, 40)])
def test_bn_relu_matmul_dw_matches_pallas(m, k, n):
    rng = np.random.RandomState(m * k + n)
    x = rng.randn(m, k).astype(np.float32)
    a, b = _affine(rng, k)
    dy = rng.randn(m, n).astype(np.float32)
    want = pallas_fused_conv.bn_relu_matmul_dw(*map(jnp.asarray, (x, a, b, dy)),
                                               interpret=True)
    got = fused_conv.bn_relu_matmul_dw(*_t(x, a, b, dy))
    assert got.dtype == torch.float32 and got.shape == (k, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DW_TOL)


CONV_SHAPES = [(2, 8, 8, 16, 24), (2, 7, 7, 8, 8)]  # the second: odd H, batch boundary


def _conv_inputs(shape, seed):
    bsz, h, wd, k, n = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(bsz, h, wd, k).astype(np.float32)
    a, b = _affine(rng, k)
    w = (0.1 * rng.randn(3, 3, k, n)).astype(np.float32)
    return x, a, b, w


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_bn_relu_conv3x3_matches_pallas(shape):
    x, a, b, w = _conv_inputs(shape, 1)
    want = pallas_fused_conv3x3.bn_relu_conv3x3(*map(jnp.asarray, (x, a, b, w)),
                                                out_dtype=jnp.float32, interpret=True)
    got = fused_conv3x3.bn_relu_conv3x3(*_t(x, a, b, w), out_dtype=torch.float32)
    assert got.shape == shape[:3] + (shape[4],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_bn_relu_conv3x3_s2_matches_pallas():
    x, a, b, w = _conv_inputs((2, 8, 8, 16, 24), 2)
    want = pallas_fused_conv3x3.bn_relu_conv3x3_s2(*map(jnp.asarray, (x, a, b, w)),
                                                   out_dtype=jnp.float32, interpret=True)
    got = fused_conv3x3.bn_relu_conv3x3_s2(*_t(x, a, b, w), out_dtype=torch.float32)
    assert got.shape == (2, 4, 4, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv3x3_dw_matches_pallas(shape):
    x, a, b, _w = _conv_inputs(shape, 3)
    dy = np.random.RandomState(4).randn(*shape[:3], shape[4]).astype(np.float32)
    want = pallas_fused_conv3x3.conv3x3_dw(*map(jnp.asarray, (x, a, b, dy)), interpret=True)
    got = fused_conv3x3.conv3x3_dw(*_t(x, a, b, dy))
    assert got.dtype == torch.float32 and got.shape == (3, 3, shape[3], shape[4])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DW_TOL)


def test_zero_padding_applies_to_z_not_x():
    """With b > 0 a padded x of 0 would give relu(b) > 0 at every border
    tap; the conv pads z, so a 1x1 image sees only its centre tap."""
    x = torch.zeros(1, 1, 1, 4)
    a, b = torch.ones(4), torch.ones(4)
    w = torch.ones(3, 3, 4, 2)
    got = fused_conv3x3.bn_relu_conv3x3(x, a, b, w, out_dtype=torch.float32)
    torch.testing.assert_close(got, torch.full((1, 1, 1, 2), 4.0))


def test_bf16_operands_are_rounded_before_the_product():
    """z is cast to the operand dtype (bf16) before an f32-accumulated
    product, and the result to `out_dtype`: the Pallas bodies' order."""
    rng = np.random.RandomState(5)
    x, a, b, w = _t(rng.randn(16, 8).astype(np.float32), *_affine(rng, 8),
                    rng.randn(8, 4).astype(np.float32))
    xb, wb = x.bfloat16(), w.bfloat16()
    got = fused_conv.bn_relu_matmul(xb, a, b, wb, out_dtype=torch.float32)
    z = torch.relu(xb.float() * a + b).bfloat16().float()
    torch.testing.assert_close(got, z @ wb.float(), rtol=1e-6, atol=1e-6)
    assert fused_conv.bn_relu_matmul(xb, a, b, wb).dtype == torch.bfloat16


def test_wrappers_check_their_inputs():
    x, a, b = torch.zeros(8, 4), torch.zeros(4), torch.zeros(4)
    w = torch.zeros(4, 6)
    with pytest.raises(ValueError):
        fused_conv.bn_relu_matmul(x.t().contiguous().t(), a, b, w)        # not row-major
    with pytest.raises(ValueError):
        fused_conv.bn_relu_matmul(x, a, b, torch.zeros(5, 6))             # K mismatch
    with pytest.raises(ValueError):
        fused_conv.bn_relu_matmul(x, a, b, w.bfloat16())                  # dtype mismatch
    with pytest.raises(TypeError):
        fused_conv.bn_relu_matmul(x.half(), a, b, w.half())
    with pytest.raises(TypeError):
        fused_conv.bn_relu_matmul(x, a, b, w, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        fused_conv.bn_relu_matmul(x, a.double(), b, w)                    # a must be f32
    with pytest.raises(ValueError):
        fused_conv.bn_relu_matmul_dw(x, a, b, torch.zeros(7, 6))          # M mismatch
    xn, w3 = torch.zeros(2, 4, 4, 4), torch.zeros(3, 3, 4, 6)
    with pytest.raises(ValueError):
        fused_conv3x3.bn_relu_conv3x3(xn.permute(0, 3, 1, 2), a, b, w3)   # NCHW, not NHWC
    with pytest.raises(ValueError):
        fused_conv3x3.bn_relu_conv3x3(xn, a, b, torch.zeros(1, 1, 4, 6))  # not 3x3
    with pytest.raises(ValueError):
        fused_conv3x3.bn_relu_conv3x3_s2(torch.zeros(2, 5, 4, 4), a, b, w3)  # odd H
    with pytest.raises(ValueError):
        fused_conv3x3.conv3x3_dw(xn, a, b, torch.zeros(2, 4, 3, 6))       # grid mismatch
    with pytest.raises(ValueError, match="unsupported device"):
        fused_conv.bn_relu_matmul(*(t.to("meta") for t in (x, a, b, w)))


def test_launch_counters_stay_zero_on_the_cpu():
    fns = (fused_conv.bn_relu_matmul, fused_conv.bn_relu_matmul_dw,
           fused_conv3x3.bn_relu_conv3x3, fused_conv3x3.bn_relu_conv3x3_s2,
           fused_conv3x3.conv3x3_dw)
    before = [f.launches for f in fns]
    x, a, b = torch.ones(2, 4, 4, 8), torch.ones(8), torch.zeros(8)
    rows, w3 = x.view(-1, 8), torch.ones(3, 3, 8, 8)
    fused_conv.bn_relu_matmul(rows, a, b, torch.ones(8, 8))
    fused_conv.bn_relu_matmul_dw(rows, a, b, rows)
    fused_conv3x3.bn_relu_conv3x3(x, a, b, w3)
    fused_conv3x3.bn_relu_conv3x3_s2(x, a, b, w3)
    fused_conv3x3.conv3x3_dw(x, a, b, x)
    assert [f.launches for f in fns] == before
