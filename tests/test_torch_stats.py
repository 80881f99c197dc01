"""The port's BN reductions and `FastBatchNorm` against the JAX package.

Same numpy inputs (from a seed) go through the JAX Pallas kernels in
interpret mode and through the port's plain versions (what a CPU tensor
takes), and through both `FastBatchNorm`s with the JAX side forced onto its
closed-form custom-VJP backward (`MOCO_TPU_BN_VJP=1`), the same algorithm
the port's `autograd.Function` runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.models.fast_bn import FastBatchNorm as JaxFastBatchNorm
from moco_tpu.ops import pallas_stats
from moco_tpu_torch.models.fast_bn import FastBatchNorm, rows_view
from moco_tpu_torch.ops import stats

# f32 sums of ~1000 O(1) terms in another order: ~1e-6 relative to sum |x|
SUM_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,c", [(1024, 24), (256, 64), (96, 3)])
def test_channel_sums_matches_jax(m, c):
    x = np.random.RandomState(m + c).randn(m, c).astype(np.float32) * 2 + 0.5
    s_j, sq_j = pallas_stats.channel_sums(jnp.asarray(x), interpret=True)
    s_t, sq_t = stats.channel_sums(torch.from_numpy(x))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **SUM_TOL)
    np.testing.assert_allclose(sq_t.numpy(), np.asarray(sq_j), **SUM_TOL)


@pytest.mark.parametrize("m,c", [(2048, 16), (512, 32)])
def test_channel_grad_sums_matches_jax(m, c):
    rng = np.random.RandomState(m * c)
    dy = rng.randn(m, c).astype(np.float32)
    x = rng.randn(m, c).astype(np.float32)
    mean = np.linspace(-0.5, 0.5, c).astype(np.float32)
    rstd = np.linspace(0.8, 1.2, c).astype(np.float32)
    ds_j, dx_j = pallas_stats.channel_grad_sums(
        jnp.asarray(dy), jnp.asarray(x), jnp.asarray(mean), jnp.asarray(rstd),
        interpret=True)
    ds_t, dx_t = stats.channel_grad_sums(*map(torch.from_numpy, (dy, x, mean, rstd)))
    np.testing.assert_allclose(ds_t.numpy(), np.asarray(ds_j), **SUM_TOL)
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), **SUM_TOL)


def test_wrappers_check_their_inputs():
    with pytest.raises(ValueError):
        stats.channel_sums(torch.zeros(4, 8).t())           # not row-major
    with pytest.raises(TypeError):
        stats.channel_sums(torch.zeros(4, 8, dtype=torch.float16))
    with pytest.raises(ValueError):
        stats.channel_sums(torch.zeros(2, 4, 8))
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        stats.channel_grad_sums(x, x, torch.zeros(7), torch.zeros(8))
    with pytest.raises(ValueError):
        stats.channel_grad_sums(x, x.bfloat16(), torch.zeros(8), torch.zeros(8))


def test_rows_view_is_a_view_and_rejects_plain_nchw():
    x = torch.randn(2, 5, 3, 4).to(memory_format=torch.channels_last)
    rows = rows_view(x)
    assert rows.shape == (2 * 3 * 4, 5) and rows.data_ptr() == x.data_ptr()
    np.testing.assert_array_equal(rows.numpy(), x.permute(0, 2, 3, 1).reshape(-1, 5).numpy())
    with pytest.raises(ValueError):
        rows_view(torch.randn(2, 5, 3, 4))  # NCHW-contiguous: no copy is made


def _bn_inputs(seed=0, shape=(8, 6, 6, 16)):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 1.7 + 0.3).astype(np.float32)          # NHWC
    scale = (1.0 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    bias = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    ct = (0.5 * rng.randn(*shape)).astype(np.float32)                # cotangent of y
    return x, scale, bias, ct


def _port_bn(scale, bias):
    bn = FastBatchNorm(scale.shape[0], momentum=0.9, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    return bn


def test_fast_bn_train_matches_jax(monkeypatch):
    monkeypatch.setenv("MOCO_TPU_BN_VJP", "1")  # JAX's closed-form backward
    x, scale, bias, ct = _bn_inputs()
    jbn = JaxFastBatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = jbn.init(jax.random.key(0), jnp.asarray(x))
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": variables["batch_stats"]}

    def loss(params, xj):
        y, mut = jbn.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           xj, mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(ct)), (y, mut["batch_stats"])

    (_, (y_j, stats_j)), (g_j, gx_j) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))

    bn = _port_bn(scale, bias)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()   # channels_last view
    y_t = bn(xt)
    (y_t * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()

    # f32 elementwise in the same op order; sums in another order: ~1e-6
    np.testing.assert_allclose(y_t.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats_j["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats_j["var"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx_j),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(g_j["scale"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(g_j["bias"]),
                               rtol=1e-4, atol=1e-4)


def test_fast_bn_eval_matches_jax():
    x, scale, bias, _ = _bn_inputs(seed=1)
    mean = np.linspace(-1, 1, 16).astype(np.float32)
    var = np.linspace(0.5, 2, 16).astype(np.float32)
    jbn = JaxFastBatchNorm(use_running_average=True, epsilon=1e-5)
    y_j = jbn.apply({"params": {"scale": scale, "bias": bias},
                     "batch_stats": {"mean": mean, "var": var}}, jnp.asarray(x))
    bn = _port_bn(scale, bias).eval()
    bn.running_mean.copy_(torch.from_numpy(mean))
    bn.running_var.copy_(torch.from_numpy(var))
    with torch.no_grad():
        y_t = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y_t.permute(0, 2, 3, 1).numpy(), np.asarray(y_j),
                               rtol=1e-6, atol=1e-6)


def test_fast_bn_running_stats_are_flax_not_torch():
    """Biased variance and old-value momentum 0.9 (flax), where
    torch.nn.BatchNorm2d would use the unbiased variance."""
    x, scale, bias, _ = _bn_inputs(seed=2, shape=(4, 3, 3, 8))
    bn = _port_bn(scale, bias)
    with torch.no_grad():
        bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    flat = x.reshape(-1, 8).astype(np.float64)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * flat.mean(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * flat.var(0), rtol=1e-5)
