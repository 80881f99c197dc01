"""The port's fused bn->relu->conv `autograd.Function`s and fused blocks
against the JAX package, on the same numpy inputs, in f32 on the CPU.

On the CPU the JAX custom VJPs (`_bn_relu_conv_train`, ...) and the fused
flax blocks run their plain math under the same custom VJP: batch stats in
flax's op order, (x - mean) * (rstd * scale) + bias, and XLA convs. The
port runs the kernels' plain versions, x*a + b with a = scale*rstd and
b = bias - mean*a, and BatchNorm's closed-form backward; the two orders
differ by a few f32 roundings, which the tolerances below cover.
"""

from functools import partial

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.models import resnet as jresnet
from moco_tpu.models.fused_block import (
    _bn_relu_conv3x3_train,
    _bn_relu_conv3x3s2_train,
    _bn_relu_conv_train,
)
from moco_tpu_torch.models import fused_block, resnet
from moco_tpu_torch.weights import params_from_jax

EPS = 1e-5

FUNCTIONS = {
    # name: (JAX custom VJP, port Function, x NHWC shape, kernel HWIO shape)
    "1x1": (_bn_relu_conv_train, fused_block._BnReluConvTrain, (4, 6, 6, 16), (1, 1, 16, 32)),
    "3x3": (_bn_relu_conv3x3_train, fused_block._BnReluConv3x3Train, (2, 8, 8, 16),
            (3, 3, 16, 24)),
    "3x3_odd": (_bn_relu_conv3x3_train, fused_block._BnReluConv3x3Train, (2, 7, 7, 8),
                (3, 3, 8, 8)),
    "3x3_s2": (_bn_relu_conv3x3s2_train, fused_block._BnReluConv3x3S2Train, (2, 8, 8, 16),
               (3, 3, 16, 24)),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_function_matches_jax_custom_vjp(name):
    """Value and gradients of sum(y * cos y) (a non-trivial cotangent), and
    the batch statistics. 2e-4: `tests/test_fused_conv.py`'s tolerance for
    the closed-form backward against autodiff."""
    jfn, tfn, xshape, wshape = FUNCTIONS[name]
    rng = np.random.RandomState(len(name))
    x = (rng.randn(*xshape) * 1.5 + 0.2).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(xshape[-1])).astype(np.float32)
    bias = (0.1 * rng.randn(xshape[-1])).astype(np.float32)
    w = (0.1 * rng.randn(*wshape)).astype(np.float32)

    def jloss(args):
        y, mean, var = jfn(*args, EPS, jnp.float32)
        return jnp.sum(y * jnp.cos(y)), (y, mean, var)

    (lj, (yj, mj, vj)), gj = jax.value_and_grad(jloss, has_aux=True)(
        tuple(map(jnp.asarray, (x, scale, bias, w))))

    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()     # channels_last view
    st, bt = torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()  # OIHW
    yt, mt, vt = tfn.apply(xt, st, bt, wt, EPS, torch.float32)
    lt = (yt * torch.cos(yt)).sum()
    lt.backward()

    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    np.testing.assert_allclose(yt.detach().permute(0, 2, 3, 1).numpy(), np.asarray(yj), **tol)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gj[0]), **tol)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gj[1]), **tol)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gj[2]), **tol)
    np.testing.assert_allclose(wt.grad.permute(2, 3, 1, 0).numpy(), np.asarray(gj[3]), **tol)


BLOCKS = {
    # name: (JAX block class, port block class, filters, stride, x NHWC shape)
    "bottleneck_s1": (jresnet.Bottleneck, resnet.Bottleneck, 8, 1, (2, 8, 8, 32)),
    "bottleneck_s2": (jresnet.Bottleneck, resnet.Bottleneck, 8, 2, (2, 8, 8, 16)),
    "basic_s2": (jresnet.BasicBlock, resnet.BasicBlock, 16, 2, (2, 8, 8, 8)),
}


def _blocks(name, train):
    jcls, tcls, filters, stride, xshape = BLOCKS[name]
    conv = partial(nn.Conv, use_bias=False, dtype=jnp.float32, param_dtype=jnp.float32)
    norm = partial(nn.BatchNorm, use_running_average=not train, momentum=0.9, epsilon=EPS,
                   dtype=jnp.float32, param_dtype=jnp.float32)
    jblock = jcls(filters=filters, strides=stride, conv=conv, norm=norm, fused_tail=True,
                  bn_momentum=0.9, dtype=jnp.float32)
    x = np.random.RandomState(stride * filters).randn(*xshape).astype(np.float32)
    variables = jblock.init(jax.random.key(3), jnp.asarray(x))
    # running stats away from their init, so that eval mode reads them
    stats = jax.tree.map(lambda v: np.asarray(v) * 1.3 + 0.1, variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    tblock = tcls(xshape[-1], filters, stride, torch.float32, fused_tail=True)
    tblock.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables["params"]),
                                           stats), strict=True)
    return jblock, variables, tblock, x


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_fused_block_train_matches_jax(name):
    """Outputs, running statistics and parameter gradients of sum(out^2)
    against the JAX fused block (`tests/test_fused_conv.py`'s 3e-4 for the
    gradients through two closed-form BN backwards)."""
    jblock, variables, tblock, x = _blocks(name, train=True)

    def jloss(params):
        out, mut = jblock.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(x), mutable=["batch_stats"])
        return jnp.sum(out ** 2), (out, mut["batch_stats"])

    (_, (out_j, stats_j)), grads_j = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])

    tblock.train()
    out_t = tblock(torch.from_numpy(x).permute(0, 3, 1, 2))
    (out_t ** 2).sum().backward()

    np.testing.assert_allclose(out_t.detach().permute(0, 2, 3, 1).numpy(), np.asarray(out_j),
                               rtol=1e-4, atol=1e-4)
    state = tblock.state_dict()
    for key, ref in params_from_jax({}, jax.tree.map(np.asarray, stats_j)).items():
        np.testing.assert_allclose(state[key].numpy(), ref.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    ref_grads = params_from_jax(jax.tree.map(np.asarray, grads_j))
    named = dict(tblock.named_parameters())
    assert named.keys() == ref_grads.keys()
    for key, ref in ref_grads.items():
        np.testing.assert_allclose(named[key].grad.numpy(), ref.numpy(), rtol=3e-4, atol=3e-4,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_fused_block_eval_matches_jax(name):
    """Eval mode runs the unfused math on the running statistics."""
    jblock, variables, tblock, x = _blocks(name, train=False)
    out_j = jblock.apply(variables, jnp.asarray(x))
    tblock.eval()
    with torch.no_grad():
        out_t = tblock(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out_t.permute(0, 2, 3, 1).numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)


def test_fused_resnet_keeps_the_unfused_parameters():
    """`fused_bn_conv` changes no parameter or buffer name or shape, and the
    fused ResNet-50 routes every block through the fused functions."""
    plain = resnet.build_resnet("resnet50", num_classes=16, mlp_head=True)
    fused = resnet.build_resnet("resnet50", num_classes=16, mlp_head=True, fused_bn_conv=True)
    sd, sd2 = plain.state_dict(), fused.state_dict()
    assert sd.keys() == sd2.keys()
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    blocks = [getattr(fused, n) for n in fused.block_names]
    assert len(blocks) == 16 and all(b.fused_tail for b in blocks)
    assert sum(b.conv2.stride == 2 for b in blocks) == 3
