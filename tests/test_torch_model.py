"""The port's ResNets against the flax ResNets on carried-over weights:
flax init -> `weights.params_from_jax` -> the port's modules, then the same
numpy images through both, in train mode (batch statistics, running-stat
update) and in eval mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.models import resnet as jresnet
from moco_tpu_torch.models import resnet
from moco_tpu_torch.weights import params_from_jax

CASES = {
    # the golden test's encoder: BasicBlocks, CIFAR stem
    "tiny_basic_cifar": (
        lambda: jresnet.ResNetTiny(num_classes=16, cifar_stem=True),
        lambda: resnet.build_resnet("resnet_tiny", num_classes=16, cifar_stem=True),
        16,
    ),
    # Bottleneck + v2 MLP head + the 7x7/2 stem and max-pool at 32 px
    "tiny_bottleneck_mlp": (
        lambda: jresnet.ResNet(stage_sizes=(1, 1), block_cls=jresnet.Bottleneck, width=8,
                               num_classes=16, mlp_head=True),
        lambda: resnet.ResNet((1, 1), resnet.Bottleneck, width=8, num_classes=16,
                              mlp_head=True),
        32,
    ),
    # the horizon's encoder at its full width: ResNet-18, CIFAR stem, the
    # 128-d head, 32 px
    "resnet18_cifar": (
        lambda: jresnet.ResNet18(num_classes=128, cifar_stem=True),
        lambda: resnet.build_resnet("resnet18", num_classes=128, cifar_stem=True),
        32,
    ),
}


@functools.cache
def _jax_init(name):
    make_j, _, size = CASES[name]
    jmodel = make_j()
    init = jax.jit(lambda key: jmodel.init(key, jnp.zeros((2, size, size, 3)), train=False))
    return jmodel, init(jax.random.key(0))


def _pair(name):
    _, make_t, size = CASES[name]
    jmodel, variables = _jax_init(name)
    tmodel = make_t()
    tmodel.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"])), strict=True)
    images = np.random.RandomState(7).randn(8, size, size, 3).astype(np.float32)
    return jmodel, variables, tmodel, images


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_forward_and_running_stats_match_flax(name):
    jmodel, variables, tmodel, images = _pair(name)
    out_j, mut = jmodel.apply(variables, jnp.asarray(images), train=True,
                              mutable=["batch_stats"])
    tmodel.train()
    with torch.no_grad():
        out_t = tmodel(torch.from_numpy(images))
    assert out_t.dtype == torch.float32 and out_t.shape == out_j.shape
    # f32 convs and BN sums in other orders, through a few layers: ~1e-5
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-4)
    ported = params_from_jax({}, jax.tree.map(np.asarray, mut["batch_stats"]))
    state = tmodel.state_dict()
    assert ported.keys() <= state.keys() and ported
    for key, ref in ported.items():
        np.testing.assert_allclose(state[key].numpy(), ref.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_forward_matches_flax(name):
    jmodel, variables, tmodel, images = _pair(name)
    out_j = jmodel.apply(variables, jnp.asarray(images), train=False)
    tmodel.eval()
    with torch.no_grad():
        out_t = tmodel(torch.from_numpy(images))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_gradients_match_flax(name):
    """One train-mode step's gradients: a fixed random projection of the
    output, differentiated with respect to every parameter in both
    frameworks, the flax gradients carried over by `params_from_jax`, each
    tensor within 2% in relative L2 norm. f32 through the whole depth puts
    a few ReLU inputs within rounding of 0, and a flipped ReLU moves its
    channel's bias gradient by a whole upstream gradient: scaling the
    images by 1 + 1e-6 moves flax's own ResNet-18 gradients by up to 0.4%
    this way, and the port's differ from flax's by up to 0.9%."""
    jmodel, variables, tmodel, images = _pair(name)
    proj = np.random.RandomState(8).randn(len(images), CASES[name][0]().num_classes)
    proj = proj.astype(np.float32)

    def loss(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(images), train=True, mutable=["batch_stats"])
        return jnp.sum(out * proj)

    grads = params_from_jax(jax.tree.map(np.asarray,
                                         jax.jit(jax.grad(loss))(variables["params"])))
    tmodel.train()
    (tmodel(torch.from_numpy(images)) * torch.from_numpy(proj)).sum().backward()
    got = {n: p.grad.numpy() for n, p in tmodel.named_parameters()}
    assert got.keys() == grads.keys()
    for key, want in grads.items():
        want = want.numpy()
        err = np.linalg.norm(got[key] - want) / np.linalg.norm(want)
        assert err < 2e-2, (key, err)


def test_weight_layouts_are_carried_across():
    """HWIO -> OIHW, [in, out] -> [out, in], BN leaves to weight/bias and
    running stats; every port parameter and buffer is covered."""
    _jmodel, variables, tmodel, _ = _pair("tiny_bottleneck_mlp")
    sd = params_from_jax(jax.tree.map(np.asarray, variables["params"]),
                         jax.tree.map(np.asarray, variables["batch_stats"]))
    assert sd.keys() == tmodel.state_dict().keys()
    k = np.asarray(variables["params"]["layer1_0"]["conv2"]["kernel"])  # [3,3,I,O]
    np.testing.assert_array_equal(sd["layer1_0.conv2.weight"].numpy()[:, :, 0, 2],
                                  k[0, 2].T)
    d = np.asarray(variables["params"]["fc_hidden"]["kernel"])         # [in, out]
    np.testing.assert_array_equal(sd["fc_hidden.weight"].numpy(), d.T)
    assert sd["bn1.running_var"].shape == (8,)


def test_r50_structure_matches_flax():
    """ResNet-50: the port's parameter shapes equal flax's, leaf by leaf
    (53 convs and 53 BNs, 163 parameter tensors with the MLP head)."""
    jmodel = jresnet.ResNet50(num_classes=128, mlp_head=True)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0),
                                                jnp.zeros((1, 64, 64, 3)), train=False))
    ref = params_from_jax(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]),
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["batch_stats"]))
    model = resnet.build_resnet("resnet50", num_classes=128, mlp_head=True)
    state = model.state_dict()
    assert state.keys() == ref.keys()
    assert all(state[k].shape == ref[k].shape for k in ref)
    assert sum(isinstance(m, resnet.FastBatchNorm) for m in model.modules()) == 53
    assert len(list(model.parameters())) == 53 + 2 * 53 + 4


def test_resnet18_cifar_init_statistics_match_flax():
    """The horizon's encoder (ResNet-18, CIFAR stem, 128-d head) as each
    package initializes it from its own generator: every BN parameter and
    statistic and the head's bias equal, and each weight tensor's mean and
    standard deviation within 4 standard errors of flax's (the frameworks
    draw other numbers from the same truncated normal)."""
    jmodel = jresnet.build_resnet("resnet18", num_classes=128, cifar_stem=True)
    variables = jax.jit(lambda key: jmodel.init(key, jnp.zeros((1, 32, 32, 3)),
                                                train=False))(jax.random.key(0))
    ref = params_from_jax(jax.tree.map(np.asarray, variables["params"]),
                          jax.tree.map(np.asarray, variables["batch_stats"]))
    model = resnet.build_resnet("resnet18", num_classes=128, cifar_stem=True,
                                generator=torch.Generator().manual_seed(0))
    state = {k: v.numpy().astype(np.float64) for k, v in model.state_dict().items()}
    assert state.keys() == ref.keys()
    weights = [k for k in ref if k.endswith("weight") and ref[k].ndim > 1]
    assert len(weights) == 21  # 20 convs and the head
    for k in ref:
        want = np.asarray(ref[k], np.float64)
        got = state[k]
        if k not in weights:
            np.testing.assert_array_equal(got, want, err_msg=k)
            continue
        n, std = want.size, want.std()
        assert abs(got.mean() - want.mean()) < 4 * std * np.sqrt(2 / n), k
        assert abs(got.std() - std) < 4 * std * np.sqrt(1 / n), k
