"""The port's ViT and MoCo-v3 heads against the JAX package's (f32, the same
weights carried over by `weights.params_from_jax`), and the timm dialect
against the JAX package's writer and reader.

Tolerances: the forwards are the same f32 ops in the same order except for
the summation order of the convolution, the matmuls and LayerNorm (and
torch's two-pass LayerNorm variance against flax's mean of squares). The
heads stay within rtol 1e-5 / atol 1e-6. The ViT does not: its patch
embedding sums 768 products per output in another order (oneDNN's against
XLA's), so the first LayerNorm's input already differs by about 1e-6 of
its scale, and LayerNorm brings that to unit scale: up to 3.0e-6 absolute
at outputs of magnitude 3 after two blocks (measured here; the same at
every stage). The ViT is held to rtol 1e-5 / atol 5e-6, its
gradients to rtol 1e-4 / atol 1e-5. The export and its reader move bytes,
so they are held to equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.checkpoint import timm_to_vit as jax_timm_to_vit
from moco_tpu.checkpoint import vit_to_timm as jax_vit_to_timm
from moco_tpu.models import heads as jheads
from moco_tpu.models import vit as jvit
from moco_tpu.v3_step import V3Model as JaxV3Model
from moco_tpu_torch.checkpoint import timm_to_vit, vit_to_timm
from moco_tpu_torch.models import heads, vit
from moco_tpu_torch.v3_step import V3Model
from moco_tpu_torch.weights import params_from_jax, params_to_jax

TOL = dict(rtol=1e-5, atol=1e-6)      # the heads
VIT_TOL = dict(rtol=1e-5, atol=5e-6)  # the ViT (see above)
B, IMG = 4, 32


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _images(seed, b=B, img=IMG):
    return np.random.RandomState(seed).randn(b, img, img, 3).astype(np.float32)


def _jax_vit(num_classes=None):
    model = jvit.build_vit("vit_tiny", num_classes=num_classes)
    v = model.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)), train=False)
    # the init leaves the biases and LN affines at 0 and 1: move them, so
    # that a wrong map of those leaves shows
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.1 * jax.random.normal(jax.random.key(len(jax.tree_util.keystr(p))),
                                                 a.shape)
        if jax.tree_util.keystr(p).endswith(("['bias']", "['scale']")) else a,
        v["params"])
    return model, params


def _port_vit(params, num_classes=None, **kw):
    model = vit.build_vit("vit_tiny", num_classes=num_classes, image_size=IMG, **kw)
    model.load_state_dict(params_from_jax(_np(params)))
    return model


def test_sincos_embedding_matches_jax():
    for h, w, d in ((2, 2, 64), (14, 14, 384), (3, 5, 32)):
        np.testing.assert_array_equal(vit.sincos_2d_position_embedding(h, w, d).numpy(),
                                      np.asarray(jvit.sincos_2d_position_embedding(h, w, d)))


@pytest.mark.parametrize("num_classes", [None, 16])
def test_vit_forward_matches_flax(num_classes):
    """Class-token features (and the v1/v2 Dense head) in f32."""
    jmodel, params = _jax_vit(num_classes)
    x = _images(0)
    ref = np.asarray(jmodel.apply({"params": params}, x, train=True))
    got = _port_vit(params, num_classes)(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ((B, 64) if num_classes is None else (B, num_classes))
    np.testing.assert_allclose(got, ref, **VIT_TOL)


def test_vit_other_input_size_matches_flax():
    """A grid other than the built one computes its own position embedding."""
    jmodel, params = _jax_vit()
    x = _images(1, img=48)
    ref = np.asarray(jmodel.apply({"params": params}, x, train=True))
    got = _port_vit(params)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, **VIT_TOL)


def test_vit_gradients_match_flax():
    """Parameter gradients of a scalar of the features; the frozen patch
    embedding gets none (flax: structurally zero through stop_gradient)."""
    jmodel, params = _jax_vit()
    x = _images(2)
    w = np.random.RandomState(3).randn(B, 64).astype(np.float32)

    def loss(p):
        return jnp.sum(jmodel.apply({"params": p}, x, train=True) * w)

    jgrads = params_from_jax(_np(jax.grad(loss)(params)))
    model = _port_vit(params)
    (model(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(jgrads["patch_embed.weight"].numpy(), 0.0)
    for name, p in model.named_parameters():
        if name.startswith("patch_embed."):
            assert p.grad is None and not p.requires_grad
            continue
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_vit_remat_same_outputs_and_gradients():
    _jmodel, params = _jax_vit()
    x = torch.from_numpy(_images(4))
    grads = []
    for remat in (False, True):
        model = _port_vit(params, remat=remat)
        out = model(x)
        out.square().sum().backward()
        grads.append((out.detach(), {n: p.grad for n, p in model.named_parameters()
                                     if p.grad is not None}))
    torch.testing.assert_close(grads[1][0], grads[0][0], rtol=0, atol=0)
    for name, g in grads[0][1].items():
        torch.testing.assert_close(grads[1][1][name], g, rtol=0, atol=0)


def test_layernorm_epsilon_and_gelu_are_flax_s():
    block = vit.TransformerBlock(64, 2, 4.0, torch.float32)
    assert block.norm1.eps == 1e-6 and vit.LayerNorm(8).eps == 1e-6
    x = torch.linspace(-4, 4, 101)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()), approximate=False))
    # XLA's erf polynomial and torch's differ by up to 5e-7 in the tails;
    # the tanh form differs by 1e-4 and more
    np.testing.assert_allclose(torch.nn.functional.gelu(x, approximate="none").numpy(), ref,
                               rtol=1e-5, atol=1e-6)
    assert np.abs(torch.nn.functional.gelu(x, approximate="tanh").numpy() - ref).max() > 1e-4


@pytest.mark.parametrize("kind", ["projector", "predictor"])
def test_heads_train_forward_and_running_stats_match_flax(kind):
    """Train-mode forward and the updated running statistics (flax: the
    BIASED batch variance; momentum 0.9 on the old value)."""
    jcls, cls = ((jheads.V3Projector, heads.V3Projector) if kind == "projector"
                 else (jheads.V3Predictor, heads.V3Predictor))
    jhead = jcls(hidden_dim=32, out_dim=16)
    x = np.random.RandomState(5).randn(8, 24).astype(np.float32)
    v = jhead.init(jax.random.key(1), jnp.zeros((2, 24)), train=False)
    params = jax.tree.map(lambda a: a + 0.05 * jnp.ones_like(a), v["params"])
    out, mut = jhead.apply({"params": params, "batch_stats": v["batch_stats"]}, x, train=True,
                           mutable=["batch_stats"])
    head = cls(24, hidden_dim=32, out_dim=16)
    head.load_state_dict(params_from_jax(_np(params), _np(v["batch_stats"])))
    got = head(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    want = params_from_jax({}, _np(mut["batch_stats"]))
    for name, ref in want.items():
        np.testing.assert_allclose(head.state_dict()[name].numpy(), ref.numpy(), **TOL,
                                   err_msg=name)
    # eval mode: the running statistics
    out_eval = jhead.apply({"params": params, "batch_stats": mut["batch_stats"]}, x,
                           train=False)
    head.eval()
    np.testing.assert_allclose(head(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(out_eval), **TOL)


def test_heads_bn_differs_from_torch_batchnorm1d():
    """The unbiased running variance of `torch.nn.BatchNorm1d` is not what
    the heads keep."""
    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    ours, theirs = heads.BatchNorm1d(3), torch.nn.BatchNorm1d(3, momentum=0.1)
    ours(x), theirs(x)
    torch.testing.assert_close(ours.running_mean, theirs.running_mean)
    torch.testing.assert_close(ours.running_var, 0.9 + 0.1 * x.var(0, unbiased=False))
    assert not torch.allclose(ours.running_var, theirs.running_var)


def _v3_pair():
    jmodel = JaxV3Model(jvit.build_vit("vit_tiny"), embed_dim=16, hidden_dim=32)
    v = jmodel.init(jax.random.key(2), jnp.zeros((2, IMG, IMG, 3)), train=False, predict=True)
    model = V3Model(vit.build_vit("vit_tiny", image_size=IMG), embed_dim=16, hidden_dim=32)
    return jmodel, v, model


def test_v3_model_forward_matches_flax():
    jmodel, v, model = _v3_pair()
    model.load_state_dict(params_from_jax(_np(v["params"]), _np(v["batch_stats"])))
    x = _images(6, b=8)
    for predict in (False, True):
        ref, _ = jmodel.apply(v, x, train=True, predict=predict, mutable=["batch_stats"])
        got = model(torch.from_numpy(x), predict=predict)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **VIT_TOL)


def test_params_round_trip_through_jax_trees():
    """params_from_jax . params_to_jax is the identity on a V3Model's
    state_dict, and params_to_jax gives the flax trees' paths and shapes."""
    _jmodel, v, model = _v3_pair()
    sd = model.state_dict()
    params, stats = params_to_jax(sd)
    assert jax.tree.map(np.shape, params) == jax.tree.map(np.shape, _np(v["params"]))
    assert jax.tree.map(np.shape, stats) == jax.tree.map(np.shape, _np(v["batch_stats"]))
    back = params_from_jax(params, stats)
    assert back.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
    # and the other way: the flax trees survive a trip through the port
    sd2 = params_from_jax(_np(v["params"]), _np(v["batch_stats"]))
    p2, s2 = params_to_jax(sd2)
    jax.tree.map(np.testing.assert_array_equal, p2, _np(v["params"]))
    jax.tree.map(np.testing.assert_array_equal, s2, _np(v["batch_stats"]))


def test_vit_to_timm_equals_jax_byte_for_byte():
    _jmodel, params = _jax_vit()
    ref = jax_vit_to_timm(_np(params), grid=(2, 2))
    got = vit_to_timm(params_from_jax(_np(params)), grid=(2, 2))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype == np.float32, k
        assert got[k].shape == ref[k].shape and got[k].tobytes() == ref[k].tobytes(), k


def test_timm_to_vit_inverts_and_equals_jax_reader():
    _jmodel, params = _jax_vit()
    sd = params_from_jax(_np(params))
    flat = vit_to_timm(sd, grid=(2, 2))
    back = timm_to_vit(flat, num_heads=2)
    assert back.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
    ref = params_from_jax(jax_timm_to_vit(flat, num_heads=2))
    for k in ref:
        assert back[k].numpy().tobytes() == ref[k].numpy().tobytes(), k


def test_timm_reader_refuses_a_learned_pos_embed():
    _jmodel, params = _jax_vit()
    flat = vit_to_timm(params_from_jax(_np(params)), grid=(2, 2))
    flat["pos_embed"] = flat["pos_embed"] + 0.5
    with pytest.raises(ValueError, match="pos_embed"):
        timm_to_vit(flat, num_heads=2)
    del flat["pos_embed"]
    timm_to_vit(flat, num_heads=2)  # no pos_embed: nothing to check


def test_vit_arch_tables_match_jax():
    assert vit.VIT_FEATURE_DIMS == jvit.VIT_FEATURE_DIMS
    assert set(vit.VIT_ARCHS) == set(jvit.VIT_ARCHS)
    for arch in ("vit_tiny", "vit_small", "vit_base"):
        m, jm = vit.build_vit(arch), jvit.build_vit(arch)
        assert (m.width, m.depth, m.num_heads, m.patch_size) == \
            (jm.width, jm.depth, jm.num_heads, jm.patch_size)
    for arch, geometry in (("vit_large", (1024, 24, 16, 16)), ("vit_huge", (1280, 32, 16, 14))):
        jm = jvit.build_vit(arch)
        assert (jm.width, jm.depth, jm.num_heads, jm.patch_size) == geometry
        fn = vit.VIT_ARCHS[arch]
        assert (fn.keywords["width"], fn.keywords["depth"], fn.keywords["num_heads"],
                fn.keywords.get("patch_size", 16)) == geometry
    with pytest.raises(ValueError, match="unknown vit arch"):
        vit.build_vit("vit_giant")


def test_vit_small_forward_matches_flax_at_full_width():
    """ViT-S/16 at 224 px (12 blocks, width 384, 12 heads of 32), f32,
    two images: the class-token features against flax's."""
    jmodel = jvit.build_vit("vit_small")
    x = _images(8, b=2, img=224)
    v = jmodel.init(jax.random.key(5), jnp.zeros((1, 224, 224, 3)), train=False)
    ref = np.asarray(jmodel.apply(v, x, train=True))
    model = vit.build_vit("vit_small")
    model.load_state_dict(params_from_jax(_np(v["params"])))
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 384)
    np.testing.assert_allclose(got, ref, **VIT_TOL)
