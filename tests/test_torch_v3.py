"""The port's MoCo-v3 path against the JAX package's, on the CPU: the ramp,
the fractional-epoch schedule, the loss, LARS and AdamW against optax, the
asymmetric view pair with solarize, three v3 steps of a tiny ViT (AdamW)
and a tiny ResNet (LARS) against `moco_tpu/v3_step.build_v3_train_step` on
one device, the exports against the JAX package's, a resumed v3 pretrain
against an uninterrupted one, and the config and presets.

Tolerances are stated where they are used. The three-step comparisons
follow `tests/test_torch_train_step.py`: losses within rtol 2e-4 (the v2
golden's), and each final tensor within 4x what a 1e-6 nudge of the
initial weights moves it in the port, plus 2e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moco_tpu.config import PRESETS as JAX_PRESETS
from moco_tpu.config import PretrainConfig as JaxConfig
from moco_tpu.data import augment as jaug
from moco_tpu.models import resnet as jresnet
from moco_tpu.models import vit as jvit
from moco_tpu.ops import matmul_resize as jresize
from moco_tpu.ops.ema import momentum_schedule as jax_momentum_schedule
from moco_tpu.ops.losses import v3_contrastive_loss as jax_v3_loss
from moco_tpu.parallel.mesh import create_mesh
from moco_tpu.train_step import build_optimizer as jax_build_optimizer
from moco_tpu.train_step import build_train_step as jax_build_train_step
from moco_tpu.train_step import lr_schedule as jax_lr_schedule
from moco_tpu.v3_step import V3Model as JaxV3Model
from moco_tpu.v3_step import create_v3_train_state
from moco_tpu_torch import checkpoint as ckpt
from moco_tpu_torch.config import PRESETS, EvalConfig, PretrainConfig
from moco_tpu_torch.data import augment as aug
from moco_tpu_torch.models import resnet, vit
from moco_tpu_torch.ops.blur import blur_taps
from moco_tpu_torch.ops.ema import ema_update, momentum_schedule
from moco_tpu_torch.ops.optim import LARS, AdamW
from moco_tpu_torch.ops.losses import v3_contrastive_loss
from moco_tpu_torch.train_state import build_optimizer, create_train_state
from moco_tpu_torch.train_step import build_encoder, build_train_step, lr_schedule
from moco_tpu_torch.v3_step import V3Model
from moco_tpu_torch.weights import params_from_jax

B, IMG, DIM, HIDDEN, SPE = 16, 32, 16, 32, 4


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


# ---------------------------------------------------------------------------
# the ramp, the schedule, the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("base_m", [0.99, 0.996])
def test_momentum_schedule_equals_jax_bit_for_bit(base_m):
    for step in (0, 1, 3, 17, 250, 499, 500, 700):
        want = float(jax_momentum_schedule(base_m, step, 500))
        assert momentum_schedule(base_m, step, 500) == want, step


@pytest.mark.parametrize("variant, fields", [
    ("v3", dict(lr=0.0, base_lr=1.5e-4, batch_size=4096, epochs=10, warmup_epochs=3,
                cos=True)),
    ("v3", dict(lr=0.3, epochs=10, cos=True)),
    ("v2", dict(lr=0.03, epochs=10, warmup_epochs=3, cos=True)),
])
def test_lr_schedule_matches_jax(variant, fields):
    """v3 at the fractional epoch (its warmup moves within an epoch), v1/v2
    at the floored one; the port in f64, JAX in f32: rtol 1e-6, and 1e-6 of
    the base lr absolute (the f32 `1 + cos` cancels near the schedule's
    end)."""
    spe = 7
    config = PretrainConfig(variant=variant, **fields)
    want = jax_lr_schedule(JaxConfig(variant=variant, **fields), spe)
    got = lr_schedule(config, spe)
    steps = [0, 1, 3, 6, 7, 13, 21, 22, 40, 69]
    np.testing.assert_allclose([got(s) for s in steps], [float(want(s)) for s in steps],
                               rtol=1e-6, atol=1e-6 * config.effective_lr)
    if variant == "v3" and fields.get("warmup_epochs"):
        assert 0 < got(1) < got(3) < got(6)       # rising within the first epoch
    if variant == "v2":
        assert got(1) == got(6) == 0.0            # the whole first epoch at warmup 0


@pytest.mark.parametrize("temperature", [0.2, 1.0])
def test_v3_contrastive_loss_and_gradient_match_jax(temperature):
    rng = np.random.RandomState(0)
    q = rng.randn(8, 16).astype(np.float32)
    k = rng.randn(8, 16).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    k /= np.linalg.norm(k, axis=1, keepdims=True)
    want, jgrad = jax.value_and_grad(lambda x: jax_v3_loss(x, k, temperature, None))(q)
    tq = torch.from_numpy(q).requires_grad_()
    got = v3_contrastive_loss(tq, torch.from_numpy(k), temperature)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-7)
    # the label offset: this process's rows sit at rank * b of the global keys
    k_all = np.concatenate([rng.randn(8, 16).astype(np.float32), k])
    shifted = v3_contrastive_loss(torch.from_numpy(q), torch.from_numpy(k_all), temperature,
                                  offset=8)
    logits = q @ k_all.T / temperature
    ref = -np.mean(logits[np.arange(8), np.arange(8) + 8]
                   - np.log(np.exp(logits).sum(1))) * 2 * temperature
    np.testing.assert_allclose(float(shifted), ref, rtol=1e-5)


# ---------------------------------------------------------------------------
# optimizers against optax
# ---------------------------------------------------------------------------

SHAPES = {"conv": (4, 3, 3, 3), "dense": (5, 6), "bias": (6,), "scale": (4,),
          "zero": (3, 2)}
LRS = [0.5, 0.3, 0.0, 0.7, 0.1]


def _opt_inputs(seed=0):
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    params["zero"][:] = 0.0  # |p| = 0: the trust ratio is 1
    grads = [{k: rng.randn(*s).astype(np.float32) * 0.1 for k, s in SHAPES.items()}
             for _ in LRS]
    grads[1]["dense"][:] = 0.0  # |u| = 0 with wd 0 below: the ratio is 1
    return params, grads


def _run_optax(tx, params, grads):
    state = tx.init(params)
    out = []
    for g in grads:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        out.append(_np(params))
    return out


def _run_torch(make, params, grads):
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make(list(tp.values()))
    out = []
    for lr, g in zip(LRS, grads):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        out.append({k: p.detach().numpy().copy() for k, p in tp.items()})
    return out


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4, 0.05])
def test_lars_matches_optax_lars(weight_decay):
    """Five steps with a changing lr (one of them 0): optax.lars with both
    masks `ndim > 1`; rtol 1e-6 (norms and products in another order)."""
    params, grads = _opt_inputs()

    def dim_mask(p):
        return jax.tree.map(lambda x: x.ndim > 1, p)

    tx = optax.lars(lambda count: jnp.asarray(LRS)[count], weight_decay=weight_decay,
                    weight_decay_mask=dim_mask, trust_ratio_mask=dim_mask, momentum=0.9)
    want = _run_optax(tx, params, grads)
    got = _run_torch(lambda ps: LARS(ps, lr=LRS[0], weight_decay=weight_decay, momentum=0.9),
                     params, grads)
    for i, (w, g) in enumerate(zip(want, got)):
        for k in SHAPES:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {i} {k}")
    assert not np.allclose(got[-1]["conv"], params["conv"])


def test_lars_momentum_carries_the_lr_scaled_update():
    """A 1-D parameter: buf = -lr * g + m * buf, so an lr of 0 still moves
    it by the momentum of earlier lr-scaled steps."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = LARS([p], lr=1.0, momentum=0.5)
    for lr in (1.0, 0.0):
        p.grad = torch.full((3,), 2.0)
        opt.param_groups[0]["lr"] = lr
        opt.step()
    # step 1: buf = -2, p = -1; step 2: buf = 0 + 0.5 * -2 = -1, p = -2
    torch.testing.assert_close(p.detach(), torch.full((3,), -2.0))


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_optax_adamw(weight_decay):
    params, grads = _opt_inputs(1)
    tx = optax.adamw(lambda count: jnp.asarray(LRS)[count], weight_decay=weight_decay)
    want = _run_optax(tx, params, grads)
    got = _run_torch(lambda ps: AdamW(ps, lr=LRS[0], betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=weight_decay), params, grads)
    for i, (w, g) in enumerate(zip(want, got)):
        for k in SHAPES:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {i} {k}")


@pytest.mark.parametrize("optimizer, cls", [("adamw", AdamW), ("lars", LARS),
                                            ("sgd", torch.optim.SGD)])
def test_build_optimizer_leaves_the_frozen_patch_embedding_out(optimizer, cls):
    config = PretrainConfig(variant="v3", arch="vit_tiny", optimizer=optimizer,
                            image_size=IMG, embed_dim=DIM, weight_decay=0.1)
    model = build_encoder(config)
    opt = build_optimizer(config, model)
    assert isinstance(opt, cls)
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    frozen = [n for n, p in model.named_parameters() if id(p) not in held]
    assert frozen == ["backbone.patch_embed.weight", "backbone.patch_embed.bias"]
    assert len(held) == sum(1 for p in model.parameters() if p.requires_grad)


# ---------------------------------------------------------------------------
# the asymmetric view pair
# ---------------------------------------------------------------------------


def test_v3_aug_configs_match_jax():
    for min_scale in (0.08, 0.2):
        for got, want in zip(aug.v3_aug_configs(96, min_scale),
                             jaug.v3_aug_configs(96, min_scale)):
            want = want._asdict()
            assert {k: want[k] for k in got._fields} == got._asdict()
    cfgs = aug.aug_config_for(PRESETS["imagenet-moco-v3-r50"])
    assert isinstance(cfgs, tuple) and len(cfgs) == 2
    assert [c.min_scale for c in cfgs] == [0.2, 0.2]
    assert [(c.blur_prob, c.solarize_prob) for c in cfgs] == [(1.0, 0.0), (0.1, 0.2)]
    assert {c.dtype for c in cfgs} == {"bfloat16"}
    assert [c.min_scale for c in aug.aug_config_for(PRESETS["imagenet-moco-v3-vits"])] == \
        [0.08, 0.08]


def test_solarize_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.rand(6, 5, 5, 3).astype(np.float32)
    img[0, 0, 0] = [0.5, 0.4999999, 1.0]
    apply = np.array([1, 0, 1, 1, 0, 1], bool)
    cfg = jaug.AugConfig(solarize_prob=1.0)  # the JAX draw always applies
    sol = jax.vmap(lambda im: jaug._random_solarize(im, jax.random.key(0), cfg))(img)
    want = np.where(apply[:, None, None, None], np.asarray(sol), img)
    got = aug.solarize(torch.from_numpy(img), torch.from_numpy(apply)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0, 0] == 0.5 and got[0, 0, 0, 1] == np.float32(0.4999999)


def _jax_inpipeline_blur(img, taps, out):
    """The JAX package's in-pipeline blur (`_gaussian_blur`) of each sample
    with the given taps in place of its own draw."""
    from moco_tpu.ops import pallas_blur

    cfg = jaug.AugConfig(out_size=out, blur_prob=1.0)

    def one(im, t):
        real = pallas_blur.blur_weights
        pallas_blur.blur_weights = lambda *a, **k: t
        try:
            return jaug._gaussian_blur(im, jax.random.key(0), cfg)
        finally:
            pallas_blur.blur_weights = real

    return jax.vmap(one)(img, taps)


@pytest.mark.parametrize("view", [0, 1])
def test_v3_views_compose_the_jax_pieces(view):
    """Each view of the pair from fixed draws equals the JAX package's
    pieces: crop with flip, jitter, grayscale; view 1 then normalize and the
    lifted (Pallas) blur; view 2 the in-pipeline blur on the [0, 1] image,
    solarize where drawn, normalize. f32; the blurs sum in other orders."""
    from moco_tpu.ops.pallas_blur import gaussian_blur_batch as jblur

    rng = np.random.RandomState(7 + view)
    b, size, out = 8, 24, 16
    u8 = rng.randint(0, 256, (b, size, size, 3), dtype=np.uint8)
    cfg = aug.v3_aug_configs(out)[view]
    ch = rng.uniform(4, size, b).astype(np.float32)
    cw = rng.uniform(4, size, b).astype(np.float32)
    y0 = (rng.uniform(0, 1, b) * (size - ch)).astype(np.float32)
    x0 = (rng.uniform(0, 1, b) * (size - cw)).astype(np.float32)
    factors = rng.uniform(0.6, 1.4, (b, 3)).astype(np.float32)
    hue = rng.uniform(-0.1, 0.1, b).astype(np.float32)
    perm = np.stack([rng.permutation(4) for _ in range(b)]).astype(np.int64)
    flip = rng.rand(b) < 0.5
    jit_on = rng.rand(b) < 0.8
    gray_on = np.array([0, 1, 0, 0, 1, 0, 0, 0], bool)
    sol_on = np.array([1, 1, 0, 1, 0, 0, 1, 0], bool) if view else None
    radius = aug.blur_radius(out)
    apply_blur = np.ones(b, bool) if view == 0 else np.array([1, 0, 1, 0, 0, 1, 0, 0], bool)
    taps = blur_taps(torch.from_numpy(rng.uniform(0.1, 2.0, b).astype(np.float32)),
                         torch.from_numpy(apply_blur), radius)
    t = torch.from_numpy
    p = aug.ViewParams(t(y0), t(x0), t(ch), t(cw), t(flip), t(factors), t(hue), t(perm),
                       t(jit_on), t(gray_on), taps,
                       solarize=None if sol_on is None else t(sol_on))
    got = aug.apply_view(t(u8), p, cfg).numpy()

    img = jnp.asarray(u8, jnp.float32) / 255.0
    img = jax.vmap(lambda im, a, c, d, e, f: jresize.crop_resize(
        im, a, c, d, e, out, True, flip_h=f))(img, y0, x0, ch, cw, flip)
    jit = jax.vmap(lambda im, f, hs, pp: jaug._apply_jitter_ops_fast(
        im, (f[0], f[1], f[2]), hs, pp, True))(img, factors, hue, perm.astype(np.int32))
    img = jnp.where(jit_on[:, None, None, None], jit, img)
    gray = jnp.broadcast_to(jaug._grayscale(img)[..., None], img.shape)
    img = jnp.where(gray_on[:, None, None, None], gray, img)
    if view == 0:
        img = (img - jaug.IMAGENET_MEAN) * jaug.IMAGENET_INV_STD
        ref = np.asarray(jblur(img, jnp.asarray(taps.numpy()), radius, interpret=True))
    else:
        img = _jax_inpipeline_blur(img, jnp.asarray(taps.numpy()), out)
        sol = jax.vmap(lambda im: jaug._random_solarize(
            im, jax.random.key(0), jaug.AugConfig(solarize_prob=1.0)))(img)
        img = jnp.where(sol_on[:, None, None, None], sol, img)
        ref = np.asarray((img - jaug.IMAGENET_MEAN) * jaug.IMAGENET_INV_STD)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)


def test_solarize_draws_only_in_a_solarizing_recipe():
    gen = torch.Generator().manual_seed(0)
    ext = torch.full((4000,), 32.0)
    assert aug.sample_view(ext, ext, aug.v2_aug_config(16), gen).solarize is None
    view2 = aug.sample_view(ext, ext, aug.v3_aug_configs(16)[1], gen)
    assert abs(view2.solarize.float().mean().item() - 0.2) < 0.03
    blurred = (view2.blur_taps[:, aug.blur_radius(16)] < 1.0).float().mean().item()
    assert abs(blurred - 0.1) < 0.03
    view1 = aug.sample_view(ext, ext, aug.v3_aug_configs(16)[0], gen)
    # p = 1: every sample blurs (a sigma under 0.18 rounds to the identity in f32)
    assert view1.solarize is None
    assert (view1.blur_taps[:, aug.blur_radius(16)] < 1.0).float().mean().item() > 0.94


def test_two_crops_pair_rows_equal_the_global_batch():
    """Each process's rows of the v3 pair equal the same rows of the whole
    batch's views, bit for bit (the draws are the global batch's)."""
    u8 = torch.randint(0, 256, (8, 24, 24, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(1))
    pair = aug.v3_aug_configs(16)
    whole = aug.two_crops(u8, pair, torch.Generator().manual_seed(2))
    for lo in (0, 4):
        part = aug.two_crops(u8[lo:lo + 4], pair, torch.Generator().manual_seed(2),
                             rows=(lo, 8))
        for a, w in zip(part, whole):
            torch.testing.assert_close(a, w[lo:lo + 4], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# three v3 steps against the JAX package's
# ---------------------------------------------------------------------------

LEGS = {
    # vit_tiny, AdamW, T=0.2, warmup over the first epoch, the ramp
    "vit_adamw": dict(arch="vit_tiny", optimizer="adamw", lr=1e-3, weight_decay=0.1,
                      temperature=0.2),
    # a 2-stage Bottleneck ResNet, LARS, T=1
    "resnet_lars": dict(arch="resnet50", optimizer="lars", lr=0.5, weight_decay=1e-4,
                        temperature=1.0),
}
COMMON = dict(variant="v3", embed_dim=DIM, momentum_ema=0.99, momentum_ramp=True,
              batch_size=B, epochs=2, warmup_epochs=1, cos=True, image_size=IMG, seed=0)


def _leg_models(leg):
    if LEGS[leg]["arch"].startswith("vit"):
        jb, tb = jvit.build_vit("vit_tiny"), vit.build_vit("vit_tiny", image_size=IMG)
    else:
        jb = jresnet.ResNet(stage_sizes=(1, 1), block_cls=jresnet.Bottleneck, width=8,
                            num_classes=None)
        tb = resnet.ResNet((1, 1), resnet.Bottleneck, width=8, num_classes=None)
    return (JaxV3Model(jb, embed_dim=DIM, hidden_dim=HIDDEN),
            V3Model(tb, embed_dim=DIM, hidden_dim=HIDDEN))


def _port_state(leg, sd):
    tcfg = PretrainConfig(**COMMON, **LEGS[leg])
    state = create_train_state(tcfg, _leg_models(leg)[1], "cpu", seed=0)
    state.model_q.load_state_dict(sd)
    state.model_k.load_state_dict({k: v for k, v in sd.items()
                                   if not k.startswith("predictor.")})
    return tcfg, state


def _port_run(leg, sd, images):
    tcfg, state = _port_state(leg, sd)
    step = build_train_step(tcfg, SPE)
    metrics = [{k: float(v) for k, v in step(state, torch.from_numpy(a.copy()),
                                                torch.from_numpy(b.copy())).items()}
               for a, b in images]
    return state, metrics


@pytest.fixture(scope="module", params=sorted(LEGS))
def v3_runs(request):
    leg = request.param
    jcfg = JaxConfig(**COMMON, **LEGS[leg])
    jmodel, _ = _leg_models(leg)
    images = [(np.asarray(jax.random.normal(jax.random.key(100 + i), (B, IMG, IMG, 3))),
               np.asarray(jax.random.normal(jax.random.key(200 + i), (B, IMG, IMG, 3))))
              for i in range(3)]
    tx, sched = jax_build_optimizer(jcfg, SPE)
    jstate = create_v3_train_state(jax.random.key(0), jmodel, tx, (B, IMG, IMG, 3))
    sd = params_from_jax(_np(jstate.params_q), _np(jstate.batch_stats_q))
    jstep = jax_build_train_step(jcfg, jmodel, tx, create_mesh(1), SPE, sched)
    jmetrics = []
    for a, b in images:
        jstate, m = jstep(jstate, a, b)
        jmetrics.append({k: float(v) for k, v in m.items()})
    jfinal = {"q": params_from_jax(_np(jstate.params_q), _np(jstate.batch_stats_q)),
              "k": params_from_jax(_np(jstate.params_k), _np(jstate.batch_stats_k))}
    state, tmetrics = _port_run(leg, sd, images)
    noise = torch.Generator().manual_seed(1)
    nudged = {k: v * (1 + 1e-6 * torch.randn(v.shape, generator=noise)) for k, v in sd.items()}
    nudged_state, _ = _port_run(leg, nudged, images)
    return leg, jmetrics, jfinal, tmetrics, state, nudged_state


def test_v3_losses_and_metrics_match_jax(v3_runs):
    _leg, jm, _jf, tm, _state, _nudged = v3_runs
    np.testing.assert_allclose([m["loss"] for m in tm], [m["loss"] for m in jm], rtol=2e-4)
    for a, b in zip(tm, jm):
        assert a["acc1"] == b["acc1"]
        for key in ("pos_sim", "neg_sim", "logit_margin"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-4, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)
        assert a["momentum"] == b["momentum"]
    assert tm[1]["lr"] > tm[0]["lr"] == 0.0  # the fractional warmup


def test_v3_updated_state_matches_jax(v3_runs):
    """Both models' parameters and BN statistics after three steps, within
    4x what the 1e-6 nudge moved each tensor, plus 2e-5. The key model has
    no predictor, as the JAX key tree."""
    _leg, _jm, jf, _tm, state, nudged = v3_runs
    for which, model, model2 in (("q", state.model_q, nudged.model_q),
                                 ("k", state.model_k, nudged.model_k)):
        sd, sd2 = model.state_dict(), model2.state_dict()
        assert sd.keys() == jf[which].keys()
        for key, ref in jf[which].items():
            got = sd[key].numpy()
            floor = np.abs(got - sd2[key].numpy()).max()
            diff = np.abs(got - ref.numpy()).max()
            assert diff <= 4 * floor + 2e-5, (which, key, diff, floor)
    assert not any(k.startswith("predictor.") for k in state.model_k.state_dict())


def test_v3_frozen_patch_embedding_never_moves():
    tcfg, state = _port_state("vit_adamw", V3Model(
        vit.build_vit("vit_tiny", image_size=IMG), embed_dim=DIM, hidden_dim=HIDDEN
    ).state_dict())
    before = {k: v.clone() for k, v in state.model_q.state_dict().items()}
    step = build_train_step(tcfg, SPE)
    x = torch.randn(2, B, IMG, IMG, 3, generator=torch.Generator().manual_seed(0))
    for _ in range(2):
        step(state, x[0], x[1])
    after = state.model_q.state_dict()
    for k in ("backbone.patch_embed.weight", "backbone.patch_embed.bias"):
        torch.testing.assert_close(after[k], before[k], rtol=0, atol=0)
    assert not torch.equal(after["backbone.cls_token"], before["backbone.cls_token"])


def test_ema_update_covers_the_key_model_by_name():
    model = V3Model(vit.build_vit("vit_tiny", image_size=IMG), embed_dim=DIM,
                    hidden_dim=HIDDEN)
    key = copy.deepcopy(model)
    key.predictor = None
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    ema_update(key, model, 0.75)
    q = dict(model.named_parameters())
    for name, p in key.named_parameters():
        torch.testing.assert_close(p, 0.75 * (q[name] - 1.0) + 0.25 * q[name])
    with pytest.raises(ValueError, match="no parameters"):
        ema_update(model, key, 0.5)


# ---------------------------------------------------------------------------
# exports, checkpoints, the entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_export_v3_backbone_equals_jax(leg, tmp_path):
    """The v3 backbone export of the same weights: a ViT in the timm dialect,
    a ResNet as the `backbone/` tree; equal key for key and byte for byte,
    and `load_for_inference` reads it back."""
    from moco_tpu.checkpoint import export_v3_backbone as jax_export

    jcfg = JaxConfig(**COMMON, **LEGS[leg])
    jmodel, _ = _leg_models(leg)
    tx, _ = jax_build_optimizer(jcfg, SPE)
    jstate = create_v3_train_state(jax.random.key(3), jmodel, tx, (2, IMG, IMG, 3))
    want = jax_export(jstate, str(tmp_path / "jax.npz"), image_size=IMG)
    sd = params_from_jax(_np(jstate.params_q), _np(jstate.batch_stats_q))
    _tcfg, state = _port_state(leg, sd)
    path = str(tmp_path / "port.npz")
    got = ckpt.export_v3_backbone(state, path, image_size=IMG)
    assert got.keys() == want.keys()
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k
    if leg == "vit_adamw":
        model = ckpt.load_for_inference(path, "vit_tiny", device="cpu", image_size=IMG)
        for k, v in model.state_dict().items():
            torch.testing.assert_close(v, state.model_q.backbone.state_dict()[k], rtol=0,
                                       atol=0)


def test_export_vit_encoder_drops_the_head(tmp_path):
    """A v1/v2 ViT encoder: the timm dialect without `head.*`, as the JAX
    package writes it."""
    from moco_tpu.checkpoint import export_vit_encoder as jax_export
    from moco_tpu.train_state import TrainState

    jmodel = jvit.build_vit("vit_tiny", num_classes=DIM)
    params = jmodel.init(jax.random.key(4), jnp.zeros((1, IMG, IMG, 3)), train=False)["params"]
    jstate = TrainState(step=0, params_q=params, params_k=params, batch_stats_q={},
                        batch_stats_k={}, opt_state=None, queue=None, queue_ptr=None, rng=None)
    want = jax_export(jstate, str(tmp_path / "jax.npz"), image_size=IMG)
    config = PretrainConfig(arch="vit_tiny", embed_dim=DIM, image_size=IMG, num_negatives=32)
    state = create_train_state(config, build_encoder(config), "cpu")
    state.model_q.load_state_dict(params_from_jax(_np(params)))
    got = ckpt.export_vit_encoder(state, str(tmp_path / "port.npz"), image_size=IMG)
    assert got.keys() == want.keys() and not any(k.startswith("head") for k in got)
    for k in want:
        assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k


def _tiny_v3_config(**kw):
    return PRESETS["imagenet-moco-v3-vits"].replace(
        dataset="synthetic", arch="vit_tiny", image_size=IMG, batch_size=8, embed_dim=DIM,
        steps_per_epoch=2, epochs=3, print_freq=1, **kw)


def _same_state(a, b):
    for name in ("model_q", "model_k"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0, msg=f"{name}.{k}")
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["state"].keys() == ob["state"].keys() and oa["state"]
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            torch.testing.assert_close(torch.as_tensor(v), torch.as_tensor(ob["state"][i][k]),
                                       rtol=0, atol=0)
    assert a.step == b.step and a.queue is None and b.queue is None
    assert torch.equal(a.data_generator.get_state(), b.data_generator.get_state())


@pytest.mark.parametrize("optimizer", ["adamw", "lars"])
def test_v3_resume_equals_the_uninterrupted_run(optimizer, tmp_path):
    """A tiny v3 pretrain checkpointed at its first epoch's end and resumed
    to step 3 equals the uninterrupted 3-step run bit for bit: both models,
    the optimizer's state (AdamW's moments and counts, LARS's buffers), the
    step and the augmentation generator. The uninterrupted run writes that
    checkpoint (step 2, asynchronously) and goes on: its first two steps
    are the checkpointed run's; the resume names step 2."""
    from moco_tpu_torch import train

    quiet = dict(device="cpu", on_step=lambda *a: None)
    config = _tiny_v3_config(optimizer=optimizer)
    ck = str(tmp_path / "ck")
    whole, _ = train.train(config.replace(ckpt_dir=ck), max_steps=3, **quiet)
    assert 2 in ckpt.checkpoint_manager(ck).all_steps()
    resumed, _ = train.train(config.replace(ckpt_dir=ck, resume="2"), max_steps=3, **quiet)
    _same_state(resumed, whole)


def test_v3_main_exports_and_the_v3_probe_reads_it(tmp_path, capsys):
    """`train.main` for a v3 preset on the CPU: the step's metrics, the
    backbone kNN monitor, the timm export; then `evals.lincls.main` with
    `imagenet-lincls-v3` on it."""
    from moco_tpu_torch import train
    from moco_tpu_torch.evals import lincls

    enc = str(tmp_path / "enc.npz")
    train.main(["--preset", "imagenet-moco-v3-vits", "--dataset", "synthetic", "--arch",
                "vit_tiny", "--image-size", str(IMG), "--batch-size", "8", "--max-steps", "2",
                "--steps-per-epoch", "2", "--print-freq", "1", "--knn-monitor", "true",
                "--knn-bank-size", "64", "--num-classes", "10", "--export-path", enc,
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 2 loss" in out and "momentum" in out and "queue_ptr" not in out
    assert "kNN(train) top-1" in out and "exported encoder" in out
    assert ckpt.detect_dialect(ckpt.import_encoder_q(enc)) == "timm_vit"
    best = lincls.main(["--preset", "imagenet-lincls-v3", "--pretrained", enc, "--arch",
                        "vit_tiny", "--dataset", "synthetic", "--image-size", str(IMG),
                        "--batch-size", "32", "--epochs", "1", "--max-steps", "2",
                        "--num-classes", "10", "--device", "cpu"])
    assert np.isfinite(best)


def test_knn_monitor_scores_backbone_features():
    from moco_tpu_torch.train import make_feature_fn

    config = _tiny_v3_config()
    model = build_encoder(config)
    x = torch.randn(4, IMG, IMG, 3, generator=torch.Generator().manual_seed(0))
    feats = make_feature_fn(model, "v3")(x)
    assert feats.shape == (4, 64)
    model.eval()
    torch.testing.assert_close(feats, torch.nn.functional.normalize(model.backbone(x), dim=1))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["imagenet-moco-v3-vits", "imagenet-moco-v3-vitb",
                                  "imagenet-moco-v3-r50", "imagenet-lincls-v3"])
def test_v3_presets_equal_the_jax_presets(name):
    """Every field both configs have, except `ckpt_dir` (the port's default
    writes nothing)."""
    got, want = PRESETS[name], JAX_PRESETS[name]
    fields = [f for f in got.__dataclass_fields__ if f != "ckpt_dir"]
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}
    assert isinstance(got, EvalConfig) == (name == "imagenet-lincls-v3")


def test_v3_config_checks():
    with pytest.raises(ValueError, match="unknown optimizer"):
        PretrainConfig(optimizer="adam")
    with pytest.raises(ValueError, match="crop_min"):
        PretrainConfig(crop_min=1.5)
    # ZeRO-1 splits every optimizer's state (tests/test_torch_zero_optimizers.py)
    for optimizer in ("sgd", "adamw", "lars"):
        assert PretrainConfig(variant="v3", optimizer=optimizer, zero_sharding=True).zero_sharding
    # telemetry and health take the JAX defaults; the collapse rollback is
    # accepted (the v3 step rolls back through the same driver)
    assert (PretrainConfig().telemetry_dir, PretrainConfig().health_stride) == ("", 0)
    PretrainConfig(telemetry_dir="/tmp/tel", health_stride=10, collapse_emb_std=1e-3)
    assert PretrainConfig(variant="v3", collapse_margin=0.01,
                          collapse_rollback=True).collapse_rollback
    with pytest.raises(ValueError, match="remat is ported for the ViT only"):
        build_encoder(PretrainConfig(variant="v3", arch="resnet50", remat=True))
    assert PRESETS["imagenet-moco-v3-vits"].effective_lr == 1.5e-4 * 4096 / 256
    assert PRESETS["imagenet-lincls-v3"].effective_lr == 3.0 * 1024 / 256


def test_gradsync_counts_the_trainable_parameters_only():
    """The JAX step syncs the frozen patch embedding's zero gradients: for
    ViT-S/16, 295,296 f32 (1,181,184 bytes) a step that the port does not
    send; every other byte is the JAX package's count."""
    from moco_tpu.parallel.gradsync import GradSync as JaxGradSync
    from moco_tpu.train_step import build_encoder as jax_build_encoder
    from moco_tpu_torch.parallel.gradsync import GradSync

    jcfg = JaxConfig(variant="v3", arch="vit_small", embed_dim=256)
    jmodel = jax_build_encoder(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 224, 224, 3)),
                                                train=False, predict=True))
    want = JaxGradSync(jcfg, 8).describe(shapes["params"])["sync_bytes_per_step"]
    config = PRESETS["imagenet-moco-v3-vits"].replace(compute_dtype="float32")
    model = build_encoder(config)
    got = GradSync(config, None).describe(model.named_parameters())["sync_bytes_per_step"]
    assert want - got == 4 * model.backbone.patch_embed.weight.numel() + 4 * 384 == 1181184
