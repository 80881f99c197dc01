"""The port's v3 step across 8 gloo processes against the JAX package's v3
step on the 8-device mesh (`mesh8`), 8 samples a process (at 2, the heads'
BatchNorms normalize pairs of values to +-1 and the gradient through them
is float noise, which AdamW's normalized step turns into lr-sized moves).

The JAX step applies the SUM of its devices' gradients
(`tests/test_torch_distributed.py::test_jax_step_sums_gradients`); the
port takes the mean. AdamW is invariant to that scale up to its eps, so the
AdamW leg (a tiny ViT) runs both at the same
hyperparameters and compares three steps' losses and metrics. LARS is not:
its `ndim > 1` leaves would need `weight_decay / n` and its 1-D leaves move
n times as far. So the LARS leg (a tiny ResNet) compares what comes before the optimizer: the first step's loss, each
process's keys, and the synced gradient (JAX = 8 x port), both legs.

The JAX gradient is the sum over the 8 devices of each device's gradient,
composed from the JAX package's pieces (the model's train-mode apply,
`l2_normalize`, `v3_contrastive_loss` against the gathered keys rolled so
the device's own rows come first): what the mesh step differentiates
(its loss agrees with the step's), without `build_v3_grad_probe`, whose
shard_map program takes minutes to compile here.

Tolerances: losses within rtol 2e-4 (the golden's) and the metrics as in
`tests/test_torch_v3.py`; keys within 5e-5 (unit vectors from f32
forwards through BatchNorm over 8 samples; up to 2.7e-5 measured).
Gradients are calibrated: a 1e-6 nudge of the JAX weights moves the
ResNet's gradients by up to 2% of a tensor's largest entry, so each port tensor may differ from JAX by at most 4x
what the nudge moved it, plus 1e-5 of its largest entry.
"""

import os

import jax
import numpy as np
import pytest
import torch

from moco_tpu.config import PretrainConfig as JaxConfig
from moco_tpu.models import resnet as jresnet
from moco_tpu.models import vit as jvit
from moco_tpu.train_step import build_optimizer as jax_build_optimizer
from moco_tpu.train_step import build_train_step as jax_build_train_step
from moco_tpu.v3_step import V3Model as JaxV3Model
from moco_tpu.ops.losses import l2_normalize, v3_contrastive_loss
from moco_tpu.v3_step import create_v3_train_state
from moco_tpu_torch.weights import params_from_jax
from torch_dist_worker import spawn

WORLD, IMG, DIM, HIDDEN, SPE = 8, 32, 16, 32, 4
COMMON = dict(variant="v3", embed_dim=DIM, momentum_ema=0.99, momentum_ramp=True,
              epochs=2, warmup_epochs=1, cos=True, image_size=IMG, seed=0)
# (config fields, steps)
LEGS = {
    "vit_adamw": (dict(arch="vit_tiny", optimizer="adamw", lr=1e-3, weight_decay=0.1,
                       temperature=0.2, batch_size=64), 3),
    "resnet_lars": (dict(arch="resnet50", optimizer="lars", lr=0.5, weight_decay=1e-4,
                         temperature=1.0, batch_size=64), 1),
}


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _jax_model(leg):
    if leg == "vit_adamw":
        backbone = jvit.build_vit("vit_tiny")
    else:
        backbone = jresnet.ResNet(stage_sizes=(1, 1), block_cls=jresnet.Bottleneck, width=8,
                                  num_classes=None)
    return JaxV3Model(backbone, embed_dim=DIM, hidden_dim=HIDDEN)


def _jax_gradient(jmodel, init, x1, x2, temperature):
    """(each device's keys of x1 in device order, the mean of the devices'
    losses, the sum of their gradients) of the v3 loss on 8 devices."""
    params_q, params_k, stats_q, stats_k = init
    b = x1.shape[0] // WORLD

    @jax.jit
    def keys(x):
        out, _ = jmodel.apply({"params": params_k, "batch_stats": stats_k}, x, train=True,
                              predict=False, mutable=["batch_stats"])
        return l2_normalize(out)

    @jax.jit
    def device_grad(pq, xa, xb, k1, k2):
        def loss(p):
            def q(x):
                out, _ = jmodel.apply({"params": p, "batch_stats": stats_q}, x, train=True,
                                      predict=True, mutable=["batch_stats"])
                return l2_normalize(out)

            return (v3_contrastive_loss(q(xa), k2, temperature, None)
                    + v3_contrastive_loss(q(xb), k1, temperature, None))

        return jax.value_and_grad(loss)(pq)

    def run(pq):
        rows = [slice(d * b, (d + 1) * b) for d in range(WORLD)]
        k1 = np.concatenate([np.asarray(keys(x1[r])) for r in rows])
        k2 = np.concatenate([np.asarray(keys(x2[r])) for r in rows])
        losses, total = [], None
        for d, r in enumerate(rows):
            # the device's own rows first: its labels are then arange(b)
            loss, g = device_grad(pq, x1[r], x2[r], np.roll(k1, -d * b, 0),
                                  np.roll(k2, -d * b, 0))
            losses.append(float(loss))
            total = g if total is None else jax.tree.map(jax.numpy.add, total, g)
        return k1, float(np.mean(losses)), params_from_jax(_np(total))

    keys1, loss, grads = run(params_q)
    noise = np.random.RandomState(1)
    nudged = jax.tree.map(lambda a: a * (1 + 1e-6 * noise.randn(*a.shape).astype(np.float32)),
                          params_q)
    return keys1, loss, grads, run(nudged)[2]


@pytest.fixture(scope="module", params=sorted(LEGS))
def leg_runs(request, mesh8, tmp_path_factory):
    leg = request.param
    fields, steps = LEGS[leg]
    batch = fields["batch_size"]
    jcfg = JaxConfig(**COMMON, **fields)
    jmodel = _jax_model(leg)
    tx, sched = jax_build_optimizer(jcfg, SPE)
    jstate = create_v3_train_state(jax.random.key(0), jmodel, tx,
                                   (batch // WORLD, IMG, IMG, 3))
    init = jax.tree.map(np.array, (jstate.params_q, jstate.params_k, jstate.batch_stats_q,
                                   jstate.batch_stats_k))
    images = [(np.asarray(jax.random.normal(jax.random.key(100 + i), (batch, IMG, IMG, 3))),
               np.asarray(jax.random.normal(jax.random.key(200 + i), (batch, IMG, IMG, 3))))
              for i in range(steps)]
    jkeys, jloss, jgrads, jnudged = _jax_gradient(jmodel, init, *images[0],
                                                  fields["temperature"])
    jstep = jax_build_train_step(jcfg, jmodel, tx, mesh8, SPE, sched)
    jmetrics = []
    for x1, x2 in images:
        jstate, m = jstep(jstate, x1, x2)
        jmetrics.append({k: float(v) for k, v in m.items()})
    # the composed gradient's function is the step's
    np.testing.assert_allclose(jloss, jmetrics[0]["loss"], rtol=1e-5)

    out = str(tmp_path_factory.mktemp(f"v3_{leg}"))
    inputs = os.path.join(out, "inputs.pt")
    torch.save({"config": {**COMMON, **fields},
                "model": dict(arch=fields["arch"], image_size=IMG, embed_dim=DIM,
                              hidden_dim=HIDDEN),
                "state_dict": params_from_jax(_np(init[0]), _np(init[2])),
                "images": [(torch.from_numpy(x1.copy()), torch.from_numpy(x2.copy()))
                           for x1, x2 in images],
                "steps_per_epoch": SPE}, inputs)
    spawn("run_v3_steps", WORLD, (inputs, out))
    ranks = [torch.load(os.path.join(out, f"v3_rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return leg, jmetrics, jkeys, (jgrads, jnudged), ranks


def test_v3_ranks_match_the_jax_mesh_step(leg_runs):
    leg, jm, _jkeys, _jg, ranks = leg_runs
    tm = ranks[0]["metrics"]
    np.testing.assert_allclose([m["loss"] for m in tm], [m["loss"] for m in jm], rtol=2e-4)
    for a, b in zip(tm, jm):
        assert a["acc1"] == b["acc1"]
        for key in ("pos_sim", "neg_sim", "logit_margin"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-4, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)
        assert a["momentum"] == b["momentum"]
    # every process ends with the same models and metrics, bit for bit
    for r in ranks[1:]:
        assert r["metrics"] == tm
        for which in ("q", "k"):
            for k, v in ranks[0][which].items():
                torch.testing.assert_close(r[which][k], v, rtol=0, atol=0)


def test_v3_keys_and_gradient_match_the_jax_mesh_step(leg_runs):
    """Each process's keys against the JAX device's; the synced gradient
    (the mean over processes) x 8 against the JAX step's (the sum). The
    frozen patch embedding has no gradient in the port."""
    leg, _jm, jkeys, (jgrads, jnudged), ranks = leg_runs
    keys = torch.cat([r["keys"] for r in ranks]).numpy()
    np.testing.assert_allclose(keys, jkeys, rtol=0, atol=5e-5)
    grads = ranks[0]["grads"]
    expected = {k for k in jgrads if not k.startswith("backbone.patch_embed.")}
    assert grads.keys() == expected
    for k, g in grads.items():
        ref = jgrads[k].numpy()
        floor = np.abs(jnudged[k].numpy() - ref).max()
        diff = np.abs(WORLD * g.numpy() - ref).max()
        assert diff <= 4 * floor + 1e-5 * np.abs(ref).max(), (k, diff, floor)
    if leg == "vit_adamw":
        assert not np.abs(jgrads["backbone.patch_embed.weight"].numpy()).any()


def test_v3_bucketed_equals_fused_at_two_ranks(tmp_path):
    """The bucketed sync's hooks sit on the trainable parameters only (a
    frozen patch embedding fires none): two v3 ViT steps at 2 ranks equal
    the fused sync's bit for bit."""
    from moco_tpu_torch.models.vit import build_vit
    from moco_tpu_torch.v3_step import V3Model

    model = V3Model(build_vit("vit_tiny", image_size=IMG), embed_dim=DIM, hidden_dim=HIDDEN)
    gen = torch.Generator().manual_seed(0)
    images = [tuple(torch.randn(16, IMG, IMG, 3, generator=gen) for _ in range(2))
              for _ in range(2)]
    runs = {}
    for mode in ("fused", "bucketed"):
        out = str(tmp_path / mode)
        os.makedirs(out)
        inputs = os.path.join(out, "inputs.pt")
        torch.save({"config": {**COMMON, **LEGS["vit_adamw"][0], "batch_size": 16,
                               "grad_sync": mode, "grad_sync_bucket_mb": 0.01},
                    "model": dict(arch="vit_tiny", image_size=IMG, embed_dim=DIM,
                                  hidden_dim=HIDDEN),
                    "state_dict": model.state_dict(), "images": images,
                    "steps_per_epoch": SPE}, inputs)
        spawn("run_v3_steps", 2, (inputs, out))
        runs[mode] = [torch.load(os.path.join(out, f"v3_rank{r}.pt"), weights_only=False)
                      for r in range(2)]
    for a, b in zip(runs["bucketed"], runs["fused"]):
        assert a["metrics"] == b["metrics"]
        for which in ("q", "k", "grads"):
            assert a[which].keys() == b[which].keys()
            for k, v in b[which].items():
                torch.testing.assert_close(a[which][k], v, rtol=0, atol=0)
