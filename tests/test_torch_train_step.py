"""The slice as a whole: three port steps against three steps of the JAX
package's 1-device step, from the same exported initial state (weights, BN
statistics, queue) on the same images.

On one device ShuffleBN's permutation does not change per-device BN (the
same samples form the batch), so the two frameworks' shuffle generators need
not agree; only the order of the sums differs.

`v2_tiny_fused` runs the port with `fused_bn_conv=True` (the fused
bn->relu->conv functions, their kernels' plain versions on the CPU) against
the same JAX step: off the TPU the JAX ResNet does not fuse
(`moco_tpu/models/resnet.py:298`), but it computes the same function.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from moco_tpu.config import PretrainConfig as JaxConfig
from moco_tpu.models import resnet as jresnet
from moco_tpu.parallel.mesh import create_mesh
from moco_tpu.train_state import create_train_state as jax_create_train_state
from moco_tpu.train_step import build_encoder as jax_build_encoder
from moco_tpu.train_step import build_optimizer as jax_build_optimizer
from moco_tpu.train_step import build_train_step as jax_build_train_step
from moco_tpu_torch.config import PretrainConfig
from moco_tpu_torch.models import resnet
from moco_tpu_torch.train_state import create_train_state
from moco_tpu_torch.train_step import build_encoder, build_train_step
from moco_tpu_torch.weights import params_from_jax

GLOBAL_B, DIM, K, SPE = 16, 16, 64, 8
GOLDEN_1DEV = [0.0279795, 2.8311126, 3.4929943]  # tests/test_golden.py

COMMON = dict(num_negatives=K, embed_dim=DIM, batch_size=GLOBAL_B, epochs=2, lr=0.1,
              seed=0)
CONFIGS = {
    # tests/test_golden.py's config: v1, resnet_tiny, CIFAR stem, 8 px
    "v1_golden": (dict(variant="v1", arch="resnet_tiny", cifar_stem=True), 8, None),
    # tiny v2: Bottleneck blocks, MLP head, T=0.2, cosine lr, 7x7 stem at 32 px
    "v2_tiny": (dict(variant="v2", arch="resnet50", mlp_head=True, temperature=0.2,
                     cos=True), 32, (1, 1)),
    # the same with the fused bn->relu->conv path: stride-1 and stride-2 mids
    "v2_tiny_fused": (dict(variant="v2", arch="resnet50", mlp_head=True, temperature=0.2,
                           cos=True, fused_bn_conv=True), 32, (1, 1)),
}


def _models(name):
    fields, _img, stages = CONFIGS[name]
    jcfg, tcfg = JaxConfig(**fields, **COMMON), PretrainConfig(**fields, **COMMON)
    if stages is None:
        return jcfg, tcfg, jax_build_encoder(jcfg), build_encoder(tcfg)
    fused = fields.get("fused_bn_conv", False)
    jmodel = jresnet.ResNet(stage_sizes=stages, block_cls=jresnet.Bottleneck, width=8,
                            num_classes=DIM, mlp_head=True, fused_bn_conv=fused)
    tmodel = resnet.ResNet(stages, resnet.Bottleneck, width=8, num_classes=DIM,
                           mlp_head=True, fused_bn_conv=fused)
    return jcfg, tcfg, jmodel, tmodel


def _tree_np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request):
    """(name, JAX metrics, JAX final state as numpy, port metrics, port
    state, port state from nudged initial weights)."""
    name = request.param
    img = CONFIGS[name][1]
    jcfg, tcfg, jmodel, tmodel = _models(name)
    images = [(np.asarray(jax.random.normal(jax.random.key(100 + i), (GLOBAL_B, img, img, 3))),
               np.asarray(jax.random.normal(jax.random.key(200 + i), (GLOBAL_B, img, img, 3))))
              for i in range(3)]

    mesh = create_mesh(1)
    tx, sched = jax_build_optimizer(jcfg, SPE)
    jstate = jax_create_train_state(jax.random.key(0), jmodel, tx, (GLOBAL_B, img, img, 3),
                                    K, DIM)
    init = (_tree_np(jstate.params_q), _tree_np(jstate.batch_stats_q),
            np.array(jstate.queue))  # copied before the donating step
    jstep = jax_build_train_step(jcfg, jmodel, tx, mesh, SPE, sched)
    jmetrics = []
    for im_q, im_k in images:
        jstate, m = jstep(jstate, im_q, im_k)
        jmetrics.append({k: float(v) for k, v in m.items()})
    trace = [t for t in jax.tree.leaves(jstate.opt_state, is_leaf=lambda t: isinstance(
        t, optax.TraceState)) if isinstance(t, optax.TraceState)]
    jfinal = {"q": params_from_jax(_tree_np(jstate.params_q), _tree_np(jstate.batch_stats_q)),
              "k": params_from_jax(_tree_np(jstate.params_k), _tree_np(jstate.batch_stats_k)),
              "queue": np.array(jstate.queue),
              "momentum": params_from_jax(_tree_np(trace[0].trace))}

    sd = params_from_jax(init[0], init[1])
    state, tmetrics = _port_run(tcfg, tmodel, sd, init[2], images)
    # the same port run from weights nudged by 1e-6 (relative): how far
    # float noise alone carries this configuration in three steps
    noise = torch.Generator().manual_seed(1)
    nudged = {k: v * (1 + 1e-6 * torch.randn(v.shape, generator=noise)) for k, v in sd.items()}
    _, _, _, tmodel2 = _models(name)
    nudged_state, _ = _port_run(tcfg, tmodel2, nudged, init[2], images)
    return name, jmetrics, jfinal, tmetrics, state, nudged_state


def _port_run(tcfg, tmodel, sd, queue, images):
    state = create_train_state(tcfg, tmodel, "cpu", seed=0)
    state.model_q.load_state_dict(sd)
    state.model_k.load_state_dict(sd)
    state.queue.copy_(torch.from_numpy(queue))
    tstep = build_train_step(tcfg, SPE)
    metrics = []
    for im_q, im_k in images:
        m = tstep(state, torch.from_numpy(im_q.copy()), torch.from_numpy(im_k.copy()))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def test_losses_and_metrics_match_jax(runs):
    name, jm, _jf, tm, _state, _nudged = runs
    # rtol 2e-4: the golden test's own tolerance for these losses
    np.testing.assert_allclose([m["loss"] for m in tm], [m["loss"] for m in jm], rtol=2e-4)
    if name == "v1_golden":
        np.testing.assert_allclose([m["loss"] for m in tm], GOLDEN_1DEV, rtol=2e-4)
    for a, b in zip(tm, jm):
        assert a["acc1"] == b["acc1"] and a["acc5"] == b["acc5"]
        assert a["queue_ptr"] == b["queue_ptr"]
        # cosines of f32 unit vectors, sums in another order
        for key in ("pos_sim", "neg_sim", "logit_margin"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-4, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)  # f64 vs f32 cosine
    assert [m["queue_ptr"] for m in tm] == [16, 32, 48]


def test_enqueued_keys_and_updated_state_match_jax(runs):
    """Queue rows and both encoders' parameters and BN statistics after
    three steps. The v2 config amplifies float noise: a 1e-6 nudge of the
    initial weights moves its step-3 parameters by up to ~1e-3 (the same
    pattern as the JAX/port difference), so each tensor may differ from
    JAX by at most 4x what the nudge moved it, plus 2e-5."""
    _name, _jm, jf, _tm, state, nudged = runs
    # unit-norm keys through 3 steps of f32 math in other orders: ~1e-6
    np.testing.assert_allclose(state.queue.numpy(), jf["queue"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(state.queue.numpy(), axis=1), 1.0, rtol=1e-5)
    for which, model, model2 in (("q", state.model_q, nudged.model_q),
                                 ("k", state.model_k, nudged.model_k)):
        sd, sd2 = model.state_dict(), model2.state_dict()
        assert sd.keys() == jf[which].keys()
        for key, ref in jf[which].items():
            got = sd[key].numpy()
            floor = np.abs(got - sd2[key].numpy()).max()
            diff = np.abs(got - ref.numpy()).max()
            assert diff <= 4 * floor + 2e-5, (which, key, diff, floor)


def test_momentum_buffers_match_jax(runs):
    """SGD's momentum buffer of every query parameter after three steps:
    the gradients with the weight decay folded in, BN's scales and shifts
    and the biases included (optax's `trace` after `add_decayed_weights`,
    torch's `momentum_buffer`). A decay that one side leaves out of a
    parameter moves its buffer by `wd * p` a step; the bound is the state
    test's: 4x what the nudge moved the buffer, plus 2e-5."""
    _name, _jm, jf, _tm, state, nudged = runs
    names = {p: n for n, p in state.model_q.named_parameters()}
    names2 = {n: p for n, p in nudged.model_q.named_parameters()}
    got = {names[p]: s["momentum_buffer"].numpy() for p, s in state.optimizer.state.items()}
    got2 = {n: nudged.optimizer.state[names2[n]]["momentum_buffer"].numpy() for n in got}
    assert got.keys() == jf["momentum"].keys()
    for key, ref in jf["momentum"].items():
        floor = np.abs(got[key] - got2[key]).max()
        diff = np.abs(got[key] - ref.numpy()).max()
        assert diff <= 4 * floor + 2e-5, (key, diff, floor)
