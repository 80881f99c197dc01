"""The port's learning health (`moco_tpu_torch/telemetry/health.py`,
`resilience/sentinel.py`) against the JAX package's, on the CPU.

- Each diagnostic against the JAX function on the same seeded numpy inputs,
  outside `shard_map`, at rtol 1e-6 (f32 sums in another order):
  `embedding_stats`, `grad_group_norms` on the tiny ResNet's real parameter
  tree, `queue_health`, `param_drift`, `region_health` on and off the
  stride, `crush_key_params`, `neg_sim_mean`.
- `CollapseSentinel`: the port's and the JAX one fire on the same steps for
  the same observation sequences (the JAX suite's unit cases).
- The v2 and v3 steps of a tiny model with `health_stride=2`: the
  trajectory equals `health_stride=0` bit for bit, and on stride steps the
  `h_*` scalars equal the JAX health functions applied to that step's own
  q, k, gradients, queue and parameters, at rtol 1e-5.
- A crushed key encoder with `collapse_emb_std` set writes one `health`
  incident to `events.jsonl`.

Why the step-level gate has this shape: the JAX step with
`health_stride > 0` cannot run under jax 0.9 (its `lax.cond` inside
`shard_map` raises a branch-type `TypeError` at
`moco_tpu/telemetry/health.py:151`; `tests/test_health.py`'s four step-level
tests fail for it), so the port's step is held against the JAX health
functions applied to the port step's own tensors, captured where the step
hands them to the diagnostics.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.config import PretrainConfig as JaxConfig
from moco_tpu.resilience import CollapseSentinel as JaxSentinel
from moco_tpu.telemetry import health as jh
from moco_tpu.train_step import build_encoder as jax_build_encoder
from moco_tpu_torch.config import PretrainConfig, get_preset
from moco_tpu_torch.ops.losses import neg_sim_mean
from moco_tpu_torch.resilience.errors import CollapseError, NonFiniteLossError
from moco_tpu_torch.resilience.sentinel import CollapseSentinel
from moco_tpu_torch.telemetry import health
from moco_tpu_torch.train_state import create_train_state
from moco_tpu_torch.train_step import build_encoder, build_train_step
from moco_tpu_torch.weights import params_from_jax, params_to_jax

RTOL = 1e-6
STEP_RTOL = 1e-5


def _close(got: dict, want: dict, rtol: float) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, atol=1e-7,
                                   err_msg=k)


def _randn(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# each function against the JAX one
# ---------------------------------------------------------------------------

_EMBEDDINGS = {
    "isotropic": lambda: _randn(0, 256, 16),
    "rank_one": lambda: _randn(1, 64, 1) * _randn(2, 1, 16),
    "constant": lambda: np.ones((64, 16), np.float32),
    "unit_rows": lambda: (lambda z: z / np.linalg.norm(z, axis=1, keepdims=True))(
        _randn(3, 32, 128)),
}


@pytest.mark.parametrize("name", sorted(_EMBEDDINGS))
def test_embedding_stats_matches_jax(name):
    z = _EMBEDDINGS[name]()
    std, pr = health.embedding_stats(torch.from_numpy(z))
    jstd, jpr = jh.embedding_stats(jnp.asarray(z))
    _close({"std": std, "pr": pr}, {"std": jstd, "pr": jpr}, RTOL)


def _tiny_resnet_grads(seed=0):
    """The flax resnet_tiny encoder's parameter tree, with a seeded numpy
    gradient of each leaf's shape; and the port's encoder with the same
    gradients in its own layout."""
    jcfg = JaxConfig(variant="v1", arch="resnet_tiny", embed_dim=16, cifar_stem=True)
    variables = jax_build_encoder(jcfg).init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)),
                                             train=False)
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32),
                         variables["params"])
    model = build_encoder(PretrainConfig(variant="v1", arch="resnet_tiny", embed_dim=16,
                                         cifar_stem=True))
    for name, g in params_from_jax(grads).items():
        model.get_parameter(name).grad = g
    return grads, model


def test_grad_group_norms_matches_jax_on_the_tiny_resnet_tree():
    grads, model = _tiny_resnet_grads()
    tree = health.param_grads(model)
    assert sorted(tree) == sorted(grads)  # the same top-level groups
    _close(health.grad_group_norms(tree), jh.grad_group_norms(grads), RTOL)


def _queue(seed, k=64, d=16):
    q = _randn(seed, k, d)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[5] = 0.0  # a crushed row
    q[9] *= 1.5
    return q


@pytest.mark.parametrize("step, batch", [(0, 16), (2, 16), (3, 16), (40, 16), (6, 128)])
def test_queue_health_matches_jax(step, batch):
    queue = _queue(step)
    got = health.queue_health(torch.from_numpy(queue), step, batch, 2)
    want = jh.queue_health(jnp.asarray(queue), jnp.int32(step), batch, 2)
    if step % 2:
        assert got == {} and all(float(v) == 0.0 for v in want.values())
    else:
        _close(got, want, RTOL)


@pytest.mark.parametrize("step", [0, 1, 4])
def test_param_drift_matches_jax(step):
    shapes = [(3, 3, 8, 8), (8,), (16, 4)]
    pq = [_randn(10 + i, *s) for i, s in enumerate(shapes)]
    pk = [p + 0.01 * _randn(20 + i, *p.shape) for i, p in enumerate(pq)]
    got = health.param_drift([torch.from_numpy(p) for p in pq],
                             [torch.from_numpy(p) for p in pk], step, 2)
    want = jh.param_drift([jnp.asarray(p) for p in pq], [jnp.asarray(p) for p in pk],
                          jnp.int32(step), 2)
    if step % 2:
        assert got == {} and float(want["h_pdrift"]) == 0.0
    else:
        _close(got, want, RTOL)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_region_health_matches_jax_on_and_off_the_stride(step):
    grads, model = _tiny_resnet_grads(step)
    q, k = _randn(30 + step, 16, 16), _randn(40 + step, 16, 16)
    got = health.region_health(torch.from_numpy(q), torch.from_numpy(k),
                               health.param_grads(model), step, 2)
    want = jh.region_health(jnp.asarray(q), jnp.asarray(k), grads, jnp.int32(step), 2)
    if step % 2:  # off the stride: no keys, where the JAX cond selects zeros
        assert got == {} and all(float(v) == 0.0 for v in want.values())
    else:
        _close(got, want, RTOL)


@pytest.mark.parametrize("arch", ["resnet_tiny", "vit_tiny"])
def test_crush_key_params_matches_jax(arch):
    """The port crushes its module in place; the result, read back in
    flax's layout, is the JAX crush of the same tree (BN statistics
    untouched), and the crushed encoder maps every input to one feature."""
    jcfg = JaxConfig(variant="v1", arch=arch, embed_dim=16, image_size=16)
    variables = jax_build_encoder(jcfg).init(jax.random.key(1), jnp.zeros((1, 16, 16, 3)),
                                             train=False)
    model = build_encoder(PretrainConfig(variant="v1", arch=arch, embed_dim=16,
                                         image_size=16))
    model.load_state_dict(params_from_jax(variables["params"],
                                          variables.get("batch_stats")), strict=False)
    stats_before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    health.crush_key_params(model)
    got, _ = params_to_jax({n: p for n, p in model.named_parameters()})
    want = jax.tree.map(np.asarray, jh.crush_key_params(variables["params"]))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    for k, v in stats_before.items():
        assert torch.equal(model.state_dict()[k], v)
    model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(_randn(5, 4, 16, 16, 3)))
    assert torch.allclose(out, out[:1].expand_as(out), atol=1e-6)


def test_neg_sim_mean_is_the_one_copy_and_matches_jax():
    assert health.neg_sim_mean is neg_sim_mean
    logits = _randn(50, 8, 5)
    for labels in (np.zeros(8, np.int64), np.arange(8) % 5):
        got = neg_sim_mean(torch.from_numpy(logits), torch.from_numpy(labels), 0.07)
        want = jh.neg_sim_mean(jnp.asarray(logits), jnp.asarray(labels, jnp.int32), 0.07)
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


# ---------------------------------------------------------------------------
# the sentinel fires where the JAX one does
# ---------------------------------------------------------------------------

# (sentinel arguments, observation runs, incidents the JAX sentinel fires)
_SENTINEL_CASES = {
    "fires_once_and_rearms": (dict(window=3, margin_eps=0.01),
                              [("logit_margin", [1.0] * 3 + [0.0] * 5 + [1.0] * 3
                                + [0.0] * 3)], 2),
    "healthy_sample_rearms": (dict(window=3, margin_eps=0.01),
                              [("logit_margin", [0.0, 0.0, 1.0, 0.0, 0.0, 1.0, 0.0, 0.0])], 0),
    "min_step_warmup": (dict(window=2, acc1_floor=5.0, min_step=10),
                        [("acc1", [0.1] * 4), ("acc1", [0.1] * 3)], 1),
    "warmup_never_fills": (dict(window=3, acc1_floor=5.0, min_step=10),
                           [("acc1", [0.1] * 9)], 0),
    "emb_std_min_of_q_and_k": (dict(window=2, emb_std_eps=1e-3),
                               [("emb", [(0.5, 0.0)] * 4)], 1),
    "unarmed": (dict(window=5), [("logit_margin", [0.0] * 20)], 0),
}


def _feed(sentinel, sequences):
    """Each run of observations from the step after the last (a run of
    acc1 starts past min_step=10), the pending one flushed after each."""
    step = 1
    for key, values in sequences:
        for v in values:
            obs = ({"h_emb_std_q": v[0], "h_emb_std_k": v[1]} if key == "emb" else {key: v})
            sentinel.observe(step, obs)
            step += 1
        sentinel.flush()
        if key == "acc1":
            step = max(step, 11)
    return sentinel.fired


@pytest.mark.parametrize("case", sorted(_SENTINEL_CASES))
def test_collapse_sentinel_fires_where_jax_does(case):
    kw, sequences, n_fired = _SENTINEL_CASES[case]
    kw = dict(kw)
    window = kw.pop("window")
    port, ref = CollapseSentinel(window, **kw), JaxSentinel(window, **kw)
    assert port.armed == ref.armed
    got, want = _feed(port, sequences), _feed(ref, sequences)
    assert got == want and len(got) == n_fired


def test_collapse_sentinel_rollback_raises_the_collapse_error():
    s = CollapseSentinel(2, margin_eps=0.01, rollback=True)
    with pytest.raises(CollapseError) as e:
        for step in (1, 2, 3):
            s.observe(step, {"logit_margin": 0.0})
        s.flush()
    assert isinstance(e.value, NonFiniteLossError) and e.value.predicate == "margin"


# ---------------------------------------------------------------------------
# the steps: bit for bit with health on, and the JAX functions on their tensors
# ---------------------------------------------------------------------------

B, IMG, DIM, K = 8, 16, 16, 32
STEPS = 4
V2 = dict(variant="v2", arch="resnet_tiny", mlp_head=True, embed_dim=DIM, num_negatives=K,
          batch_size=B, image_size=IMG, lr=0.1, epochs=2, temperature=0.2, cos=True)
V3 = dict(variant="v3", arch="vit_tiny", embed_dim=DIM, batch_size=B, image_size=IMG,
          optimizer="adamw", lr=1e-3, weight_decay=0.1, temperature=0.2, momentum_ema=0.99,
          momentum_ramp=True, epochs=2)


def _np(t):
    return t.detach().float().cpu().numpy().copy()


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else _np(v) for k, v in tree.items()}


class _Spy:
    """Wraps the health module's functions to keep a copy of what the step
    hands them, then calls the real ones."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("region_health", "queue_health", "param_drift"):
            real = getattr(health, name)
            monkeypatch.setattr(health, name, self._wrap(name, real))

    def _wrap(self, name, real):
        def spy(*args):
            args = list(args)
            if name == "param_drift":
                args[0], args[1] = list(args[0]), list(args[1])
            kept = [(_tree_np(a) if isinstance(a, dict) else
                     [_np(t) for t in a] if isinstance(a, list) else
                     _np(a) if isinstance(a, torch.Tensor) else a) for a in args]
            self.calls.append((name, kept))
            return real(*args)
        return spy


def _run(fields, monkeypatch=None, **kw):
    config = PretrainConfig(**fields, **kw)
    state = create_train_state(config, build_encoder(config), "cpu", seed=0)
    step = build_train_step(config, steps_per_epoch=2)
    spy = _Spy(monkeypatch) if monkeypatch is not None else None
    rng = np.random.default_rng(7)
    metrics = []
    for _ in range(STEPS):
        a, b = (torch.from_numpy(rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32))
                for _ in range(2))
        metrics.append(step(state, a, b))
    return state, metrics, spy


def _step_of(name, args) -> int:
    return args[1] if name == "queue_health" else args[-2]


def _jax_apply(name, args):
    step, stride = _step_of(name, args), args[-1]
    if name == "region_health":
        q, k, grads = args[:3]
        return jh.region_health(jnp.asarray(q), jnp.asarray(k),
                                jax.tree.map(jnp.asarray, grads), jnp.int32(step), stride)
    if name == "queue_health":
        return jh.queue_health(jnp.asarray(args[0]), jnp.int32(step), args[2], stride)
    return jh.param_drift([jnp.asarray(p) for p in args[0]],
                          [jnp.asarray(p) for p in args[1]], jnp.int32(step), stride)


@pytest.mark.parametrize("fields", [V2, V3], ids=["v2", "v3"])
def test_step_with_health_is_bitwise_and_matches_the_jax_functions(fields, monkeypatch):
    off_state, off_metrics, _ = _run(fields)
    on_state, on_metrics, spy = _run(fields, monkeypatch, health_stride=2)
    # the trajectory: every metric of health_stride=0, then the state
    for m_on, m_off in zip(on_metrics, off_metrics):
        for key, value in m_off.items():
            assert (torch.equal(m_on[key], value) if isinstance(value, torch.Tensor)
                    else m_on[key] == value), key
    for a, b in ((on_state.model_q, off_state.model_q), (on_state.model_k, off_state.model_k)):
        for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), name
    if fields["variant"] == "v2":
        assert torch.equal(on_state.queue, off_state.queue)
    for sa, sb in zip(on_state.optimizer.state.values(), off_state.optimizer.state.values()):
        for key in sa:
            assert torch.equal(torch.as_tensor(sa[key]), torch.as_tensor(sb[key])), key
    # the diagnostics: on stride steps only, equal to the JAX functions on
    # the tensors the step handed them
    names = ["region_health", "param_drift"]
    if fields["variant"] == "v2":
        names.insert(1, "queue_health")
    assert [c[0] for c in spy.calls] == names * (STEPS // 2)
    expected = {}
    for name, args in spy.calls:
        step = _step_of(name, args)
        assert step % 2 == 0
        expected.setdefault(step, {}).update(_jax_apply(name, args))
    for i, m in enumerate(on_metrics):
        h = {k: v for k, v in m.items() if k.startswith("h_")}
        if i % 2:
            assert h == {}
        else:
            _close(h, expected[i], STEP_RTOL)
            assert ("h_qnorm_mean" in h) == (fields["variant"] == "v2")
    if fields["variant"] == "v3":
        # the drift covers the key model's parameters: no predictor
        n_k = len(list(on_state.model_k.parameters()))
        assert all(len(args[0]) == n_k for name, args in spy.calls if name == "param_drift")


def test_crushed_key_encoder_writes_one_health_incident(tmp_path, monkeypatch):
    """The collapse drill of the JAX suite through the port's driver: the
    key encoder crushed after every step (a wedged momentum update), the
    stride-sampled embedding std pinned at ~0, one `health` incident."""
    from moco_tpu_torch import train

    real = train.build_train_step

    def crushing(config, steps_per_epoch, group=None):
        step = real(config, steps_per_epoch, group=group)

        def run(state, im_q, im_k):
            out = step(state, im_q, im_k)
            health.crush_key_params(state.model_k)
            return out
        return run

    monkeypatch.setattr(train, "build_train_step", crushing)
    config = get_preset("imagenet-moco-v2").replace(
        dataset="synthetic", arch="resnet_tiny", image_size=IMG, batch_size=B,
        num_negatives=K, embed_dim=DIM, compute_dtype="float32", epochs=1,
        steps_per_epoch=8, print_freq=100, telemetry_dir=str(tmp_path / "tel"),
        health_stride=1, collapse_emb_std=1e-3, collapse_window=2)
    train.train(config, device="cpu", on_step=lambda *a: None)
    with open(tmp_path / "tel" / "events.jsonl") as f:
        records = [json.loads(line) for line in f]
    incidents = [r for r in records if r.get("event") == "health"]
    assert len(incidents) == 1
    (incident,) = incidents
    assert incident["predicate"] == "emb_std" and incident["value"] <= 1e-3
    stds = [r["health"]["emb_std_k"] for r in records if r["kind"] == "step"]
    assert stds[0] > 1e-3 and max(stds[1:]) <= 1e-3  # crushed from the second step
    (end,) = [r for r in records if r["kind"] == "run_end"]
    assert end["incidents"] == 1
    assert os.path.exists(tmp_path / "tel" / "heartbeat.json")
