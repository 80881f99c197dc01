"""The port's gradient-sync modes (`moco_tpu_torch/parallel/gradsync.py`,
`collectives.py`) on the CPU with gloo, held against the JAX package.

At the level of its functions, with per-device inputs that differ, against
the JAX package's on the `mesh8` fixture (`shard_map`, `in_specs=P(DATA_AXIS)`):
`quantized_mean` in int8 and bf16 against `quantized_psum_mean`, DeMo's
merge and residues against `GradSync._reduce_demo` + `finalize` at cadence
1, and the plans, byte counts and config checks against the JAX package's.
At the level of the step the JAX package cannot be the reference: its
multi-device step sums the devices' gradients (tests/test_torch_distributed.py),
so its quantized and DeMo runs quantize an already summed, replicated
gradient, not what a rank holds; and two of its own tests of this layer fail
under jax 0.9. So each mode's step is held against the port's own `fused`
step with the JAX tests' bands. Each multi-process run is a fresh group of
one-thread processes (`tests/torch_dist_worker.py`) under a time limit.

The random inputs are continuous draws, so `torch.topk` and `lax.top_k`
meet no ties, where they may order equal entries differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from moco_tpu.config import PretrainConfig as JaxConfig
from moco_tpu.parallel.collectives import quantized_psum_mean
from moco_tpu.parallel.gradsync import GradSync as JaxGradSync
from moco_tpu.parallel.gradsync import leaf_wire_dtype as jax_leaf_wire_dtype
from moco_tpu.parallel.mesh import DATA_AXIS
from moco_tpu.utils.compat import shard_map
from moco_tpu_torch.config import PretrainConfig
from moco_tpu_torch.parallel.collectives import quantized_mean
from moco_tpu_torch.parallel.gradsync import GradSync, leaf_wire_dtype
from torch_dist_worker import spawn

TIMEOUT = 180.0
B, IMG, DIM, K, SPE = 16, 16, 16, 64, 8
CONFIG = dict(variant="v1", arch="resnet_tiny", cifar_stem=True, num_negatives=K,
              embed_dim=DIM, batch_size=B, epochs=2, lr=0.1, seed=0)
SEG_SIZES = (1, 7, 300, 4097)  # per-leaf segments, each at its own scale
DEMO_SHAPES = {"a": (37,), "b": (8, 16), "c": (3, 3, 4, 5)}
DEMO_TOPK, DEMO_BETA = 0.1, 0.9


def _load(out_dir, name, world):
    return [torch.load(out_dir / f"{name}_rank{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# function level, 8 ranks against mesh8
# ---------------------------------------------------------------------------


def _per_device_inputs():
    rng = np.random.RandomState(0)
    segments = [(rng.randn(8, s) * 10.0 ** rng.uniform(-6, 1, size=(8, 1))).astype(np.float32)
                for s in SEG_SIZES]
    grads = {k: rng.randn(8, *s).astype(np.float32) for k, s in DEMO_SHAPES.items()}
    acc = {k: rng.randn(8, *s).astype(np.float32) for k, s in DEMO_SHAPES.items()}
    return segments, grads, acc


@pytest.fixture(scope="module")
def functions(tmp_path_factory):
    """The port's reduces on 8 gloo ranks, and the JAX package's on mesh8,
    from the same per-device inputs."""
    tmp = tmp_path_factory.mktemp("functions")
    segments, grads, acc = _per_device_inputs()
    inputs = tmp / "inputs.pt"
    torch.save({"segments": segments, "demo_grads": grads, "demo_acc": acc,
                "topk": DEMO_TOPK, "beta": DEMO_BETA}, inputs)
    spawn("run_functions", 8, (str(inputs), str(tmp)), TIMEOUT)
    return _load(tmp, "functions", 8), segments, grads, acc


def _jax_quantized(mesh8, segments, wire):
    def region(*segs):
        means, errs = quantized_psum_mean([s[0] for s in segs], DATA_AXIS, 8, wire)
        return [m[None] for m in means], [e[None] for e in errs]

    n = len(segments)
    fn = shard_map(region, mesh=mesh8, in_specs=(P(DATA_AXIS),) * n,
                   out_specs=([P(DATA_AXIS)] * n, [P(DATA_AXIS)] * n))
    means, errs = jax.jit(fn)(*[jnp.asarray(s) for s in segments])
    return [np.asarray(m) for m in means], [np.asarray(e) for e in errs]


def _ulps(a, b):
    """|a - b| in units of the last place of f32 at b."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(b), np.finfo(np.float32).tiny))


def _errs_close(got, want, segment):
    """Errors within 1 ulp of the value they are the residual of: XLA
    contracts `s - q * scale` into one FMA on the CPU, eager PyTorch rounds
    the product first, so the two differ by at most the product's rounding.
    A different int8 value or scale would move an error by a whole scale."""
    assert (np.abs(got - want) <= np.spacing(np.abs(segment).astype(np.float32))).all()


def test_int8_quantized_mean_matches_quantized_psum_mean(mesh8, functions):
    """The int32 sum is exact (each rank's int8 values add up to it in
    int64), every rank's error is the JAX package's (so the shared scales
    and the int8 values agree too), and the means are within 1 ulp."""
    ranks, segments, _, _ = functions
    jmeans, jerrs = _jax_quantized(mesh8, segments, "int8")
    exact = sum(torch.cat(r["int8"]["qs"]).long() for r in ranks)
    for r, out in enumerate(ranks):
        assert out["int8"]["summed"].dtype == torch.int32
        assert torch.equal(out["int8"]["summed"].long(), exact)
        for i in range(len(SEG_SIZES)):
            _errs_close(out["int8"]["errs"][i].numpy(), jerrs[i][r], segments[i][r])
            assert _ulps(out["int8"]["means"][i].numpy(), jmeans[i][r]).max() <= 1
            # every rank holds the same mean
            assert torch.equal(out["int8"]["means"][i], ranks[0]["int8"]["means"][i])


def test_bf16_quantized_mean_matches_quantized_psum_mean(mesh8, functions):
    """Errors within 1 ulp of their input. The means are not held to 1 ulp:
    XLA's CPU psum adds the bf16 values in f32 and rounds the sum once,
    where gloo's ring (and NCCL's) rounds each of its n - 1 adds to bf16.
    Each rounding is at most half a bf16 ulp of a running sum bounded by
    sum_r |x_r|, so the means differ by at most n/2 such ulps over n: half
    a bf16 ulp of sum_r |x_r| (plus the f32 rounding of the division)."""
    ranks, segments, _, _ = functions
    jmeans, jerrs = _jax_quantized(mesh8, segments, "bfloat16")
    for i, seg in enumerate(segments):
        bf16 = torch.from_numpy(seg).bfloat16().float().numpy()
        total = np.abs(bf16).sum(0)
        bound = 2.0 ** (np.floor(np.log2(np.maximum(total, 1e-38))) - 7) / 2
        for r, out in enumerate(ranks):
            _errs_close(out["bfloat16"]["errs"][i].numpy(), jerrs[i][r], seg[r])
            got = out["bfloat16"]["means"][i].numpy()
            assert (np.abs(got - jmeans[i][r]) <= bound + np.spacing(np.abs(got))).all()
            assert torch.equal(out["bfloat16"]["means"][i], ranks[0]["bfloat16"]["means"][i])
            assert torch.equal(out["bfloat16"]["means"][i], ranks[0]["bfloat16"]["means"][i])


def test_int8_scales_per_leaf_avoid_starvation(functions):
    """A 0.1 leaf and a 1e-5 leaf in one bucket: both reach the mean within
    2%, as in the JAX package's test (a bucket-wide scale would round the
    small leaf to 0)."""
    for out in functions[0]:
        big, small = out["starve"]
        np.testing.assert_allclose(big.numpy(), 0.1, rtol=0.02)
        np.testing.assert_allclose(small.numpy(), 1e-5, rtol=0.02)


def test_demo_merge_and_residues_match_the_jax_package(mesh8, functions):
    """`GradSync.finish` in mode demo at step 0 against the JAX package's
    `_reduce_demo` inside shard_map and `finalize` outside it, cadence 1."""
    ranks, _, grads, acc = functions
    names = sorted(DEMO_SHAPES)
    gs = JaxGradSync(JaxConfig(grad_sync="demo", grad_sync_topk=DEMO_TOPK,
                               grad_sync_demo_beta=DEMO_BETA), 8)

    def region(g, a):
        gs.plan({k: g[k][0] for k in names})
        payload, new, = gs._reduce_demo([g[k][0] for k in names],
                                        [a[k][0].reshape(-1) for k in names], 0, DATA_AXIS)
        return payload, new

    fn = shard_map(region, mesh=mesh8, in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
                   out_specs=(gs.payload_specs(P), P(DATA_AXIS)))
    payload, new = jax.jit(fn)({k: jnp.asarray(grads[k]) for k in names},
                               {k: jnp.asarray(acc[k]) for k in names})
    delta = gs.finalize(payload, jnp.int32(0))
    residues = new["acc"]
    for r, out in enumerate(ranks):
        for k in names:
            np.testing.assert_allclose(out["demo"]["delta"][k].numpy(), np.asarray(delta[k]),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(out["demo"]["acc"][k].numpy(),
                                       np.asarray(residues[k])[r], rtol=0, atol=1e-6)
            k_leaf = int(np.ceil(np.prod(DEMO_SHAPES[k]) * DEMO_TOPK))
            # the sent entries left the local momentum
            assert int((out["demo"]["acc"][k] == 0).sum()) == k_leaf


# ---------------------------------------------------------------------------
# plans, bytes, checks: against the JAX package, no processes
# ---------------------------------------------------------------------------


def test_wire_dtype_policy():
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        for policy in ("float32", "bfloat16"):
            want = jax_leaf_wire_dtype(jnp.dtype(jdtype), policy)
            got = leaf_wire_dtype(dtype, policy)
            assert str(got).removeprefix("torch.") == str(want)
    for fn in (leaf_wire_dtype, jax_leaf_wire_dtype):
        with pytest.raises(ValueError, match="unknown grad_allreduce_dtype"):
            fn(torch.float32 if fn is leaf_wire_dtype else jnp.dtype(jnp.float32), "int8")


def _tiny_params():
    """The tiny ResNet's parameters: the port's (named, in registration
    order) and the JAX package's tree."""
    from moco_tpu.train_step import build_encoder as jax_build_encoder
    from moco_tpu_torch.train_step import build_encoder

    config = PretrainConfig(**CONFIG)
    jax_model = jax_build_encoder(JaxConfig(**CONFIG))
    variables = jax_model.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)), train=False)
    return list(build_encoder(config).named_parameters()), variables["params"]


@pytest.mark.parametrize("mode, bucket_mb", [("bucketed", 0.01), ("quantized", 0.01),
                                             ("quantized", 0.002)])
def test_bucket_plan_covers_every_leaf_and_respects_the_budget(mode, bucket_mb):
    params, _ = _tiny_params()
    gs = GradSync(PretrainConfig(**CONFIG, grad_sync=mode, grad_sync_bucket_mb=bucket_mb),
                  None)
    gs.plan(params)
    buckets = gs._bucket_plan()
    order = [p.index for b in buckets for p in b]
    # every leaf once, in reverse registration order (the backward's)
    assert order == list(range(len(params)))[::-1]
    per_elem = 1 if mode == "quantized" else 4
    for b in buckets:
        assert len(b) == 1 or sum(p.size for p in b) * per_elem <= bucket_mb * 2**20
    assert len(buckets) > 1


@pytest.mark.parametrize("overrides", [
    dict(grad_sync="fused"), dict(grad_sync="fused", grad_allreduce_dtype="bfloat16"),
    dict(grad_sync="bucketed"), dict(grad_sync="quantized"),
    dict(grad_sync="quantized", grad_sync_quant_dtype="bfloat16"),
    dict(grad_sync="demo"), dict(grad_sync="demo", grad_sync_topk=0.05, grad_sync_cadence=4),
])
def test_sync_bytes_per_step_equal_the_jax_number(overrides):
    params, jax_params = _tiny_params()
    got = GradSync(PretrainConfig(**CONFIG, **overrides), None).describe(params)
    want = JaxGradSync(JaxConfig(**CONFIG, **overrides), 8).describe(jax_params)
    assert got["sync_bytes_per_step"] == want["sync_bytes_per_step"]
    assert {k: v for k, v in got.items() if k not in ("buckets", "carried_bytes_per_step")} \
        == {k: v for k, v in want.items() if k != "buckets"}
    elems = sum(p.numel() for _, p in params)
    if overrides.get("grad_sync") == "quantized" and "grad_sync_quant_dtype" not in overrides:
        # the int8 payload rides an int32 carrier: 4x, plus the f32 absmaxes
        assert got["sync_bytes_per_step"] == elems + 4 * len(params)
        assert got["carried_bytes_per_step"] == 4 * elems + 4 * len(params)
    elif overrides.get("grad_sync") != "demo":
        assert got["carried_bytes_per_step"] == got["sync_bytes_per_step"]


_BAD_KNOBS = [dict(grad_sync="turbo"), dict(grad_sync_bucket_mb=0),
              dict(grad_sync_quant_dtype="int4"), dict(grad_sync_cadence=0),
              dict(grad_sync_topk=0.0), dict(grad_sync_topk=1.5),
              dict(grad_sync_demo_beta=1.0),
              # the telemetry and learning-health knobs (the JAX messages too)
              dict(health_stride=-2), dict(collapse_window=0), dict(collapse_min_step=-1),
              dict(collapse_margin=-0.1), dict(collapse_emb_std=0.01),
              dict(trace_mode="all"), dict(trace_capture_steps=0),
              dict(trace_capture_budget=-1), dict(trace_slow_step_k=1.0)]


@pytest.mark.parametrize("bad", _BAD_KNOBS)
def test_config_rejects_bad_knobs_with_the_jax_messages(bad):
    with pytest.raises(ValueError) as jax_err:
        JaxConfig(**bad)
    with pytest.raises(ValueError) as port_err:
        PretrainConfig(**bad)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("mode", ["fused", "bucketed", "quantized", "demo"])
def test_config_accepts_every_mode_and_zero_sharding(mode):
    config = PretrainConfig(grad_sync=mode, zero_sharding=True)
    assert (config.grad_sync, config.zero_sharding) == (mode, True)


@pytest.mark.parametrize("wire", ["int8", "bfloat16"])
def test_quantized_mean_alone_rebuilds_its_input(wire):
    """One process: mean + error is the input (within 1 ulp), and the error
    is under half a quantum (int8) or a bf16 rounding."""
    gen = torch.Generator().manual_seed(1)
    segs = [torch.randn(s, generator=gen) * 10.0 ** e for s, e in ((33, -4), (500, 0))]
    means, errs = quantized_mean(segs, None, wire)
    for s, m, e in zip(segs, means, errs):
        assert _ulps((m + e).numpy(), s.numpy()).max() <= 1
        limit = (s.abs().max() / 127 / 2 if wire == "int8"
                 else s.abs() * 2.0 ** -8).numpy() + np.spacing(s.abs().numpy())
        assert (e.abs().numpy() <= limit).all()


def test_no_hooks_without_a_group_and_none_fire_unarmed():
    """A one-process `train()` registers no hook; a GradSync's hooks launch
    nothing on a backward that the step did not start."""
    import moco_tpu_torch.train as driver

    config = PretrainConfig(**{**CONFIG, "grad_sync": "bucketed", "image_size": IMG,
                               "dataset": "synthetic", "batch_size": 8})
    state, _ = driver.train(config, max_steps=1, device="cpu", on_step=lambda *a: None)
    assert not any(p._post_accumulate_grad_hooks for p in state.model_q.parameters())
    gs = GradSync(config, None)
    gs._bind(state.model_q)
    assert all(len(p._post_accumulate_grad_hooks) == 1 for p in state.model_q.parameters())
    launched = []
    gs._launch = launched.append
    state.model_q(torch.randn(2, IMG, IMG, 3)).square().sum().backward()
    assert not launched and gs._next == 0 and all(b.ready == 0 for b in gs._buckets)


# ---------------------------------------------------------------------------
# step level: each mode against the port's own fused step
# ---------------------------------------------------------------------------

N_STEPS = 5
SMALL_BUCKETS = dict(grad_sync_bucket_mb=0.01)  # several buckets in the tiny ResNet
RUNS = {
    "fused": (dict(grad_sync="fused"), N_STEPS, False),
    "bucketed": (dict(grad_sync="bucketed", **SMALL_BUCKETS), N_STEPS, False),
    "fused_fbc": (dict(grad_sync="fused", fused_bn_conv=True), 3, False),
    "bucketed_fbc": (dict(grad_sync="bucketed", fused_bn_conv=True, **SMALL_BUCKETS), 3,
                     False),
    "int8": (dict(grad_sync="quantized", **SMALL_BUCKETS), N_STEPS, False),
    "bf16": (dict(grad_sync="quantized", grad_sync_quant_dtype="bfloat16"), N_STEPS, False),
    "demo": (dict(grad_sync="demo", grad_sync_topk=0.25), N_STEPS, False),
    "fused_short": (dict(grad_sync="fused"), 2, False),
    "bucketed_short": (dict(grad_sync="bucketed", **SMALL_BUCKETS), 2, False),
    # a memoryless optimizer: an off-step's zero gradient moves nothing
    "demo_cadence": (dict(grad_sync="demo", grad_sync_topk=0.25, grad_sync_cadence=2,
                          sgd_momentum=0.0, weight_decay=0.0), 3, True),
}


def _images(steps):
    rng = np.random.RandomState(7)
    return [(torch.from_numpy(rng.randn(B, IMG, IMG, 3).astype(np.float32)),
             torch.from_numpy(rng.randn(B, IMG, IMG, 3).astype(np.float32)))
            for _ in range(steps)]


def _spawn_modes(tmp, world, names):
    inputs = tmp / "inputs.pt"
    torch.save({"config": CONFIG, "steps_per_epoch": SPE, "images": _images(N_STEPS),
                "runs": [(n, *RUNS[n]) for n in names]}, inputs)
    spawn("run_modes", world, (str(inputs), str(tmp)), TIMEOUT)
    return {n: _load(tmp, n, world) for n in names}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _spawn_modes(tmp_path_factory.mktemp("two"), 2,
                        [n for n in RUNS if not n.endswith("_short")])


def _assert_same(a, b, what=""):
    """Two runs equal bit for bit: losses, both encoders, the queue, the
    momentum buffers."""
    assert a["metrics"] == b["metrics"], what
    assert a["queue_ptr"] == b["queue_ptr"] and torch.equal(a["queue"], b["queue"]), what
    for which in ("q", "k"):
        for key in a[which]:
            assert torch.equal(a[which][key], b[which][key]), (what, which, key)
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and sa, what
    for i in sa:
        assert torch.equal(sa[i]["momentum_buffer"], sb[i]["momentum_buffer"]), (what, i)


@pytest.mark.parametrize("fused_bn_conv", [False, True])
def test_bucketed_equals_fused_bit_for_bit_at_two_ranks(two_ranks, fused_bn_conv):
    """The hooks fire through the fused path's autograd Functions too; on
    2 ranks each sum is one commutative add, so the buckets change no bit."""
    suffix = "_fbc" if fused_bn_conv else ""
    for r in range(2):
        _assert_same(two_ranks["fused" + suffix][r], two_ranks["bucketed" + suffix][r])
    _assert_same(two_ranks["bucketed" + suffix][0], two_ranks["bucketed" + suffix][1])


def test_bucketed_equals_fused_bit_for_bit_at_one_rank(tmp_path):
    one = _spawn_modes(tmp_path, 1, ["fused", "bucketed", "fused_fbc", "bucketed_fbc"])
    _assert_same(one["fused"][0], one["bucketed"][0])
    _assert_same(one["fused_fbc"][0], one["bucketed_fbc"][0])


def test_bucketed_equals_fused_within_float_reduction_at_four_ranks(tmp_path):
    """Not bit for bit at 4 ranks: gloo's ring (as NCCL's) sums an element
    in an order set by its offset in the flat buffer, and the buckets lay
    the gradients out otherwise than the one fused buffer. So the sums
    differ in their last bits, a float-reduction size: after 2 steps the
    losses and parameters agree within rtol 1e-6 (of each tensor's largest
    entry), and every rank holds the same bits."""
    four = _spawn_modes(tmp_path, 4, ["fused_short", "bucketed_short"])
    for r in range(4):
        a, b = four["fused_short"][r], four["bucketed_short"][r]
        np.testing.assert_allclose(b["metrics"], a["metrics"], rtol=1e-6)
        for k in a["q"]:
            scale = float(a["q"][k].abs().max())
            np.testing.assert_allclose(b["q"][k].numpy(), a["q"][k].numpy(), rtol=0,
                                       atol=1e-6 * scale, err_msg=k)
            assert torch.equal(b["q"][k], four["bucketed_short"][0]["q"][k])


@pytest.mark.parametrize("run, band", [("int8", 0.05), ("bf16", 0.02), ("demo", 0.5)])
def test_compressed_modes_stay_within_the_jax_bands(two_ranks, run, band):
    """The JAX package's bands around the exact step's losses over 5
    steps (int8 5%, bf16 2%, DeMo 50%), the compression really happened
    (the parameters differ from the fused run's), every rank holds the same
    parameters, and the accumulators carry a nonzero residue."""
    fused = two_ranks["fused"][0]["metrics"]
    for r in range(2):
        got = two_ranks[run][r]
        assert all(np.isfinite(got["metrics"]))
        for a, b in zip(fused, got["metrics"]):
            assert abs(a - b) <= band * max(abs(a), 1.0), (fused, got["metrics"])
        assert any(not torch.equal(got["q"][k], two_ranks["fused"][r]["q"][k])
                   for k in got["q"])
        assert got["gradsync"] and any(float(a.abs().max()) > 0
                                       for a in got["gradsync"].values())
        for k in got["q"]:
            assert torch.equal(got["q"][k], two_ranks[run][0]["q"][k]), (run, r, k)
    # the accumulators are per-process: the ranks' residues differ
    a, b = (two_ranks[run][r]["gradsync"] for r in range(2))
    assert any(not torch.equal(a[k], b[k]) for k in a)


def test_demo_cadence_off_step_moves_nothing(two_ranks):
    """Cadence 2, momentum 0, weight decay 0: step 1 is an off-step, its
    zero gradient leaves every parameter where step 0 put it; step 2 syncs
    and moves them."""
    for r in range(2):
        s0, s1, s2 = two_ranks["demo_cadence"][r]["snapshots"]
        params = [k for k in s0 if not k.endswith(("running_mean", "running_var"))]
        for k in params:
            assert torch.equal(s0[k], s1[k]), k
        assert any(not torch.equal(s1[k], s2[k]) for k in params)


# ---------------------------------------------------------------------------
# checkpoints: the accumulators (dialect 2 rows) and the fresh-zero restores
# ---------------------------------------------------------------------------

TRAIN = dict(variant="v2", arch="resnet_tiny", mlp_head=True, temperature=0.2, aug_plus=True,
             cos=True, dataset="synthetic", image_size=16, batch_size=8, num_negatives=32,
             embed_dim=16, epochs=4, lr=0.03, seed=3, print_freq=1, staging_workers=2,
             grad_sync="quantized")
TRAIN_N = 16


def test_accumulators_round_trip_bit_for_bit(tmp_path):
    """A 2-rank quantized `train()` saves each rank's error feedback as row
    `rank` of `gradsync/acc` [2, *shape]; resumed, it equals the
    uninterrupted run bit for bit, accumulators included."""
    from moco_tpu_torch.checkpoint import checkpoint_manager

    ckpt = str(tmp_path / "ckpt")
    spawn("run_train", 2, (TRAIN, str(tmp_path), "whole", 4, TRAIN_N), TIMEOUT)
    spawn("run_train", 2, ({**TRAIN, "ckpt_dir": ckpt}, str(tmp_path), "first", 2, TRAIN_N),
          TIMEOUT)
    saved = checkpoint_manager(ckpt).restore(2)["gradsync"]
    first = _load(tmp_path, "first", 2)
    assert saved["mode"] == "quantized"
    for k, rows in saved["acc"].items():
        assert rows.shape[0] == 2
        for r in range(2):
            assert torch.equal(rows[r], first[r]["gradsync"][k])
    assert any(not torch.equal(rows[0], rows[1]) for rows in saved["acc"].values())
    spawn("run_train", 2, ({**TRAIN, "ckpt_dir": ckpt, "resume": "auto"}, str(tmp_path),
                           "resumed", 4, TRAIN_N), TIMEOUT)
    whole, resumed = _load(tmp_path, "whole", 2), _load(tmp_path, "resumed", 2)
    for r in range(2):
        assert resumed[r]["history"][-1] == whole[r]["history"][-1]
        for which in ("q", "k", "gradsync"):
            for k in whole[r][which]:
                assert torch.equal(resumed[r][which][k], whole[r][which][k]), (which, k)
        assert torch.equal(resumed[r]["queue"], whole[r]["queue"])


def _state(mode):
    from moco_tpu_torch.train_state import create_train_state
    from moco_tpu_torch.train_step import build_encoder

    config = PretrainConfig(**{**CONFIG, "grad_sync": mode})
    state = create_train_state(config, build_encoder(config), "cpu")
    GradSync(config, None).attach(state)
    gen = torch.Generator().manual_seed(5)
    for t in state.gradsync.values():
        t.copy_(torch.randn(t.shape, generator=gen))
    return state


def _saved(tmp_path, edit=None):
    """A checkpoint of a quantized state (one process), its payload
    edited by `edit`, saved again as step 2."""
    from moco_tpu_torch.checkpoint import checkpoint_manager, save_checkpoint

    mgr = checkpoint_manager(str(tmp_path / "ckpt"))
    state = _state("quantized")
    save_checkpoint(mgr, state, 1)
    payload = mgr.restore(1)
    if edit is not None:
        edit(payload)
    mgr.save(2, payload)
    return mgr, state


def test_matching_accumulators_restore_bit_for_bit(tmp_path):
    from moco_tpu_torch.checkpoint import restore_checkpoint

    mgr, state = _saved(tmp_path)
    fresh = restore_checkpoint(mgr, _state("quantized"), 2)
    for k, t in state.gradsync.items():
        assert torch.equal(fresh.gradsync[k], t)


def _drop(payload):
    del payload["gradsync"]  # what PRs 10-11 wrote


def _two_rows(payload):
    payload["gradsync"]["acc"] = {k: torch.cat([a, a]) for k, a in
                                  payload["gradsync"]["acc"].items()}


@pytest.mark.parametrize("edit, mode, logged", [
    (_drop, "quantized", "has no gradsync accumulators"),
    (None, "demo", "was saved under grad_sync='quantized', this run uses 'demo'"),
    (_two_rows, "quantized", "was saved by 2 processes, this run has 1"),
])
def test_restore_starts_the_accumulators_from_zeros(tmp_path, capsys, edit, mode, logged):
    """An older checkpoint with no accumulators, another mode's, or
    another world size's: the rest of the state restores, the accumulators
    restart from zeros, and the event is logged."""
    from moco_tpu_torch.checkpoint import restore_checkpoint

    mgr, state = _saved(tmp_path, edit)
    fresh = restore_checkpoint(mgr, _state(mode), 2)
    assert fresh.gradsync and all(not t.any() for t in fresh.gradsync.values())
    for k, v in state.model_q.state_dict().items():
        assert torch.equal(fresh.model_q.state_dict()[k], v)
    err = capsys.readouterr().err
    assert "[ckpt-dialect]" in err and logged in err


def test_mismatched_accumulators_raise(tmp_path):
    from moco_tpu_torch.checkpoint import restore_checkpoint

    def bad(payload):
        name = next(iter(payload["gradsync"]["acc"]))
        payload["gradsync"]["acc"][name] = torch.zeros(1, 3, 3)

    mgr, _ = _saved(tmp_path, bad)
    with pytest.raises(ValueError, match="accumulator shapes differ"):
        restore_checkpoint(mgr, _state("quantized"), 2)
