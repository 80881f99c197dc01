"""Cross-process BatchNorm (`PretrainConfig.sync_bn`) of the port, on the
CPU with gloo.

Each multi-process run is fresh one-thread processes
(`tests/torch_dist_worker.py`, torch only) under a time limit of its own.
Tolerances, stated up front:

- the BN layer at 2 and 4 ranks against one process's BN over the
  concatenated batch: f32 rtol 1e-5 / atol 1e-6 (output, running
  statistics, `dx`, the rank-summed `dscale`/`dbias`): the sums are taken
  in another order, nothing else differs;
- world 1: bit for bit (a SUM over one process is exact);
- an n-rank `sync_bn` step (n = 2, 4) against the one-process step at the
  same global batch, lr and weight decay: each loss and every final tensor
  (parameters, BN buffers, queue) within 4x what a 1e-6 nudge of the
  initial weights moves it in the one-process run, plus 1e-6. Global BN
  does not depend on the ShuffleBN permutation, so this gate holds whatever
  the permutation;
- 8 ranks against the JAX package's sync-BN step on `mesh8`
  (`tests/test_replication.py::test_sync_bn_step_runs`'s configuration, the
  JAX weights carried across by `weights.params_from_jax`) at `lr * 8`,
  `weight_decay / 8` (the JAX step sums its devices' gradients; see
  `tests/test_torch_distributed.py`): losses rtol 2e-4, every final tensor
  within 4x the nudge's movement plus 2e-5, as the v2 and v3 comparisons;
- every gradient-sync mode and ZeRO-1 under `sync_bn` at 2 ranks, held as
  `tests/test_torch_gradsync.py` and `tests/test_torch_zero.py` hold them
  without it: bucketed and ZeRO-1 equal fused bit for bit, the compressed
  modes within the JAX package's bands (int8 5%, bf16 2%, DeMo 50%).
"""

import os

import jax
import numpy as np
import pytest
import torch

from moco_tpu.config import PretrainConfig as JaxConfig
from moco_tpu.train_state import create_train_state as jax_create_train_state
from moco_tpu.train_step import build_encoder as jax_build_encoder
from moco_tpu.train_step import build_optimizer as jax_build_optimizer
from moco_tpu.train_step import build_train_step as jax_build_train_step
from moco_tpu_torch.config import PretrainConfig
from moco_tpu_torch.models.fast_bn import FastBatchNorm
from moco_tpu_torch.models.heads import BatchNorm1d
from moco_tpu_torch.train_step import build_encoder
from moco_tpu_torch.weights import params_from_jax
from torch_dist_worker import spawn

TIMEOUT = 180.0
B, IMG, DIM, K, SPE, STEPS = 16, 8, 16, 64, 8, 3
CONFIG = dict(variant="v1", arch="resnet_tiny", cifar_stem=True, num_negatives=K,
              embed_dim=DIM, batch_size=B, epochs=2, lr=0.1, seed=0)
SMALL_BUCKETS = dict(grad_sync_bucket_mb=0.01)
SYNC_RUNS = {
    "fused": dict(sync_bn=True),
    "bucketed": dict(sync_bn=True, grad_sync="bucketed", **SMALL_BUCKETS),
    "int8": dict(sync_bn=True, grad_sync="quantized", **SMALL_BUCKETS),
    "bf16": dict(sync_bn=True, grad_sync="quantized", grad_sync_quant_dtype="bfloat16"),
    "demo": dict(sync_bn=True, grad_sync="demo", grad_sync_topk=0.25),
    "zero": dict(sync_bn=True, zero_sharding=True),
    "v3": dict(sync_bn=True, variant="v3", optimizer="lars", lr=0.0, base_lr=0.3,
               weight_decay=1.5e-6, temperature=1.0, momentum_ema=0.99, warmup_epochs=1,
               cos=True),
}


def _load(out_dir, name, world):
    return [torch.load(os.path.join(out_dir, f"{name}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _images(steps=STEPS, seed=7):
    rng = np.random.RandomState(seed)
    return [(torch.from_numpy(rng.randn(B, IMG, IMG, 3).astype(np.float32)),
             torch.from_numpy(rng.randn(B, IMG, IMG, 3).astype(np.float32)))
            for _ in range(steps)]


def _spawn(tmp, world, runs, group=True, **data):
    """`run_bn_steps` over `runs` ({name: (overrides, nudge)}) in `world`
    processes; returns {name: [rank results]}."""
    tmp.mkdir(parents=True, exist_ok=True)
    inputs = tmp / "inputs.pt"
    torch.save({"config": CONFIG, "steps_per_epoch": SPE, "images": _images(),
                "runs": [(n, o, nudge) for n, (o, nudge) in runs.items()], **data}, inputs)
    spawn("run_bn_steps", world, (str(inputs), str(tmp)), TIMEOUT, group=group)
    return {n: _load(tmp, n, world) for n in runs}


def _assert_same(a, b, what=""):
    """Two runs equal bit for bit."""
    assert a["metrics"] == b["metrics"], what
    assert a["queue_ptr"] == b["queue_ptr"], what
    assert (a["queue"] is None and b["queue"] is None) or torch.equal(a["queue"], b["queue"])
    for which in ("q", "k"):
        assert a[which].keys() == b[which].keys()
        for key in a[which]:
            assert torch.equal(a[which][key], b[which][key]), (what, which, key)


def _assert_within_nudge(got, ref, base, nudged, slack, what=""):
    """Every final tensor of `got` (and the queue) within 4x what the 1e-6
    nudge moved it (`base` against `nudged`, one implementation's runs),
    plus `slack`, of `ref`."""
    pairs = [((which, key), got[which][key], r, base[which][key], nudged[which][key])
             for which in ("q", "k") for key, r in ref[which].items()]
    assert all(got[w].keys() == ref[w].keys() for w in ("q", "k"))
    pairs.append((("queue",), got["queue"], ref["queue"], base["queue"], nudged["queue"]))
    for name, g, r, a, b in pairs:
        floor = float((a - b).abs().max())
        diff = float((g - r).abs().max())
        assert diff <= 4 * floor + slack, (what, name, diff, floor)


# ---------------------------------------------------------------------------
# the BN layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_sync_bn_layer_equals_one_process_over_the_global_batch(tmp_path, world):
    rng = np.random.RandomState(world)
    c = 6
    x = torch.from_numpy(rng.randn(8, c, 5, 5).astype(np.float32) * 2 + 0.5)
    w = torch.from_numpy(rng.randn(8, c, 5, 5).astype(np.float32))
    scale = torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5)
    bias = torch.from_numpy(rng.randn(c).astype(np.float32))
    torch.save({"x": x, "w": w, "scale": scale, "bias": bias}, tmp_path / "inputs.pt")
    spawn("run_sync_bn_layer", world, (str(tmp_path / "inputs.pt"), str(tmp_path)), TIMEOUT)
    ranks = _load(tmp_path, "bn_layer", world)

    xs = x.clone().contiguous(memory_format=torch.channels_last).requires_grad_()
    bn = FastBatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(scale)
        bn.bias.copy_(bias)
    y = bn(xs)
    (y * w).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(torch.cat([r["y"] for r in ranks]).numpy(), y.detach().numpy(),
                               **tol)
    np.testing.assert_allclose(torch.cat([r["dx"] for r in ranks]).numpy(), xs.grad.numpy(),
                               **tol)
    for key, want in (("dscale", bn.weight.grad), ("dbias", bn.bias.grad)):
        got = torch.stack([r[key] for r in ranks]).sum(0)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **tol, err_msg=key)
    for r in ranks:
        np.testing.assert_allclose(r["running_mean"].numpy(), bn.running_mean.numpy(), **tol)
        np.testing.assert_allclose(r["running_var"].numpy(), bn.running_var.numpy(), **tol)
        # every rank normalized with the same statistics
        assert torch.equal(r["running_mean"], ranks[0]["running_mean"])


def test_sync_bn_layer_without_a_group_is_the_local_bn():
    """No group: the one-process path, and the local statistics."""
    x = torch.randn(4, 3, 2, 2).contiguous(memory_format=torch.channels_last)
    a, b = FastBatchNorm(3), FastBatchNorm(3, group=None)
    assert torch.equal(a(x), b(x))
    assert b.group is None


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def test_world_one_sync_bn_equals_per_process_bn_bit_for_bit(tmp_path):
    """A one-process group: the SUM over itself is exact, so `sync_bn` is
    the per-process step bit for bit; and with no group `sync_bn` is
    today's path."""
    grouped = _spawn(tmp_path / "group", 1, {"off": ({}, 0.0), "sync": ({"sync_bn": True}, 0.0)})
    _assert_same(grouped["off"][0], grouped["sync"][0])
    alone = _spawn(tmp_path / "alone", 1, {"sync": ({"sync_bn": True}, 0.0)}, group=False)
    _assert_same(grouped["off"][0], alone["sync"][0])


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The one-process step at the global batch, and its 1e-6-nudged twin."""
    runs = _spawn(tmp_path_factory.mktemp("one"), 1,
                  {"ref": ({}, 0.0), "nudged": ({}, 1e-6)}, group=False)
    return runs["ref"][0], runs["nudged"][0]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("two"), 2,
                  {n: (o, 0.0) for n, o in SYNC_RUNS.items()})


def _against_one_process(ranks, one_process, world):
    ref, nudged = one_process
    for r in ranks:
        for got, want, moved in zip(r["metrics"], ref["metrics"], nudged["metrics"]):
            floor = abs(want["loss"] - moved["loss"])
            assert abs(got["loss"] - want["loss"]) <= 4 * floor + 1e-6, (got, want, floor)
        assert r["queue_ptr"] == ref["queue_ptr"]
        _assert_within_nudge(r, ref, ref, nudged, 1e-6, f"{world} ranks")


def test_two_rank_sync_bn_step_equals_the_one_process_step(two_ranks, one_process):
    _against_one_process(two_ranks["fused"], one_process, 2)


def test_four_rank_sync_bn_step_equals_the_one_process_step(tmp_path, one_process):
    four = _spawn(tmp_path, 4, {"fused": ({"sync_bn": True}, 0.0)})
    _against_one_process(four["fused"], one_process, 4)
    for r in four["fused"][1:]:
        for key in r["q"]:
            assert torch.equal(r["q"][key], four["fused"][0]["q"][key]), key


def test_per_process_bn_differs_from_the_one_process_step(tmp_path, one_process):
    """The gate above has teeth: without `sync_bn` two ranks normalize over
    their halves, and the state leaves the nudge's band."""
    two = _spawn(tmp_path, 2, {"local": ({}, 0.0)})
    with pytest.raises(AssertionError):
        _against_one_process(two["local"], one_process, 2)


@pytest.mark.parametrize("mode", ["bucketed", "zero"])
def test_sync_bn_under_bucketed_and_zero_equals_fused_bit_for_bit(two_ranks, mode):
    """The BN all-reduces share the communicator with the bucketed sync's
    reduces launched from the backward, in the one autograd order every
    rank keeps: no hang, and the same bits as the fused sync (two ranks:
    each sum is one commutative add)."""
    for r in range(2):
        _assert_same(two_ranks["fused"][r], two_ranks[mode][r], mode)
    _assert_same(two_ranks[mode][0], two_ranks[mode][1], mode)


@pytest.mark.parametrize("run, band", [("int8", 0.05), ("bf16", 0.02), ("demo", 0.5)])
def test_sync_bn_under_compressed_modes_stays_within_the_jax_bands(two_ranks, run, band):
    fused = [m["loss"] for m in two_ranks["fused"][0]["metrics"]]
    for r in range(2):
        got = [m["loss"] for m in two_ranks[run][r]["metrics"]]
        assert all(np.isfinite(got))
        for a, b in zip(fused, got):
            assert abs(a - b) <= band * max(abs(a), 1.0), (fused, got)
        for key in two_ranks[run][r]["q"]:
            assert torch.equal(two_ranks[run][r]["q"][key], two_ranks[run][0]["q"][key])


def test_v3_backbone_syncs_and_its_heads_do_not(two_ranks):
    """(structure) every BN of the R50-type backbone holds the group, the
    projector's and predictor's BatchNorm1d have none (the JAX package's
    heads use `nn.BatchNorm` without `axis_name`); (run) a two-rank v3
    step under `sync_bn` is finite and every rank ends equal."""
    group = object()  # FastBatchNorm only holds it until a train-mode forward
    config = PretrainConfig(**{**CONFIG, **SYNC_RUNS["v3"]})
    model = build_encoder(config, group=group)
    backbone_bns = [m for m in model.backbone.modules() if isinstance(m, FastBatchNorm)]
    assert backbone_bns and all(m.group is group for m in backbone_bns)
    head_bns = [m for n in ("projector", "predictor")
                for m in getattr(model, n).modules() if isinstance(m, BatchNorm1d)]
    assert head_bns and not any(hasattr(m, "group") for m in head_bns)
    assert not any(isinstance(m, FastBatchNorm) for n in ("projector", "predictor")
                   for m in getattr(model, n).modules())
    ranks = two_ranks["v3"]
    for r in ranks:
        assert all(np.isfinite(m["loss"]) for m in r["metrics"])
        for key in r["q"]:
            assert torch.equal(r["q"][key], ranks[0]["q"][key]), key


@pytest.mark.parametrize("variant", ["v2", "v3"])
def test_sync_bn_keeps_the_fused_tail_off(variant):
    """`fused_bn_conv=True` with `sync_bn` builds no fused block (the JAX
    package ignores the fused tail under SyncBN), with or without a group;
    without `sync_bn` the same config fuses."""
    base = PretrainConfig(variant=variant, arch="resnet_tiny", fused_bn_conv=True,
                          embed_dim=DIM, num_negatives=K, batch_size=B)

    def fused_blocks(model):
        return [m for m in model.modules() if getattr(m, "fused_tail", False)]

    assert fused_blocks(build_encoder(base))
    for group in (None, object()):
        model = build_encoder(base.replace(sync_bn=True), group=group)
        assert not fused_blocks(model)
        bns = [m for m in model.modules() if isinstance(m, FastBatchNorm)]
        assert bns and all(m.group is group for m in bns)


def test_encoder_without_sync_bn_ignores_the_group():
    model = build_encoder(PretrainConfig(**CONFIG), group=object())
    assert all(m.group is None for m in model.modules() if isinstance(m, FastBatchNorm))


def test_sync_bn_flag_parses():
    import argparse

    from moco_tpu_torch.config import add_config_flags, collect_overrides

    parser = argparse.ArgumentParser()
    add_config_flags(parser)
    for text, value in (("true", True), ("false", False)):
        over = collect_overrides(parser.parse_args(["--sync-bn", text]))
        assert over == {"sync_bn": value}
    assert PretrainConfig().sync_bn is False
    assert JaxConfig().sync_bn is False


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def test_eight_ranks_match_the_jax_sync_bn_step(tmp_path, mesh8):
    """`test_sync_bn_step_runs`'s configuration on `mesh8`, two steps with
    the JAX step's own ShuffleBN permutations, against 8 gloo ranks of the
    port started from the same weights and queue."""
    jcfg = JaxConfig(**CONFIG, sync_bn=True)
    model = jax_build_encoder(jcfg)
    tx, sched = jax_build_optimizer(jcfg, SPE)
    state = jax_create_train_state(jax.random.key(0), model, tx, (B // 8, IMG, IMG, 3), K, DIM)
    sd = params_from_jax(_np(state.params_q), _np(state.batch_stats_q))
    queue = torch.from_numpy(np.array(state.queue))
    perms = [torch.from_numpy(np.array(jax.random.permutation(
        jax.random.fold_in(state.rng, i), B))).long() for i in range(2)]
    images = [(np.asarray(jax.random.normal(jax.random.key(1 + 2 * i), (B, IMG, IMG, 3))),
               np.asarray(jax.random.normal(jax.random.key(2 + 2 * i), (B, IMG, IMG, 3))))
              for i in range(2)]
    step = jax_build_train_step(jcfg, model, tx, mesh8, SPE, sched)
    losses = []
    for im_q, im_k in images:
        state, m = step(state, im_q, im_k)
        losses.append(float(m["loss"]))
    want = {"q": params_from_jax(_np(state.params_q), _np(state.batch_stats_q)),
            "k": params_from_jax(_np(state.params_k), _np(state.batch_stats_k)),
            "queue": torch.from_numpy(np.array(state.queue))}

    inputs = tmp_path / "inputs.pt"
    as_sums = dict(sync_bn=True, lr=CONFIG["lr"] * 8, weight_decay=1e-4 / 8)
    torch.save({"config": CONFIG, "steps_per_epoch": SPE, "state_dict": sd, "queue": queue,
                "perms": perms,
                "images": [(torch.from_numpy(q.copy()), torch.from_numpy(k.copy()))
                           for q, k in images],
                "runs": [("port", as_sums, 0.0), ("nudged", as_sums, 1e-6)]}, inputs)
    spawn("run_bn_steps", 8, (str(inputs), str(tmp_path)), TIMEOUT)
    port = _load(tmp_path, "port", 8)
    nudged = _load(tmp_path, "nudged", 8)[0]
    np.testing.assert_allclose([m["loss"] for m in port[0]["metrics"]], losses, rtol=2e-4)
    assert port[0]["queue_ptr"] == 2 * B
    _assert_within_nudge(port[0], want, port[0], nudged, 2e-5, "vs JAX")
    for r in port[1:]:
        _assert_same(port[0], r)
