"""The port's data-parallel pretrain across processes, on the CPU with gloo.

Each multi-process test runs its ranks as fresh processes with one thread
each (`tests/torch_dist_worker.py`, torch only) under a time limit of its
own. The inputs come from the JAX package in this process:

- 8 ranks of 2 samples each, with the JAX step's own permutations injected
  (`jax.random.permutation(jax.random.fold_in(state.rng, step), 16)`),
  reproduce `tests/test_golden.py`'s 8-device losses; every rank ends with
  the same parameters, BN statistics and queue, bit for bit;
- `shuffle_mode="ring"` on 8 ranks matches the JAX package's 8-device ring
  step, run here on the `mesh8` fixture;
- `collective_chunks` 2 and 4 equal 1 bit for bit, and a one-rank group
  equals no group bit for bit;
- a 2-rank `train()`: disjoint and exhaustive rank shards, crops that do
  not depend on the world size, one checkpoint stamped `devices: 2`, and a
  resumed run equal to an uninterrupted one.

The JAX package's step applies the SUM of the devices' gradients, not their
mean: under jax 0.9's shard_map the gradient of a replicated parameter
comes out already summed over the devices, and `GradSync`'s `pmean` of
that replicated value returns it unchanged (`test_jax_step_sums_gradients`
below shows it). The port takes the mean, as the reference's DDP does. The
two are the same update at other hyperparameters: with `g = n * mean`,
`d = g + wd * p = n * (mean + wd / n * p)`, the momentum buffer scales by n,
and `lr * buf` is `(n * lr) * (buf / n)`. So the n-rank comparisons run the
port at `lr * n` and `weight_decay / n`; for n a power of two these
scalings are exact in binary floating point.
"""

import json
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
from moco_tpu_torch.checkpoint import read_recorded_devices
from moco_tpu_torch.weights import params_from_jax
from torch_dist_worker import spawn

GLOBAL_B, IMG, DIM, K, SPE = 16, 8, 16, 64, 8
GOLDEN_8DEV = [0.016187, 2.8706696, 3.7958486]  # tests/test_golden.py
CONFIG = dict(variant="v1", arch="resnet_tiny", cifar_stem=True, num_negatives=K,
              embed_dim=DIM, batch_size=GLOBAL_B, epochs=2, lr=0.1, seed=0)
TIMEOUT = 180.0


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _jax_run(mesh, shuffle_mode="permute"):
    """Three JAX steps on `mesh`: (initial state as port tensors, queue,
    images, the permutation of each step, losses)."""
    cfg = JaxConfig(**CONFIG, shuffle_mode=shuffle_mode)
    model = jax_build_encoder(cfg)
    tx, sched = jax_build_optimizer(cfg, SPE)
    state = jax_create_train_state(jax.random.key(0), model, tx,
                                   (GLOBAL_B // mesh.size, IMG, IMG, 3), K, DIM)
    sd = params_from_jax(_np(state.params_q), _np(state.batch_stats_q))
    queue = torch.from_numpy(np.array(state.queue))
    perms = [torch.from_numpy(np.array(jax.random.permutation(
        jax.random.fold_in(state.rng, i), GLOBAL_B))).long() for i in range(3)]
    images = [(np.asarray(jax.random.normal(jax.random.key(100 + i), (GLOBAL_B, IMG, IMG, 3))),
               np.asarray(jax.random.normal(jax.random.key(200 + i), (GLOBAL_B, IMG, IMG, 3))))
              for i in range(3)]
    step = jax_build_train_step(cfg, model, tx, mesh, SPE, sched)
    losses = []
    for im_q, im_k in images:
        state, m = step(state, im_q, im_k)
        losses.append(float(m["loss"]))
    images = [(torch.from_numpy(q.copy()), torch.from_numpy(k.copy())) for q, k in images]
    return sd, queue, images, perms, losses


@pytest.fixture(scope="module")
def jax_permute(mesh8):
    return _jax_run(mesh8)


def _as_jax_sums(world):
    """The port's hyperparameters for the JAX package's update on `world`
    devices (see the module docstring)."""
    return dict(lr=CONFIG["lr"] * world, weight_decay=1e-4 / world)


def test_jax_step_sums_gradients(mesh8):
    """The reference-side fault the n-rank comparisons correct for: one
    row per device, a local mean loss, and `GradSync` returns the sum of
    the rows, not their mean."""
    from jax.sharding import PartitionSpec as P

    from moco_tpu.parallel.gradsync import GradSync
    from moco_tpu.parallel.mesh import DATA_AXIS
    from moco_tpu.utils.compat import shard_map

    gradsync = GradSync(JaxConfig(), 8)
    x = jax.numpy.arange(24, dtype=jax.numpy.float32).reshape(8, 3)

    def region(w, x):
        g = jax.grad(lambda w: jax.numpy.mean(x @ w))(w)
        return gradsync.region_reduce({"w": g}, {}, jax.numpy.int32(0))[0]["w"]

    got = shard_map(region, mesh=mesh8, in_specs=(P(), P(DATA_AXIS)), out_specs=P())(
        jax.numpy.ones(3), x)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(x).sum(0))


def _inputs(tmp_path, jax_run, perms=True, **config):
    sd, queue, images, jperms, _ = jax_run
    path = str(tmp_path / "inputs.pt")
    torch.save({"config": {**CONFIG, **config}, "state_dict": sd, "queue": queue,
                "images": images, "perms": jperms if perms else None,
                "steps_per_epoch": SPE}, path)
    return path


def _load(out_dir, name, world):
    return [torch.load(os.path.join(out_dir, f"{name}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _assert_same(a, b, what=""):
    """Two runs' results equal bit for bit."""
    assert a["metrics"] == b["metrics"], what
    assert a["queue_ptr"] == b["queue_ptr"], what
    assert torch.equal(a["queue"], b["queue"]), what
    for which in ("q", "k"):
        assert a[which].keys() == b[which].keys()
        for key in a[which]:
            assert torch.equal(a[which][key], b[which][key]), (what, which, key)


def test_eight_ranks_reproduce_the_8_device_golden(tmp_path, jax_permute):
    spawn("run_steps", 8, (_inputs(tmp_path, jax_permute, **_as_jax_sums(8)), str(tmp_path)),
          TIMEOUT)
    ranks = _load(tmp_path, "steps_chunksNone", 8)
    losses = [m["loss"] for m in ranks[0]["metrics"]]
    np.testing.assert_allclose(losses, GOLDEN_8DEV, rtol=2e-4, err_msg=str(losses))
    np.testing.assert_allclose(losses, jax_permute[4], rtol=2e-4)
    assert [m["queue_ptr"] for m in ranks[0]["metrics"]] == [16, 32, 48]
    for r in ranks[1:]:
        _assert_same(ranks[0], r)
    # the enqueued keys are unit rows of the whole global batch
    rows = ranks[0]["queue"][:48]
    np.testing.assert_allclose(rows.norm(dim=1).numpy(), 1.0, rtol=1e-5)


def test_ring_mode_matches_the_jax_8_device_ring_step(tmp_path, mesh8):
    run = _jax_run(mesh8, "ring")
    spawn("run_steps", 8, (_inputs(tmp_path, run, perms=False, shuffle_mode="ring",
                                   **_as_jax_sums(8)), str(tmp_path)), TIMEOUT)
    ranks = _load(tmp_path, "steps_chunksNone", 8)
    losses = [m["loss"] for m in ranks[0]["metrics"]]
    np.testing.assert_allclose(losses, run[4], rtol=2e-4, err_msg=str(losses))
    for r in ranks[1:]:
        _assert_same(ranks[0], r)


@pytest.mark.parametrize("mode", ["permute", "ring"])
def test_collective_chunks_equal_one_chunk_bit_for_bit(tmp_path, jax_permute, mode):
    """2 ranks of 8 samples: 2 and 4 chunks divide the local batch."""
    spawn("run_steps", 2, (_inputs(tmp_path, jax_permute, perms=False, shuffle_mode=mode),
                           str(tmp_path), (1, 2, 4)), TIMEOUT)
    for r in range(2):
        one = _load(tmp_path, "steps_chunks1", 2)[r]
        for chunks in (2, 4):
            _assert_same(one, _load(tmp_path, f"steps_chunks{chunks}", 2)[r], chunks)


def test_one_rank_group_equals_no_group_bit_for_bit(tmp_path, jax_permute):
    inputs = _inputs(tmp_path, jax_permute, perms=False)
    (tmp_path / "group").mkdir()
    (tmp_path / "alone").mkdir()
    spawn("run_steps", 1, (inputs, str(tmp_path / "group")), TIMEOUT)
    spawn("run_steps", 1, (inputs, str(tmp_path / "alone")), TIMEOUT, group=False)
    group = _load(tmp_path / "group", "steps_chunksNone", 1)[0]
    _assert_same(group, _load(tmp_path / "alone", "steps_chunksNone", 1)[0])
    # and the 1-device golden: the one-rank group is the one-card step
    np.testing.assert_allclose([m["loss"] for m in group["metrics"]],
                               [0.0279795, 2.8311126, 3.4929943], rtol=2e-4)


TRAIN_B, TRAIN_N = 8, 16  # two global batches an epoch: each epoch covers the set
TRAIN = dict(variant="v2", arch="resnet_tiny", mlp_head=True, temperature=0.2, aug_plus=True,
             cos=True, dataset="synthetic", image_size=16, batch_size=TRAIN_B,
             num_negatives=32, embed_dim=16, epochs=4, lr=0.03, seed=3, print_freq=1,
             staging_workers=2)


def _epoch_batches(epoch):
    from moco_tpu_torch.data.loader import epoch_permutation

    return epoch_permutation(TRAIN_N, epoch, TRAIN["seed"], TRAIN_B).reshape(-1, TRAIN_B)


def test_two_rank_train_shards_crops_checkpoint_and_resume(tmp_path):
    out = str(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    spawn("run_train", 2, (TRAIN, out, "whole", 4, TRAIN_N), TIMEOUT)
    spawn("run_train", 1, (TRAIN, out, "alone", 4, TRAIN_N), TIMEOUT, group=False)
    spawn("run_train", 2, ({**TRAIN, "ckpt_dir": ckpt}, out, "first", 2, TRAIN_N), TIMEOUT)
    # one checkpoint, by rank 0, stamped with the world size
    assert sorted(os.listdir(ckpt)) == [".integrity", ".position", "2"]
    assert read_recorded_devices(ckpt, 2) == 2
    with open(os.path.join(ckpt, ".position", "2.json")) as f:
        assert json.load(f) == {"epoch": 1, "batch": 0, "devices": 2}
    spawn("run_train", 2, ({**TRAIN, "ckpt_dir": ckpt, "resume": "auto"}, out, "resumed", 4,
                           TRAIN_N), TIMEOUT)
    whole, alone, resumed = (_load(out, n, w) for n, w in
                             (("whole", 2), ("alone", 1), ("resumed", 2)))
    # the rank shards: disjoint, and together each step's global batch
    # of the epoch's permutation, every sample once an epoch
    for s in range(4):
        a, b = whole[0]["seen"][s], whole[1]["seen"][s]
        assert not set(a) & set(b)
        assert a + b == _epoch_batches(s // 2)[s % 2].tolist()
        assert alone[0]["seen"][s] == a + b
    # the crops do not depend on the world size
    for s in range(4):
        for v in range(2):
            joined = torch.cat([whole[0]["views"][s][v], whole[1]["views"][s][v]])
            assert torch.equal(joined, alone[0]["views"][s][v]), (s, v)
    # the resumed run equals the uninterrupted one, on every rank
    for r in range(2):
        assert resumed[r]["step"] == whole[r]["step"] == 4
        assert resumed[r]["history"][-1] == whole[r]["history"][-1]
        _assert_same({**resumed[r], "metrics": None}, {**whole[r], "metrics": None})
    _assert_same({**whole[0], "metrics": None}, {**whole[1], "metrics": None})
    # a restore at another world size: one process resumes the 2-rank state
    spawn("run_train", 1, ({**TRAIN, "ckpt_dir": ckpt, "resume": "2"}, out, "regrouped", 3,
                           TRAIN_N), TIMEOUT, group=False)
    regrouped = _load(out, "regrouped", 1)[0]
    assert regrouped["step"] == 3 and regrouped["queue_ptr"] == 24
    assert regrouped["seen"][0] == _epoch_batches(1)[0].tolist()


@pytest.mark.parametrize("field, value, match", [
    ("grad_sync_bucket_mb", -1.0, "grad_sync_bucket_mb"),
    ("grad_sync_quant_dtype", "fp8", "unknown grad_sync_quant_dtype"),
    ("grad_sync_cadence", -2, "grad_sync_cadence"),
    ("grad_sync", "nope", "unknown grad_sync"),
    ("grad_allreduce_dtype", "int8", "unknown grad_allreduce_dtype"),
    ("shuffle_mode", "swap", "unknown shuffle_mode"),
    ("collective_chunks", 0, "collective_chunks"),
    ("health_stride", -1, "health_stride must be >= 0"),
    ("collapse_emb_std", 0.01, "collapse_emb_std needs health_stride > 0"),
    ("trace_mode", "verbose", "unknown trace_mode"),
])
def test_config_rejects_what_is_not_ported(field, value, match):
    from moco_tpu_torch.config import PretrainConfig

    with pytest.raises(ValueError, match=match):
        PretrainConfig(**{field: value})


def test_config_accepts_collapse_rollback():
    """Refused until the rollback was ported; `tests/test_torch_resilience_driver.py`
    drives it into the rollback."""
    from moco_tpu_torch.config import PretrainConfig

    assert PretrainConfig(collapse_margin=0.01, collapse_rollback=True).collapse_rollback


def test_local_batch_size_and_ring_checks():
    from moco_tpu_torch.parallel.collectives import ring_shuffle
    from moco_tpu_torch.parallel.mesh import local_batch_size

    assert local_batch_size(256, 8) == 32
    with pytest.raises(ValueError, match="not divisible"):
        local_batch_size(10, 4)
    x = torch.arange(6.0).reshape(3, 2)
    with pytest.raises(ValueError, match="even local batch"):
        ring_shuffle(x, None)
    assert torch.equal(ring_shuffle(x[:2], None), x[:2])  # one process: the identity


def test_gradient_mean_in_each_wire_dtype(tmp_path):
    """Two ranks: the float32 wire gives the f32 mean, the bfloat16 wire
    the bf16 sum of the bf16-rounded tensors halved in bf16 (the JAX
    package's `pmean` on the wire dtype), each cast back to f32; both
    ranks hold the same bits."""
    spawn("run_mean", 2, (str(tmp_path),), TIMEOUT)
    ranks = _load(tmp_path, "mean", 2)
    shapes = ((3, 5), (7,), (2, 2, 2))
    drawn = []
    for r in range(2):
        gen = torch.Generator().manual_seed(r)
        drawn.append([torch.randn(s, generator=gen) for s in shapes])
    for wire, dtype, nbytes in (("float32", torch.float32, 4 * 30),
                                ("bfloat16", torch.bfloat16, 2 * 30)):
        for r in range(2):
            got, sent = ranks[r][wire]
            assert sent == nbytes
            for g, a, b in zip(got, *drawn):
                want = ((a.to(dtype) + b.to(dtype)) / 2).float()
                assert g.dtype == torch.float32 and torch.equal(g, want), wire
        assert all(torch.equal(a, b) for a, b in zip(ranks[0][wire][0], ranks[1][wire][0]))


def test_driver_main_under_torchrun_variables(tmp_path):
    """`python -m moco_tpu_torch.train` as torchrun starts it: each process
    joins from RANK/WORLD_SIZE/LOCAL_RANK/MASTER_ADDR/MASTER_PORT (env://),
    only rank 0 prints, and the global batch of 16 advances the queue by 16
    a step."""
    argv = ["--preset", "imagenet-moco-v2", "--dataset", "synthetic", "--arch",
            "resnet_tiny", "--image-size", "32", "--batch-size", "16", "--num-negatives",
            "64", "--embed-dim", "16", "--max-steps", "2", "--print-freq", "1",
            "--device", "cpu"]
    spawn("run_main", 2, (argv, str(tmp_path)), TIMEOUT, group="env")
    main = (tmp_path / "main_rank0.txt").read_text()
    assert "2 process(es)" in main
    assert "step 2 loss" in main and "queue_ptr 32" in main
    assert (tmp_path / "main_rank1.txt").read_text() == ""
