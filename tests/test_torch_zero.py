"""ZeRO-1 of the port (`moco_tpu_torch/parallel/zero.py`) on the CPU with gloo.

The layout is held against the JAX package's `opt_state_shardings` on the
`mesh8` fixture; the sharded step against the port's own plain SGD step
(the JAX package's step sums the devices' gradients, see
tests/test_torch_distributed.py); the checkpoints against themselves at
other world sizes and with ZeRO off. Each multi-process run is a fresh
group of one-thread processes (`tests/torch_dist_worker.py`) under a time
limit.
"""

import jax.numpy as jnp
import numpy as np
import torch

from moco_tpu.parallel.mesh import DATA_AXIS
from moco_tpu.parallel.zero import opt_state_shardings
from moco_tpu_torch.parallel.zero import shard_axis
from torch_dist_worker import spawn

TIMEOUT = 180.0
B, IMG, DIM, K, SPE = 16, 16, 16, 64, 8
CONFIG = dict(variant="v1", arch="resnet_tiny", cifar_stem=True, num_negatives=K,
              embed_dim=DIM, batch_size=B, epochs=2, lr=0.1, seed=0)
STEPS = 3
RUNS = [("plain", {}, STEPS, False), ("zero", dict(zero_sharding=True), STEPS, False)]


def _load(out_dir, name, world):
    return [torch.load(out_dir / f"{name}_rank{r}.pt", weights_only=False)
            for r in range(world)]


def _spawn_runs(tmp, world):
    rng = np.random.RandomState(11)
    images = [(torch.from_numpy(rng.randn(B, IMG, IMG, 3).astype(np.float32)),
               torch.from_numpy(rng.randn(B, IMG, IMG, 3).astype(np.float32)))
              for _ in range(STEPS)]
    inputs = tmp / "inputs.pt"
    torch.save({"config": CONFIG, "steps_per_epoch": SPE, "images": images, "runs": RUNS},
               inputs)
    spawn("run_modes", world, (str(inputs), str(tmp)), TIMEOUT)
    return {name: _load(tmp, name, world) for name, *_ in RUNS}


SHAPES = [(), (0,), (3,), (8,), (64,), (7, 5), (16, 24), (24, 16), (64, 3, 7, 7),
          (128, 2048), (3, 3, 16, 16), (2048, 1000), (10, 10, 8)]


def test_layout_is_the_jax_packages(mesh8):
    """Each buffer split on its largest axis the world size divides, else
    whole: the JAX package's `opt_state_shardings` on 8 devices."""
    tree = {str(i): jnp.zeros(s) for i, s in enumerate(SHAPES)}
    specs = opt_state_shardings(tree, mesh8)
    for i, shape in enumerate(SHAPES):
        spec = tuple(specs[str(i)].spec)
        want = spec.index(DATA_AXIS) if DATA_AXIS in spec else None
        assert shard_axis(shape, 8) == want, shape
    assert shard_axis((6, 4), 2) == 0 and shard_axis((4, 6), 2) == 1
    assert shard_axis((4, 4), 4) == 0 and shard_axis((3, 5), 2) is None


def _assert_same(a, b):
    assert a["metrics"] == b["metrics"]
    assert torch.equal(a["queue"], b["queue"])
    for which in ("q", "k"):
        for key in a[which]:
            assert torch.equal(a[which][key], b[which][key]), (which, key)
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and sa
    for i in sa:
        assert torch.equal(sa[i]["momentum_buffer"], sb[i]["momentum_buffer"]), i


def test_zero_equals_plain_bit_for_bit_at_two_ranks(tmp_path):
    """The same elementwise update on each slice, then a gather of the
    slices: the parameters, and the momentum gathered whole, equal the
    plain SGD's bit for bit."""
    runs = _spawn_runs(tmp_path, 2)
    for r in range(2):
        _assert_same(runs["plain"][r], runs["zero"][r])
    assert runs["zero"][0]["momentum_bytes"] < 0.6 * runs["plain"][0]["momentum_bytes"]


def test_zero_at_four_ranks_holds_a_quarter_of_the_momentum(tmp_path):
    """Bit for bit at 4 ranks too, which is more than the rtol 1e-5 / atol
    1e-6 asked of it: the gradients are the same fused mean, and each
    element's update is the same arithmetic on the same values wherever its
    slice lies. Each rank holds under 0.4x the momentum bytes."""
    runs = _spawn_runs(tmp_path, 4)
    for r in range(4):
        plain, zero = runs["plain"][r], runs["zero"][r]
        _assert_same(plain, zero)
        assert zero["momentum_bytes"] < 0.4 * plain["momentum_bytes"]


TRAIN = dict(variant="v2", arch="resnet_tiny", mlp_head=True, temperature=0.2, aug_plus=True,
             cos=True, dataset="synthetic", image_size=16, batch_size=8, num_negatives=32,
             embed_dim=16, epochs=4, lr=0.03, seed=3, print_freq=1, staging_workers=2,
             zero_sharding=True)
TRAIN_N = 16


def test_zero_checkpoint_round_trips_and_restores_anywhere(tmp_path):
    """A 4-rank ZeRO `train()` saves the whole momentum at step 2; resumed
    at 4 ranks it equals the uninterrupted run bit for bit; the same
    checkpoint restores at 2 ranks with ZeRO and in one process without
    it, each holding the saved momentum whole."""
    from moco_tpu_torch.checkpoint import checkpoint_manager

    out, ckpt = str(tmp_path), str(tmp_path / "ckpt")
    spawn("run_train", 4, (TRAIN, out, "whole", 4, TRAIN_N), TIMEOUT)
    spawn("run_train", 4, ({**TRAIN, "ckpt_dir": ckpt}, out, "first", 2, TRAIN_N), TIMEOUT)
    spawn("run_train", 4, ({**TRAIN, "ckpt_dir": ckpt, "resume": "auto"}, out, "resumed", 4,
                           TRAIN_N), TIMEOUT)
    whole, first, resumed = (_load(tmp_path, n, 4) for n in ("whole", "first", "resumed"))
    saved = checkpoint_manager(ckpt).restore(2)["optimizer"]["state"]
    for i, s in first[0]["optimizer"]["state"].items():
        assert torch.equal(saved[i]["momentum_buffer"], s["momentum_buffer"])
    for r in range(4):
        assert resumed[r]["history"][-1] == whole[r]["history"][-1]
        for which in ("q", "k"):
            for k in whole[r][which]:
                assert torch.equal(resumed[r][which][k], whole[r][which][k]), (which, k)
        for i, s in whole[r]["optimizer"]["state"].items():
            assert torch.equal(resumed[r]["optimizer"]["state"][i]["momentum_buffer"],
                               s["momentum_buffer"])
    # max_steps 2: the restored state itself, no step taken
    spawn("run_train", 2, ({**TRAIN, "ckpt_dir": ckpt, "resume": "2"}, out, "two", 2,
                           TRAIN_N), TIMEOUT)
    spawn("run_train", 1, ({**TRAIN, "ckpt_dir": ckpt, "resume": "2", "zero_sharding": False},
                           out, "alone", 2, TRAIN_N), TIMEOUT, group=False)
    for run in _load(tmp_path, "two", 2) + _load(tmp_path, "alone", 1):
        assert run["step"] == 2
        state = run["optimizer"]["state"]
        assert state.keys() == saved.keys()
        for i in saved:
            assert torch.equal(state[i]["momentum_buffer"], saved[i]["momentum_buffer"])
