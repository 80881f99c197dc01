"""ZeRO-1 of the port for AdamW and LARS (`moco_tpu_torch/parallel/zero.py`)
on the CPU with gloo.

The layout is held against the JAX package's `opt_state_shardings` over an
optax AdamW and LARS state on the `mesh8` fixture; the sharded optimizers
against the port's own plain `AdamW` and `LARS` (`ops/optim.py`) over the
same parameters and gradients at 2 and 4 ranks; a ZeRO checkpoint taken at 4
ranks restored at 2 and without ZeRO; and a v3 step at 2 ranks with
`zero_sharding` on and off. Each multi-process run is a fresh group of
one-thread processes (`tests/torch_dist_worker.py`) under a time limit: one
group of 4 and one of 2 for the whole file.

Tolerances, stated before the first run:
- `ShardedAdamW` equals `AdamW` bit for bit (an elementwise update on each
  slice, the same f32 bias corrections).
- `ShardedLARS`: after 5 steps on random parameters and gradients at unit
  scale, max |p_zero - p_plain| <= 1e-6 * max |p| for every parameter (the
  norms of split parameters add their squares in another order than
  `torch.linalg.vector_norm` of the whole tensor).
- The v3 step's LARS leg: each final tensor within 4x what a 1e-6 nudge of
  the weights moves it, plus 2e-5 (the calibration of
  tests/test_torch_sync_bn.py); its AdamW leg bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moco_tpu.parallel.mesh import DATA_AXIS
from moco_tpu.parallel.zero import opt_state_shardings
from moco_tpu_torch.ops.optim import LARS, AdamW
from moco_tpu_torch.parallel.zero import shard_axis
from torch_dist_worker import spawn

TIMEOUT = 180.0
STEPS, CKPT_STEPS = 5, 3
LARS_RTOL = 1e-6
# divisible by 2 and 4 on some axis, by neither, 1-D and scalar-like shapes:
# each kind of split and whole parameter, ndim > 1 (trust ratio) and not
SHAPES = [(8, 12), (12, 5, 3, 3), (7, 5), (16,), (6,), (3,), (4, 4, 2), (5, 9, 8)]
OPTIMIZERS = {"adamw": dict(lr=3e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1),
              "lars": dict(lr=0.3, weight_decay=1e-4, momentum=0.9)}
IMG, DIM, B = 8, 16, 16
V3 = dict(variant="v3", arch="resnet50", embed_dim=DIM, batch_size=B,
          epochs=2, warmup_epochs=1, cos=True, momentum_ema=0.99, temperature=1.0, seed=0)
V3_LEGS = {"adamw": dict(optimizer="adamw", lr=1e-3, weight_decay=0.1),
           "lars": dict(optimizer="lars", lr=0.0, base_lr=0.3, weight_decay=1.5e-6)}


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    params = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in SHAPES]
    grads = [[torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in SHAPES]
             for _ in range(STEPS)]
    return params, grads


def _v3_inputs():
    rng = np.random.RandomState(7)
    images = [(torch.from_numpy(rng.randn(B, IMG, IMG, 3).astype(np.float32)),
               torch.from_numpy(rng.randn(B, IMG, IMG, 3).astype(np.float32)))
              for _ in range(2)]
    runs = []
    for leg, over in V3_LEGS.items():
        runs += [(f"v3_{leg}_off", over, 0.0),
                 (f"v3_{leg}_zero", {**over, "zero_sharding": True}, 0.0)]
    runs.append(("v3_lars_nudged", V3_LEGS["lars"], 1e-6))
    return {"config": V3, "steps_per_epoch": 2, "images": images, "runs": runs,
            "model": dict(arch="resnet", embed_dim=DIM, hidden_dim=32)}


def _load(tmp, name, world):
    return [torch.load(tmp / f"{name}_rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The 4-rank group's runs, then the 2-rank group's (which restores the
    4-rank ZeRO checkpoint and runs the v3 legs)."""
    params, grads = _inputs()
    out = {}
    tmp4 = tmp_path_factory.mktemp("zero4")
    torch.save({"params": params, "grads": grads, "optimizers": OPTIMIZERS,
                "ckpt_steps": CKPT_STEPS}, tmp4 / "inputs.pt")
    spawn("run_zero_optimizers", 4, (str(tmp4 / "inputs.pt"), str(tmp4)), TIMEOUT)
    out[4] = _load(tmp4, "zero_optimizers", 4)
    tmp2 = tmp_path_factory.mktemp("zero2")
    v3 = _v3_inputs()
    torch.save({"params": params, "grads": grads, "optimizers": OPTIMIZERS,
                "ckpt_steps": CKPT_STEPS, "v3": v3,
                "resume": {name: out[4][0][name]["ckpt"] for name in OPTIMIZERS}},
               tmp2 / "inputs.pt")
    spawn("run_zero_optimizers", 2, (str(tmp2 / "inputs.pt"), str(tmp2)), TIMEOUT)
    out[2] = _load(tmp2, "zero_optimizers", 2)
    out["v3"] = {name: _load(tmp2, name, 2) for name, _, _ in v3["runs"]}
    return out


def _plain_run(name, start, grads, state=None):
    params = [torch.nn.Parameter(t.clone()) for t in start]
    opt = {"adamw": AdamW, "lars": LARS}[name](params, **OPTIMIZERS[name])
    if state is not None:
        opt.load_state_dict(state)
    for step_grads in grads:
        for p, g in zip(params, step_grads):
            p.grad = g.clone()
        opt.step()
    return [p.detach() for p in params], opt.state_dict()


def _assert_states(a, b, exact=True):
    assert a["state"].keys() == b["state"].keys() and a["state"]
    for i in a["state"]:
        sa, sb = a["state"][i], b["state"][i]
        assert sa.keys() == sb.keys()
        for key in sa:
            if isinstance(sa[key], torch.Tensor):
                assert sa[key].shape == sb[key].shape, (i, key)
                if exact:
                    assert torch.equal(sa[key], sb[key]), (i, key)
                else:
                    scale = float(sb[key].abs().max()) or 1.0
                    assert float((sa[key] - sb[key]).abs().max()) <= LARS_RTOL * scale, (i, key)
            else:
                assert sa[key] == sb[key], (i, key)


def _assert_params(got, want, exact):
    for i, (g, w) in enumerate(zip(got, want)):
        if exact:
            assert torch.equal(g, w), i
        else:
            assert float((g - w).abs().max()) <= LARS_RTOL * float(w.abs().max()), i


def test_adamw_and_lars_layouts_are_the_jax_packages(mesh8):
    """Each moment and momentum split on its parameter's largest axis the
    world size divides, else whole, and AdamW's count whole: the JAX
    package's `opt_state_shardings` over optax's AdamW and LARS states."""
    tree = {str(i): jnp.zeros(s) for i, s in enumerate(SHAPES + [(16, 24), (2048, 1000)])}
    for opt in (optax.adamw(1e-3, weight_decay=0.1), optax.lars(0.3, momentum=0.9)):
        state = opt.init(tree)
        specs = opt_state_shardings(state, mesh8)
        checked = 0
        for path, sharding in jax.tree_util.tree_leaves_with_path(specs):
            names = [getattr(k, "key", getattr(k, "name", None)) for k in path]
            key = next((n for n in names if isinstance(n, str) and n.isdigit()), None)
            spec = tuple(sharding.spec)
            axis = spec.index(DATA_AXIS) if DATA_AXIS in spec else None
            if key is None:  # the count
                assert axis is None
                continue
            assert shard_axis(tree[key].shape, 8) == axis, (names, spec)
            checked += 1
        assert checked >= len(tree)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_adamw_equals_plain_bit_for_bit(groups, world):
    for rank in groups[world]:
        rec = rank["adamw"]
        _assert_params(rec["zero"], rec["plain"], exact=True)
        _assert_states(rec["zero_state"], rec["plain_state"], exact=True)
        assert rec["zero_state"]["state"][0]["step"] == STEPS


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_lars_within_its_stated_tolerance(groups, world):
    """One all-reduce of the [2, n_split] sums a step; the parameters and
    the gathered momentum within LARS_RTOL of the plain LARS, and equal on
    every rank."""
    ranks = groups[world]
    for rank in ranks:
        rec = rank["lars"]
        _assert_params(rec["zero"], rec["plain"], exact=False)
        _assert_states(rec["zero_state"], rec["plain_state"], exact=False)
        _assert_params(rec["zero"], ranks[0]["lars"]["zero"], exact=True)
    diff = max(float((z - p).abs().max() / p.abs().max())
               for z, p in zip(ranks[0]["lars"]["zero"], ranks[0]["lars"]["plain"]))
    print(f"LARS at {world} ranks: max |dp| / max |p| = {diff:.3e}")


def test_four_ranks_hold_a_quarter_of_the_split_state(groups):
    """Every SHAPES entry but (7, 5), (6,) and (3,) splits at 4: each rank
    holds under 0.4x the plain state's bytes, at 2 ranks under 0.65x."""
    for world, limit in ((4, 0.4), (2, 0.65)):
        for rank in groups[world]:
            for name in OPTIMIZERS:
                rec = rank[name]
                assert rec["zero_bytes"] < limit * rec["plain_bytes"], (world, name)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_zero_checkpoint_restores_at_another_world_size_and_without_zero(groups, name):
    """The 4-rank ZeRO state dict after 3 steps is the plain optimizer's
    layout, whole; restored at 2 ranks with ZeRO and in one process
    without it, two more steps end where the uninterrupted runs end (AdamW
    bit for bit, LARS within its tolerance)."""
    exact = name == "adamw"
    params, grads = _inputs()
    ckpt = groups[4][0][name]["ckpt"]
    for rank in groups[4]:
        _assert_states(rank[name]["ckpt"]["optimizer"], ckpt["optimizer"], exact=True)
    mid, mid_state = _plain_run(name, params, grads[:CKPT_STEPS])
    _assert_params(ckpt["params"], mid, exact)
    _assert_states(ckpt["optimizer"], mid_state, exact)
    whole, whole_state = _plain_run(name, params, grads)
    for rank in groups[2]:
        _assert_params(rank[name]["resumed"], whole, exact)
        _assert_states(rank[name]["resumed_state"], whole_state, exact)
    alone, alone_state = _plain_run(name, ckpt["params"], grads[CKPT_STEPS:],
                                    state=ckpt["optimizer"])
    _assert_params(alone, whole, exact)
    _assert_states(alone_state, whole_state, exact)


@pytest.mark.parametrize("leg", sorted(V3_LEGS))
def test_v3_step_at_two_ranks_with_zero_on_and_off(groups, leg):
    runs = groups["v3"]
    for r in range(2):
        off, zero = runs[f"v3_{leg}_off"][r], runs[f"v3_{leg}_zero"][r]
        assert all(np.isfinite(m["loss"]) for m in zero["metrics"])
        if leg == "adamw":
            assert zero["metrics"] == off["metrics"]
            for which in ("q", "k"):
                for key in off[which]:
                    assert torch.equal(zero[which][key], off[which][key]), (which, key)
            continue
        assert zero["metrics"][0] == off["metrics"][0]  # before any update
        nudged = runs["v3_lars_nudged"][r]
        for which in ("q", "k"):
            for key, ref in off[which].items():
                floor = float((ref - nudged[which][key]).abs().max())
                diff = float((zero[which][key] - ref).abs().max())
                assert diff <= 4 * floor + 2e-5, (which, key, diff, floor)
