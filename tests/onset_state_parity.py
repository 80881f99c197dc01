"""The port's MoCo-v1 step against a reference, leaf by leaf of the whole
training state, at a rung of `tests/onset_cpu_pair.py` (by default R3: the
horizon's resnet18 at 32 px, B=64, K=4096, embed 128, wd 1e-4, f32).

Two references:

- `--reference jax` (CPU only): the JAX package's one-device step, from
  the JAX driver's initial state (its init key, model and input shape,
  carried over by `moco_tpu_torch/weights.py::params_from_jax`), on the
  JAX package's v1 `two_crops` of the texture images; the port runs on
  the CPU.
- `--reference cpu --device cuda` (torch only, so it runs on the card's
  machine): the port's own step on the CPU, from the port's initial state,
  on the port's v1 `two_crops` drawn on the CPU; the port runs on the card
  with the precision policy of its entry points (TF32 off), so the card
  path (its kernels, cuDNN) is what differs.

Each runs N steps of the reference, N of the port, and N of the port on
the CPU from the same weights nudged by 1e-6 (relative). After each step
it maps every state to the port's names and compares every leaf:

- `q/`, `k/`: both encoders' parameters (the key encoder's are the EMA)
  and BN buffers (running mean and variance);
- `mom/`: SGD's momentum buffer of each query parameter (the gradient
  with the weight decay folded in: optax's `trace`, torch's
  `momentum_buffer`);
- `queue`: the negatives after the enqueue.

With d(run) a leaf's change since the run's own start (for `mom/`, the
buffer itself), it prints per leaf `err`, |d(port) - d(ref)| / |d(ref)|,
and `noise`, |d(cpu port) - d(nudged cpu port)| / |d(ref)|: how far the
nudge alone carries the steps' change of the leaf. A leaf the reference
left bit for bit where it was (the key encoder at step 1, whose EMA
averages two equal encoders) is measured against its own norm instead (an
all-zero one, a BN shift there, in absolute terms; the port's EMA rounds
twice, so against `--reference cpu` that leaf moves by rounding alone and
its `noise` is of order 1). A leaf whose `err` is
many times its `noise` differs in the step (a weight-decay mask, a
buffer's update, an EMA), not by float rounding.

    python tests/onset_state_parity.py --rung R3 --steps 3 --log runs/onset_state_parity_cpu_R3.log
    python tests/onset_state_parity.py --rung R3 --steps 3 --reference cpu --device cuda

Not collected by pytest.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import onset_cpu_pair as pair  # noqa: E402
from moco_tpu_torch.data import augment as aug  # noqa: E402
from moco_tpu_torch.data.datasets import SyntheticTextureDataset  # noqa: E402
from moco_tpu_torch.train_state import create_train_state  # noqa: E402
from moco_tpu_torch.train_step import build_encoder, build_train_step  # noqa: E402
from moco_tpu_torch.utils.device import set_precision_policy  # noqa: E402


def batches(rung, steps: int) -> list[np.ndarray]:
    """The first `steps` batches of the rung's texture images (uint8 NHWC)."""
    data = SyntheticTextureDataset(num_samples=rung.batch * steps, image_size=pair.IMAGE_SIZE,
                                   num_classes=16)
    return [data.get_batch(np.arange(i * rung.batch, (i + 1) * rung.batch))[0]
            for i in range(steps)]


def jax_reference(rung_name: str, seed: int, steps: int):
    """(views, the port's initial state dict, queue, the JAX state's leaves
    at the start and after each step), all from the JAX package."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import optax

    from moco_tpu.data import augment as jaug
    from moco_tpu.parallel.mesh import create_mesh
    from moco_tpu.train_state import create_train_state as jax_create_train_state
    from moco_tpu.train_step import build_encoder as jax_build_encoder
    from moco_tpu.train_step import build_optimizer as jax_build_optimizer
    from moco_tpu.train_step import build_train_step as jax_build_train_step
    from moco_tpu_torch.weights import params_from_jax

    jax.config.update("jax_platforms", "cpu")

    def _np(tree):
        return jax.tree.map(lambda a: np.array(a, np.float32), tree)

    def leaves(jstate) -> dict[str, np.ndarray]:
        out = {}
        for side, params, stats in (("q", jstate.params_q, jstate.batch_stats_q),
                                    ("k", jstate.params_k, jstate.batch_stats_k)):
            for name, v in params_from_jax(_np(params), _np(stats)).items():
                out[f"{side}/{name}"] = v.numpy()
        trace = [s for s in jax.tree.leaves(jstate.opt_state, is_leaf=lambda s: isinstance(
            s, optax.TraceState)) if isinstance(s, optax.TraceState)]
        assert len(trace) == 1, trace
        for name, v in params_from_jax(_np(trace[0].trace)).items():
            out[f"mom/{name}"] = v.numpy()
        out["queue"] = np.array(jstate.queue, np.float32)
        return out

    rung = pair.RUNGS[rung_name]
    spe, _, _ = pair.schedule(rung)
    jcfg = pair.jax_config(rung_name, seed)
    aug_cfg = jaug.v1_aug_config(pair.IMAGE_SIZE)
    views = []
    for i, images in enumerate(batches(rung, steps)):
        q, k = jaug.two_crops(jax.numpy.asarray(images), jax.random.key(1000 + i), aug_cfg)
        views.append((np.asarray(q, np.float32), np.asarray(k, np.float32)))
    jmodel = jax_build_encoder(jcfg)
    tx, sched = jax_build_optimizer(jcfg, spe)
    shape = (rung.batch, pair.IMAGE_SIZE, pair.IMAGE_SIZE, 3)
    jstate = jax_create_train_state(jax.random.key(jcfg.seed), jmodel, tx, shape,
                                    jcfg.num_negatives, jcfg.embed_dim)
    out = [leaves(jstate)]
    sd = params_from_jax(_np(jstate.params_q), _np(jstate.batch_stats_q))
    queue = np.array(jstate.queue)
    jstep = jax_build_train_step(jcfg, jmodel, tx, create_mesh(1), spe, sched)
    for q, k in views:
        jstate, _ = jstep(jstate, q, k)
        out.append(leaves(jstate))
    return views, sd, queue, out


def port_start(cfg, steps: int, rung):
    """(views, initial state dict, queue), all from the port, on the CPU."""
    state = create_train_state(cfg, build_encoder(cfg), "cpu", seed=cfg.seed)
    generator = torch.Generator().manual_seed(1000)
    views = []
    for images in batches(rung, steps):
        q, k = aug.two_crops(torch.from_numpy(images), aug.v1_aug_config(pair.IMAGE_SIZE),
                             generator)
        views.append((q.numpy().copy(), k.numpy().copy()))
    sd = {n: v.detach().clone() for n, v in state.model_q.state_dict().items()}
    return views, sd, state.queue.detach().numpy().copy()


def port_leaves(state) -> dict[str, np.ndarray]:
    def host(t):
        return t.detach().float().cpu().numpy().copy()

    out = {}
    for side, model in (("q", state.model_q), ("k", state.model_k)):
        for name, v in model.state_dict().items():
            if not name.endswith("num_batches_tracked"):
                out[f"{side}/{name}"] = host(v)
    for name, p in state.model_q.named_parameters():
        buf = state.optimizer.state[p].get("momentum_buffer")
        if buf is not None:
            out[f"mom/{name}"] = host(buf)
    out["queue"] = host(state.queue)
    return out


def port_run(cfg, spe, sd, queue, views, device="cpu") -> list[dict[str, np.ndarray]]:
    """The port's leaves at the start and after each step on `device`."""
    state = create_train_state(cfg, build_encoder(cfg), device, seed=cfg.seed)
    state.model_q.load_state_dict(sd)
    state.model_k.load_state_dict(sd)
    state.queue.copy_(torch.from_numpy(queue))
    step = build_train_step(cfg, spe)
    out = [port_leaves(state)]
    for q, k in views:
        step(state, torch.from_numpy(q.copy()).to(device), torch.from_numpy(k.copy()).to(device))
        out.append(port_leaves(state))
    return out


def _norm(a) -> float:
    return float(np.linalg.norm(a.astype(np.float64).ravel()))


def compare(ref0, ref_n, port0, port_n, cpu0, cpu_n, nudged0, nudged_n
            ) -> list[tuple[str, float, float]]:
    """(leaf, err, noise) for every leaf, as the module docstring defines them."""
    rows = []
    for name, r in ref_n.items():
        if name not in port_n:
            raise KeyError(f"the port has no leaf {name}")
        moved = {run: n[name] - (0.0 if name.startswith("mom/") else z[name])
                 for run, z, n in (("ref", ref0, ref_n), ("port", port0, port_n),
                                   ("cpu", cpu0, cpu_n), ("nudged", nudged0, nudged_n))}
        scale = _norm(moved["ref"]) or _norm(r) or 1.0
        rows.append((name, _norm(moved["port"] - moved["ref"]) / scale,
                     _norm(moved["cpu"] - moved["nudged"]) / scale))
    missing = set(port_n) - set(ref_n)
    if missing:
        raise KeyError(f"the reference has no leaves {sorted(missing)[:5]}")
    return rows


def group_of(name: str) -> str:
    """`q/conv`, `k/bn.weight`, `mom/fc`, ... for the summary."""
    if name == "queue":
        return "queue"
    side, rest = name.split("/", 1)
    leaf = rest.rsplit(".", 1)[-1]
    kind = "bn" if "bn" in rest else "fc" if rest.startswith("fc") else "conv"
    return f"{side}/{kind}.{leaf}"


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--rung", choices=sorted(pair.RUNGS), default="R3")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reference", choices=["jax", "cpu"], default="jax")
    p.add_argument("--device", default="cpu", help="the port's under test")
    p.add_argument("--log", default="", help="also write every leaf's row here")
    a = p.parse_args(argv)
    if a.reference == "cpu" and a.device == "cpu":
        p.error("--reference cpu holds the port on another --device against the CPU")
    set_precision_policy()
    torch.manual_seed(0)
    rung = pair.RUNGS[a.rung]
    spe, _, _ = pair.schedule(rung)
    cfg = pair.port_config(a.rung, a.seed)
    if a.reference == "jax":
        views, sd, queue, ref_steps = jax_reference(a.rung, a.seed, a.steps)
    else:
        views, sd, queue = port_start(cfg, a.steps, rung)
    cpu_steps = port_run(cfg, spe, sd, queue, views)
    if a.reference == "cpu":
        ref_steps = cpu_steps
    port_steps = cpu_steps if a.device == "cpu" else port_run(cfg, spe, sd, queue, views,
                                                              a.device)
    noise = torch.Generator().manual_seed(1)
    nudged = {n: (v * (1 + 1e-6 * torch.randn(v.shape, generator=noise))
                  if v.is_floating_point() else v) for n, v in sd.items()}
    nudged_steps = port_run(cfg, spe, nudged, queue, views)

    lines = [f"{cfg.arch} @{pair.IMAGE_SIZE}px, B={rung.batch}, K={cfg.num_negatives}, "
             f"dim {cfg.embed_dim}, lr {cfg.lr}, wd {cfg.weight_decay}, m {cfg.momentum_ema}, "
             f"rung {a.rung}, seed {a.seed}, port on {a.device} against {a.reference}, "
             f"{len(ref_steps[-1])} leaves; err = |d(port)-d(ref)|/|d(ref)|, "
             f"noise = |d(cpu port)-d(nudged)|/|d(ref)|"]
    every = []
    for n in range(1, a.steps + 1):
        rows = compare(ref_steps[0], ref_steps[n], port_steps[0], port_steps[n],
                       cpu_steps[0], cpu_steps[n], nudged_steps[0], nudged_steps[n])
        every += [(n, *r) for r in rows]
        groups: dict[str, list] = {}
        for name, err, nz in rows:
            groups.setdefault(group_of(name), []).append((err, nz, name))
        lines.append(f"step {n}: group  leaves  max err (leaf)  max noise  "
                     "leaves with err > 10 x noise")
        for g in sorted(groups):
            rs = groups[g]
            worst = max(rs)
            over = sum(1 for err, nz, _ in rs if err > 10 * nz and err > 1e-6)
            lines.append(f"  {g:<26} {len(rs):>3}  {worst[0]:.3e} ({worst[2]})  "
                         f"{max(nz for _, nz, _ in rs):.3e}  {over}")
    for line in lines:
        print(line, flush=True)
    if a.log:
        with open(a.log, "w") as f:
            f.write("\n".join(lines) + "\n")
            f.write("step leaf err noise\n")
            for n, name, err, nz in every:
                f.write(f"{n} {name} {err:.6e} {nz:.6e}\n")


if __name__ == "__main__":
    main()
