"""The worker processes of tests/test_torch_distributed.py.

Torch only (no JAX, nothing of `moco_tpu`), so that each gloo process starts
fast: the test prepares its inputs with the JAX package, saves them with
`torch.save`, and `spawn` runs one of the targets below in `world` processes,
each with one thread, joined in a gloo group over a `FileStore` (or given
torchrun's variables, for the driver's `main` to join by `env://`). Each
target saves what it computed for the test to compare.
"""

from __future__ import annotations

import contextlib
import os
import socket
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as mp


def _entry(rank: int, world: int, rendezvous: str | None, target: str, args: tuple) -> None:
    torch.set_num_threads(1)
    from moco_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed

    if rendezvous is not None and rendezvous.startswith("file://"):
        init_distributed("cpu", rank=rank, world_size=world, init_method=rendezvous,
                         timeout_s=120)
    elif rendezvous is not None:  # torchrun's environment; the target joins
        host, port = rendezvous.split(":")
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                          MASTER_ADDR=host, MASTER_PORT=port)
    try:
        globals()[target](*args)
    finally:
        shutdown_distributed()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(target: str, world: int, args: tuple, timeout: float = 180.0,
          group: bool | str = True) -> None:
    """Run `target(*args)` in `world` fresh processes, in one gloo group
    over a FileStore (`group=False`: one process with none; `group="env"`:
    torchrun's variables set, for a target that joins the group itself);
    raise if one fails or the whole run outlasts `timeout` seconds, and
    leave no process behind."""
    if not group and world != 1:
        raise ValueError("only one process can run without a group")
    with tempfile.TemporaryDirectory(prefix="gloo_") as tmp:
        rendezvous = (None if not group else f"127.0.0.1:{_free_port()}" if group == "env"
                      else f"file://{os.path.join(tmp, 'store')}")
        ctx = mp.start_processes(_entry, args=(world, rendezvous, target, args),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{target} in {world} processes outlasted {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)


def _group():
    from moco_tpu_torch.parallel.mesh import process_group

    return process_group()


def _out(out_dir: str, name: str) -> str:
    from moco_tpu_torch.parallel.mesh import rank

    return os.path.join(out_dir, f"{name}_rank{rank(_group())}.pt")


def run_steps(inputs: str, out_dir: str, chunk_counts: tuple = (None,)) -> None:
    """Steps of the port from the initial state and images of `inputs`,
    this process on its rows of each global batch; once for each
    `collective_chunks` in `chunk_counts` (None: the config's)."""
    from moco_tpu_torch.config import PretrainConfig
    from moco_tpu_torch.parallel.mesh import rank, world_size
    from moco_tpu_torch.train_state import create_train_state
    from moco_tpu_torch.train_step import build_encoder, build_train_step

    data = torch.load(inputs, weights_only=False)
    group = _group()
    b = data["images"][0][0].shape[0] // world_size(group)
    r = rank(group)
    perms = data["perms"]
    perm_fn = None if perms is None else (lambda step, n: perms[step])
    for chunks in chunk_counts:
        config = PretrainConfig(**data["config"])
        if chunks is not None:
            config = config.replace(collective_chunks=chunks)
        state = create_train_state(config, build_encoder(config, group=group), "cpu", seed=0)
        state.model_q.load_state_dict(data["state_dict"])
        state.model_k.load_state_dict(data["state_dict"])
        state.queue.copy_(data["queue"])
        step = build_train_step(config, data["steps_per_epoch"], group=group, perm_fn=perm_fn)
        metrics = []
        for im_q, im_k in data["images"]:
            m = step(state, im_q[r * b:(r + 1) * b], im_k[r * b:(r + 1) * b])
            metrics.append({k: float(v) for k, v in m.items()})
        torch.save({"metrics": metrics, "q": state.model_q.state_dict(),
                    "k": state.model_k.state_dict(), "queue": state.queue.clone(),
                    "queue_ptr": state.queue_ptr},
                   _out(out_dir, f"steps_chunks{chunks}"))


class IndexedImages:
    """`n` random uint8 images whose first pixel spells their index, labels
    = index: what a step consumed can be read back from its crops' source."""

    def __init__(self, n: int, size: int, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.images = rng.randint(0, 256, size=(n, size, size, 3)).astype(np.uint8)
        self.images[:, 0, 0, 0] = np.arange(n) % 256
        self.images[:, 0, 0, 1] = np.arange(n) // 256
        self.labels = np.arange(n, dtype=np.int32)
        self.num_classes = n
        self.image_size = size

    def __len__(self) -> int:
        return len(self.images)

    def get_batch(self, indices):
        idx = np.asarray(indices)
        b = len(idx)
        extents = np.tile(np.asarray([[self.image_size, self.image_size, 0]], np.int32),
                          (b, 1))
        return self.images[idx], self.labels[idx], extents


def run_train(config_kw: dict, out_dir: str, name: str, max_steps: int,
              n_images: int) -> None:
    """`train()` on `IndexedImages`, recording each step's source indices
    and both views; saves them with the final state (the optimizer's in
    the plain SGD's layout, and this process's gradient-sync
    accumulators)."""
    import moco_tpu_torch.train as driver
    from moco_tpu_torch.config import PretrainConfig

    config = PretrainConfig(**config_kw)
    seen, views = [], []
    two_crops = driver.two_crops

    def recording(images, *args, **kw):
        im_q, im_k = two_crops(images, *args, **kw)
        px = images[:, 0, 0].long()
        seen.append((px[:, 0] + 256 * px[:, 1]).tolist())
        views.append((im_q.clone(), im_k.clone()))
        return im_q, im_k

    driver.two_crops = recording
    state, history = driver.train(config, max_steps=max_steps, device="cpu",
                                  dataset=IndexedImages(n_images, config.image_size),
                                  on_step=lambda *a: None)
    torch.save({"seen": seen, "views": views, "history": history, "step": state.step,
                "q": state.model_q.state_dict(), "k": state.model_k.state_dict(),
                "queue": state.queue.clone(), "queue_ptr": state.queue_ptr,
                "optimizer": state.optimizer.state_dict(),
                "gradsync": {k: v.clone() for k, v in state.gradsync.items()}},
               _out(out_dir, name))


def run_mean(out_dir: str) -> None:
    """`mean_tensors_` over the group in each wire dtype, on tensors drawn
    from this rank's seed."""
    from moco_tpu_torch.parallel.gradsync import leaf_wire_dtype, mean_tensors_
    from moco_tpu_torch.parallel.mesh import rank

    out = {}
    for wire in ("float32", "bfloat16"):
        gen = torch.Generator().manual_seed(rank(_group()))
        ts = [torch.randn(shape, generator=gen) for shape in ((3, 5), (7,), (2, 2, 2))]
        nbytes = mean_tensors_(ts, _group(), lambda dt: leaf_wire_dtype(dt, wire))
        out[wire] = (ts, nbytes)
    torch.save(out, _out(out_dir, "mean"))


def run_main(argv: list, out_dir: str) -> None:
    """The driver's `main` as torchrun starts it, its standard output kept."""
    from moco_tpu_torch import train

    path = os.path.join(out_dir, f"main_rank{os.environ['RANK']}.txt")
    with open(path, "w") as f, contextlib.redirect_stdout(f):
        train.main(argv)


def run_modes(inputs: str, out_dir: str) -> None:
    """For each `(name, config overrides, steps, snapshots)` of `inputs`'
    runs: the port's state from its seed, the gradient sync's accumulators
    attached, `steps` steps on this process's rows of the saved images;
    saves the losses, both encoders, the queue, the full optimizer state,
    the accumulators, the momentum bytes this process holds, and (with
    `snapshots`) the query encoder after each step."""
    from moco_tpu_torch.config import PretrainConfig
    from moco_tpu_torch.parallel.gradsync import GradSync
    from moco_tpu_torch.parallel.mesh import rank, world_size
    from moco_tpu_torch.train_state import create_train_state
    from moco_tpu_torch.train_step import build_encoder, build_train_step

    data = torch.load(inputs, weights_only=False)
    group = _group()
    n, r = world_size(group), rank(group)
    for name, overrides, steps, snapshots in data["runs"]:
        config = PretrainConfig(**{**data["config"], **overrides})
        state = create_train_state(config, build_encoder(config, group=group), "cpu", seed=0,
                                   group=group)
        GradSync(config, group).attach(state)
        step = build_train_step(config, data["steps_per_epoch"], group=group)
        losses, snaps = [], []
        for im_q, im_k in data["images"][:steps]:
            b = im_q.shape[0] // n
            m = step(state, im_q[r * b:(r + 1) * b], im_k[r * b:(r + 1) * b])
            losses.append(float(m["loss"]))
            if snapshots:
                snaps.append({k: v.clone() for k, v in state.model_q.state_dict().items()})
        optimizer = state.optimizer
        momentum_bytes = (optimizer.state_bytes() if hasattr(optimizer, "state_bytes")
                          else sum(s["momentum_buffer"].numel() * 4
                                   for s in optimizer.state.values()))
        torch.save({"metrics": losses, "q": state.model_q.state_dict(),
                    "k": state.model_k.state_dict(), "queue": state.queue.clone(),
                    "queue_ptr": state.queue_ptr, "optimizer": optimizer.state_dict(),
                    "gradsync": {k: v.clone() for k, v in state.gradsync.items()},
                    "momentum_bytes": momentum_bytes, "snapshots": snaps},
                   _out(out_dir, name))


def run_functions(inputs: str, out_dir: str) -> None:
    """The reduces of `parallel/collectives.py` and DeMo's sync of
    `parallel/gradsync.py` on this process's slices of the saved per-rank
    inputs: `quantized_mean` in int8 (with its int32 sum and each
    segment's int8 values) and bf16, the starvation bucket (0.1 and 1e-5
    leaves), and `GradSync.finish` of mode demo at step 0 on a module whose
    gradients and accumulators are the saved ones."""
    from types import SimpleNamespace

    from moco_tpu_torch.config import PretrainConfig
    from moco_tpu_torch.parallel.collectives import quantized_mean
    from moco_tpu_torch.parallel.gradsync import GradSync
    from moco_tpu_torch.parallel.mesh import rank

    data = torch.load(inputs, weights_only=False)
    group = _group()
    r = rank(group)
    segs = [torch.from_numpy(a[r].copy()) for a in data["segments"]]
    out = {}
    for wire in ("int8", "bfloat16"):
        pending = quantized_mean(segs, group, wire, async_op=True)
        means, errs = pending.wait()
        out[wire] = {"means": means, "errs": errs, "summed": pending.summed,
                     "qs": pending.qs}
    out["starve"] = quantized_mean([torch.full((64,), 0.1), torch.full((64,), 1e-5)], group,
                                   "int8")[0]
    module = torch.nn.Module()
    for name, g in data["demo_grads"].items():
        module.register_parameter(name, torch.nn.Parameter(torch.zeros(g.shape[1:])))
        getattr(module, name).grad = torch.from_numpy(g[r].copy())
    state = SimpleNamespace(model_q=module, gradsync_mode="demo", step=0, gradsync={
        name: torch.from_numpy(a[r].copy()) for name, a in data["demo_acc"].items()})
    config = PretrainConfig(grad_sync="demo", grad_sync_topk=data["topk"],
                            grad_sync_demo_beta=data["beta"])
    GradSync(config, group).finish(state)
    out["demo"] = {"delta": {n: p.grad.clone() for n, p in module.named_parameters()},
                   "acc": {n: a.clone() for n, a in state.gradsync.items()}}
    torch.save(out, _out(out_dir, "functions"))


def _v3_model(spec: dict):
    """The tiny V3Model of `spec`: a `vit_tiny` or a 2-stage Bottleneck
    ResNet backbone with the heads."""
    from moco_tpu_torch.models import resnet, vit
    from moco_tpu_torch.v3_step import V3Model

    if spec["arch"] == "vit_tiny":
        backbone = vit.build_vit("vit_tiny", image_size=spec["image_size"])
    else:
        backbone = resnet.ResNet((1, 1), resnet.Bottleneck, width=8, num_classes=None)
    return V3Model(backbone, embed_dim=spec["embed_dim"], hidden_dim=spec["hidden_dim"])


def run_v3_steps(inputs: str, out_dir: str) -> None:
    """v3 steps of the port from the saved initial weights, this process on
    its rows of each global batch: saves each step's metrics, the synced
    gradient of the first step (before the optimizer; the step leaves it
    in `.grad`), this process's keys of the first batch's view 1 from the
    initial key model, and both models at the end."""
    import copy

    from moco_tpu_torch.config import PretrainConfig
    from moco_tpu_torch.ops.losses import l2_normalize
    from moco_tpu_torch.parallel.gradsync import GradSync
    from moco_tpu_torch.parallel.mesh import rank, world_size
    from moco_tpu_torch.train_state import create_train_state
    from moco_tpu_torch.train_step import build_train_step

    data = torch.load(inputs, weights_only=False)
    group = _group()
    n, r = world_size(group), rank(group)
    config = PretrainConfig(**data["config"])
    state = create_train_state(config, _v3_model(data["model"]), "cpu", seed=0, group=group)
    GradSync(config, group).attach(state)
    sd = data["state_dict"]
    state.model_q.load_state_dict(sd)
    state.model_k.load_state_dict({k: v for k, v in sd.items()
                                   if not k.startswith("predictor.")})
    b = data["images"][0][0].shape[0] // n
    with torch.no_grad():
        keys = l2_normalize(copy.deepcopy(state.model_k)(data["images"][0][0][r * b:(r + 1) * b]))
    step = build_train_step(config, data["steps_per_epoch"], group=group)
    metrics, grads = [], None
    for x1, x2 in data["images"]:
        m = step(state, x1[r * b:(r + 1) * b], x2[r * b:(r + 1) * b])
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {k: p.grad.clone() for k, p in state.model_q.named_parameters()
                     if p.grad is not None}
    torch.save({"metrics": metrics, "grads": grads, "keys": keys,
                "q": state.model_q.state_dict(), "k": state.model_k.state_dict()},
               _out(out_dir, "v3"))


def run_preempted(config_kw: dict, out_dir: str, steps: int, n_images: int,
                  chaos_rank: int, chaos_spec: str) -> None:
    """Three `train()` runs in this group on `IndexedImages`: `steps` steps
    uninterrupted; then, into `config_kw`'s `ckpt_dir`, the same with the
    chaos plan of `chaos_spec` installed on rank `chaos_rank` alone; then a
    resume of it to `steps`. Saves each run's final step, history and
    state."""
    import moco_tpu_torch.train as driver
    from moco_tpu_torch.config import PretrainConfig
    from moco_tpu_torch.parallel.mesh import rank
    from moco_tpu_torch.resilience import chaos_context, parse_chaos_spec

    config = PretrainConfig(**config_kw)
    data = IndexedImages(n_images, config.image_size)
    quiet = dict(device="cpu", dataset=data, on_step=lambda *a: None)
    out = {}
    whole, _ = driver.train(config.replace(ckpt_dir=""), max_steps=steps, **quiet)
    out["whole"] = whole
    if rank(_group()) == chaos_rank:
        with chaos_context(parse_chaos_spec(chaos_spec)):
            cut, cut_history = driver.train(config, max_steps=steps, **quiet)
    else:
        cut, cut_history = driver.train(config, max_steps=steps, **quiet)
    out["steps_after_cut"] = sorted(int(n) for n in os.listdir(config.ckpt_dir) if n.isdigit())
    resumed, _ = driver.train(config.replace(resume="auto"), max_steps=steps, **quiet)
    for name, state in (("whole", whole), ("cut", cut), ("resumed", resumed)):
        out[name] = {"step": state.step, "q": state.model_q.state_dict(),
                     "k": state.model_k.state_dict(), "queue": state.queue.clone(),
                     "queue_ptr": state.queue_ptr, "optimizer": state.optimizer.state_dict(),
                     "generators": (state.generator.get_state(),
                                    state.data_generator.get_state())}
    out["cut_history"] = cut_history
    torch.save(out, _out(out_dir, "preempted"))


def run_sync_bn_layer(inputs: str, out_dir: str) -> None:
    """One train-mode `FastBatchNorm` over this process's rows of the saved
    global batch, with the group (`sync_bn`): saves its output, running
    statistics and the gradients of `sum(y * w)` (this rank's rows of `w`)."""
    from moco_tpu_torch.models.fast_bn import FastBatchNorm
    from moco_tpu_torch.parallel.mesh import rank, world_size

    data = torch.load(inputs, weights_only=False)
    group = _group()
    n, r = world_size(group), rank(group)
    b = data["x"].shape[0] // n
    rows = slice(r * b, (r + 1) * b)
    x = data["x"][rows].clone().contiguous(memory_format=torch.channels_last).requires_grad_()
    bn = FastBatchNorm(x.shape[1], group=group)
    with torch.no_grad():
        bn.weight.copy_(data["scale"])
        bn.bias.copy_(data["bias"])
    y = bn(x)
    (y * data["w"][rows]).sum().backward()
    torch.save({"y": y.detach(), "running_mean": bn.running_mean.clone(),
                "running_var": bn.running_var.clone(), "dx": x.grad.clone(),
                "dscale": bn.weight.grad.clone(), "dbias": bn.bias.grad.clone()},
               _out(out_dir, "bn_layer"))


def run_bn_steps(inputs: str, out_dir: str) -> None:
    """For each `(name, overrides, nudge)` of `inputs`' runs: the port's
    state (from the saved `state_dict` and `queue` where there are, else
    from the seed; the query parameters scaled by `1 + nudge * N(0, 1)`
    where `nudge`, the key model a copy), the gradient sync attached, the
    encoder's BNs on the group when the config says `sync_bn`, and a step on
    this process's rows of each saved global batch (with the saved ShuffleBN
    permutations where there are). Saves the metrics, both encoders, the
    queue and the optimizer state."""
    from moco_tpu_torch.config import PretrainConfig
    from moco_tpu_torch.parallel.gradsync import GradSync
    from moco_tpu_torch.parallel.mesh import rank, world_size
    from moco_tpu_torch.train_state import create_train_state
    from moco_tpu_torch.train_step import build_encoder, build_train_step

    data = torch.load(inputs, weights_only=False)
    group = _group()
    n, r = world_size(group), rank(group)
    perms = data.get("perms")
    perm_fn = None if perms is None else (lambda step, size: perms[step])
    for name, overrides, nudge in data["runs"]:
        config = PretrainConfig(**{**data["config"], **overrides})
        state = create_train_state(config, build_encoder(config, group=group), "cpu", seed=0,
                                   group=group)
        GradSync(config, group).attach(state)
        if data.get("state_dict") is not None:
            state.model_q.load_state_dict(data["state_dict"])
            state.queue.copy_(data["queue"])
        if nudge:
            noise = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for p in state.model_q.parameters():
                    p.mul_(1 + nudge * torch.randn(p.shape, generator=noise))
        if data.get("state_dict") is not None or nudge:
            state.model_k.load_state_dict(state.model_q.state_dict(), strict=False)
        step = build_train_step(config, data["steps_per_epoch"], group=group,
                                perm_fn=None if config.variant == "v3" else perm_fn)
        metrics = []
        for im_q, im_k in data["images"]:
            b = im_q.shape[0] // n
            m = step(state, im_q[r * b:(r + 1) * b], im_k[r * b:(r + 1) * b])
            metrics.append({k: float(v) for k, v in m.items()})
        torch.save({"metrics": metrics, "q": state.model_q.state_dict(),
                    "k": state.model_k.state_dict(),
                    "queue": None if state.queue is None else state.queue.clone(),
                    "queue_ptr": state.queue_ptr,
                    "optimizer": state.optimizer.state_dict()},
                   _out(out_dir, name))


def run_zero_optimizers(inputs: str, out_dir: str) -> None:
    """For each optimizer of `inputs` (`adamw`, `lars`): its plain version
    and its ZeRO-1 version over the group (`parallel/zero.py`), each over
    the saved parameters and each step's saved gradients (the same on every
    process). Saves both runs' final parameters and full state dicts, the
    state bytes each holds, and the sharded run's parameters and full state
    dict after `ckpt_steps` (a ZeRO checkpoint); where `inputs` carries a
    checkpoint of another world size, the sharded run restored from it and
    taken to the end. Then the v3 steps of `inputs`' `v3` runs."""
    import copy

    from moco_tpu_torch.ops.optim import LARS, AdamW
    from moco_tpu_torch.parallel.zero import ShardedAdamW, ShardedLARS

    data = torch.load(inputs, weights_only=False)
    group = _group()
    classes = {"adamw": (AdamW, ShardedAdamW), "lars": (LARS, ShardedLARS)}

    def run(make, start_params, grads, state=None, ckpt_steps=None):
        params = [torch.nn.Parameter(t.clone()) for t in start_params]
        opt = make(params)
        if state is not None:
            opt.load_state_dict(state)
        ckpt = None
        for t, step_grads in enumerate(grads):
            for p, g in zip(params, step_grads):
                p.grad = g.clone()
            opt.step()
            if t + 1 == ckpt_steps:
                # a copy: the state dict holds the live tensors of whole parameters
                ckpt = {"params": [p.detach().clone() for p in params],
                        "optimizer": copy.deepcopy(opt.state_dict())}
        return params, opt, ckpt

    out = {}
    for name, kw in data["optimizers"].items():
        plain_cls, sharded_cls = classes[name]
        grads = data["grads"]
        plain, plain_opt, _ = run(lambda ps: plain_cls(ps, **kw), data["params"], grads)
        zero, zero_opt, ckpt = run(lambda ps: sharded_cls(ps, group, **kw), data["params"],
                                   grads, ckpt_steps=data["ckpt_steps"])
        rec = {"plain": [p.detach() for p in plain], "zero": [p.detach() for p in zero],
               "plain_state": plain_opt.state_dict(), "zero_state": zero_opt.state_dict(),
               "plain_bytes": sum(v.numel() * v.element_size()
                                  for s in plain_opt.state.values() for v in s.values()
                                  if isinstance(v, torch.Tensor)),
               "zero_bytes": zero_opt.state_bytes(), "ckpt": ckpt}
        resume = data.get("resume", {}).get(name)
        if resume is not None:
            resumed, resumed_opt, _ = run(lambda ps: sharded_cls(ps, group, **kw),
                                          resume["params"], grads[data["ckpt_steps"]:],
                                          state=resume["optimizer"])
            rec["resumed"] = [p.detach() for p in resumed]
            rec["resumed_state"] = resumed_opt.state_dict()
        out[name] = rec
    torch.save(out, _out(out_dir, "zero_optimizers"))
    if data.get("v3"):
        _run_v3_legs(data["v3"], group, out_dir)


def _run_v3_legs(v3: dict, group, out_dir: str) -> None:
    """For each `(name, overrides, nudge)` of `v3["runs"]`: the tiny
    V3Model of `v3["model"]` from its seed (its parameters scaled by
    `1 + nudge * N(0, 1)` where `nudge`, the key model a copy), the gradient
    sync attached, and a v3 step on this process's rows of each saved
    global batch. Saves the metrics and both models."""
    from moco_tpu_torch.config import PretrainConfig
    from moco_tpu_torch.parallel.gradsync import GradSync
    from moco_tpu_torch.parallel.mesh import rank, world_size
    from moco_tpu_torch.train_state import create_train_state
    from moco_tpu_torch.train_step import build_train_step

    n, r = world_size(group), rank(group)
    for name, overrides, nudge in v3["runs"]:
        config = PretrainConfig(**{**v3["config"], **overrides})
        torch.manual_seed(0)
        state = create_train_state(config, _v3_model(v3["model"]), "cpu", seed=0, group=group)
        GradSync(config, group).attach(state)
        if nudge:
            noise = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for p in state.model_q.parameters():
                    p.mul_(1 + nudge * torch.randn(p.shape, generator=noise))
            state.model_k.load_state_dict(state.model_q.state_dict(), strict=False)
        step = build_train_step(config, v3["steps_per_epoch"], group=group)
        metrics = []
        for x1, x2 in v3["images"]:
            b = x1.shape[0] // n
            m = step(state, x1[r * b:(r + 1) * b], x2[r * b:(r + 1) * b])
            metrics.append({k: float(v) for k, v in m.items()})
        torch.save({"metrics": metrics, "q": state.model_q.state_dict(),
                    "k": state.model_k.state_dict()}, _out(out_dir, name))


def _fsdp_model(spec: dict):
    """The tiny V3Model of `spec`: a ViT of `patch`, `width`, `depth` and
    `heads`, or the ResNet `spec["resnet"]` (the R50 leg's structure at a
    tiny width), with the heads of `embed_dim` and `hidden_dim`."""
    from moco_tpu_torch.models.resnet import build_resnet
    from moco_tpu_torch.models.vit import ViT
    from moco_tpu_torch.v3_step import V3Model

    if "resnet" in spec:
        backbone = build_resnet(spec["resnet"], num_classes=None)
    else:
        backbone = ViT(patch_size=spec["patch"], width=spec["width"], depth=spec["depth"],
                       num_heads=spec["heads"], image_size=spec["image_size"])
    return V3Model(backbone, embed_dim=spec["embed_dim"], hidden_dim=spec["hidden_dim"])


def run_fsdp_steps(inputs: str, out_dir: str) -> None:
    """For each `(name, config overrides)` of `inputs["runs"]`: the tiny
    V3Model of `inputs["model"]` with the saved weights, its state placed
    as the config's `sharding` asks (`parallel/fsdp.py::place_state`, after
    the gradient sync's accumulators are attached; a name ending in
    `_plain` skips the layout and the placement, the dp calls as they were
    before FSDP), and a v3 step on this process's rows of each saved global
    batch. Saves the metrics, both models (gathered), the optimizer's full
    state dict, this process's accumulators, its state bytes after each
    step, the bytes its query model's storage holds between steps, the
    gradient sync's `describe()` and the shard axes. Then the driver legs
    of `inputs["legs"]` (`run_fsdp_driver`, with `inputs["legs_model"]`
    where given, else the runs' model)."""
    from moco_tpu_torch.config import PretrainConfig
    from moco_tpu_torch.parallel.fsdp import place_state, state_bytes_per_device, \
        state_shardings
    from moco_tpu_torch.parallel.gradsync import GradSync
    from moco_tpu_torch.parallel.mesh import build_layout, rank, world_size
    from moco_tpu_torch.train_state import create_train_state
    from moco_tpu_torch.train_step import build_train_step

    data = torch.load(inputs, weights_only=False)
    group = _group()
    n, r = world_size(group), rank(group)
    sd = data["state_dict"]
    for name, overrides in data["runs"]:
        config = PretrainConfig(**{**data["config"], **overrides})
        state = create_train_state(config, _fsdp_model(data["model"]), "cpu", seed=0,
                                   group=group)
        state.model_q.load_state_dict(sd)
        state.model_k.load_state_dict({k: v for k, v in sd.items()
                                       if not k.startswith("predictor.")})
        if name.endswith("_plain"):
            gradsync = GradSync(config, group)
            gradsync.attach(state)
        else:
            layout = build_layout(config, group)
            gradsync = GradSync(config, group, layout)
            gradsync.attach(state)
            state = place_state(state, config, layout)
        step = build_train_step(config, data["steps_per_epoch"], group=group)
        metrics, bytes_between = [], []
        for x1, x2 in data["images"]:
            b = x1.shape[0] // n
            m = step(state, x1[r * b:(r + 1) * b], x2[r * b:(r + 1) * b])
            metrics.append({k: float(v) for k, v in m.items()})
            bytes_between.append(state_bytes_per_device(state))
        held = sum(p.untyped_storage().nbytes() for p in state.model_q.parameters())
        optimizer = state.optimizer.state_dict()
        if state.fsdp is not None:
            state.fsdp.gather()
        torch.save({"metrics": metrics, "q": state.model_q.state_dict(),
                    "k": state.model_k.state_dict(), "optimizer": optimizer,
                    "gradsync": {k: v.clone() for k, v in state.gradsync.items()},
                    "bytes": bytes_between, "held_q_bytes": held,
                    "describe": gradsync.describe(state.model_q.named_parameters()),
                    "axes": state_shardings(state),
                    "optimizer_class": type(state.optimizer).__name__},
                   _out(out_dir, name))
    if data.get("legs"):
        run_fsdp_driver(data["legs"], out_dir, data.get("legs_model", data["model"]))


def run_fsdp_driver(legs: list, out_dir: str, model: dict | None = None) -> None:
    """For each `(name, config fields, max_steps, n_images)` of `legs`:
    `train()` on `IndexedImages` (the encoder the tiny V3Model of `model`
    where given), the `log_event` events of the call kept. Saves the
    history, the events, the final step, both models, the optimizer's full
    state dict and this process's accumulators."""
    import moco_tpu_torch.train as driver
    from moco_tpu_torch.config import PretrainConfig
    from moco_tpu_torch.utils import logging as mlog

    if model is not None:
        driver.build_encoder = lambda config, group=None: _fsdp_model(model)
    for name, config_kw, max_steps, n_images in legs:
        config = PretrainConfig(**config_kw)
        events = []

        def sink(kind, msg, fields, events=events):
            events.append((kind, msg))

        mlog.add_event_sink(sink)
        try:
            state, history = driver.train(config, max_steps=max_steps, device="cpu",
                                          dataset=IndexedImages(n_images, config.image_size),
                                          on_step=lambda *a: None)
        finally:
            mlog.remove_event_sink(sink)
        torch.save({"history": history, "events": events, "step": state.step,
                    "q": state.model_q.state_dict(), "k": state.model_k.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "gradsync": {k: v.clone() for k, v in state.gradsync.items()}},
                   _out(out_dir, name))


def run_multihop(inputs: str, out_dir: str) -> None:
    """`collectives.multihop_quantized_mean` of this rank's row of the
    saved draw over the layout of the saved config (its fsdp and data
    subgroups made by `build_layout`), on each wire dtype."""
    from moco_tpu_torch.config import PretrainConfig
    from moco_tpu_torch.parallel.collectives import multihop_quantized_mean
    from moco_tpu_torch.parallel.mesh import build_layout, rank

    data = torch.load(inputs, weights_only=False)
    layout = build_layout(PretrainConfig(**data["config"]), _group())
    row = data["x"][rank(_group())]
    out = {}
    for wire in ("int8", "bfloat16"):
        means, errs = multihop_quantized_mean([row.clone()], layout.data_group,
                                              layout.fsdp_group, wire)
        out[wire] = {"mean": means[0], "err": errs[0],
                     "layout": (layout.data, layout.fsdp, layout.fsdp_rank)}
    torch.save(out, _out(out_dir, "multihop"))
