"""Checkpoint, resume and export (port of `moco_tpu/checkpoint.py`).

Full state. A step's checkpoint is `<ckpt_dir>/<step>/state.pt`, one
`torch.save` of the whole `TrainState`: both encoders' state_dicts (BN
running statistics included), the optimizer's state (the SGD or LARS
momentum buffers, AdamW's moments and step counts), the queue and its
pointer (None and 0 for v3), the step, and the states of both generators
(ShuffleBN's and the augmentation's), so a resumed run draws what the
uninterrupted one would have. The write is atomic: the step is written
into a temporary directory whose name is not a step, then renamed into
place. After each save the
integrity manifest and the data-stream position sidecar (with the number
of processes the state was saved under, `devices`) are written as the JAX
package writes them (`resilience/integrity.py`), and only the newest
`max_to_keep` steps stay, with their sidecars. In a data-parallel run the
state is replicated except for what the gradient sync and ZeRO-1 keep per
process: every process takes part in gathering those, and rank 0 writes.
The gradient sync's accumulators go under `gradsync` as `acc` rows
`[world, *shape]` (the JAX package's dialect 2), with the mode they belong
to; under ZeRO-1 the momentum is stored whole, so a checkpoint restores at
any world size, with ZeRO on or off. Every process restores, at any world
size, since the position counts global batches; each takes back its row of
the accumulators, or fresh zeros, with a logged event, when the checkpoint
has none (PRs 10-11), has another mode's, or was saved at another world
size. A restore with no step walks back from the newest step past any that
fails its manifest or its load. Restore loads onto the device of the state
it fills. Under `sharding="fsdp"|"fsdp_tp"` (`parallel/fsdp.py`) the state on
disk is the dp state's logical tree: a save gathers the full parameters
and optimizer state (every process calls it) and releases them after, and
a restore keeps this process's slices, at any world size and from any
mode; the sidecar's `sharding` stamp (`read_recorded_sharding`) records the
mode the state was saved under, as the JAX package's does.

Asynchronous saves. `save_checkpoint(..., wait=False)` writes the position
sidecar first, then snapshots the state into pinned host memory with
`non_blocking` copies queued on the current stream, the stream the next
step runs on, so the step's in-place updates of the parameters, momentum
and queue come after the copies; a writer thread waits on the copies'
CUDA event, then serializes and renames the step into place (and prunes
the steps past `max_to_keep`). The integrity manifest is deferred to the
next save or to `finalize_checkpoints`, which join the writer first, so
nothing else touches the directory while it writes; a step the process
died writing has no manifest and restores as unverified.

The reference checkpoint dialect. `export_encoder_q` writes the query
encoder under torchvision's names (`module.encoder_q.*`) and tensor layouts,
the dialect of the reference's checkpoints, as `.npz` or `.safetensors`;
the port's module names map onto torchvision's one for one, and conv and
linear weights are already [O, I, H, W] and [out, in]. The JAX package and
the port write the same file for the same weights. MoCo-v3:
`export_v3_backbone` writes the query backbone, a ViT in the timm dialect
(`vit_to_timm`) and a ResNet as the `backbone/` tree; `export_vit_encoder`
a v1/v2 ViT without its head. `load_for_inference` reads any known dialect
(`detect_dialect`), drops the contrastive head (the linear probe's
checkpoint surgery) and checks that what is left is exactly the backbone's
state. `.safetensors` needs the `safetensors` package.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys
import threading

import numpy as np
import torch
import torch.distributed as dist

from moco_tpu_torch.parallel.mesh import rank, world_size
from moco_tpu_torch.resilience.integrity import position_path, verify_step, write_manifest
from moco_tpu_torch.utils.logging import emit_event
from moco_tpu_torch.weights import params_from_jax, params_to_jax

STATE_FILE = "state.pt"


def _log(event: str, msg: str) -> None:
    """A `ckpt-*` event: its line on stderr, the event to the run's sinks
    (`events.jsonl` with telemetry on)."""
    print(f"[{event}] {msg}", file=sys.stderr, flush=True)
    emit_event(event, msg)


# ---------------------------------------------------------------------------
# step directories
# ---------------------------------------------------------------------------


class CheckpointManager:
    """The step directories `<directory>/<step>/` of one run: each holds
    one `torch.save` payload, written atomically; the newest `max_to_keep`
    are kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self.pending_manifest: int | None = None  # an async save's step, until finalized
        self._writer: threading.Thread | None = None
        self._writer_error: BaseException | None = None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: dict) -> None:
        """Write `payload` as step `step` (replacing an earlier save of the
        same step), then drop the steps past `max_to_keep`."""
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        final = self.step_dir(step)
        if os.path.exists(final):
            old = os.path.join(self.directory, f".old-{step}-{os.getpid()}")
            os.replace(final, old)
            shutil.rmtree(old)
        os.replace(tmp, final)
        for s in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)

    def save_async(self, step: int, payload: dict, ready=None) -> None:
        """`save(step, payload)` on a writer thread, once `ready` (a CUDA
        event behind the payload's copies, or None) has completed."""
        self.wait_until_finished()

        def write():
            try:
                if ready is not None:
                    ready.synchronize()
                self.save(step, payload)
            except BaseException as e:  # re-raised by wait_until_finished
                self._writer_error = e

        self._writer = threading.Thread(target=write, name=f"ckpt-writer-{step}")
        self._writer.start()

    def wait_until_finished(self) -> None:
        """Join the writer thread, if any; re-raise what it raised."""
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()
        err, self._writer_error = self._writer_error, None
        if err is not None:
            raise err

    def restore(self, step: int) -> dict:
        """The payload of step `step`, its tensors on the CPU."""
        return torch.load(os.path.join(self.step_dir(step), STATE_FILE), map_location="cpu",
                          weights_only=True)


def checkpoint_manager(directory: str, max_to_keep: int = 3) -> CheckpointManager:
    return CheckpointManager(directory, max_to_keep=max_to_keep)


def write_position(directory: str, step: int, position: tuple[int, int] | None,
                   devices: int | None = None, sharding: str | None = None) -> None:
    """Record the data-stream position `(epoch, next_batch_index)` a run
    restored from `step` resumes at (atomically), `devices`, the number of
    processes the state was saved under (the JAX package's mesh-size stamp),
    and `sharding`, the mode it was saved under (a mode change at the same
    world size leaves the accumulators' shapes as they were, so the driver
    reads this stamp to restart them from zeros). Absent or unreadable, a
    resume falls back to step arithmetic."""
    if position is None:
        return
    path = position_path(directory, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {"epoch": int(position[0]), "batch": int(position[1])}
    if devices is not None:
        payload["devices"] = int(devices)
    if sharding is not None:
        payload["sharding"] = str(sharding)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def _read_sidecar(directory: str, step: int) -> dict | None:
    try:
        with open(position_path(directory, step)) as f:
            d = json.load(f)
        return d if isinstance(d, dict) else None
    except (OSError, ValueError, json.JSONDecodeError):
        return None


def read_position(directory: str, step: int) -> tuple[int, int] | None:
    try:
        d = _read_sidecar(directory, step)
        return int(d["epoch"]), int(d["batch"])
    except (KeyError, TypeError, ValueError):
        return None


def read_recorded_devices(directory: str, step: int) -> int | None:
    """The number of processes `step` was saved under; None when its
    sidecar has no stamp or cannot be read."""
    try:
        return int(_read_sidecar(directory, step)["devices"])
    except (KeyError, TypeError, ValueError):
        return None


def read_recorded_sharding(directory: str, step: int) -> str | None:
    """The sharding mode `step` was saved under; None when its sidecar has
    no stamp (a checkpoint from before it: the driver takes it as "dp") or
    cannot be read."""
    d = _read_sidecar(directory, step)
    mode = d.get("sharding") if d is not None else None
    return str(mode) if mode is not None else None


def _prune_sidecars(mgr: CheckpointManager) -> None:
    """Drop the manifest and position sidecars of steps no longer kept."""
    keep = {str(s) for s in mgr.all_steps()}
    for sub in (".integrity", ".position"):
        d = os.path.join(mgr.directory, sub)
        try:
            names = os.listdir(d)
        except OSError:
            continue
        for name in names:
            stem, ext = os.path.splitext(name)
            if ext == ".json" and stem.isdigit() and stem not in keep:
                try:
                    os.remove(os.path.join(d, name))
                except OSError:
                    pass  # lost a cleanup race; the next prune retries


# ---------------------------------------------------------------------------
# full-state save and restore
# ---------------------------------------------------------------------------


def cpu_copy(tree, non_blocking: bool = False):
    """A copy of a nest of dicts, lists and tensors with every tensor on the
    CPU. `non_blocking`: the copy does not wait for the device; each CUDA
    tensor goes into fresh pinned memory by a copy queued on the current
    stream (complete once an event recorded after it has)."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if non_blocking and t.is_cuda:
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return out.copy_(t, non_blocking=True)
        return t.to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: cpu_copy(v, non_blocking) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cpu_copy(v, non_blocking) for v in tree)
    return tree


def gather_gradsync(state, group) -> dict | None:
    """The gradient sync's accumulators of every process, as `acc` rows
    `[world, *shape]` on the CPU with the mode they belong to (rank 0; None
    on the others; a collective: every process calls it)."""
    n, r = world_size(group), rank(group)
    names = sorted(state.gradsync)
    acc = {}
    if names:
        flat = torch.cat([state.gradsync[k].reshape(-1) for k in names])
        parts = [torch.empty_like(flat) for _ in range(n)] if r == 0 else None
        if group is None:
            parts = [flat]
        else:
            dist.gather(flat, parts, dst=0, group=group)
        if r == 0:
            rows = torch.stack(parts).cpu()
            sizes = [state.gradsync[k].numel() for k in names]
            for k, col in zip(names, rows.split(sizes, dim=1)):
                acc[k] = col.reshape(n, *state.gradsync[k].shape).clone()
    return {"mode": state.gradsync_mode, "acc": acc} if r == 0 else None


def state_payload(state, optimizer: dict | None = None, gradsync: dict | None = None,
                  non_blocking: bool = False) -> dict:
    """Everything a `TrainState` holds, as CPU tensors and numbers.
    `optimizer` and `gradsync` are the gathered forms of a process group
    (a sharded optimizer's `state_dict()`, `gather_gradsync`); by default this
    process's own. `non_blocking`: see `cpu_copy`."""

    def copy(tree):
        return cpu_copy(tree, non_blocking)

    if optimizer is None:
        optimizer = state.optimizer.state_dict()
    if gradsync is None:
        gradsync = gather_gradsync(state, None)
    return {
        "step": int(state.step),
        "model_q": copy(state.model_q.state_dict()),
        "model_k": copy(state.model_k.state_dict()),
        "optimizer": copy(optimizer),
        "queue": copy(state.queue),
        "queue_ptr": int(state.queue_ptr),
        "generator": state.generator.get_state(),
        "data_generator": (None if state.data_generator is None
                           else state.data_generator.get_state()),
        "gradsync": gradsync,
    }


def _check_payload(state, payload: dict) -> None:
    """Raise before anything is written if `payload` does not fit `state`."""
    for name in ("model_q", "model_k"):
        want = getattr(state, name).state_dict()
        got = payload[name]
        if want.keys() != got.keys():
            raise ValueError(f"checkpoint {name} names differ: missing "
                             f"{sorted(want.keys() - got.keys())[:5]}, extra "
                             f"{sorted(got.keys() - want.keys())[:5]}")
        bad = [k for k in want if want[k].shape != got[k].shape]
        if bad:
            raise ValueError(f"checkpoint {name} shapes differ at {bad[:5]}")
    if (payload["queue"] is None) != (state.queue is None):
        raise ValueError("checkpoint and state disagree on the queue (a v3 state has none)")
    if state.queue is not None and payload["queue"].shape != state.queue.shape:
        raise ValueError(f"checkpoint queue {tuple(payload['queue'].shape)} != "
                         f"{tuple(state.queue.shape)}")
    if (payload["data_generator"] is None) != (state.data_generator is None):
        raise ValueError("checkpoint and state disagree on the data generator")
    acc = (payload.get("gradsync") or {}).get("acc", {})
    if acc:
        params = {n: p for n, p in state.model_q.named_parameters() if p.requires_grad}
        if acc.keys() != params.keys():
            raise ValueError("checkpoint gradsync accumulators name other parameters: "
                             f"{sorted(acc.keys() ^ params.keys())[:5]}")
        bad = [k for k, a in acc.items() if a.dim() < 1 or a.shape[1:] != params[k].shape]
        if bad:
            raise ValueError(f"checkpoint gradsync accumulator shapes differ at {bad[:5]}")


def _load_gradsync(state, saved: dict | None, step: int, group) -> None:
    """This process's row of the saved accumulators, or fresh zeros (with a
    logged event) when the checkpoint has none, or another mode's, or was
    saved at another world size: the accumulators are per-process state of
    one mode at one world size, and zeros are the cold start."""
    if not state.gradsync and not (saved and saved["acc"]):
        return
    n = world_size(group)
    acc = saved["acc"] if saved else {}
    if state.gradsync and acc and saved["mode"] == state.gradsync_mode \
            and next(iter(acc.values())).shape[0] == n:
        with torch.no_grad():
            for k, t in state.gradsync.items():
                t.copy_(acc[k][rank(group)])
        return
    if saved is None:
        why = "has no gradsync accumulators (an older checkpoint)"
    elif saved["mode"] != state.gradsync_mode:
        why = f"was saved under grad_sync={saved['mode']!r}, this run uses " \
              f"{state.gradsync_mode!r}"
    else:
        why = f"was saved by {next(iter(acc.values())).shape[0]} processes, this run has {n}"
    for t in state.gradsync.values():
        t.zero_()
    if rank(group) == 0:
        _log("ckpt-dialect", f"step {step} {why}: restored without them; the "
                             "error-feedback/momentum state restarts from zeros")


def load_state(state, payload: dict, group=None):
    """Fill `state` in place from a `state_payload` (on the state's
    device), bit for bit; returns it. `group` is the process group whose
    rank picks this process's accumulators. An fsdp state takes its slices
    of the full parameters (and the optimizer its slices of the state)."""
    _check_payload(state, payload)
    plan = getattr(state, "fsdp", None)
    if plan is not None:
        plan.materialize()
    try:
        state.model_q.load_state_dict(payload["model_q"])
        state.model_k.load_state_dict(payload["model_k"])
        if plan is not None:
            plan.reshard()
    finally:
        if plan is not None:
            plan.release()
    state.optimizer.load_state_dict(payload["optimizer"])
    if state.queue is not None:
        with torch.no_grad():
            state.queue.copy_(payload["queue"])
    state.queue_ptr = int(payload["queue_ptr"])
    state.step = int(payload["step"])
    state.generator.set_state(payload["generator"])
    if state.data_generator is not None:
        state.data_generator.set_state(payload["data_generator"])
    _load_gradsync(state, payload.get("gradsync"), state.step, group)
    return state


def save_checkpoint(mgr: CheckpointManager, state, step: int,
                    position: tuple[int, int] | None = None, devices: int | None = None,
                    group=None, wait: bool = True, sharding: str | None = None) -> None:
    """Save `state` as step `step`: its position sidecar (with the
    `devices` and `sharding` stamps), then the state, then the integrity
    manifest; then drop the sidecars of pruned steps. In a process group
    every process gathers its accumulators, momentum slices and (fsdp) its
    parameter shards to the payload, rank 0 writes, and every process waits
    at a barrier until it has.

    `wait=False` returns once the state's copies are queued (see the module
    docstring): the payload is written on a thread and the manifest, the
    sidecar pruning and the barrier wait for the next save or
    `finalize_checkpoints`. A pending save is finalized first either way."""
    finalize_checkpoints(mgr, group)
    plan = getattr(state, "fsdp", None)
    full = plan.gathered() if plan is not None else contextlib.nullcontext()
    with full:  # the copies below are queued before the full storage is released
        optimizer = state.optimizer.state_dict()
        gradsync = gather_gradsync(state, group)
        if group is None or dist.get_rank(group) == 0:
            write_position(mgr.directory, step, position, devices, sharding)
            if wait:
                mgr.save(step, state_payload(state, optimizer, gradsync))
                write_manifest(mgr.directory, step)
                _prune_sidecars(mgr)
            else:
                payload = state_payload(state, optimizer, gradsync, non_blocking=True)
                ready = None
                device = next(state.model_q.parameters()).device
                if device.type == "cuda":
                    ready = torch.cuda.Event()
                    # behind every copy queued on the stream the next step runs on
                    ready.record(torch.cuda.current_stream(device))
                mgr.save_async(step, payload, ready)
    if not wait:
        mgr.pending_manifest = step
    elif group is not None:
        dist.barrier(group)


def finalize_checkpoints(mgr: CheckpointManager, group=None) -> None:
    """Wait for a pending async save to land, then write its deferred
    integrity manifest and prune the sidecars (rank 0), and meet the other
    processes at a barrier. Idempotent; nothing to do when no save is
    pending."""
    step, mgr.pending_manifest = mgr.pending_manifest, None
    if step is None:
        return
    if group is None or dist.get_rank(group) == 0:
        mgr.wait_until_finished()
        write_manifest(mgr.directory, step)
        _prune_sidecars(mgr)
    if group is not None:
        dist.barrier(group)


def restore_checkpoint(mgr: CheckpointManager, state, step: int | None = None, group=None):
    """Restore step `step` into `state`; with `step=None` the newest step
    that verifies and loads, walking back past corrupt or partial newer
    ones with a warning. An explicit step fails hard."""
    if step is not None:
        return load_state(state, mgr.restore(step), group)
    steps = mgr.all_steps()[::-1]
    if not steps:
        raise FileNotFoundError(f"no checkpoint found in {mgr.directory} to resume from")
    skipped: list[tuple[int, str]] = []
    for s in steps:
        reason = verify_step(mgr.directory, s)
        if reason is None:
            try:
                payload = mgr.restore(s)
                _check_payload(state, payload)
            except Exception as e:  # a torn file raises whatever the unpickler hits
                reason = f"{type(e).__name__}: {e}"
        if reason is not None:
            _log("ckpt-restore", f"step {s} fails ({reason}); falling back to the "
                                 "next-older step")
            skipped.append((s, reason))
            continue
        if skipped:
            _log("ckpt-restore", f"restored OLDER step {s} after skipping "
                                 f"{[x[0] for x in skipped]}: up to {steps[0] - s} steps "
                                 "of progress lost")
        return load_state(state, payload, group)
    raise FileNotFoundError(f"no restorable checkpoint in {mgr.directory}; all candidates "
                            f"failed: {skipped}")


def resume_dir(mgr: CheckpointManager | None, resume: str) -> str | None:
    """The directory `maybe_resume(mgr, _, resume)` restores from."""
    if resume and not (resume == "auto" or resume.isdigit()):
        return os.path.dirname(os.path.normpath(resume))
    return None if mgr is None else mgr.directory


def maybe_resume(mgr: CheckpointManager | None, state, resume: str, group=None):
    """`""`: the fresh state; `"auto"`: the newest restorable step if any,
    else the fresh state; a step number: that step of `mgr`'s directory; a
    path `<ckpt_dir>/<step>`: that step of that directory (the reference's
    `--resume <path>`). `group`: the process group the state runs in."""
    if not resume:
        return state
    if mgr is None and (resume == "auto" or resume.isdigit()):
        raise ValueError(f"--resume {resume} needs a checkpoint directory (--ckpt-dir)")
    if resume == "auto":
        if mgr.latest_step() is None:
            return state
        return restore_checkpoint(mgr, state, group=group)
    if resume.isdigit():
        return restore_checkpoint(mgr, state, int(resume), group)
    path = os.path.normpath(resume)
    base = os.path.basename(path)
    if not base.isdigit():
        raise ValueError(f"--resume expects 'auto', a step number, or a path ending in a "
                         f"step directory; got {resume!r}")
    return restore_checkpoint(checkpoint_manager(os.path.dirname(path)), state, int(base),
                              group)


# ---------------------------------------------------------------------------
# the reference checkpoint dialect (torchvision names)
# ---------------------------------------------------------------------------


def _torchvision_module(mods: list[str], mlp_head: bool) -> list[str]:
    """The port's module path of one entry -> torchvision's."""
    top = mods[0]
    if top in ("conv1", "bn1") and len(mods) == 1:
        return mods
    if top.startswith("layer") and len(mods) == 2:
        stage, block = top.split("_")
        member = mods[1]
        if member == "downsample_conv":
            return [stage, block, "downsample", "0"]
        if member == "downsample_bn":
            return [stage, block, "downsample", "1"]
        if member.startswith(("conv", "bn")):
            return [stage, block, member]
        raise ValueError(f"unexpected block member {top}.{member}")
    if top == "fc_hidden" and len(mods) == 1:
        return ["fc", "0"]
    if top == "fc" and len(mods) == 1:
        return ["fc", "2"] if mlp_head else ["fc"]
    raise ValueError(f"unexpected module {'.'.join(mods)}")


def resnet_to_torchvision(state_dict: dict, mlp_head: bool | None = None,
                          prefix: str = "") -> dict[str, np.ndarray]:
    """The port's ResNet state_dict under torchvision's names: `layer{i}_{j}`
    -> `layer{i}.{j}`, `downsample_conv`/`_bn` -> `downsample.0`/`.1`, the
    v2 MLP head `fc_hidden`/`fc` -> `fc.0`/`fc.2` (the reference's
    `Sequential(Linear, ReLU, Linear)`). `mlp_head` is read from the names
    unless given. Values are numpy copies."""
    if mlp_head is None:
        mlp_head = any(k.startswith("fc_hidden.") for k in state_dict)
    out = {}
    for name, value in state_dict.items():
        *mods, leaf = name.split(".")
        key = ".".join(_torchvision_module(mods, mlp_head) + [leaf])
        out[prefix + key] = value.detach().cpu().numpy().copy()
    return out


def torchvision_to_resnet(flat: dict, prefix: str = "module.encoder_q.") -> dict:
    """The inverse of `resnet_to_torchvision`, and the linear probe's
    checkpoint surgery (`main_lincls.py`): keep the `prefix` entries, strip
    the prefix, DROP the contrastive head (`fc*`), and rename to the port's
    modules. Returns a state_dict of CPU tensors."""
    out = {}
    for name, arr in flat.items():
        if not name.startswith(prefix):
            continue
        name = name[len(prefix):]
        *mods, leaf = name.split(".")
        if mods and mods[0].startswith("fc"):
            continue  # the contrastive head, dropped as the reference drops it
        if leaf == "num_batches_tracked":
            continue
        if leaf not in ("weight", "bias", "running_mean", "running_var"):
            raise ValueError(f"unexpected leaf {name!r}")
        if len(mods) >= 2 and mods[-2] == "downsample":
            mods = mods[:-2] + ["downsample_conv" if mods[-1] == "0" else "downsample_bn"]
        if len(mods) >= 2 and mods[0].startswith("layer"):
            mods = [f"{mods[0]}_{mods[1]}"] + mods[2:]
        out[".".join(mods + [leaf])] = torch.tensor(np.asarray(arr))
    return out


def export_encoder_q(state, path: str, mlp_head: bool | None = None,
                     prefix: str = "module.encoder_q.") -> dict[str, np.ndarray]:
    """Write the query encoder in the reference's checkpoint dialect as
    `.npz` or `.safetensors` (by the path's extension). Returns the flat
    dict written."""
    flat = resnet_to_torchvision(state.model_q.state_dict(), mlp_head=mlp_head,
                                 prefix=prefix)
    _save_flat(flat, path)
    return flat


def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """`a/b/c`-joined flattening of a nested dict (the `backbone/` dialect)."""
    out: dict[str, np.ndarray] = {}
    for name, sub in tree.items():
        key = f"{prefix}{name}"
        if isinstance(sub, dict):
            out.update(flatten_tree(sub, key + "/"))
        else:
            out[key] = np.ascontiguousarray(np.asarray(sub))
    return out


def unflatten_tree(flat: dict[str, np.ndarray], prefix: str = "") -> dict:
    tree: dict = {}
    for name, arr in flat.items():
        if not name.startswith(prefix):
            continue
        parts = name[len(prefix):].split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def export_backbone_tree(state_dict: dict, path: str) -> dict[str, np.ndarray]:
    """Write a backbone in the `backbone/a/b/c` dialect (flax tree names and
    layouts, BN running statistics under `backbone_stats/`), the dialect the
    JAX package's v3 ResNet exports use."""
    params, stats = params_to_jax(state_dict)
    flat = flatten_tree(params, "backbone/")
    if stats:
        flat.update(flatten_tree(stats, "backbone_stats/"))
    _save_flat(flat, path)
    return flat


def _safetensors_numpy(path: str):
    try:
        import safetensors.numpy
    except ImportError as e:
        raise ImportError(f"{path!r} is a .safetensors path, which needs the `safetensors` "
                          "package; it is not installed. Use a .npz path instead") from e
    return safetensors.numpy


def _save_flat(flat: dict[str, np.ndarray], path: str) -> None:
    """`.npz` by extension, else safetensors."""
    if path.endswith(".npz"):
        np.savez(path, **flat)
    else:
        _safetensors_numpy(path).save_file(flat, path)


def import_encoder_q(path: str) -> dict[str, np.ndarray]:
    """A flat exported dict, read back."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return dict(f)
    return _safetensors_numpy(path).load_file(path)


# name -> predicate over the flat key set; the first match wins
CHECKPOINT_DIALECTS: tuple[tuple[str, object], ...] = (
    ("v3_tree", lambda flat: any(k.startswith("backbone/") for k in flat)),
    ("timm_vit", lambda flat: "patch_embed.proj.weight" in flat),
    ("torchvision_encoder_q",
     lambda flat: any(k.startswith("module.encoder_q.") for k in flat)),
)


def detect_dialect(flat: dict[str, np.ndarray]) -> str:
    """Classify a flat checkpoint against `CHECKPOINT_DIALECTS`; raises
    with the known dialects on a miss."""
    for name, pred in CHECKPOINT_DIALECTS:
        if pred(flat):
            return name
    known = ", ".join(name for name, _ in CHECKPOINT_DIALECTS)
    raise ValueError(f"checkpoint matches no known dialect (looked for: {known}); "
                     f"got keys like {sorted(flat)[:3]}")


def load_pretrained_backbone(path: str, num_heads: int = 12) -> dict:
    """A pretrained backbone's state_dict (CPU tensors, head dropped) from
    any dialect: torchvision `module.encoder_q.*` or a `backbone/*` tree
    (ResNets), or timm (ViTs, the fused qkv split into `num_heads` heads)."""
    flat = import_encoder_q(path)
    dialect = detect_dialect(flat)
    if dialect == "v3_tree":
        return params_from_jax(unflatten_tree(flat, "backbone/"),
                               unflatten_tree(flat, "backbone_stats/"))
    if dialect == "timm_vit":
        return timm_to_vit(flat, num_heads=num_heads)
    return torchvision_to_resnet(flat)


def load_for_inference(path: str, arch: str, *, cifar_stem: bool = False, device="cuda",
                       image_size: int = 224):
    """The checkpoint surgery every consumer that does not train goes
    through: build the feature-mode backbone of `arch`, load `path` through
    the dialect table (a ViT's qkv split with THIS arch's head count), check
    that the surgery left EXACTLY the backbone's names (else raise with the
    missing and extra ones), and return the model on `device` in eval mode,
    its parameters frozen."""
    from moco_tpu_torch.models import build_backbone

    model = build_backbone(arch, cifar_stem=cifar_stem, image_size=image_size)
    state = load_pretrained_backbone(path, num_heads=getattr(model, "num_heads", 12))
    want, got = set(model.state_dict()), set(state)
    if want != got:
        raise ValueError(f"checkpoint surgery mismatch for arch {arch!r}: missing "
                         f"{sorted(want - got)[:5]}, extra {sorted(got - want)[:5]}")
    model.load_state_dict(state, strict=True)
    for p in model.parameters():
        p.requires_grad_(False)
    return model.to(device).eval()


# ---------------------------------------------------------------------------
# the timm ViT dialect and the v3 exports
# ---------------------------------------------------------------------------


def _sincos_pos_embed(gh: int, gw: int, dim: int) -> np.ndarray:
    """timm's `pos_embed` [1, 1 + gh*gw, dim]: a zero class-token row, then
    the fixed sin-cos grid (what moco-v3's `vits.py` builds)."""
    from moco_tpu_torch.models.vit import sincos_2d_position_embedding

    grid = sincos_2d_position_embedding(gh, gw, dim).numpy()
    return np.concatenate([np.zeros((1, 1, dim), np.float32), grid], axis=1)


def _np(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy().astype(np.float32, copy=True))


def vit_to_timm(state_dict: dict, prefix: str = "",
                grid: tuple[int, int] = (14, 14)) -> dict[str, np.ndarray]:
    """The port's ViT state_dict under timm `VisionTransformer` names, the
    dialect of moco-v3's ViT checkpoints: `cls_token`, `pos_embed` (the
    fixed sin-cos buffer, emitted because the dialect has it),
    `patch_embed.proj.*`, `blocks.N.{norm1, attn.qkv, attn.proj, norm2,
    mlp.fc1, mlp.fc2}.*`, `norm.*`. The query, key and value kernels [D, H,
    hd] become the rows of one fused `qkv` [3D, D]; `out` [H, hd, D] becomes
    `proj` [D, D]. The same file as the JAX package's `vit_to_timm` for the
    same weights. A `head.*` entry is not written."""
    sd = state_dict
    width = int(sd["cls_token"].shape[-1])
    out: dict[str, np.ndarray] = {
        f"{prefix}cls_token": _np(sd["cls_token"]),
        f"{prefix}pos_embed": _sincos_pos_embed(grid[0], grid[1], width),
        f"{prefix}patch_embed.proj.weight": _np(sd["patch_embed.weight"]),
        f"{prefix}patch_embed.proj.bias": _np(sd["patch_embed.bias"]),
    }
    blocks = sorted({int(k.split(".")[0][len("block"):]) for k in sd if k.startswith("block")})
    for i in blocks:
        b, t = f"block{i}.", f"{prefix}blocks.{i}."
        for ln in ("norm1", "norm2"):
            out[f"{t}{ln}.weight"] = _np(sd[f"{b}{ln}.weight"])
            out[f"{t}{ln}.bias"] = _np(sd[f"{b}{ln}.bias"])
        out[f"{t}attn.qkv.weight"] = np.concatenate(
            [_np(sd[f"{b}attn.{m}.weight"].reshape(width, width).t()) for m in
             ("query", "key", "value")], axis=0)
        out[f"{t}attn.qkv.bias"] = np.concatenate(
            [_np(sd[f"{b}attn.{m}.bias"].reshape(width)) for m in ("query", "key", "value")])
        out[f"{t}attn.proj.weight"] = _np(sd[f"{b}attn.out.weight"].reshape(width, width).t())
        out[f"{t}attn.proj.bias"] = _np(sd[f"{b}attn.out.bias"])
        for fc, tn in (("mlp_fc1", "mlp.fc1"), ("mlp_fc2", "mlp.fc2")):
            out[f"{t}{tn}.weight"] = _np(sd[f"{b}{fc}.weight"])
            out[f"{t}{tn}.bias"] = _np(sd[f"{b}{fc}.bias"])
    out[f"{prefix}norm.weight"] = _np(sd["norm.weight"])
    out[f"{prefix}norm.bias"] = _np(sd["norm.bias"])
    return out


def timm_to_vit(flat: dict, num_heads: int = 12, prefix: str = "") -> dict:
    """The inverse of `vit_to_timm`: the port's ViT state_dict (CPU
    tensors, no head) from a timm checkpoint with a fused qkv (ours or any
    timm ViT), the qkv split into `num_heads` heads. `head.*` entries are
    ignored. A `pos_embed` that is not the fixed sin-cos buffer (a learned
    or resized one) is refused: the ViT has no positional parameter, so
    importing it would silently change the token positions."""
    width = int(flat[f"{prefix}cls_token"].shape[-1])
    pe = flat.get(f"{prefix}pos_embed")
    if pe is not None:
        pe = np.asarray(pe)
        n = pe.shape[-2] - 1
        g = int(round(n ** 0.5))
        expected = _sincos_pos_embed(g, g, width) if g * g == n else None
        if expected is None or not np.allclose(pe.reshape(expected.shape), expected,
                                               rtol=1e-3, atol=1e-3):
            raise ValueError(
                "timm checkpoint carries a pos_embed that differs from the fixed 2-D "
                "sin-cos buffer this ViT uses (a learned or resized positional "
                "embedding). Importing it would silently change token positions; convert "
                "the checkpoint (or retrain) instead.")
    hd = width // num_heads

    def t(name):
        return torch.tensor(np.array(flat[prefix + name], dtype=np.float32))

    out = {"cls_token": t("cls_token"), "patch_embed.weight": t("patch_embed.proj.weight"),
           "patch_embed.bias": t("patch_embed.proj.bias"), "norm.weight": t("norm.weight"),
           "norm.bias": t("norm.bias")}
    n_blocks = 1 + max(int(k[len(prefix):].split(".")[1]) for k in flat
                       if k.startswith(f"{prefix}blocks."))
    for i in range(n_blocks):
        b, s = f"block{i}.", f"blocks.{i}."
        for ln in ("norm1", "norm2"):
            out[f"{b}{ln}.weight"] = t(f"{s}{ln}.weight")
            out[f"{b}{ln}.bias"] = t(f"{s}{ln}.bias")
        qkv_w, qkv_b = t(f"{s}attn.qkv.weight"), t(f"{s}attn.qkv.bias")
        for j, m in enumerate(("query", "key", "value")):
            rows = slice(j * width, (j + 1) * width)
            out[f"{b}attn.{m}.weight"] = qkv_w[rows].t().reshape(width, num_heads, hd).clone()
            out[f"{b}attn.{m}.bias"] = qkv_b[rows].reshape(num_heads, hd).clone()
        out[f"{b}attn.out.weight"] = t(f"{s}attn.proj.weight").t().reshape(
            num_heads, hd, width).clone()
        out[f"{b}attn.out.bias"] = t(f"{s}attn.proj.bias")
        for fc, tn in (("mlp_fc1", "mlp.fc1"), ("mlp_fc2", "mlp.fc2")):
            out[f"{b}{fc}.weight"] = t(f"{s}{tn}.weight")
            out[f"{b}{fc}.bias"] = t(f"{s}{tn}.bias")
    return out


def _vit_grid(state_dict: dict, image_size: int) -> tuple[int, int]:
    """The patch grid of `pos_embed`: the training resolution over the
    patch embedding's own patch size."""
    p = int(state_dict["patch_embed.weight"].shape[-1])
    return image_size // p, image_size // p


def export_v3_backbone(state, path: str, image_size: int = 224) -> dict[str, np.ndarray]:
    """The MoCo-v3 query BACKBONE (projector and predictor dropped: the v3
    probe reads backbone features), as `.npz` or `.safetensors`: a ViT in
    the timm dialect, a ResNet as the `backbone/` tree with its BN
    statistics under `backbone_stats/` (the JAX package's dialects).
    Returns the flat dict written."""
    sd = state.model_q.backbone.state_dict()
    if "patch_embed.weight" in sd:
        flat = vit_to_timm(sd, grid=_vit_grid(sd, image_size))
        _save_flat(flat, path)
        return flat
    return export_backbone_tree(sd, path)


def export_vit_encoder(state, path: str, image_size: int = 224) -> dict[str, np.ndarray]:
    """A v1/v2 ViT query encoder in the timm dialect, its contrastive
    `head` dropped."""
    sd = {k: v for k, v in state.model_q.state_dict().items() if not k.startswith("head.")}
    flat = vit_to_timm(sd, grid=_vit_grid(sd, image_size))
    _save_flat(flat, path)
    return flat
