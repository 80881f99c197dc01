"""Pretraining driver of the port (port of `moco_tpu/train.py`'s main path).

    python -m moco_tpu_torch.train --preset imagenet-moco-v2 --data-dir /data/imagenet \\
        --max-steps 5 [--batch-size B] [--ckpt-dir DIR [--resume auto]] \\
        [--export-path encoder.npz] [--knn-monitor true] [--device cpu]
    python -m moco_tpu_torch.train --preset imagenet-moco-v3-vits --data-dir ... [...]
    python -m moco_tpu_torch.train --num-devices 8 --preset imagenet-moco-v2 ...
    torchrun --nproc-per-node 8 -m moco_tpu_torch.train --preset imagenet-moco-v2 ...

Data parallelism is one process per card, as the reference's `mp.spawn`
runs it: `--num-devices N` makes `main` a launcher of N rank processes
(`parallel/launch.py`; the form a supervisor relaunches with another N),
and under torchrun the same; each process joins an NCCL group (gloo with
`--device cpu`) and runs on `cuda:LOCAL_RANK`; `--batch-size` is the
global batch. Each process stages its contiguous slice of every global
batch, the step shuffles the key batch across processes and takes the mean
of the gradients, BN statistics and metrics (`train_step.py`), and only
rank 0 prints and writes (checkpoints, their sidecars, the export, the kNN
baseline); every process restores.

`grad_sync` picks the gradient sync of a process group (fused, bucketed,
quantized, demo; `parallel/gradsync.py`) and `zero_sharding` splits the
optimizer's state over it (`parallel/zero.py`); rank 0 prints the sync's bytes a
step once at the start. `sharding` (`--sharding fsdp|fsdp_tp`, with
`--sharding-axis-size K` for fsdp_tp) splits a v3 run's parameters and
optimizer state over the group, or over inner groups of K ranks
(`parallel/fsdp.py`): the state is placed after it is built and before any
restore; `main` checks the layout against the number of ranks before any
rendezvous; a checkpoint saved under another mode at the same world size
restarts the gradient sync's accumulators from zeros (the sidecar's
`sharding` stamp says which mode it was).

Builds the dataset the config names (wrapped in the decode-once cache when
`input_cache_mb` > 0; with `input_prestage` the pre-staged epoch cache of
`data/service/prestage.py` instead, and no cache) and the state, then runs
epochs: an `epoch_loader`
stages each epoch's batches ahead of the step on worker threads and copies
them to the device on a side stream; the step draws the two views on the
device from each batch's staging extents and trains. With `input_service`
(`--input-service host:port,...`) the canvas rows come from standalone
staging servers (`python -m moco_tpu_torch.staging_server`) through
`data/service/client.py::service_epoch_loader`, bit for bit the same
batches; without the kNN monitor the dataset length comes from the servers'
meta answer and nothing is built locally, and unreachable or drifted
servers end `main` with EXIT_CONFIG_ERROR. `sync_bn` (`--sync-bn true`)
takes the BN statistics over the process group's global batch
(`models/fast_bn.py`). The step's metrics
stay on the device except on print steps (`print_freq`), where they reach
the host in one transfer. It runs on the card unless `--device cpu` is
given: `train` raises if CUDA is asked for and absent, `main` exits
EXIT_CONFIG_ERROR.

The v3 presets (`imagenet-moco-v3-vits`, `-vitb`, `-r50`) run the
queue-free v3 step (`v3_step.py`) on the asymmetric view pair, with AdamW
or LARS; their kNN monitor scores the query BACKBONE's features and their
export writes the backbone (a ViT in the timm dialect, a ResNet as the
`backbone/` tree); a v1/v2 ViT exports its encoder without the head in the
timm dialect.

With `ckpt_dir` the whole state is checkpointed every `ckpt_every_epochs`
epochs (and when `max_steps` ends the run on such an epoch) with the
data-stream position it resumes at; `resume` restores it (`"auto"`, a step
number, or `<ckpt_dir>/<step>`), and the resumed epoch skips the batches it
already used, so a resumed run is the uninterrupted one. `export_path`
writes the query encoder in the reference's checkpoint dialect at the end.
`knn_monitor` scores a kNN top-1 of the query encoder's embedding at step 0
and every `knn_every_epochs` epochs (and at the run's last).

With `telemetry_dir` (`--telemetry-dir`) every rank builds a
`telemetry.RunTelemetry` and rank 0 writes the JAX package's
`events.jsonl` (run_start, a step record a step with data / host /
telemetry seconds, imgs/s, MFU against the card's peak, device and host
memory, device_s and comm_s on every `telemetry_stride`-th step, fenced by
pulling the loss to the host; pod records under a process group every
`resilience_sync_steps` steps; incidents; run_end), `heartbeat.json` and
the spans of `trace_mode` (`spans.jsonl`, with the Prefetcher's staging
spans); `tools/telemetry_report.py` reads it. With `telemetry_dir=""` the
loop does no telemetry work. `health_stride` adds the collapse diagnostics
to the stride steps' metrics (the records' `health` block) and the
`collapse_*` thresholds arm a `CollapseSentinel`, whose fired predicate is
one `health` incident. `tb_dir` writes tensorboardX scalars where the
package is installed; `profile_dir` a `torch.profiler` trace of steps
[`profile_start`, `profile_stop`).

Resilience (`resilience/`): `loss_sentinel` checks every step's loss one
step late (a pinned copy the host reads after the next step is launched);
a non-finite loss, or a fired collapse predicate with `collapse_rollback`,
makes `train` restore the last good checkpoint, skip the data stream
through the poisoned batch and run again, up to `max_rollbacks`
consecutive rollbacks (`RollbackExhaustedError` then). SIGTERM/SIGINT sets
a flag the loop polls after each step (under a group the ranks agree on it
every `resilience_sync_steps` steps): the run stops at that step, writes a
synchronous emergency checkpoint at the mid-epoch position, marks the
heartbeat `preempt_exit` and returns with `preempted` in its history. A
resize request (SIGUSR2, or `<telemetry_dir>/resize.request`;
`resilience/resize.py`) is agreed on the same way and ends the run the same
way, with an elastic checkpoint, `resize_exit` and `resized`.
Epoch-end checkpoints are asynchronous (`save_checkpoint(wait=False)`).
`watchdog_secs` flags a step that does not end in time (the kNN monitor
runs with it suspended); `debug_nans` turns on autograd's anomaly mode with
its NaN check for the run and checks the loss on print steps;
`loader_retries`/`loader_backoff_secs` set the Prefetcher's retries; `chaos`
(or `MOCO_TPU_CHAOS`) installs a fault-injection plan for the drills.
`main()` exits through the codes of `resilience/exitcodes.py`;
`python -m moco_tpu_torch.supervise` relaunches it by them.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import sys
import time
from typing import Callable

import numpy as np
import torch

from moco_tpu_torch.checkpoint import checkpoint_manager, export_encoder_q, \
    export_v3_backbone, export_vit_encoder, finalize_checkpoints, maybe_resume, \
    read_position, read_recorded_devices, read_recorded_sharding, resume_dir, \
    save_checkpoint
from moco_tpu_torch.config import PretrainConfig, add_config_flags, collect_overrides, \
    get_preset, preset_names
from moco_tpu_torch.data.augment import aug_config_for, two_crops
from moco_tpu_torch.data.canvas_cache import CachedDataset
from moco_tpu_torch.data.datasets import build_dataset
from moco_tpu_torch.data.loader import epoch_loader
from moco_tpu_torch.data.service import protocol
from moco_tpu_torch.data.service.client import ServiceConfigError, service_epoch_loader
from moco_tpu_torch.data.service.prestage import PrestagedDataset
from moco_tpu_torch.evals.knn import build_feature_fn, encode_dataset
from moco_tpu_torch.ops.knn import knn_accuracy
from moco_tpu_torch.parallel.fsdp import place_state, state_bytes_per_device
from moco_tpu_torch.parallel.gradsync import GradSync
from moco_tpu_torch.parallel.launch import ENV_INIT_METHOD, join_launcher, exit_with, \
    launch, strip_device_flag
from moco_tpu_torch.parallel.mesh import build_layout, init_distributed, layout_for_config, \
    local_batch_size, process_group, rank, shutdown_distributed, topology, world_size
from moco_tpu_torch.resilience.chaos import active_chaos, clear_chaos, install_chaos, \
    parse_chaos_spec
from moco_tpu_torch.resilience.errors import CollapseError, DataQualityError, \
    NonFiniteLossError, RollbackExhaustedError
from moco_tpu_torch.resilience.exitcodes import EXIT_CONFIG_ERROR, EXIT_DATA_QUALITY, \
    EXIT_PREEMPTED, EXIT_RESIZE, EXIT_ROLLBACK_EXHAUSTED
from moco_tpu_torch.resilience.preemption import PreemptionHandler
from moco_tpu_torch.resilience.resize import ResizeListener, write_resize_request
from moco_tpu_torch.resilience.sentinel import CollapseSentinel, NaNSentinel
from moco_tpu_torch.resilience.watchdog import StepWatchdog
from moco_tpu_torch.telemetry.health import crush_key_params
from moco_tpu_torch.train_state import TrainState, create_train_state
from moco_tpu_torch.train_step import build_encoder, build_train_step
from moco_tpu_torch.utils.device import resolve_device, set_precision_policy
from moco_tpu_torch.utils.logging import ProfilerWindow, ScalarWriter, log_event
from moco_tpu_torch.utils.meters import Throughput

METRIC_NAMES = ("loss", "acc1", "acc5", "pos_sim", "neg_sim", "logit_margin", "lr",
                "queue_ptr")
V3_METRIC_NAMES = ("loss", "acc1", "pos_sim", "neg_sim", "logit_margin", "lr", "momentum")


def host_metrics(metrics: dict) -> dict:
    """A step's metrics as host numbers, the device ones in one transfer."""
    names = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    values = dict(zip(names, torch.stack([metrics[k].float() for k in names]).cpu().tolist()))
    return {k: values.get(k, v) for k, v in metrics.items()}


def print_step(step: int, metrics: dict, seconds: float, batch: int) -> None:
    names = V3_METRIC_NAMES if "momentum" in metrics else METRIC_NAMES
    shown = " ".join(f"{k} {metrics[k]:.6g}" for k in names)
    print(f"step {step} {shown} step_s {seconds:.4f} imgs_s {batch / seconds:.1f}",
          flush=True)


def check_decode_rate(failed: int, total: int, config: PretrainConfig) -> None:
    """Raise `DataQualityError` once the cumulative decode-failure rate
    `failed / total` exceeds `decode_abort_rate` (after at least one
    batch's worth)."""
    if config.decode_abort_rate and total >= config.batch_size \
            and failed / total > config.decode_abort_rate:
        raise DataQualityError(
            f"decode-failure rate {failed}/{total} = {failed / total:.1%} exceeds "
            f"decode_abort_rate={config.decode_abort_rate:.1%}: training on zero "
            "canvases would silently waste the run")


def make_feature_fn(model, variant: str = "v2"):
    """The kNN monitor's embedding: the query encoder's L2-normalized output
    in eval mode (BN on its running statistics), without autograd; the
    encoder goes back to train mode after each batch. v3 embeds with the
    BACKBONE alone, the features its probe and kNN eval score."""
    return build_feature_fn(model.backbone if variant == "v3" else model)


def knn_monitor(config, feature_fn, state: TrainState, dataset,
                val_dataset=None) -> tuple[float, bool]:
    """kNN top-1 at monitoring scale: the bank is a `knn_bank_size` subset
    of the train set; the queries come from `val_dataset` where there is
    one (a real val metric), else from a held-out 20% of that subset.
    Returns (accuracy, is_real_val)."""
    n = min(len(dataset), config.knn_bank_size)
    rng = np.random.RandomState(config.seed)
    idx = rng.permutation(len(dataset))[:n]
    if val_dataset is not None:
        bank_idx = idx
        q_set = val_dataset
        q_idx = rng.permutation(len(val_dataset))[:max(n // 4, 1)]
    else:
        split = int(n * 0.8)
        bank_idx, q_idx = idx[:split], idx[split:]
        q_set = dataset
    bank, bank_labels = encode_dataset(state.model_q, dataset, config, indices=bank_idx,
                                       feature_fn=feature_fn)
    val, val_labels = encode_dataset(state.model_q, q_set, config, indices=q_idx,
                                     feature_fn=feature_fn)
    acc = knn_accuracy(val, val_labels, bank, bank_labels, num_classes=dataset.num_classes,
                       k=min(200, len(bank_idx)), temperature=0.07)
    return acc, val_dataset is not None


def _monitor_val_split(config, train_dataset):
    """A real validation split for the kNN monitor where the dataset has
    one (imagefolder `val/` with the train split's classes, the CIFAR-10
    test batch, a held-out synthetic texture draw), else None."""
    if config.dataset == "imagefolder":
        val_dir = os.path.join(config.data_dir, "val")
        if os.path.isdir(val_dir):
            try:
                val = build_dataset("imagefolder", val_dir, image_size=config.image_size,
                                    stage_size=config.stage_size,
                                    num_workers=config.num_workers)
            except FileNotFoundError:
                return None  # an empty val/ placeholder
            if val.class_to_idx != getattr(train_dataset, "class_to_idx", None):
                print("kNN monitor: val/ class directories differ from train/; labels "
                      "would misalign, so the monitor holds out train data", flush=True)
                return None
            return val
    if config.dataset == "cifar10":
        try:
            return build_dataset("cifar10", config.data_dir, train=False)
        except FileNotFoundError:
            return None
    if config.dataset == "synthetic_texture":
        from moco_tpu_torch.data.datasets import SyntheticTextureDataset

        # the same classes (fixed-seed tiles), another draw, the train
        # split's distribution knobs
        return SyntheticTextureDataset(
            num_samples=2048, image_size=config.image_size, num_classes=config.num_classes,
            seed=getattr(train_dataset, "seed", 0) + 10007,
            texture_amp=getattr(train_dataset, "texture_amp", 0.4),
            cast_strength=getattr(train_dataset, "cast_strength", 0.5))
    return None


def _write_json(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def train(config: PretrainConfig, max_steps: int | None = None, device="cuda",
          dataset=None, on_step: Callable[[int, dict, float], None] | None = None,
          stats=None) -> tuple[TrainState, list[dict]]:
    """Run up to step `max_steps` (default: the whole schedule) on `dataset`
    (default: the one the config names), resuming first if the config says
    so. Returns the state and a history: the metrics of each print step as
    host numbers, `{"step", "knn_*_top1"}` for each kNN monitor run, and
    `{"step", "preempted": True}` (or `"resized"`) last when a preemption
    (or a resize) ended the run.
    `on_step(step, metrics, seconds)` sees every print step on rank 0
    (default: print it); `seconds` is the host time per step since the
    previous print, ending with the metrics on the host, which waits for the
    device. `stats` is an optional `InputPipelineStats` the input pipeline
    reports to (with telemetry on, the telemetry's own by default). In a
    process group (`parallel/mesh.py::init_distributed`) this process trains
    its slice of each global batch on `device`.

    Fault tolerance: SIGTERM/SIGINT finishes the step in flight, writes an
    emergency checkpoint at the mid-epoch position and returns; a
    non-finite loss (or, with `collapse_rollback`, a fired collapse
    predicate) makes a bounded rollback: restore the last good checkpoint,
    advance the data stream past the poisoned batch, and run again,
    raising `RollbackExhaustedError` after `max_rollbacks` consecutive
    rollbacks that made no progress past the poisoned step. A rollback
    changes the data stream, so the run that follows is not the
    uninterrupted one; a preempted and resumed run is, bit for bit. The
    plan of `config.chaos` is installed for the call (an already active
    plan wins, with a `chaos` event) and cleared after it."""
    set_precision_policy()
    installed_chaos = False
    if config.chaos:
        if active_chaos() is None:
            plan = parse_chaos_spec(config.chaos)
            if plan is not None:
                # fire-once markers across restarts, as an env plan keeps them
                plan.state_dir = os.environ.get("MOCO_TPU_CHAOS_STATE") or None
            install_chaos(plan)
            installed_chaos = True
        else:
            log_event("chaos", f"--chaos {config.chaos!r} IGNORED: a plan is already active "
                               f"for this process ({active_chaos()!r}) — unset MOCO_TPU_CHAOS "
                               "to use the CLI spec")
    rollbacks, last_nan_step, data_advance, poison_pos = 0, -1, 0, None
    run_config = config
    try:
        while True:
            try:
                return _train_once(run_config, max_steps, device, dataset, on_step, stats,
                                   data_advance, poison_pos)
            except NonFiniteLossError as e:
                if not config.ckpt_dir or config.max_rollbacks <= 0:
                    raise
                # consecutive = no progress: a poisoned step at or before the
                # last one means the run never got past it
                rollbacks = rollbacks + 1 if e.step <= last_nan_step else 1
                last_nan_step = max(last_nan_step, e.step)
                if rollbacks > config.max_rollbacks:
                    raise RollbackExhaustedError(
                        f"{rollbacks} consecutive rollbacks without progress past step "
                        f"{last_nan_step} (max_rollbacks={config.max_rollbacks}): the "
                        "divergence is structural, not a poisoned data window — aborting "
                        "for a human") from e
                reason = ("representation collapse" if isinstance(e, CollapseError)
                          else "non-finite loss")
                log_event("rollback", f"{reason} at step {e.step}: restoring the last good "
                                      "checkpoint and advancing the data stream past the "
                                      f"poisoned window (rollback {rollbacks}/"
                                      f"{config.max_rollbacks})")
                run_config = config.replace(resume="auto")
                data_advance, poison_pos = e.step, e.pos
            # the failed pass's state went with its frames: free its device
            # memory before the restored state is built
            gc.collect()
            if resolve_device(device).type == "cuda":
                torch.cuda.empty_cache()
    finally:
        if installed_chaos:
            # a plan left installed would hijack the next train() call
            clear_chaos()


def _sync_faults(preempt: bool, resize: bool, failed: int, total: int, telemetry, step: int,
                 dev, group) -> tuple[bool, bool, int, int]:
    """The group's agreement on the preemption and resize flags (any
    rank's) and the decode counters (summed), in one all-gather that also
    carries each rank's telemetry vector for the `pod` record."""
    row = [float(preempt), float(failed), float(total), float(resize)]
    if telemetry is not None:
        row += list(telemetry.pod_vector())
    rows = _all_gather_rows(np.asarray(row, np.float64), dev, group)
    if telemetry is not None:
        telemetry.pod_record(step, rows[:, 4:])
    return (bool(rows[:, 0].max()), bool(rows[:, 3].max()), int(rows[:, 1].sum()),
            int(rows[:, 2].sum()))


def _train_once(config: PretrainConfig, max_steps: int | None, device, dataset, on_step,
                stats, data_advance: int = 0,
                poison_pos: tuple[int, int] | None = None) -> tuple[TrainState, list[dict]]:
    """One pass of the driver, the body `train` runs again after a rollback.
    `data_advance` is the poisoned step and `poison_pos` the `(epoch,
    batch)` it consumed: every batch from the restored position THROUGH
    the poisoned one is skipped, across epoch boundaries (whole epochs
    before the poison's, its own through the poisoned batch), so the window
    is never consumed again. Whatever raises, its `finally` closes the
    Prefetcher, the profiler, the telemetry (its log_event sink) and the
    signal handlers, and lands any pending checkpoint before a restore walks
    the directory."""
    dev = resolve_device(device)
    group = process_group()
    world, me = world_size(group), rank(group)
    is_main = me == 0
    local_b = local_batch_size(config.batch_size, world)
    n_data, n_fsdp = layout_for_config(config, world)  # raises for a layout world cannot take
    if config.knn_monitor and config.knn_every_epochs < 1:
        raise ValueError(f"knn_every_epochs must be >= 1 (got {config.knn_every_epochs}); "
                         "disable the monitor with knn_monitor=False instead")
    dataset_len = None
    if dataset is None:
        if config.input_prestage:
            # the pre-staged epoch cache: epochs are row gathers from its mmap
            dataset = PrestagedDataset(config.input_prestage)
        elif config.input_service and not config.knn_monitor:
            # the remote-decode topology: this host may not even mount the
            # data, and its only use of the dataset would be len(), which the
            # servers' meta answer carries (the kNN monitor decodes locally,
            # so it keeps the local build)
            dataset_len = service_dataset_len(config.input_service)
        else:
            dataset = build_dataset(config.dataset, config.data_dir,
                                    image_size=config.image_size,
                                    stage_size=config.stage_size,
                                    num_workers=config.num_workers)
    if dataset_len is None:
        dataset_len = len(dataset)
    if dataset_len < config.batch_size:
        raise ValueError(f"the dataset holds {dataset_len} samples, fewer than one batch "
                         f"of {config.batch_size}")
    steps_per_epoch = min(config.steps_per_epoch or dataset_len // config.batch_size,
                          dataset_len // config.batch_size)
    total = config.epochs * steps_per_epoch if max_steps is None else max_steps
    if on_step is None:
        def on_step(step, metrics, seconds):
            print_step(step, metrics, seconds, config.batch_size)

    def report(msg: str) -> None:
        if is_main:
            print(msg, flush=True)

    # run telemetry: every rank builds one (the pod all-gather needs every
    # rank's vector), rank 0 alone writes; None when off, and then the loop
    # below runs no telemetry code. Built before the cache wrap, so that
    # the cache reports into its input statistics, and before the rollback's
    # events, so that they land in the stream.
    telemetry = None
    if config.telemetry_dir:
        from moco_tpu_torch.telemetry.run import RunTelemetry, health_block

        telemetry = RunTelemetry(config, n_chips=world, n_procs=world, process_index=me,
                                 steps_per_epoch=steps_per_epoch, device=dev)
        if stats is None:
            stats = telemetry.input_stats
        else:
            telemetry.input_stats = stats
    tracer = telemetry.tracer if telemetry is not None else None
    writer = ScalarWriter(config.tb_dir if is_main else "")
    profiler = ProfilerWindow(config.profile_dir if is_main else "", config.profile_start,
                              config.profile_stop)
    # the every-step sentinels; the collapse one is armed when a predicate
    # has a threshold
    sentinel = NaNSentinel() if config.loss_sentinel else None
    collapse = None
    if config.collapse_acc1 or config.collapse_emb_std or config.collapse_margin:
        collapse = CollapseSentinel(
            config.collapse_window, acc1_floor=config.collapse_acc1,
            emb_std_eps=config.collapse_emb_std, margin_eps=config.collapse_margin,
            min_step=config.collapse_min_step, rollback=config.collapse_rollback)
    plan = active_chaos()
    anomaly = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    resilience = contextlib.ExitStack()
    state = mgr = None
    preempted = resized = False
    try:
        if config.debug_nans:
            # the port's jax_debug_nans: autograd raises at the backward op
            # that made the first NaN
            torch.autograd.set_detect_anomaly(True, check_nan=True)
        if config.input_cache_mb and not config.input_prestage and dataset is not None:
            # a prestage already holds every canvas; caching it again would
            # duplicate in RAM what the page cache shares
            dataset = CachedDataset(dataset, config.input_cache_mb, stats=stats)

        # under zero_sharding the optimizer splits its state over the group;
        # a restore into it keeps this process's slices (the JAX driver's
        # shard_opt_state after the resume)
        state = create_train_state(config, build_encoder(config, group=group), dev,
                                   seed=config.seed, group=group)
        # the fsdp layout's subgroups (every rank makes every one); None for dp
        layout = build_layout(config, group)
        # the gradient sync's per-process accumulators, attached before any
        # resume so that a restore fills them (or restarts them from zeros);
        # told the layout, so that it describes the reduce the step runs
        gradsync = GradSync(config, group, layout)
        gradsync.attach(state)
        # fsdp: the parameters and optimizer state split before any restore,
        # which then keeps this process's slices
        state = place_state(state, config, layout)
        if group is not None:
            report(f"grad_sync: {gradsync.describe(state.model_q.named_parameters())}")
        mgr = checkpoint_manager(config.ckpt_dir) if config.ckpt_dir else None
        # every process restores the state, and its own accumulators
        state = maybe_resume(mgr, state, config.resume, group)
        if gradsync.needs_state and state.step:
            # a mode change at the same world size leaves the accumulators'
            # shapes as they were, but they were accumulated under another
            # reduce: the sidecar's stamp tells
            recorded = read_recorded_sharding(resume_dir(mgr, config.resume),
                                              state.step) or "dp"
            if recorded != config.sharding:
                if is_main:
                    log_event("ckpt-dialect",
                              f"step {state.step} was saved under sharding={recorded!r}, this "
                              f"run uses {config.sharding!r} — discarding its gradsync "
                              "accumulators: error-feedback/momentum state restarts from "
                              "zeros")
                for t in state.gradsync.values():
                    t.zero_()
        if telemetry is not None:
            # the sync plan: mode, knobs, the JAX package's analytic bytes a step
            sync_plan = gradsync.describe(state.model_q.named_parameters())
            sync_plan.pop("carried_bytes_per_step")  # the port's own count, not in the schema
            telemetry.set_grad_sync(dict(sync_plan, sharding=config.sharding))
        # the state's bytes a device, recorded once its first step has made
        # the optimizer's buffers
        sharding_pending = telemetry is not None
        # the data-stream position: the sidecar of the restored step, else step
        # arithmetic; the resumed epoch skips the batches it already used (the
        # epoch permutation is deterministic, so batch i is the interrupted
        # run's batch i). Positions count global batches, so a restore at
        # another world size resumes at the same place.
        pos = None
        if state.step:
            ckpt_from = resume_dir(mgr, config.resume)
            pos = read_position(ckpt_from, state.step)
            saved_under = read_recorded_devices(ckpt_from, state.step)
            report(f"resumed at step {state.step}" + (
                f" (saved under {saved_under} processes, now {world})"
                if saved_under not in (None, world) else ""))
        epoch, skip = pos if pos is not None else divmod(state.step, steps_per_epoch)
        poison = None
        if data_advance > state.step:
            # a rollback: the weights restart from the restored step, the data
            # stream skips through the poisoned batch
            poison = (poison_pos if poison_pos is not None
                      else divmod(data_advance - 1, steps_per_epoch))
            log_event("rollback", "advancing the data stream past the poisoned window: "
                                  f"restored step {state.step}, skipping through batch "
                                  f"{poison[1]} of epoch {poison[0]}")

        step_fn = build_train_step(config, steps_per_epoch, group=group)
        aug_cfg = aug_config_for(config)
        # each process draws the views of the whole global batch and keeps its rows
        rows = None if group is None else (me * local_b, config.batch_size)
        history = []
        feature_fn = monitor_val = None
        if config.knn_monitor:
            feature_fn = make_feature_fn(state.model_q, config.variant)
            monitor_val = _monitor_val_split(config, dataset)
        baseline_path = (os.path.join(mgr.directory, "untrained_baseline.json")
                         if mgr else None)
        # the kNN monitor runs on every process, as the JAX driver's does; only
        # rank 0 reports and writes
        if config.knn_monitor and state.step == 0:
            # what random features score on the same data, before any step
            with _full_params(state):
                acc0, is_val = knn_monitor(config, feature_fn, state, dataset, monitor_val)
            tag0 = "knn_val_top1_untrained" if is_val else "knn_train_top1_untrained"
            history.append({"step": 0, tag0: acc0})
            report(f"Epoch [-1] kNN({'val' if is_val else 'train'}) top-1 {100 * acc0:.2f}% "
                   f"(UNTRAINED baseline; chance {100.0 / dataset.num_classes:.2f}%)")
            if is_main:
                writer.write(0, {tag0: acc0})
            if telemetry is not None:
                telemetry.event("knn_eval", step=0, tag=tag0, acc=float(acc0))
            if baseline_path and is_main:
                _write_json(baseline_path, {tag0: acc0})  # a resumed run cannot measure it
        elif config.knn_monitor and baseline_path and os.path.exists(baseline_path):
            try:
                with open(baseline_path) as f:
                    baseline = dict(json.load(f))
            except (OSError, ValueError, TypeError):
                baseline = {}  # unreadable: the history carries no baseline
            if baseline:
                history.append({"step": 0, **baseline})
                report(f"kNN untrained baseline {baseline}, restored from {baseline_path}")
        preempt = resilience.enter_context(PreemptionHandler())
        # elastic resize: SIGUSR2 or a <telemetry_dir>/resize.request asks for
        # an elastic checkpoint and EXIT_RESIZE, for a relaunch onto another
        # number of cards
        resize = resilience.enter_context(ResizeListener(config.telemetry_dir))
        watchdog = resilience.enter_context(StepWatchdog(config.watchdog_secs))
        since, t_last = 0, time.perf_counter()
        while state.step < total and epoch < config.epochs:
            if poison is not None and epoch <= poison[0]:
                # inside the poisoned window: the epochs before the poison's
                # whole, the poison's own through the poisoned batch
                skip = steps_per_epoch if epoch < poison[0] else max(skip, poison[1] + 1)
            epoch_start_step = state.step
            loader = None
            if skip < steps_per_epoch and config.input_service:
                # the same permutation, rank shard and skip, with the canvas
                # rows fetched from the staging servers: the same bits
                loader = service_epoch_loader(
                    config.input_service, dataset_len, epoch, config.seed, config.batch_size,
                    dev, skip_batches=skip, retries=config.loader_retries,
                    backoff_secs=config.loader_backoff_secs, depth=config.prefetch_depth,
                    streams=config.staging_workers, stats=stats, tracer=tracer,
                    request_timeout_s=config.input_request_timeout_s,
                    num_processes=world, process_index=me)
            elif skip < steps_per_epoch:
                loader = epoch_loader(dataset, epoch, config.seed, config.batch_size, dev,
                                      skip_batches=skip, retries=config.loader_retries,
                                      backoff_secs=config.loader_backoff_secs,
                                      depth=config.prefetch_depth,
                                      workers=config.staging_workers, stats=stats,
                                      trim_h2d=config.h2d_trim, num_processes=world,
                                      process_index=me, tracer=tracer)
            next_batch = skip
            # the rolling rate sheds the epoch's first-step stall
            throughput = Throughput(world, window=32)
            if telemetry is not None:
                telemetry.timer.epoch_start()
            try:
                for i, (images, _labels, extents) in enumerate(loader or (), start=skip):
                    if i >= steps_per_epoch or state.step >= total:
                        break
                    if telemetry is not None:
                        telemetry.timer.mark_data()
                    profiler.maybe_toggle(state.step)
                    im_q, im_k = two_crops(images, aug_cfg, state.data_generator, extents,
                                           rows)
                    metrics = step_fn(state, im_q, im_k)
                    # telemetry's comm stamps and the stride's health
                    # diagnostics leave the metrics the meters see
                    gs_pre = metrics.pop("gs_comm_pre", None)
                    gs_post = metrics.pop("gs_comm_post", None)
                    health_dev = {k: metrics.pop(k) for k in
                                  [k for k in metrics if k.startswith("h_")]}
                    next_batch = i + 1
                    since += 1
                    if telemetry is not None:
                        telemetry.timer.mark_dispatch()
                        if sharding_pending:
                            sharding_pending = False
                            mesh_shape = ({"data": world} if config.sharding == "dp"
                                          else {"data": n_data, "fsdp": n_fsdp})
                            telemetry.set_sharding(dict(mode=config.sharding,
                                                        mesh_shape=mesh_shape,
                                                        **state_bytes_per_device(state)))
                        # stride-gated fence: the other steps stay asynchronous
                        telemetry.timer.maybe_fence(state.step, metrics["loss"],
                                                    comm_pre=gs_pre, comm_post=gs_post)
                    if plan is not None and plan.maybe_nan(state.step):
                        # an injected divergence flows through the same metrics
                        metrics["loss"] = float("nan")
                    if sentinel is not None:
                        sentinel.observe(state.step, metrics["loss"], pos=(epoch, i))
                    if collapse is not None:
                        # the diagnostics are real on stride steps only
                        collapse.observe(state.step, {"logit_margin": metrics["logit_margin"],
                                                      "acc1": metrics["acc1"], **health_dev},
                                         pos=(epoch, i))
                    if plan is not None:
                        plan.maybe_slow(state.step)  # inside this step's timer window
                    watchdog.beat(state.step)
                    # a rank's fault signals are acted on by every rank at once
                    # (one rank breaking alone would hang the others in the
                    # next collective): under a group they are agreed on every
                    # resilience_sync_steps steps, alone at once
                    failed = getattr(dataset, "decode_failures", 0)
                    decoded = getattr(dataset, "decode_total", 0)
                    # the trigger file, time-gated, before the agreement, so
                    # that every rank folds in the same observation
                    resize.poll()
                    agreed = resize_agreed = False
                    if group is not None:
                        if (config.resilience_sync_steps > 0
                                and state.step % config.resilience_sync_steps == 0):
                            agreed, resize_agreed, failed, decoded = _sync_faults(
                                preempt.triggered, resize.triggered, failed, decoded,
                                telemetry, state.step, dev, group)
                        else:
                            failed = decoded = 0
                    check_decode_rate(failed, decoded, config)
                    step_loss = None
                    if i % config.print_freq == 0:
                        metrics = host_metrics(metrics)
                        step_loss = metrics["loss"]
                        if config.debug_nans and not math.isfinite(step_loss):
                            raise FloatingPointError(
                                f"non-finite loss {step_loss} at step {state.step}")
                        seconds = (time.perf_counter() - t_last) / since
                        history.append(metrics)
                        if is_main:
                            on_step(state.step, metrics, seconds)
                            writer.write(state.step, dict(
                                metrics, imgs_per_sec=throughput.rolling_imgs_per_sec,
                                imgs_per_sec_per_chip=throughput.rolling_imgs_per_sec
                                / max(world, 1)))
                        since, t_last = 0, time.perf_counter()
                    throughput.update(config.batch_size)
                    if telemetry is not None:
                        health = health_block(health_dev, metrics) if health_dev else None
                        phases = telemetry.timer.finish_step()
                        if telemetry.on_step(state.step, phases, throughput, loss=step_loss,
                                             health=health):
                            writer.flush()
                    if plan is not None:
                        plan.maybe_sigterm(state.step)
                        # the resize drill: the target count goes where the
                        # supervisor looks for it, then the operator's path
                        chaos_devices = plan.maybe_resize(state.step)
                        if chaos_devices is not None:
                            if config.telemetry_dir:
                                write_resize_request(config.telemetry_dir,
                                                     devices=chaos_devices or None)
                            resize.trigger()
                        if plan.maybe_collapse(state.step):
                            # every step from the onset: the EMA would heal a
                            # one-shot crush
                            crush_key_params(state.model_k, None if state.fsdp is None
                                             else state.fsdp.local)
                        # after on_step, so the heartbeat records this step
                        plan.maybe_kill(state.step)
                        plan.maybe_freeze(state.step)
                    if agreed or (group is None and preempt.triggered):
                        # finish the step, then stop; the emergency checkpoint
                        # follows at a step every rank agrees on
                        preempted = True
                        break
                    if resize_agreed or (group is None and resize.triggered):
                        # the same stop, but the exit asks for a relaunch onto
                        # another number of cards (EXIT_RESIZE); a rank that
                        # learned it from the group marks its listener too, so
                        # that a late SIGUSR2 finds it ignored, not fatal
                        resize.trigger(source="agreed by the group")
                        resized = True
                        break
            finally:
                if loader is not None:
                    # quietly: a pending staging error must not replace the
                    # exception in flight (disarming the rollback)
                    loader.close_quietly()
            if sentinel is not None:
                # the epoch's last loss, before any checkpoint of it (the
                # rollback would otherwise restore the very state it escapes)
                sentinel.flush()
            if collapse is not None:
                collapse.flush()
            if preempted or resized:
                break  # no epoch eval or save: the emergency checkpoint follows
            finished = state.step >= total
            t_pause = time.perf_counter()
            if telemetry is not None and state.step > epoch_start_step:
                telemetry.event("epoch_summary", epoch=epoch, step=state.step,
                                imgs_per_sec=round(throughput.imgs_per_sec, 2),
                                imgs_per_sec_rolling=round(throughput.rolling_imgs_per_sec,
                                                           2))
            # epochs with no step (a resume at an epoch's end, an epoch the
            # rollback skipped) report and save nothing
            if config.knn_monitor and state.step > epoch_start_step and (
                    (epoch + 1) % config.knn_every_epochs == 0 or epoch == config.epochs - 1
                    or finished):
                if telemetry is not None:
                    # a supervisor widens its staleness window for the eval
                    telemetry.phase_beat("eval", state.step)
                with watchdog.suspended(), _full_params(state):  # no beat is no hang
                    acc, is_val = knn_monitor(config, feature_fn, state, dataset,
                                              monitor_val)
                tag = "knn_val_top1" if is_val else "knn_train_top1"
                history.append({"step": state.step, tag: acc})
                report(f"Epoch [{epoch}] kNN({'val' if is_val else 'train'}) top-1 "
                       f"{100 * acc:.2f}%")
                if is_main:
                    writer.write(state.step, {tag: acc})
                if telemetry is not None:
                    telemetry.event("knn_eval", step=state.step, epoch=epoch, tag=tag,
                                    acc=float(acc))
            if mgr is not None and state.step > epoch_start_step \
                    and (epoch + 1) % config.ckpt_every_epochs == 0:
                position = ((epoch + 1, 0) if next_batch >= steps_per_epoch
                            else (epoch, next_batch))
                # asynchronous: the write overlaps the next epoch's steps
                save_checkpoint(mgr, state, state.step, position=position, devices=world,
                                group=group, wait=False, sharding=config.sharding)
            epoch, skip = epoch + 1, 0
            t_last += time.perf_counter() - t_pause  # the printed step time leaves these out
        if sentinel is not None:
            sentinel.flush()
        if collapse is not None:
            collapse.flush()
    finally:
        # land the profiler trace and the run_end record, restore the signal
        # dispositions, stop the watchdog, and land a pending save, even when
        # the loop raises
        resilience.close()
        torch.autograd.set_detect_anomaly(*anomaly)
        profiler.close()
        if telemetry is not None:
            # `preempted` makes the heartbeat's last phase preempt_exit,
            # `resized` resize_exit
            telemetry.close(scalar_drops=writer.dropped,
                            last_step=state.step if state is not None else 0,
                            preempted=preempted, resized=resized)
        writer.close()
        if mgr is not None:
            finalize_checkpoints(mgr, group)
    if preempted or resized:
        if mgr is not None:
            # synchronous, at the mid-epoch position: the resumed run is the
            # uninterrupted one bit for bit (at another world size, the same
            # data stream)
            position = (epoch + 1, 0) if next_batch >= steps_per_epoch else (epoch, next_batch)
            log_event("resize" if resized else "preempt",
                      f"writing {'elastic' if resized else 'emergency'} checkpoint at step "
                      f"{state.step}, then exiting cleanly", step=state.step, pid=os.getpid())
            save_checkpoint(mgr, state, state.step, position=position, devices=world,
                            group=group, sharding=config.sharding)
        history.append({"step": state.step, "resized" if resized else "preempted": True})
    if state.fsdp is not None:
        # the full parameters for the export and the caller (every rank)
        state.fsdp.gather()
    if not (preempted or resized) and config.export_path and is_main:
        if config.variant == "v3":
            export_v3_backbone(state, config.export_path, config.image_size)
        elif config.arch.startswith("vit"):
            export_vit_encoder(state, config.export_path, config.image_size)
        else:
            export_encoder_q(state, config.export_path)
        print(f"exported encoder -> {config.export_path}", flush=True)
    return state, history


def _full_params(state):
    """The full parameters of an fsdp state for the body (gathered and
    released by every rank), else nothing to do."""
    return state.fsdp.gathered() if state.fsdp is not None else contextlib.nullcontext()


def service_dataset_len(endpoints_spec) -> int:
    """The dataset length from the first staging server that answers a meta
    probe. Every endpoint is tried once; none answering is a configuration
    error (`ServiceConfigError`): the servers are expected up before the
    train host starts, as `ServiceClient`'s handshake expects them. A
    same-length server with other data is still caught per connection by
    the client's meta check."""
    endpoints = (protocol.parse_endpoints(endpoints_spec)
                 if isinstance(endpoints_spec, str) else endpoints_spec)
    tried = []
    for host, port in endpoints:
        meta = protocol.fetch_meta(host, port)
        if meta is not None and int(meta.get("n", 0)) > 0:
            return int(meta["n"])
        tried.append(f"{host}:{port}")
    raise ServiceConfigError("no staging server answered a meta probe (tried "
                             + ", ".join(tried)
                             + "): start the servers first, or unset input_service")


def _all_gather_rows(vector: np.ndarray, device, group) -> np.ndarray:
    """Every rank's float64 `vector`, gathered into `[world, len]` (one
    `all_gather` on the group's device)."""
    import torch.distributed as dist

    local = torch.as_tensor(vector, dtype=torch.float64, device=device)
    rows = [torch.empty_like(local) for _ in range(world_size(group))]
    dist.all_gather(rows, local, group=group)
    return torch.stack(rows).cpu().numpy()


def _check_num_devices(n: int, device: str) -> None:
    """Raise ValueError (RuntimeError for CUDA asked for and absent) unless
    this host can run `n` rank processes on `device`."""
    if n < 1:
        raise ValueError(f"--num-devices must be >= 1, got {n}")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise ValueError("--num-devices starts its own rank processes; under torchrun "
                         f"(WORLD_SIZE={os.environ['WORLD_SIZE']}) leave it out")
    if resolve_device(device).type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"--num-devices {n} but this host has {torch.cuda.device_count()} "
                         "card(s)")


def main(argv=None) -> None:
    """CLI entry. Exits through the named codes of `resilience/exitcodes.py`:
    0 at the run's end, EXIT_PREEMPTED after an honored SIGTERM/SIGINT and
    its emergency checkpoint, EXIT_RESIZE after an honored resize and its
    elastic checkpoint, EXIT_ROLLBACK_EXHAUSTED and EXIT_DATA_QUALITY for the
    run-enders a restart cannot fix, EXIT_CONFIG_ERROR for a bad preset,
    flag or config, or a device or world the host cannot satisfy. Anything
    else propagates as a traceback (exit 1, a generic crash).

    With `--num-devices N` (N > 1) this process is the launcher of N rank
    processes (`parallel/launch.py`) and exits with their code."""
    set_precision_policy()
    parser = argparse.ArgumentParser(description="moco_tpu_torch pretraining")
    parser.add_argument("--preset", default="imagenet-moco-v2",
                        choices=preset_names(PretrainConfig))
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; cuda:LOCAL_RANK in a group) or cpu")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="start this many rank processes, one per card (gloo ranks "
                             "with --device cpu); the last one given wins")
    parser.add_argument("--deterministic", type=lambda s: s.lower() in ("1", "true", "yes"),
                        default=False,
                        help="cuDNN's deterministic algorithms, for runs held bit for bit "
                             "against each other")
    add_config_flags(parser)
    args = parser.parse_args(argv)
    # a rank of a launcher dies with it, and a SIGUSR2 outside its resize
    # listener does not kill it
    join_launcher()
    try:
        config = get_preset(args.preset).replace(**collect_overrides(args))
    except (TypeError, ValueError) as e:
        # the same argv can never succeed: the code says "do not restart me"
        log_event("exit", f"config error: {e}", code=EXIT_CONFIG_ERROR)
        sys.exit(EXIT_CONFIG_ERROR)
    try:
        if args.num_devices is not None:
            _check_num_devices(args.num_devices, args.device)
        # the device and rank the group would take, before any rendezvous
        topology(args.device)
        # and the sharding layout those ranks can take (a resize may have
        # appended a --sharding the new count cannot divide)
        layout_for_config(config, args.num_devices or int(os.environ.get("WORLD_SIZE", "1")))
    except (RuntimeError, ValueError) as e:
        # a device or world this host can never give (a resize to more cards
        # than it has): a relaunch of the same argv cannot succeed either
        log_event("exit", f"device config error: {e}", code=EXIT_CONFIG_ERROR)
        sys.exit(EXIT_CONFIG_ERROR)
    if args.num_devices is not None and args.num_devices > 1:
        code = launch(args.num_devices,
                      strip_device_flag(list(sys.argv[1:] if argv is None else argv)))
        log_event("exit", f"the {args.num_devices} ranks ended; the launcher exits {code}",
                  code=code)
        exit_with(code)
    if args.deterministic:
        torch.backends.cudnn.deterministic = True
    # a launched rank or torchrun's (WORLD_SIZE > 1) joins the group; alone a no-op
    dev = init_distributed(args.device, init_method=os.environ.get(ENV_INIT_METHOD) or None)
    try:
        group = process_group()
        if rank(group) == 0:
            name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
            print(f"config: {config}\ndevice: {dev} ({name}), {world_size(group)} "
                  f"process(es)", flush=True)
        try:
            _state, history = train(config, max_steps=args.max_steps, device=dev)
        except RollbackExhaustedError as e:
            log_event("exit", f"rollback budget exhausted: {e}", code=EXIT_ROLLBACK_EXHAUSTED)
            sys.exit(EXIT_ROLLBACK_EXHAUSTED)
        except DataQualityError as e:
            log_event("exit", f"data quality abort: {e}", code=EXIT_DATA_QUALITY)
            sys.exit(EXIT_DATA_QUALITY)
        except ServiceConfigError as e:
            # unreachable or drifted staging servers: a config error, and
            # nothing decodes in-process instead
            log_event("exit", f"input service config error: {e}", code=EXIT_CONFIG_ERROR)
            sys.exit(EXIT_CONFIG_ERROR)
        if history and history[-1].get("preempted"):
            log_event("exit", "preemption honored: emergency checkpoint written, exiting "
                              "for relaunch", code=EXIT_PREEMPTED)
            sys.exit(EXIT_PREEMPTED)
        if history and history[-1].get("resized"):
            log_event("exit", "resize honored: elastic checkpoint written, exiting for "
                              "relaunch onto the new number of cards", code=EXIT_RESIZE)
            sys.exit(EXIT_RESIZE)
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    main()
