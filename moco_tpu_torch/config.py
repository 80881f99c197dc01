"""Configs of the port: the fields the v1/v2 and v3 pretrain steps, their
input pipeline, checkpoints and kNN monitor read (`PretrainConfig`), the
linear probe's and kNN eval's (`EvalConfig`), the embedding service's
(`ServeConfig`), the presets, and the flag surface of the entry points.

The port's own copy of the relevant part of `moco_tpu/config.py`
(`PretrainConfig`, `EvalConfig`, `ServeConfig`, the `imagenet-moco-v1`, `imagenet-moco-v2`,
`imagenet-moco-v2-8chip`, `cifar10-moco-v1`, `imagenet-moco-v3-vits`,
`-vitb`, `-r50`, `imagenet-lincls` and `imagenet-lincls-v3` presets,
`effective_lr`); field names, defaults and validation are the same, except
that `ckpt_dir` defaults to "" (no checkpoints unless asked for) in both
configs, so a run writes nothing into its working directory by default,
and that `shuffle_mode`, `grad_allreduce_dtype`, `optimizer` and
`crop_min` are checked here (the JAX package checks them where they are used). The
gradient-sync knobs, `zero_sharding`, `sharding` and `sharding_axis_size`
carry the JAX package's checks and messages, its rule that `zero_sharding`
excludes `sharding != "dp"` included. `zero_sharding` splits the state of
every optimizer (SGD, AdamW, LARS), as the JAX package shards any optax
state; `sharding="fsdp"|"fsdp_tp"` shards the v3 step's parameters and
optimizer state (`parallel/fsdp.py`).
The telemetry, tracing, learning-health and resilience fields carry the
JAX package's defaults and checks. The port adds checks of its own to the
resilience knobs, which the JAX package leaves unchecked: `max_rollbacks`,
`watchdog_secs`, `loader_retries` and `loader_backoff_secs` must be >= 0,
and `chaos` must parse (with the JAX parser's message). `sync_bn` and the
input-service fields (`input_service`, `input_request_timeout_s`) carry the
JAX package's defaults and checks.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

VARIANTS = ("v1", "v2", "v3")
OPTIMIZERS = ("sgd", "adamw", "lars")
DATASETS = ("synthetic", "synthetic_texture", "cifar10", "imagefolder")


@dataclass
class PretrainConfig:
    # experiment
    name: str = "moco"
    variant: str = "v2"               # "v1" | "v2" | "v3"
    seed: int = 0
    # model (reference flags -a/--arch, --moco-dim/k/m/t, --mlp)
    arch: str = "resnet50"            # resnet18/34/50/101/152 | vit_small/base/large/huge
    embed_dim: int = 128              # --moco-dim
    num_negatives: int = 65536        # --moco-k (v3 has no queue)
    momentum_ema: float = 0.999       # --moco-m (v3: the base of the cosine ramp, 0.99)
    temperature: float = 0.07         # --moco-t (v2 runs use 0.2)
    mlp_head: bool = False            # --mlp
    cifar_stem: bool = False
    shuffle_mode: str = "permute"     # ShuffleBN across processes: "permute" (gather +
                                      # one shared permutation) | "ring" (half-shard
                                      # exchanges, partial decorrelation)
    compute_dtype: str = "float32"    # "bfloat16" for the ImageNet presets
    sync_bn: bool = False             # BN statistics over the group's global batch
                                      # (models/fast_bn.py); per-process BN is the
                                      # MoCo default
    fused_bn_conv: bool = False       # blocks' bn->relu->conv through the fused kernels
    remat: bool = False               # recompute each ViT block in the backward
                                      # (torch.utils.checkpoint): memory for FLOPs
    # data parallelism across processes (parallel/)
    collective_chunks: int = 1        # ShuffleBN gathers as N chunk collectives (same bits)
    grad_sync: str = "fused"          # gradient sync (parallel/gradsync.py): "fused" (one
                                      # flat all-reduce) | "bucketed" (a reduce per bucket,
                                      # launched from the backward) | "quantized" (int8/bf16
                                      # with error feedback) | "demo" (top-k of a local
                                      # momentum every grad_sync_cadence steps)
    grad_sync_bucket_mb: float = 4.0  # bucketed/quantized: MiB of wire bytes a bucket
    grad_sync_quant_dtype: str = "int8"  # quantized wire dtype: "int8" | "bfloat16"
    grad_sync_cadence: int = 1        # demo: sync every N steps
    grad_sync_topk: float = 0.01      # demo: fraction of each leaf's momentum synced
    grad_sync_demo_beta: float = 0.9  # demo: local momentum decay
    grad_allreduce_dtype: str = "float32"  # fused/bucketed wire dtype: "float32" | "bfloat16"
    zero_sharding: bool = False       # ZeRO-1: the optimizer's state split 1/n over the
                                      # processes
                                      # (parallel/zero.py)
    sharding: str = "dp"              # "dp" (parameters whole on every process) | "fsdp"
                                      # (v3 only: parameters and optimizer state split
                                      # 1/n over every process, gathered on use;
                                      # parallel/fsdp.py) | "fsdp_tp" (split over an
                                      # inner group of sharding_axis_size processes,
                                      # whole across the groups; quantized grad_sync
                                      # becomes the two-hop reduce)
    sharding_axis_size: int = 0       # the inner (fsdp) group's size for fsdp_tp; 0 =
                                      # derive (every process for fsdp, the largest
                                      # proper divisor for fsdp_tp). Must divide the
                                      # number of processes.
    # data
    dataset: str = "synthetic"        # synthetic | synthetic_texture | cifar10 | imagefolder
    data_dir: str = ""
    image_size: int = 224
    aug_plus: bool = False            # --aug-plus (v2 augmentation stack)
    crop_min: float = 0.0             # v3 --crop-min (0 = the v3 default, 0.08)
    num_workers: int = 0              # ImageFolder decode threads (-j); 0 = its default (8)
    stage_size: int = 0               # ImageFolder canvas shorter side; 0 = its default (512)
    # input pipeline (data/loader.py)
    prefetch_depth: int = 2           # device batches staged ahead of the consumer
    staging_workers: int = 4          # staging threads, each decoding a sub-slice of a batch
    input_cache_mb: int = 0           # decode-once canvas cache budget in MiB (0 = off)
    h2d_trim: bool = False            # copy only the canvas prefix the extents cover
    decode_abort_rate: float = 0.5    # DataQualityError past this decode-failure rate (0 = never)
    input_prestage: str = ""          # pre-staged epoch cache directory
                                      # (data/service/prestage.py): epochs are row gathers
    input_service: str = ""           # "host:port,host:port" staging-server data
                                      # endpoints (data/service/): batches are fetched
                                      # from standalone decode servers (ServiceClient),
                                      # bit for bit the in-process staging; "" = in-process
    input_request_timeout_s: float = 30.0  # one service shard round trip before the
                                      # client tears the link and asks another server
    # optimization (reference: SGD momentum .9, wd 1e-4, lr .03, batch 256)
    optimizer: str = "sgd"            # sgd | adamw | lars
    lr: float = 0.03                  # absolute lr; 0.0 = derive from base_lr
    base_lr: float = 0.0              # lr per 256 samples
    batch_size: int = 256
    epochs: int = 200
    warmup_epochs: int = 0
    schedule: tuple[int, ...] = (120, 160)  # step-lr milestones (epochs)
    cos: bool = False                 # --cos
    sgd_momentum: float = 0.9
    weight_decay: float = 1e-4
    momentum_ramp: bool = False       # v3: cosine ramp of the EMA momentum to 1
    print_freq: int = 10              # -p: metrics reach the host on these steps only
    tb_dir: str = ""                  # tensorboardX scalar logdir ("" = off)
    profile_dir: str = ""             # torch.profiler trace of steps [profile_start,
    profile_start: int = 10           # profile_stop) into this directory ("" = off)
    profile_stop: int = 20
    debug_nans: bool = False          # autograd anomaly mode with its NaN check for the
                                      # run, and a finite-loss check on print steps
    # run telemetry (telemetry/): step phases, MFU, device memory, events
    telemetry_dir: str = ""           # events.jsonl, heartbeat.json and spans.jsonl
                                      # land here ("" = telemetry off: the step loop
                                      # does no telemetry work)
    telemetry_flush_steps: int = 50   # buffered-record flush cadence, in records
    heartbeat_secs: float = 1.0       # min seconds between heartbeat.json writes
    telemetry_stride: int = 16        # every N steps the fence pulls the loss to the
                                      # host (device_s, comm_s) and memory is sampled;
                                      # the other steps stay asynchronous (0 = never)
    peak_flops_per_chip: float = 0.0  # MFU denominator override; 0 = the card's
                                      # datasheet peak (telemetry/mfu.py; an unknown
                                      # device reports no MFU)
    trace_mode: str = "off"           # spans: "off" (capture windows still armable) |
                                      # "steps" (one a step / staged batch) | "full"
                                      # (+ decode slices, H2D copies, phase segments)
    trace_capture_steps: int = 50     # capture-window length in steps (SIGUSR1,
                                      # <telemetry_dir>/trace.trigger, anomalies)
    trace_capture_budget: int = 3     # capture windows a run (0 = captures off)
    trace_slow_step_k: float = 3.0    # arm a capture when step_s (or data_s) exceeds
                                      # k x its rolling p95
    trace_device_profile: bool = False  # capture windows also record a torch.profiler
                                      # trace into <telemetry_dir>/traces/
    # learning health (telemetry/health.py, resilience/sentinel.py)
    health_stride: int = 0            # 0 = off; N = the collapse diagnostics every N
                                      # steps, the step records' `health` block (the
                                      # trajectory is the same bits either way)
    collapse_window: int = 50         # CollapseSentinel window, in observations
    collapse_min_step: int = 0        # predicates evaluate only past this step
    collapse_acc1: float = 0.0        # predicate: acc1 below this over a window (0 = off)
    collapse_emb_std: float = 0.0     # predicate: embedding std <= this (0 = off;
                                      # needs health_stride > 0)
    collapse_margin: float = 0.0      # predicate: logit margin <= this (0 = off)
    collapse_rollback: bool = False   # a fired predicate raises CollapseError into the
                                      # bounded rollback (max_rollbacks-capped) instead of
                                      # logging a `health` incident
    resilience_sync_steps: int = 16   # process groups: every N steps the ranks agree on
                                      # the preemption flag and the decode counters in
                                      # one all-gather that also carries the telemetry's
                                      # `pod` record (0 = never: no preemption or decode
                                      # abort under a group)
    # checkpoints (checkpoint.py)
    ckpt_dir: str = ""                # full-state checkpoints ("" = none)
    ckpt_every_epochs: int = 1
    resume: str = ""                  # "" | "auto" | <step> | <ckpt_dir>/<step>
    export_path: str = ""             # write encoder_q (.npz/.safetensors) at the end
    steps_per_epoch: int | None = None  # derived from the dataset unless set
    # fault tolerance (resilience/)
    loss_sentinel: bool = True        # every-step non-finite loss check (one-step lag)
    max_rollbacks: int = 3            # consecutive rollbacks before the run aborts
                                      # (0 = a non-finite loss raises at once)
    watchdog_secs: float = 0.0        # flag when no step completes within this (0 = off)
    loader_retries: int = 3           # transient read retries a batch (Prefetcher)
    loader_backoff_secs: float = 0.5  # base backoff between retries (doubling)
    chaos: str = ""                   # fault-injection spec, e.g. "sigterm_at_step=100"
                                      # (resilience/chaos.py; also MOCO_TPU_CHAOS)
    # kNN monitor (train.py::knn_monitor)
    knn_monitor: bool = False         # kNN top-1 at step 0 and every knn_every_epochs
    knn_every_epochs: int = 1         # the run's final epoch always reports
    knn_bank_size: int = 4096         # monitor bank cap (train-subset size)
    num_classes: int = 1000           # dataset classes (kNN only)

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"variant {self.variant!r} is not ported; choose from {VARIANTS}")
        if self.dataset not in DATASETS:
            raise ValueError(f"dataset {self.dataset!r} is not ported; choose from {DATASETS}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        # a bad depth or worker count fails where it was written, not as a
        # wedged queue half an epoch into a run
        if self.prefetch_depth < 1:
            raise ValueError(f"prefetch_depth must be >= 1, got {self.prefetch_depth}")
        if self.staging_workers < 1:
            raise ValueError(f"staging_workers must be >= 1, got {self.staging_workers}")
        if self.input_cache_mb < 0:
            raise ValueError(f"input_cache_mb must be >= 0, got {self.input_cache_mb}")
        # a typo'd endpoint list fails where it was written, not as an
        # unreachable-server stall mid-run
        if self.input_request_timeout_s <= 0:
            raise ValueError("input_request_timeout_s must be > 0, got "
                             f"{self.input_request_timeout_s}")
        if self.input_service:
            from moco_tpu_torch.data.service.protocol import parse_endpoints

            parse_endpoints(self.input_service)  # raises ValueError
            if self.h2d_trim:
                raise ValueError(
                    "input_service and h2d_trim are mutually exclusive: extent-trimming "
                    "slices the staged canvas CLIENT-side into a shape grid the remote "
                    "shard frames do not carry — run the service with full canvases or "
                    "trim in-process")
            if self.input_prestage:
                raise ValueError(
                    "input_service and input_prestage are mutually exclusive on the "
                    "train host: the service loader would feed training while the "
                    "prestage sat unused — point the staging servers at it instead "
                    "(python -m moco_tpu_torch.staging_server --prestage <dir>)")
        if self.print_freq < 1:
            raise ValueError(f"print_freq must be >= 1, got {self.print_freq}")
        if self.ckpt_every_epochs < 1:
            raise ValueError(f"ckpt_every_epochs must be >= 1, got {self.ckpt_every_epochs}")
        if self.shuffle_mode not in ("permute", "ring"):
            raise ValueError(f"unknown shuffle_mode {self.shuffle_mode!r}; choose from "
                             "permute/ring")
        # the sharding knobs: literals kept in step with parallel/mesh.SHARDING_MODES
        if self.sharding not in ("dp", "fsdp", "fsdp_tp"):
            raise ValueError(f"unknown sharding {self.sharding!r}; choose from "
                             "dp/fsdp/fsdp_tp")
        if self.sharding != "dp" and self.variant != "v3":
            raise ValueError(
                f"sharding={self.sharding!r} requires variant='v3': the queue-based v1/v2 "
                "step needs the replicated queue's identical-enqueue invariant (and its "
                "encoders fit per-chip) — FSDP targets the queue-free large-batch v3 regime")
        if self.sharding_axis_size < 0:
            raise ValueError(f"sharding_axis_size must be >= 0, got "
                             f"{self.sharding_axis_size}")
        if self.sharding != "dp" and self.zero_sharding:
            raise ValueError(
                "zero_sharding and sharding=fsdp/fsdp_tp are mutually exclusive: fsdp "
                "already shards the optimizer state over the fsdp axis — re-placing it with "
                "the ZeRO-1 data-axis layout would silently re-replicate the shards")
        if self.collective_chunks < 1:
            raise ValueError(f"collective_chunks must be >= 1, got {self.collective_chunks}")
        if self.grad_sync not in ("fused", "bucketed", "quantized", "demo"):
            raise ValueError(f"unknown grad_sync {self.grad_sync!r}; choose from "
                             "fused/bucketed/quantized/demo")
        if self.grad_sync_bucket_mb <= 0:
            raise ValueError(f"grad_sync_bucket_mb must be > 0, got {self.grad_sync_bucket_mb}")
        if self.grad_sync_quant_dtype not in ("int8", "bfloat16"):
            raise ValueError(f"unknown grad_sync_quant_dtype {self.grad_sync_quant_dtype!r}")
        if self.grad_sync_cadence < 1:
            raise ValueError(f"grad_sync_cadence must be >= 1, got {self.grad_sync_cadence}")
        if not 0.0 < self.grad_sync_topk <= 1.0:
            raise ValueError(f"grad_sync_topk must be in (0, 1], got {self.grad_sync_topk}")
        if not 0.0 <= self.grad_sync_demo_beta < 1.0:
            raise ValueError(f"grad_sync_demo_beta must be in [0, 1), got "
                             f"{self.grad_sync_demo_beta}")
        if self.grad_allreduce_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown grad_allreduce_dtype {self.grad_allreduce_dtype!r}")
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.optimizer!r}; choose from {OPTIMIZERS}")
        if not 0.0 <= self.crop_min <= 1.0:
            raise ValueError(f"crop_min must be in [0, 1], got {self.crop_min}")
        if self.trace_mode not in ("off", "steps", "full"):
            raise ValueError(f"unknown trace_mode {self.trace_mode!r}; choose from "
                             "off/steps/full")
        if self.trace_capture_steps < 1:
            raise ValueError(f"trace_capture_steps must be >= 1, got "
                             f"{self.trace_capture_steps}")
        if self.trace_capture_budget < 0:
            raise ValueError(f"trace_capture_budget must be >= 0, got "
                             f"{self.trace_capture_budget}")
        if self.trace_slow_step_k <= 1.0:
            raise ValueError(f"trace_slow_step_k must be > 1, got {self.trace_slow_step_k}")
        if self.health_stride < 0:
            raise ValueError(f"health_stride must be >= 0, got {self.health_stride}")
        if self.collapse_window < 1:
            raise ValueError(f"collapse_window must be >= 1, got {self.collapse_window}")
        if self.collapse_min_step < 0:
            raise ValueError(f"collapse_min_step must be >= 0, got {self.collapse_min_step}")
        for knob in ("collapse_acc1", "collapse_emb_std", "collapse_margin"):
            if getattr(self, knob) < 0:
                raise ValueError(f"{knob} must be >= 0 (0 disables the predicate), "
                                 f"got {getattr(self, knob)}")
        if self.collapse_emb_std and not self.health_stride:
            raise ValueError("collapse_emb_std needs health_stride > 0: the embedding-"
                             "std predicate consumes the stride-sampled in-graph "
                             "diagnostics and would otherwise watch an empty stream")
        for knob in ("max_rollbacks", "watchdog_secs", "loader_retries",
                     "loader_backoff_secs"):
            if getattr(self, knob) < 0:
                raise ValueError(f"{knob} must be >= 0, got {getattr(self, knob)}")
        if self.chaos:
            from moco_tpu_torch.resilience.chaos import parse_chaos_spec

            parse_chaos_spec(self.chaos)

    def replace(self, **kw) -> "PretrainConfig":
        return dataclasses.replace(self, **kw)

    @property
    def effective_lr(self) -> float:
        return _effective_lr(self)


def _effective_lr(config) -> float:
    """`lr` if set, else the batch-scaled `base_lr * batch / 256`; an
    explicit `lr` always wins."""
    if config.lr:
        return config.lr
    if not config.base_lr:
        raise ValueError("config needs lr or base_lr (both are 0)")
    return config.base_lr * config.batch_size / 256


@dataclass
class EvalConfig:
    """Linear probe (`main_lincls.py` defaults) and kNN settings."""

    arch: str = "resnet50"            # a ResNet, or vit_* for a v3 ViT export (timm dialect)
    pretrained: str = ""              # --pretrained checkpoint path
    dataset: str = "imagefolder"
    data_dir: str = ""
    image_size: int = 224
    cifar_stem: bool = False
    num_classes: int = 1000
    num_workers: int = 0              # ImageFolder decode threads (-j); 0 = its default (8)
    stage_size: int = 0               # ImageFolder canvas shorter side (0 = its default)
    prefetch_depth: int = 2           # batches staged ahead (epoch_loader)
    staging_workers: int = 4          # staging threads per Prefetcher
    seed: int = 0
    # lincls recipe: lr 30, epochs 100, milestones 60/80, wd 0, batch 256
    lr: float = 30.0                  # absolute lr; 0.0 = derive from base_lr
    base_lr: float = 0.0              # lr per 256 samples
    batch_size: int = 256
    epochs: int = 100
    schedule: tuple[int, ...] = (60, 80)
    cos: bool = False
    sgd_momentum: float = 0.9
    weight_decay: float = 0.0
    # kNN protocol: top-200 neighbours, T=0.07
    knn_k: int = 200
    knn_temperature: float = 0.07
    knn_bank_chunk: int = 65536       # bank rows per streamed top-k slice (0 = off)
    print_freq: int = 10
    ckpt_dir: str = ""                # probe checkpoints ("" = none)
    resume: str = ""                  # "" | "auto" (latest probe checkpoint)
    evaluate: bool = False            # -e/--evaluate: validate the (resumed) probe, no training

    def __post_init__(self):
        if self.prefetch_depth < 1:
            raise ValueError(f"prefetch_depth must be >= 1, got {self.prefetch_depth}")
        if self.staging_workers < 1:
            raise ValueError(f"staging_workers must be >= 1, got {self.staging_workers}")

    def replace(self, **kw) -> "EvalConfig":
        return dataclasses.replace(self, **kw)

    @property
    def effective_lr(self) -> float:
        return _effective_lr(self)


@dataclass
class ServeConfig:
    """Online embedding service (`moco_tpu_torch/serve/`). One flat
    dataclass like the drivers', exposed by `python -m moco_tpu_torch.serve`
    as `--flags`: the JAX package's fields, defaults, checks and messages."""

    pretrained: str = ""              # exported encoder (.safetensors/.npz),
                                      # any dialect in checkpoint.CHECKPOINT_DIALECTS
    arch: str = "resnet50"
    image_size: int = 224
    cifar_stem: bool = False
    host: str = "127.0.0.1"
    port: int = 8080                  # 0 = ephemeral (tests/bench)
    # micro-batcher (serve/batcher.py): flush on bucket-full OR deadline
    buckets: tuple[int, ...] = (1, 8, 32, 128)  # padded bucket shapes; one CUDA
                                      # graph each
    flush_ms: float = 10.0            # max coalesce wait before a partial
                                      # bucket flushes (the latency a lone
                                      # request pays to help the next one)
    max_queue: int = 256              # admission-queue depth; beyond it
                                      # requests shed with `overloaded`
    request_deadline_ms: float = 2000.0  # per-request budget; expired-in-
                                      # queue requests shed with
                                      # `deadline_exceeded`, never stall
    embed_cache_mb: int = 64          # content-hash embedding LRU budget
                                      # (serve/cache.py; 0 = off)
    # observability (same events.jsonl stream as training)
    telemetry_dir: str = ""           # "" = telemetry off
    snapshot_every: int = 25          # serve-record cadence, in batches
    # distributed tracing: request/flush spans + capture windows
    trace_mode: str = "off"           # off | steps | full (README table)
    trace_capture_steps: int = 50     # capture-window length, in FLUSHED
                                      # batches (the serve tick unit)
    trace_capture_budget: int = 3     # max capture windows per process
    trace_shed_spike: int = 8         # arm a capture when this many
                                      # overload sheds land within 5 s
                                      # (0 = shed-spike detector off)
    # optional kNN-classify endpoint over a precomputed feature bank
    knn_bank: str = ""                # npz with `features` [N,D] + `labels` [N]
    knn_k: int = 200
    knn_temperature: float = 0.07
    num_classes: int = 0              # 0 = derive from bank labels
    drain_timeout_s: float = 60.0     # SIGTERM: max wait for in-flight work
    # hot-reload drift guard: before swapping a reloaded
    # engine in, embed a fixed probe batch on old+new and refuse (409
    # reload_collapsed — the fleet quarantines the step) a checkpoint
    # whose probe embeddings are degenerate
    reload_probe: int = 8             # probe rows (0 = guard off)
    reload_min_spread: float = 1e-4   # refuse when 1-‖mean unit row‖ of
                                      # the NEW engine's probe embeddings
                                      # falls below this (rank-one
                                      # collapse as seen from serving)
    # dual swap: mean probe-row cosine between a paired
    # bank's recorded probe features and the NEW engine's embedding of
    # the same rows must clear this floor or the pair is refused
    # (409 reload_bank_mismatch — the fleet quarantines the pair)
    bank_agreement_min: float = 0.98
    # sharded ANN index: ann_cells > 0 requires a verified
    # paired index next to the bank (python -m moco_tpu_torch.bank_build
    # --ann-cells)
    # and replaces the exact /v1/knn vote with the IVF probe; 0 keeps
    # the exact path bit-identical to before
    ann_cells: int = 0                # coarse-quantizer cells (0 = exact)
    ann_nprobe: int = 8               # cells probed per query
    ann_rerank: int = 0               # candidates kept per probe
                                      # (0 = knn_k)
    ann_shard: int = 0                # this replica's cell partition ...
    ann_shards: int = 1               # ... of how many (cell % shards)
    # tiered admission: interactive vs batch lanes
    admission_tiers: bool = True      # False folds "batch" onto the
                                      # interactive lane
    batch_max_queue: int = 1024       # batch-lane admission depth
    batch_deadline_ms: float = 30000.0  # batch-lane default deadline

    def __post_init__(self):
        # the ONE bucket-ladder rule, shared with the runtime's own check
        # (serve/batcher.py is numpy+stdlib — safe at config-import time)
        from moco_tpu_torch.serve.batcher import validate_buckets

        b = validate_buckets(self.buckets)
        if self.max_queue < b[-1]:
            raise ValueError(
                f"max_queue ({self.max_queue}) must hold at least one full "
                f"bucket ({b[-1]})"
            )
        if self.flush_ms < 0 or self.request_deadline_ms <= 0:
            raise ValueError(
                "flush_ms must be >= 0 and request_deadline_ms > 0"
            )
        if self.embed_cache_mb < 0:
            raise ValueError(
                f"embed_cache_mb must be >= 0, got {self.embed_cache_mb}"
            )
        if self.reload_probe < 0 or self.reload_min_spread < 0:
            raise ValueError(
                "reload_probe and reload_min_spread must be >= 0 "
                f"(0 disables the guard), got {self.reload_probe} / "
                f"{self.reload_min_spread}"
            )
        if not -1.0 <= self.bank_agreement_min <= 1.0:
            raise ValueError(
                "bank_agreement_min is a cosine floor in [-1, 1], got "
                f"{self.bank_agreement_min}"
            )
        if self.trace_mode not in ("off", "steps", "full"):
            raise ValueError(
                f"unknown trace_mode {self.trace_mode!r}; choose from "
                "off/steps/full"
            )
        if self.trace_capture_steps < 1 or self.trace_capture_budget < 0 \
                or self.trace_shed_spike < 0:
            raise ValueError(
                "trace_capture_steps must be >= 1, trace_capture_budget "
                "and trace_shed_spike >= 0"
            )
        if self.ann_cells < 0 or self.ann_nprobe < 1 or self.ann_rerank < 0:
            raise ValueError(
                "need ann_cells >= 0 (0 = exact), ann_nprobe >= 1, "
                f"ann_rerank >= 0 (0 = knn_k); got {self.ann_cells} / "
                f"{self.ann_nprobe} / {self.ann_rerank}"
            )
        if self.ann_shards < 1 or not 0 <= self.ann_shard < self.ann_shards:
            raise ValueError(
                f"need 0 <= ann_shard < ann_shards, got "
                f"{self.ann_shard} / {self.ann_shards}"
            )
        if self.ann_cells and not self.knn_bank:
            raise ValueError(
                "ann_cells > 0 needs a --knn-bank (the index pairs with "
                "a versioned bank)"
            )
        if self.batch_max_queue < b[-1]:
            raise ValueError(
                f"batch_max_queue ({self.batch_max_queue}) must hold at "
                f"least one full bucket ({b[-1]})"
            )
        if self.batch_deadline_ms <= 0:
            raise ValueError(
                f"batch_deadline_ms must be > 0, got "
                f"{self.batch_deadline_ms}"
            )

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)


PRESETS: dict[str, PretrainConfig | EvalConfig] = {
    # MoCo-v1 ResNet-18 CIFAR-10, K=4096
    "cifar10-moco-v1": PretrainConfig(
        name="cifar10-moco-v1",
        variant="v1",
        arch="resnet18",
        num_negatives=4096,
        temperature=0.07,
        cifar_stem=True,
        dataset="cifar10",
        image_size=32,
        batch_size=256,
        epochs=200,
        cos=False,
        knn_monitor=True,
        num_classes=10,
    ),
    # MoCo-v1 ResNet-50 ImageNet-1k, the reference's default run (no MLP,
    # no aug+, no cosine; T=0.07, milestones 120/160)
    "imagenet-moco-v1": PretrainConfig(
        name="imagenet-moco-v1",
        variant="v1",
        arch="resnet50",
        dataset="imagefolder",
        compute_dtype="bfloat16",
    ),
    # MoCo-v2 ResNet-50, K=65536, MLP head, cosine LR, aug+ (ImageNet recipe)
    "imagenet-moco-v2": PretrainConfig(
        name="imagenet-moco-v2",
        variant="v2",
        arch="resnet50",
        num_negatives=65536,
        temperature=0.2,
        mlp_head=True,
        aug_plus=True,
        cos=True,
        dataset="imagefolder",
        compute_dtype="bfloat16",
    ),
    # linear probe and kNN eval on frozen MoCo-v2 features
    "imagenet-lincls": EvalConfig(),
    # MoCo-v3 linear probe (the v3 reference's `main_lincls.py`: SGD lr
    # 3 x batch/256, 90 epochs, cosine, wd 0) on a v3 export's backbone
    "imagenet-lincls-v3": EvalConfig(
        arch="vit_small",
        lr=0.0,
        base_lr=3.0,
        batch_size=1024,
        epochs=90,
        schedule=(),
        cos=True,
    ),
    # MoCo-v3 ViT-S/16, queue-free, AdamW lr 1.5e-4 x batch/256, wd 0.1,
    # batch 4096, 300 epochs with 40 of warmup, m 0.99 ramped to 1
    "imagenet-moco-v3-vits": PretrainConfig(
        name="imagenet-moco-v3-vits",
        variant="v3",
        arch="vit_small",
        embed_dim=256,
        momentum_ema=0.99,
        momentum_ramp=True,
        temperature=0.2,
        optimizer="adamw",
        lr=0.0,
        base_lr=1.5e-4,
        weight_decay=0.1,
        batch_size=4096,
        epochs=300,
        warmup_epochs=40,
        cos=True,
        aug_plus=True,
        dataset="imagefolder",
        compute_dtype="bfloat16",
    ),
    # MoCo-v3 ViT-B/16: the same recipe at ViT-B's width and depth, remat on
    "imagenet-moco-v3-vitb": PretrainConfig(
        name="imagenet-moco-v3-vitb",
        variant="v3",
        arch="vit_base",
        embed_dim=256,
        momentum_ema=0.99,
        momentum_ramp=True,
        temperature=0.2,
        optimizer="adamw",
        lr=0.0,
        base_lr=1.5e-4,
        weight_decay=0.1,
        batch_size=4096,
        epochs=300,
        warmup_epochs=40,
        cos=True,
        aug_plus=True,
        remat=True,
        dataset="imagefolder",
        compute_dtype="bfloat16",
    ),
    # MoCo-v3 ResNet-50: LARS lr 0.3 x batch/256, wd 1.5e-6, 100 epochs with
    # 10 of warmup, T=1.0, crop-min 0.2, m 0.99 ramped
    "imagenet-moco-v3-r50": PretrainConfig(
        name="imagenet-moco-v3-r50",
        variant="v3",
        arch="resnet50",
        embed_dim=256,
        momentum_ema=0.99,
        momentum_ramp=True,
        temperature=1.0,
        optimizer="lars",
        lr=0.0,
        base_lr=0.3,
        weight_decay=1.5e-6,
        batch_size=4096,
        epochs=100,
        warmup_epochs=10,
        cos=True,
        crop_min=0.2,
        dataset="imagefolder",
        compute_dtype="bfloat16",
    ),
}

# the same recipe, ShuffleBN across 8 cards: the same step by construction
# (derived, so the two can never fork); the number of processes comes from
# the launch (`--num-devices 8` or torchrun)
PRESETS["imagenet-moco-v2-8chip"] = PRESETS["imagenet-moco-v2"].replace(
    name="imagenet-moco-v2-8chip")


def get_preset(name: str):
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; choose from {sorted(PRESETS)}")
    return PRESETS[name]


def preset_names(config_cls) -> list[str]:
    """The presets of one config class, sorted."""
    return sorted(n for n, c in PRESETS.items() if isinstance(c, config_cls))


def add_config_flags(parser, config_cls=PretrainConfig) -> None:
    """Every field of `config_cls` as a `--flag` (None = keep the preset's
    value)."""
    for f in dataclasses.fields(config_cls):
        name = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=None)
        elif isinstance(f.default, tuple):
            parser.add_argument(name, type=int, nargs="*", default=None)
        elif f.default is None:
            parser.add_argument(name, type=int, default=None)
        else:
            parser.add_argument(name, type=type(f.default), default=None)


def collect_overrides(args, config_cls=PretrainConfig) -> dict:
    """Parsed flags that were given -> `replace()` keyword arguments."""
    out = {}
    for f in dataclasses.fields(config_cls):
        value = getattr(args, f.name, None)
        if value is not None:
            out[f.name] = tuple(value) if isinstance(f.default, tuple) else value
    return out
