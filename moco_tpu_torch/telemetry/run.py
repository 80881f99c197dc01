"""RunTelemetry — the one object the driver talks to (port of
`moco_tpu/telemetry/run.py`).

Owns the registry and its `events.jsonl` sink, the phase timer, the MFU
estimator, the device monitor, the pod aggregator, the heartbeat and the
span tracer, and registers itself as a `log_event` sink so every incident
lands in the same stream as the step records. The records, their kinds and
keys, the heartbeat and the span files are the JAX package's, so
`tools/telemetry_report.py` and `tools/trace_report.py` read a run of the
port unchanged.

Process topology: EVERY rank builds one (the pod all-gather needs every
rank's vector), but only rank 0 gets a file sink, a heartbeat and a
tracer; the other ranks aggregate instruments and write nothing.

Overhead contract: with telemetry off the driver holds no RunTelemetry and
none of this runs; with it on, the synchronizing calls are the
stride-gated fence of `StepPhaseTimer` and, with `health_stride`, the one
transfer of `health_block` on each health-stride step. A capture window
(`trace_device_profile`) records a `torch.profiler` trace into
`<telemetry_dir>/traces/`.
"""

from __future__ import annotations

import os
import time

import torch

from moco_tpu_torch.data.stats import InputPipelineStats
from moco_tpu_torch.telemetry.device import DeviceMonitor
from moco_tpu_torch.telemetry.mfu import MFUEstimator
from moco_tpu_torch.telemetry.pod import PodAggregator
from moco_tpu_torch.telemetry.registry import (
    EVENTS_FILENAME,
    HEARTBEAT_FILENAME,
    Heartbeat,
    MetricsRegistry,
)
from moco_tpu_torch.telemetry.timing import StepPhaseTimer
from moco_tpu_torch.telemetry.trace import SlowSampleDetector, Tracer, null_tracer
from moco_tpu_torch.utils import logging as mlog


def device_kind(device) -> str:
    """The device's name as the records carry it: the card's name on CUDA,
    "cpu" on the CPU."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


class RunTelemetry:
    def __init__(self, config, *, n_chips: int, n_procs: int,
                 process_index: int, steps_per_epoch: int, device="cuda"):
        is_main = process_index == 0
        kind = device_kind(device)
        run_dir = config.telemetry_dir
        self.events_path = os.path.join(run_dir, EVENTS_FILENAME)
        # the span layer: rank 0 only, like every file sink. The tracer
        # exists even at trace_mode="off": the SIGUSR1 / trigger-file /
        # anomaly capture windows stay reachable
        self.tracer = (
            Tracer(run_dir, config.trace_mode, proc="driver",
                   capture_steps=config.trace_capture_steps,
                   capture_budget=config.trace_capture_budget)
            if is_main else null_tracer()
        )
        self.tracer.install_signal()
        if is_main and config.trace_device_profile:
            trace = mlog.DeviceTrace()
            self.tracer.profiler_hooks = (trace.start, trace.stop)
        # anomaly detectors arming the capture window (budgeted in the
        # tracer): a slow step against the rolling p95, and a data-phase
        # blowout (an empty prefetch queue). skip=3 drops the warm-up
        # steps; the floors keep microsecond noise from tripping them
        k = config.trace_slow_step_k
        self._slow_step = SlowSampleDetector(k=k, floor_s=0.005, skip=3)
        self._input_stall = SlowSampleDetector(k=k, floor_s=0.25, skip=3)
        self.registry = MetricsRegistry(
            self.events_path if is_main else None,
            flush_every=config.telemetry_flush_steps,
            stamp={"run_id": self.tracer.run_id,
                   "trace_id": self.tracer.trace_id} if is_main else None,
        )
        self.heartbeat = (
            Heartbeat(os.path.join(run_dir, HEARTBEAT_FILENAME),
                      min_interval_secs=config.heartbeat_secs)
            if is_main else None
        )
        self.timer = StepPhaseTimer(stride=config.telemetry_stride)
        # threaded into every Prefetcher and CachedDataset of the run;
        # snapshots ride the step records at the sampling stride
        self.input_stats = InputPipelineStats()
        self.mfu = MFUEstimator.for_config(config, n_chips, kind)
        self.devices = DeviceMonitor(device)
        self.pod = PodAggregator(self.registry, n_procs, process_index)
        self.n_chips = n_chips

        self._step_hist = self.registry.histogram("step_s")
        self._mfu_hist = self.registry.histogram("mfu")
        self._hbm_gauge = self.registry.gauge("hbm_peak_bytes")
        self._incidents = self.registry.counter("incidents")
        self._grad_sync: dict | None = None
        self._closed = False
        mlog.add_event_sink(self._on_event)
        self.registry.emit(
            "run_start",
            name=config.name,
            variant=config.variant,
            arch=config.arch,
            image_size=config.image_size,
            batch_size=config.batch_size,
            steps_per_epoch=steps_per_epoch,
            n_chips=n_chips,
            n_procs=n_procs,
            sharding=getattr(config, "sharding", "dp"),
            device_kind=kind,
            peak_flops_per_chip=self.mfu.peak_flops_per_chip,
            flops_per_step=self.mfu.flops_per_step,
            flops_per_image=self.mfu.flops_per_step / max(config.batch_size, 1),
            telemetry_stride=config.telemetry_stride,
        )
        if self.heartbeat is not None:
            self.heartbeat.beat(0, phase="run_start")

    # -- incidents (log_event sink) -----------------------------------------
    def _on_event(self, kind: str, msg: str, fields: dict) -> None:
        self._incidents.inc()
        self.registry.emit("event", event=kind, msg=msg, **fields)

    def event(self, kind: str, **fields) -> None:
        """Structured non-incident event (knn_eval, epoch_summary)."""
        self.registry.emit("event", event=kind, **fields)

    def set_grad_sync(self, info: dict) -> None:
        """Record the gradient-sync plan (`GradSync.describe`): one routine
        `grad_sync` event; the compressed modes (quantized, demo) also stamp
        it onto the sampled step records."""
        self._grad_sync = dict(info)
        self.registry.emit("event", event="grad_sync", **info)

    def set_sharding(self, info: dict) -> None:
        """Record the state's layout and its bytes a device: one routine
        `sharding` event."""
        self.registry.emit("event", event="sharding", **info)

    def phase_beat(self, phase: str, step: int) -> None:
        """Forced heartbeat declaring a known-long non-step phase (the kNN
        monitor): a supervisor widens its staleness window while the newest
        beat's phase is not "step"."""
        if self.heartbeat is not None:
            self.heartbeat.beat(step, phase=phase)

    # -- per-step ------------------------------------------------------------
    def on_step(self, step: int, phases: dict, throughput, loss=None,
                health: dict | None = None) -> bool:
        """Emit one step record; returns True when this step flushed the
        sink (the driver flushes the ScalarWriter with it).

        `health` is the learning-health block the driver pulls on
        health-stride steps (None otherwise), recorded as the record's
        `health` sub-dict. Everything this method costs is booked into the
        phase timer's `telemetry` sub-phase."""
        t_tel0 = time.perf_counter()
        # anomaly -> capture window, checked BEFORE the step span records;
        # the anomaly event lands whenever the request was newly routed,
        # past the budget too (the tick answers with one `denied`)
        if self._slow_step.observe(phases["step_s"]):
            if self.tracer.maybe_autocapture("slow_step"):
                self.registry.emit(
                    "event", event="trace_anomaly", anomaly="slow_step",
                    step=int(step), step_s=round(phases["step_s"], 6),
                    p95_s=round(self._slow_step.last_p95, 6),
                )
        if self._input_stall.observe(phases["data_s"]):
            if self.tracer.maybe_autocapture("input_stall"):
                self.registry.emit(
                    "event", event="trace_anomaly", anomaly="input_stall",
                    step=int(step), data_s=round(phases["data_s"], 6),
                    p95_s=round(self._input_stall.last_p95, 6),
                )
        self.tracer.record_step(step, phases)
        capture_evt = self.tracer.tick(step)
        if capture_evt is not None:
            self.registry.emit("event", event="trace_capture", **capture_evt)
        record = dict(step=int(step))
        for key, value in phases.items():
            record[key] = round(value, 6)
        if phases.get("step_s"):
            record["data_share"] = round(
                phases.get("data_s", 0.0) / phases["step_s"], 4)
        rolling = throughput.rolling_imgs_per_sec
        record["imgs_per_sec"] = round(rolling, 2)
        record["imgs_per_sec_cum"] = round(throughput.imgs_per_sec, 2)
        self._step_hist.observe(phases["step_s"])
        mfu = self.mfu.mfu(phases["step_s"])
        if mfu is not None:
            record["mfu"] = round(mfu, 5)
            self._mfu_hist.observe(mfu)
        if loss is not None:
            record["loss"] = float(loss)
        if health:
            record["health"] = dict(health)
        stride = self.timer.stride or self.registry.flush_every
        if step % stride == 0:
            sampled = self.devices.sample()
            record.update(sampled)
            if "hbm_peak_bytes" in sampled:
                self._hbm_gauge.set(sampled["hbm_peak_bytes"])
            self.pod.update(**sampled)
            if self.input_stats.staged_batches:
                record["input"] = self.input_stats.snapshot()
            if self._grad_sync and self._grad_sync.get("mode") in (
                    "quantized", "demo"):
                record["grad_sync"] = self._grad_sync
        self.pod.update(
            step_s=phases["step_s"], data_s=phases["data_s"],
            imgs_per_sec=rolling, incidents=self._incidents.value,
        )
        flushed = self.registry.emit("step", **record)
        if self.heartbeat is not None:
            # every step, time-gated by heartbeat_secs, independent of the
            # sink's flush cadence
            self.heartbeat.maybe_beat(
                step, phase="step",
                last_step_ms=round(phases["step_s"] * 1e3, 1),
                trace=self.tracer.capture_state(),
            )
        # the tracer's own tick/flush time ran inside this window: drop its
        # separate count and book the whole window
        self.tracer.consume_self_time()
        self.timer.note_telemetry(time.perf_counter() - t_tel0)
        return flushed

    # -- pod sync (the resilience_sync_steps all-gather) ---------------------
    def pod_vector(self):
        return self.pod.local_vector()

    def pod_record(self, step: int, gathered) -> None:
        self.pod.record(step, gathered)

    # -- teardown ------------------------------------------------------------
    def close(self, **extra_summary) -> None:
        """Idempotent: the run_end summary, the final heartbeat, the last
        flush."""
        if self._closed:
            return
        self._closed = True
        mlog.remove_event_sink(self._on_event)
        summary = dict(
            steps=self._step_hist.count,
            incidents=self._incidents.value,
        )
        if self._step_hist.count:
            summary.update(
                step_s_p50=round(self._step_hist.percentile(50), 6),
                step_s_p95=round(self._step_hist.percentile(95), 6),
                step_s_p99=round(self._step_hist.percentile(99), 6),
            )
        if self._mfu_hist.count:
            summary["mfu_mean"] = round(self._mfu_hist.mean, 5)
        if self._hbm_gauge.high_water > float("-inf"):
            summary["hbm_peak_bytes"] = int(self._hbm_gauge.high_water)
        if self.input_stats.staged_batches:
            summary["input"] = self.input_stats.snapshot()
        if self.tracer.captures_used or self.tracer.spans_recorded:
            summary["trace"] = dict(
                self.tracer.capture_state(),
                spans_recorded=self.tracer.spans_recorded,
            )
        summary.update(extra_summary)
        self.registry.emit("run_end", **summary)
        if self.heartbeat is not None:
            phase = "run_end"
            if summary.get("preempted"):
                phase = "preempt_exit"
            elif summary.get("resized"):
                phase = "resize_exit"
            self.heartbeat.beat(
                summary.get("last_step", self._step_hist.count),
                phase=phase,
                trace=self.tracer.capture_state(),
            )
        self.registry.close()
        self.tracer.close()


def health_block(health_dev: dict, metrics: dict) -> dict:
    """A step record's `health` block: the stride's `h_*` diagnostics under
    their names without the prefix, and the step's contrast metrics, all
    pulled to the host in one transfer."""
    values = {**{k: metrics[k] for k in ("logit_margin", "neg_sim", "pos_sim", "acc1")},
              **health_dev}
    # a print step has already brought the metrics to the host
    on_device = [k for k, v in values.items() if isinstance(v, torch.Tensor)]
    if on_device:
        pulled = torch.stack([values[k].float() for k in on_device]).tolist()
        values.update(zip(on_device, pulled))
    block = {k.removeprefix("h_"): round(float(v), 6) for k, v in values.items()}
    block["acc1"] = round(float(values["acc1"]), 4)
    return block
