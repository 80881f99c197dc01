"""Typed metric instruments + the buffered JSONL event sink (the port's copy
of `moco_tpu/telemetry/registry.py`: the same schema, file names and
record shapes, so `tools/telemetry_report.py` reads a run of either).

Every record in `<telemetry_dir>/events.jsonl` is one JSON object per line,
stamped with `"v": SCHEMA_VERSION` and a wall-clock `"t"`, and carries a
`"kind"`:

  run_start  — one per driver pass: arch/variant/batch/mesh shape, the
               analytic per-step FLOPs and the peak-FLOPs assumption MFU
               is judged against (so a report is self-describing)
  step       — one per training step: step index, phase times
               (data_s/host_s, device_s on fenced samples), throughput
               (rolling + cumulative), MFU, loss when host-synced anyway,
               HBM + host-RSS samples at the device stride
  pod        — process-0 aggregate built from a periodic allgather of
               per-host scalars (max/min step time, summed throughput,
               max HBM/RSS high-water across hosts)
  event      — discrete incidents routed from `log_event` (preempt,
               rollback, chaos, watchdog, scalar_writer drops, ...); the
               original `[kind]` goes in the "event" field
  run_end    — final summary written at close (step count, high-water
               marks) so a truncated tail is detectable

Writes are buffered and flushed every `flush_every` records (plus on
close), each flush ending in `flush()+fsync` so a SIGKILL between flushes
loses at most one buffer — never corrupts previously-flushed lines
(append-only, newline-framed; a torn final line is skipped by the reader).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque

SCHEMA_VERSION = 1

EVENTS_FILENAME = "events.jsonl"
HEARTBEAT_FILENAME = "heartbeat.json"


class Counter:
    """Monotonic count (incidents, drops, records written). `inc` is
    locked: incident counts arrive from log_event sinks on the watchdog /
    prefetcher threads concurrently with the step loop."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += int(n)


class Gauge:
    """Last-observed value plus its running high-water mark (HBM, RSS)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.high_water = float("-inf")

    def set(self, value: float) -> None:
        self.value = float(value)
        self.high_water = max(self.high_water, self.value)


class Histogram:
    """Reservoir of observations with exact percentiles (step times, MFU).

    By default keeps every observation: at one float per step a multi-day
    1M-step run is ~8 MB — exactness is worth more here than a sketch,
    because the p99 regression a perf PR must catch lives in the tail.
    A LONG-LIVED process with unbounded observation rate (the serving
    path) must pass `window` instead — a bounded deque of the
    most recent N observations, so memory and per-snapshot sort cost stay
    flat forever and the percentiles describe recent behavior (which is
    what an operator watching a server wants anyway).
    """

    def __init__(self, name: str, window: int | None = None):
        self.name = name
        if window is not None and window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._values = (
            deque(maxlen=int(window)) if window is not None else []
        )

    def observe(self, value: float) -> None:
        self._values.append(float(value))

    @property
    def count(self) -> int:
        return len(self._values)

    @property
    def sum(self) -> float:
        return float(sum(self._values))

    @property
    def mean(self) -> float:
        return self.sum / self.count if self._values else 0.0

    @property
    def max(self) -> float:
        return max(self._values) if self._values else 0.0

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile, q in [0, 100]. 0.0 when empty."""
        if not self._values:
            return 0.0
        ordered = sorted(self._values)
        rank = max(0, min(len(ordered) - 1, round(q / 100.0 * (len(ordered) - 1))))
        return ordered[int(rank)]

    def percentiles_ms(self, qs=(50, 95, 99)) -> dict:
        """{"p50": ..., ...} of seconds-valued observations in ms — THE
        shared percentile-record shape (BENCH_*.json folds, serve
        snapshots, telemetry_report rendering)."""
        return {f"p{q}": round(self.percentile(q) * 1e3, 3) for q in qs}


def _json_safe(value):
    """RFC-8259-safe record values: json.dumps would happily write bare
    `NaN`/`Infinity` (invalid JSON most non-Python consumers reject) for
    exactly the interesting records — a diverged loss. Encode non-finite
    floats as their string names instead; recurse through containers, and
    coerce foreign scalars (numpy float32/int64, 0-d tensors — NOT
    `float` subclasses) through the same finiteness check."""
    if isinstance(value, float):
        return value if math.isfinite(value) else repr(value)  # 'nan', 'inf'
    if isinstance(value, (str, int, bool)) or value is None:
        return value
    if isinstance(value, dict):
        return {k: _json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    try:
        return _json_safe(float(value))
    except (TypeError, ValueError):
        return str(value)  # last resort: never let dumps raise mid-run


def percentiles_ms(values, qs=(50, 95, 99)) -> dict:
    """{"p50": ..., ...} of `values` (seconds) in milliseconds — the
    free-function form of `Histogram.percentiles_ms` for callers holding
    a plain list (bench.py's BENCH_*.json folds)."""
    h = Histogram("tmp")
    for v in values:
        h.observe(float(v))
    return h.percentiles_ms(qs)


class MetricsRegistry:
    """Get-or-create registry of typed instruments + the JSONL sink.

    `path` is the events file ("" / None disables the sink: instruments
    still aggregate — non-main pod hosts run exactly this way, feeding the
    allgather without writing files). `stamp` is a small dict merged into
    EVERY record (the tracer's `run_id`/`trace_id`), so the flat
    event stream joins the span timeline — explicit record fields win on
    key collision."""

    def __init__(self, path: str | None = None, flush_every: int = 50,
                 stamp: dict | None = None):
        self._instruments: dict[str, Counter | Gauge | Histogram] = {}
        self._buffer: list[str] = []
        self._stamp = dict(stamp) if stamp else None
        self._path = path or None
        self._file = None
        # emit/flush are called from the main step loop AND from log_event
        # sinks firing on the watchdog / prefetcher threads — an unlocked
        # buffer swap would drop or duplicate exactly the stall incidents
        # telemetry exists to capture
        self._lock = threading.Lock()
        self.flush_every = max(int(flush_every), 1)
        self.records_written = 0
        if self._path:
            os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
            # a SIGKILL mid-flush can leave a torn final line with no
            # newline; appending straight after it would weld the resumed
            # run's run_start onto the fragment (two records lost instead
            # of one) — start on a fresh line if the tail is torn
            torn = False
            try:
                with open(self._path, "rb") as existing:
                    existing.seek(0, os.SEEK_END)
                    if existing.tell() > 0:
                        existing.seek(-1, os.SEEK_END)
                        torn = existing.read(1) != b"\n"
            except OSError:
                torn = False
            self._file = open(self._path, "a", encoding="utf-8")
            if torn:
                self._file.write("\n")

    # -- typed instruments --------------------------------------------------
    def _get(self, name: str, cls):
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls(name)
        elif not isinstance(inst, cls):
            raise TypeError(
                f"instrument {name!r} already registered as "
                f"{type(inst).__name__}, requested {cls.__name__}"
            )
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    # -- records ------------------------------------------------------------
    def emit(self, kind: str, **fields) -> bool:
        """Buffer one schema-versioned record; returns True when this call
        flushed (the driver aligns ScalarWriter.flush with that cadence).
        Thread-safe: log_event sinks fire from watchdog/loader threads."""
        if self._file is None:
            # sink-less (non-main pod hosts) or already closed: skip the
            # serialization work entirely — instruments still aggregate
            return False
        record = {"v": SCHEMA_VERSION, "t": round(time.time(), 3), "kind": kind}
        if self._stamp:
            record.update(self._stamp)
        record.update(fields)
        line = json.dumps(_json_safe(record), allow_nan=False)
        with self._lock:
            self._buffer.append(line)
            self.records_written += 1
            if len(self._buffer) >= self.flush_every:
                self._flush_locked()
                return True
        return False

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._buffer:
            return
        lines, self._buffer = self._buffer, []
        if self._file is None:
            return
        self._file.write("\n".join(lines) + "\n")
        self._file.flush()
        os.fsync(self._file.fileno())

    def close(self) -> None:
        with self._lock:
            self._flush_locked()
            if self._file is not None:
                self._file.close()
                self._file = None


class Heartbeat:
    """Atomically-replaced liveness file for the run supervisor
    and any other external watchdog.

    Monitors `stat` the file: a stale mtime (or a stale "t" inside) means
    the run stopped making progress even if the process is still alive.
    Atomic replace, never append — a reader must never see a torn write.

    The payload carries everything the supervisor's hang/progress checks
    need without log scraping: `pid` (is this beat from MY child, or a
    stale file from the previous incarnation?), `step` (monotonic progress
    for the restart-budget refund), and `phase` ("run_start" before the
    first step — cold-compile stalls there are normal — "step" once the
    loop is actually advancing, "run_end"/"preempt_exit" at the exits).

    `min_interval_secs` gates `maybe_beat` (the every-step call): one
    atomic replace per second is free, one per 100 ms step is not. `beat`
    always writes (lifecycle transitions must never be elided).

    Besides the wall-clock `t`, every beat carries a monotonic pair:
    `seq` (a per-process counter — did ANYTHING change since the reader's last look?) and `mono_s`
    (`time.monotonic()`, CLOCK_MONOTONIC — system-wide since boot on
    Linux, so a same-host reader can order beats against its own
    monotonic clock). Staleness/freshness readers (the run supervisor)
    prefer the pair when present: an NTP step or a manual clock change
    moves `t` but neither `seq` nor `mono_s`, so a wall jump can no
    longer read as "hung child" (backwards) or make a stale file look
    fresh (forwards)."""

    def __init__(self, path: str, min_interval_secs: float = 0.0):
        self.path = path
        self.min_interval = float(min_interval_secs)
        self._last_write = float("-inf")
        self._seq = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: int, **fields) -> None:
        self._seq += 1
        payload = {"v": SCHEMA_VERSION, "t": round(time.time(), 3),
                   "seq": self._seq,
                   "mono_s": round(time.monotonic(), 3),
                   "step": int(step), "pid": os.getpid()}
        payload.update(fields)
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)
        self._last_write = time.monotonic()

    def maybe_beat(self, step: int, **fields) -> bool:
        """Time-gated beat for per-step call sites: writes (and returns
        True) only when `min_interval_secs` has elapsed since the last
        write — the supervisor's staleness granularity is the max of this
        and the step time, independent of any flush cadence."""
        if time.monotonic() - self._last_write < self.min_interval:
            return False
        self.beat(step, **fields)
        return True
