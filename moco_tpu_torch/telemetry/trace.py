"""Distributed tracing + on-demand capture windows (the port's copy of
`moco_tpu/telemetry/trace.py`: the same span records, ids, env vars and
capture-window state machine, so `tools/trace_report.py` merges a run of
either).

The repo runs as a small distributed system — supervisor → train driver →
staging workers → device step, plus a serve stack — and its telemetry was
flat per-process JSONL: no way to follow one step or one request across a
process boundary, and no way to grab a profile *when* the slow step
actually happens. This module is the span layer every process shares:

  - `Tracer.span(name)` is a context manager that records one timed span
    into a lock-free ring buffer (a `deque.append` under the GIL — no
    lock, no syscall on the fast path) and flushes batches of spans as
    JSONL lines to `<telemetry_dir>/spans.jsonl` with O_APPEND one-line
    writes, safe to interleave across processes sharing the file.
  - Every span carries `run`/`trace`/`span`/`parent` ids. The ids
    propagate ACROSS processes through two env vars (`MOCO_TPU_RUN_ID`,
    `MOCO_TPU_TRACE_PARENT`): the supervisor stamps its child's env from
    inside its per-launch span, the child's Tracer picks the parent up at
    construction, and thread-side spans (staging workers) continue a
    coordinator span through an explicit `parent=span.context()`.
  - `trace_mode` knob, off by default: `off` records nothing, `steps`
    records the coarse spans (one per step / staged batch / serve flush /
    supervisor launch), `full` additionally records the detail spans
    (worker decode slices, per-shard H2D puts, engine calls).
  - On-demand and anomaly-triggered CAPTURE: SIGUSR1 or a
    `<telemetry_dir>/trace.trigger` file arms a bounded window during
    which the effective mode is `full` (and, when hooks are installed, a
    torch.profiler device trace lands under `<telemetry_dir>/traces/`).
    Anomaly detectors (`SlowSampleDetector` for step-time / staging-stall
    blowouts, `SpikeDetector` for serve shed spikes) arm the same window
    through `maybe_autocapture`, bounded by a per-run capture budget — a
    3 a.m. slowdown leaves a profile behind without anyone watching.

This module stays stdlib-only (no torch, no numpy): an out-of-process
supervisor must be able to import it, and its whole contract is surviving
the failures that kill the training runtime. Spans are opened as context
managers only.
`tools/trace_report.py` merges spans + events from every process of a run
into one Chrome-trace/Perfetto JSON.
"""

from __future__ import annotations

import os
import signal
import threading
import time
import uuid
from collections import deque

SCHEMA_VERSION = 1

SPANS_FILENAME = "spans.jsonl"
TRIGGER_FILENAME = "trace.trigger"
TRACES_DIRNAME = "traces"

ENV_RUN_ID = "MOCO_TPU_RUN_ID"
ENV_TRACE_PARENT = "MOCO_TPU_TRACE_PARENT"  # "<trace_id>:<span_id>"

TRACE_MODES = ("off", "steps", "full")
_LEVEL = {"off": 0, "steps": 1, "full": 2}


def new_id() -> str:
    """16-hex-char id (64 random bits): short enough to read in a report,
    long enough that a run's span set never collides."""
    return uuid.uuid4().hex[:16]


def parse_parent(value: str | None) -> tuple[str, str] | None:
    """`"<trace_id>:<span_id>"` → tuple; None on absent/malformed (a
    malformed env var must degrade to a fresh trace, never crash the
    child at import time)."""
    if not value:
        return None
    trace_id, sep, span_id = value.partition(":")
    if not sep or not trace_id or not span_id:
        return None
    return trace_id, span_id


# ---------------------------------------------------------------------------
# anomaly detectors (stdlib, shared by driver / loader / serve call sites)
# ---------------------------------------------------------------------------


class SlowSampleDetector:
    """Rolling-window tail detector: `observe(x)` returns True when `x`
    exceeds `k` × the window's p95 (with at least `min_samples` PRIOR
    samples, and `x` above `floor_s` so microsecond-scale noise on a fast
    phase can never trip it). The current sample is checked BEFORE it
    joins the window, so one anomaly does not raise the bar for the next.
    The first `skip` observations are DISCARDED entirely: cold-compile /
    warmup steps are seconds-scale by design, and two of them in the
    window put the p95 itself at warmup scale — every later real anomaly
    would hide under k × (compile time). Not thread-safe by design — each
    caller owns one detector."""

    def __init__(self, k: float = 3.0, window: int = 64,
                 min_samples: int = 8, floor_s: float = 0.0,
                 skip: int = 0):
        self.k = float(k)
        self.min_samples = int(min_samples)
        self.floor_s = float(floor_s)
        self._skip = int(skip)
        self.last_p95 = 0.0  # the threshold the last observe() compared
                             # against — snapshotted BEFORE the sample
                             # joined the window, so an anomaly report can
                             # name the p95 it actually violated
        self._window: deque = deque(maxlen=int(window))

    def p95(self) -> float:
        if not self._window:
            return 0.0
        ordered = sorted(self._window)
        rank = max(0, min(len(ordered) - 1,
                          round(0.95 * (len(ordered) - 1))))
        return ordered[rank]

    def observe(self, value: float) -> bool:
        if self._skip > 0:
            self._skip -= 1
            return False
        value = float(value)
        self.last_p95 = self.p95()
        anomalous = (
            len(self._window) >= self.min_samples
            and value > self.floor_s
            and value > self.k * self.last_p95
        )
        self._window.append(value)
        return anomalous


class SpikeDetector:
    """Event-rate spike detector for discrete bad events (serve sheds):
    `note()` returns True when at least `min_events` landed within the
    trailing `window_s` seconds. After firing, the window is cleared so
    one sustained spike arms one capture, not one per shed. Thread-safe:
    sheds arrive from concurrent HTTP handler threads."""

    def __init__(self, min_events: int = 8, window_s: float = 5.0):
        self.min_events = int(min_events)
        self.window_s = float(window_s)
        self._times: deque = deque()
        self._lock = threading.Lock()

    def note(self, now: float | None = None) -> bool:
        if self.min_events <= 0:
            return False
        now = time.monotonic() if now is None else now
        with self._lock:
            self._times.append(now)
            while self._times and now - self._times[0] > self.window_s:
                self._times.popleft()
            if len(self._times) >= self.min_events:
                self._times.clear()
                return True
        return False


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class _NullSpan:
    """The no-op span: returned whenever the tracer is off or the span's
    detail level is filtered — the fast path is one attribute check and
    this singleton's trivial __enter__/__exit__."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass

    def context(self):
        return None


NULL_SPAN = _NullSpan()


class Span:
    """One live span (handle of `Tracer.span(...)`). Only ever used as a
    context manager: __enter__ stamps the start and pushes
    onto the opening thread's span stack (so nested spans parent
    automatically), __exit__ records the completed span into the ring."""

    __slots__ = ("_tracer", "name", "cat", "trace_id", "span_id",
                 "parent_id", "attrs", "_t_wall", "_t0", "_entered")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 parent: tuple[str, str] | None, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        if parent is None:
            parent = tracer.current_context()
        self.trace_id = parent[0] if parent else tracer.trace_id
        self.parent_id = parent[1] if parent else tracer.root_parent
        self.span_id = new_id()
        self.attrs = attrs
        self._t_wall = 0.0
        self._t0 = 0.0
        self._entered = False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def context(self) -> tuple[str, str]:
        """(trace_id, span_id) — the handle a worker thread (or a child
        process, via `Tracer.child_env`) parents its own spans under."""
        return (self.trace_id, self.span_id)

    def __enter__(self):
        self._t_wall = time.time()
        self._t0 = time.perf_counter()
        self._entered = True
        self._tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer._pop(self)
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._tracer._record(
            self.name, self.cat, self._t_wall,
            time.perf_counter() - self._t0,
            self.trace_id, self.span_id, self.parent_id, self.attrs,
        )
        return False


class _NullTracer:
    """Shared do-nothing tracer so call sites never branch on `tracer is
    None` in hot loops: every method is a constant-return no-op."""

    run_id = ""
    trace_id = ""
    root_parent = None
    mode = "off"
    captures_used = 0
    capture_budget = 0
    spans_recorded = 0
    spans_written = 0
    profiler_hooks = None

    def span(self, name, *, cat="span", detail=False, parent=None, **attrs):
        return NULL_SPAN

    def instant(self, name, *, cat="instant", parent=None, **attrs):
        return None

    def record_span(self, *a, **kw):
        return None

    def record_step(self, *a, **kw):
        return None

    def tick(self, step=None):
        return None

    def maybe_autocapture(self, reason):
        return False

    def request_capture(self, reason):
        pass

    def capture_state(self):
        return None

    def current_context(self):
        return None

    def child_env(self):
        return {}

    def consume_self_time(self):
        return 0.0

    def install_signal(self):
        return False

    def flush(self):
        pass

    def close(self):
        pass


_NULL_TRACER = _NullTracer()


def null_tracer() -> _NullTracer:
    return _NULL_TRACER


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------


class Tracer:
    """Per-process span recorder + capture-window state machine.

    `telemetry_dir` is where `spans.jsonl` (O_APPEND, shared with every
    other process of the run), the `trace.trigger` file and the
    `traces/` profiler dir live; None disables recording entirely.
    `mode` is the configured `trace_mode`; a capture window elevates the
    EFFECTIVE level to `full` without touching the configured one.
    `proc` labels this process's track in the merged timeline
    ("supervisor" / "driver" / "serve" / ...).

    Overhead contract: recording one span is a dict build plus a
    `deque.append` (GIL-atomic, lock-free); the ring drains to disk only
    when `flush_every` spans accumulated (or at capture end / close), and
    that drain time — plus everything else the span layer does off the
    hot path (trigger-file polls, capture transitions) — is accumulated
    into `consume_self_time()` so the step-phase report can book it as
    the explicit `telemetry` sub-phase instead of skewing data/host."""

    def __init__(self, telemetry_dir: str | None, mode: str = "off", *,
                 proc: str = "proc", run_id: str | None = None,
                 parent: tuple[str, str] | None = None,
                 capture_steps: int = 50, capture_budget: int = 3,
                 ring_size: int = 4096, flush_every: int = 256,
                 trigger_poll_secs: float = 1.0):
        if mode not in TRACE_MODES:
            raise ValueError(
                f"unknown trace_mode {mode!r}; choose from {TRACE_MODES}"
            )
        self.mode = mode
        self.proc = proc
        self.pid = os.getpid()
        self.run_id = run_id or os.environ.get(ENV_RUN_ID) or new_id()
        env_parent = parent or parse_parent(os.environ.get(ENV_TRACE_PARENT))
        if env_parent is not None:
            self.trace_id, self.root_parent = env_parent
        else:
            self.trace_id, self.root_parent = new_id(), None
        self.capture_steps = max(int(capture_steps), 1)
        self.capture_budget = max(int(capture_budget), 0)
        self.captures_used = 0
        self.spans_recorded = 0
        self.spans_written = 0
        self._capturing = False
        self._capture_left = 0
        self._capture_reason = ""
        # set from signal handlers / other threads: plain assignments only
        self._pending_reason: str | None = None
        self._denied_reported = False
        self._ring: deque = deque(maxlen=max(int(ring_size), 2))
        self._flush_every = max(int(flush_every), 1)
        self._io_lock = threading.Lock()
        self._tls = threading.local()
        self._self_s = 0.0
        self._self_lock = threading.Lock()
        self._trigger_poll_secs = float(trigger_poll_secs)
        self._last_trigger_poll = float("-inf")
        self._prev_sigusr1 = None
        self.profiler_hooks: tuple | None = None  # (start(dir), stop())
        self.profiler_error: str | None = None
        self._profiler_active = False
        self._path = None
        self._trigger_path = None
        self._traces_dir = None
        if telemetry_dir:
            os.makedirs(telemetry_dir, exist_ok=True)
            self._path = os.path.join(telemetry_dir, SPANS_FILENAME)
            self._trigger_path = os.path.join(telemetry_dir, TRIGGER_FILENAME)
            self._traces_dir = os.path.join(telemetry_dir, TRACES_DIRNAME)

    # -- levels --------------------------------------------------------------
    def _level(self) -> int:
        if self._path is None:
            return 0
        if self._capturing:
            return 2
        return _LEVEL[self.mode]

    # -- span API (context-manager only) -------------------------------------
    def span(self, name: str, *, cat: str = "span", detail: bool = False,
             parent: tuple[str, str] | None = None, **attrs):
        """Open one span as a context manager. `detail=True` marks a
        fine-grained span recorded only at `full` level (or inside a
        capture window); coarse spans record from `steps` up."""
        lvl = self._level()
        if lvl == 0 or (detail and lvl < 2):
            return NULL_SPAN
        return Span(self, name, cat, parent, attrs)

    def instant(self, name: str, *, cat: str = "instant",
                parent: tuple[str, str] | None = None, **attrs):
        """Zero-duration marker (rendered as an instant event)."""
        return self.record_span(name, time.time(), 0.0, cat=cat,
                                parent=parent, **attrs)

    def record_span(self, name: str, t_start_wall: float, dur_s: float, *,
                    cat: str = "span", detail: bool = False,
                    parent: tuple[str, str] | None = None,
                    trace_id: str | None = None,
                    span_id: str | None = None, **attrs) -> str | None:
        """Retroactive span: record an already-measured interval (the step
        spans are derived from StepPhaseTimer after the fact — zero
        context-manager overhead inside the hot loop; serve request spans
        are stamped at resolve time). Same `detail` filtering as `span`.
        Returns the span id so callers can parent further retroactive
        children under it."""
        lvl = self._level()
        if lvl == 0 or (detail and lvl < 2):
            return None
        if parent is None:
            parent = self.current_context()
        sid = span_id or new_id()
        self._record(
            name, cat, t_start_wall, dur_s,
            trace_id or (parent[0] if parent else self.trace_id),
            sid,
            parent[1] if parent else self.root_parent,
            attrs,
        )
        return sid

    def record_step(self, step: int, phases: dict, **attrs) -> str | None:
        """One training step as a span tree, derived from the phase dict
        (`step_s`/`data_s`/`host_s`/...): the step span at `steps` level,
        plus sequential data/host/telemetry child segments at `full`
        level. `device_s`/`comm_s` are drain measurements, not wall
        segments — they ride as attrs, not child spans."""
        lvl = self._level()
        if lvl == 0:
            return None
        step_s = float(phases.get("step_s", 0.0))
        t0 = time.time() - step_s
        span_attrs = {k: round(float(v), 6) for k, v in phases.items()}
        span_attrs.update(attrs)
        span_attrs["step"] = int(step)
        sid = self.record_span("step", t0, step_s, cat="step", **span_attrs)
        if lvl >= 2 and sid is not None:
            parent = (self.trace_id, sid)
            cursor = t0
            for seg in ("telemetry_s", "data_s", "host_s"):
                seg_s = float(phases.get(seg, 0.0))
                if seg_s > 0.0:
                    self.record_span(seg[:-2], cursor, seg_s, cat="phase",
                                     parent=parent, step=int(step))
                    cursor += seg_s
        return sid

    # -- parenting -----------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:  # exotic unwind order: drop it wherever it is
            stack.remove(span)

    def current_context(self) -> tuple[str, str] | None:
        """(trace_id, span_id) of this thread's innermost open span, else
        the process root context inherited from the parent process."""
        stack = getattr(self._tls, "stack", None)
        if stack:
            return stack[-1].context()
        if self.root_parent is not None:
            return (self.trace_id, self.root_parent)
        return None

    def child_env(self) -> dict:
        """Env vars that make a child process continue this trace: its
        tracer adopts our run id and parents its spans under the CURRENT
        span of the calling thread (the supervisor calls this inside its
        per-launch span)."""
        ctx = self.current_context() or (self.trace_id, "")
        env = {ENV_RUN_ID: self.run_id}
        if ctx[1]:
            env[ENV_TRACE_PARENT] = f"{ctx[0]}:{ctx[1]}"
        return env

    # -- recording / flushing ------------------------------------------------
    def _record(self, name, cat, t_wall, dur_s, trace_id, span_id,
                parent_id, attrs) -> None:
        thread = threading.current_thread()
        rec = {
            "v": SCHEMA_VERSION,
            "kind": "span",
            "name": name,
            "cat": cat,
            "run": self.run_id,
            "trace": trace_id,
            "span": span_id,
            "t": round(t_wall, 6),
            "dur": round(max(dur_s, 0.0), 6),
            "pid": self.pid,
            "proc": self.proc,
            "tid": thread.ident,
            "thread": thread.name,
        }
        if parent_id:
            rec["parent"] = parent_id
        if attrs:
            rec["attrs"] = attrs
        self._ring.append(rec)  # lock-free fast path (GIL-atomic append)
        self.spans_recorded += 1
        if len(self._ring) >= self._flush_every:
            self.flush()

    def flush(self) -> None:
        """Drain the ring to spans.jsonl (one O_APPEND write of all
        pending lines — safe to interleave with other processes appending
        to the same file). Flush time is booked as span-layer self-time."""
        if self._path is None:
            return
        t0 = time.perf_counter()
        with self._io_lock:
            lines = []
            while True:
                try:
                    rec = self._ring.popleft()
                except IndexError:
                    break
                lines.append(_dumps(rec))
            if lines:
                with open(self._path, "a", encoding="utf-8") as f:
                    f.write("\n".join(lines) + "\n")
                self.spans_written += len(lines)
        self._note_self(time.perf_counter() - t0)

    # -- capture windows -----------------------------------------------------
    def request_capture(self, reason: str) -> None:
        """Arm a capture window at the next `tick`. Signal-safe: a plain
        assignment, no locks, no I/O — callable straight from a SIGUSR1
        handler or any thread."""
        self._pending_reason = reason

    def maybe_autocapture(self, reason: str) -> bool:
        """Anomaly-detector entry: route a capture request unless one is
        already running/pending. Returns True when this call newly routed
        it — the caller then logs the anomaly. Deliberately NOT gated on
        the budget here: a budget-exhausted anomaly must still be visible
        (the next tick reports it through the once-only `denied` event)
        rather than vanish without a trace; spam is self-limiting because
        anomalous samples join the detector window and raise its p95."""
        if (self._path is None or self._capturing
                or self._pending_reason is not None):
            return False
        self._pending_reason = reason
        return True

    def tick(self, step=None) -> dict | None:
        """Advance the capture state machine one unit (a train step, a
        serve flush). Returns a small event dict on transitions (capture
        start / end / budget-denied) for the caller to land in
        events.jsonl, else None. Also polls the trigger file, time-gated
        so the stat() never rides every step."""
        t0 = time.perf_counter()
        evt = self._tick_inner(step)
        self._note_self(time.perf_counter() - t0)
        return evt

    def _tick_inner(self, step) -> dict | None:
        if self._path is None:
            return None
        now = time.monotonic()
        if (self._trigger_path is not None
                and now - self._last_trigger_poll >= self._trigger_poll_secs):
            self._last_trigger_poll = now
            if os.path.exists(self._trigger_path):
                try:
                    os.remove(self._trigger_path)  # re-touch re-arms
                except OSError:
                    pass
                # also while a window is ACTIVE: the file is consumed
                # either way, so the request must queue (it starts on the
                # first tick after the current window ends) — deleting it
                # without arming would silently drop the operator's touch
                if self._pending_reason is None:
                    self._pending_reason = "trigger_file"
        if self._pending_reason is not None and not self._capturing:
            reason, self._pending_reason = self._pending_reason, None
            if self.captures_used >= self.capture_budget:
                if self._denied_reported:
                    return None
                self._denied_reported = True
                return {"action": "denied", "reason": reason,
                        "captures_used": self.captures_used,
                        "capture_budget": self.capture_budget}
            self.captures_used += 1
            self._capturing = True
            self._capture_left = self.capture_steps
            self._capture_reason = reason
            self.instant("capture_start", cat="capture", reason=reason,
                         step=step, captures_used=self.captures_used)
            self._start_profiler(reason, step)
            return {"action": "start", "reason": reason, "step": step,
                    "window_steps": self.capture_steps,
                    "captures_used": self.captures_used,
                    "capture_budget": self.capture_budget}
        if self._capturing:
            self._capture_left -= 1
            if self._capture_left <= 0:
                reason = self._capture_reason
                self._stop_profiler()
                self.instant("capture_end", cat="capture", reason=reason,
                             step=step)
                self._capturing = False
                self._capture_reason = ""
                self.flush()  # land the window's full-detail spans NOW
                return {"action": "end", "reason": reason, "step": step}
        return None

    def capture_state(self) -> dict:
        """The heartbeat/healthz payload: is a capture running, how much
        window is left, how much budget is spent."""
        return {
            "capturing": self._capturing,
            "window_steps_left": self._capture_left if self._capturing else 0,
            "captures_used": self.captures_used,
            "capture_budget": self.capture_budget,
        }

    def _start_profiler(self, reason: str, step) -> None:
        if self.profiler_hooks is None or self._traces_dir is None:
            return
        tag = f"{int(time.time())}-{reason}"
        if step is not None:
            tag += f"-s{step}"
        trace_dir = os.path.join(self._traces_dir, tag)
        try:
            os.makedirs(trace_dir, exist_ok=True)
            self.profiler_hooks[0](trace_dir)
            self._profiler_active = True
        except Exception as e:  # device profiler failure must not end the
            # run — the span capture still happens; the failure is visible
            # in the timeline and on `profiler_error`
            self._profiler_active = False
            self.profiler_error = repr(e)
            self.instant("profiler_error", cat="capture", error=repr(e))

    def _stop_profiler(self) -> None:
        if not self._profiler_active:
            return
        self._profiler_active = False
        try:
            self.profiler_hooks[1]()
        except Exception as e:  # ending the window must never end the run
            self.profiler_error = repr(e)
            self.instant("profiler_error", cat="capture", error=repr(e))

    # -- self-time accounting (the `telemetry` sub-phase) --------------------
    def _note_self(self, seconds: float) -> None:
        with self._self_lock:
            self._self_s += seconds

    def consume_self_time(self) -> float:
        """Span-layer self-time (flushes, trigger polls, capture
        transitions) accumulated since the last call — booked by the
        driver into StepPhaseTimer's `telemetry` sub-phase so a capture
        window cannot masquerade as a data/host regression."""
        with self._self_lock:
            s, self._self_s = self._self_s, 0.0
        return s

    # -- signals -------------------------------------------------------------
    def install_signal(self) -> bool:
        """SIGUSR1 → arm a capture window. Main-thread only (CPython
        restriction); returns False elsewhere. The previous handler is
        chained and restored by close()."""
        if threading.current_thread() is not threading.main_thread():
            return False
        prev = signal.getsignal(signal.SIGUSR1)

        def _handler(signum, frame):
            self.request_capture("sigusr1")  # assignment only: signal-safe
            if callable(prev):
                prev(signum, frame)

        self._prev_sigusr1 = prev
        signal.signal(signal.SIGUSR1, _handler)
        return True

    # -- teardown ------------------------------------------------------------
    def close(self) -> None:
        """Idempotent: stop any open capture, flush the ring, restore the
        signal disposition."""
        if self._capturing:
            self._stop_profiler()
            self.instant("capture_end", cat="capture",
                         reason=self._capture_reason, truncated=True)
            self._capturing = False
        self.flush()
        if self._prev_sigusr1 is not None:
            try:
                signal.signal(signal.SIGUSR1, self._prev_sigusr1)
            except ValueError:
                pass  # not the main thread anymore (interpreter teardown)
            self._prev_sigusr1 = None


def _dumps(rec: dict) -> str:
    """JSON without importing json at call time is not worth it — but the
    import IS stdlib; kept in a helper so a future binary format has one
    seam."""
    import json

    try:
        return json.dumps(rec)
    except (TypeError, ValueError):
        # foreign attr values (a numpy scalar from a caller): stringify
        # rather than lose the span
        return json.dumps({k: (v if isinstance(
            v, (str, int, float, bool, dict, list, type(None))) else str(v))
            for k, v in rec.items()}, default=str)
