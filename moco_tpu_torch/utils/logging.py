"""Scalar logging, event sinks and profiling windows of the port (port of
`moco_tpu/utils/logging.py`).

- `log_event` prints one `[kind] msg` line and fans the event out to the
  registered sinks (the run telemetry lands it in `events.jsonl`); a
  broken sink never raises; `emit_event` is the fan-out alone. `info` is
  the plain human-facing line.
- `ScalarWriter`: tensorboardX scalars; a no-op when `logdir` is empty or
  tensorboardX is missing (one `info` line on rank 0 then).
- `DeviceTrace` and `ProfilerWindow`: `torch.profiler` traces (host and,
  on a CUDA device, the card's kernels) written as Chrome-trace JSON;
  the window traces steps [start, stop) into `profile_dir`.
"""

from __future__ import annotations

import os

# structured-event sinks: telemetry registers a callable
# `(kind, msg, fields) -> None`; the stdout line stays either way
_EVENT_SINKS: list = []


def add_event_sink(sink) -> None:
    if sink not in _EVENT_SINKS:
        _EVENT_SINKS.append(sink)


def remove_event_sink(sink) -> None:
    if sink in _EVENT_SINKS:
        _EVENT_SINKS.remove(sink)


def log_event(kind: str, msg: str, **fields) -> None:
    """One `[kind] msg` line (flushed), and `(kind, msg, fields)` to every
    sink; `fields` ride the sinks only. A sink that raises is reported on
    a line of its own and the run goes on."""
    print(f"[{kind}] {msg}", flush=True)
    emit_event(kind, msg, **fields)


def emit_event(kind: str, msg: str, **fields) -> None:
    """`log_event` without the line: the sinks alone (for a caller that
    prints its own line elsewhere)."""
    for sink in list(_EVENT_SINKS):
        try:
            sink(kind, msg, fields)
        except Exception as e:  # a broken sink must not take down the run
            print(f"[telemetry] event sink failed: {e!r}", flush=True)


def info(msg: str) -> None:
    """Plain human-facing line (flushed)."""
    print(msg, flush=True)


class ScalarWriter:
    """tensorboardX `SummaryWriter` wrapper; a no-op when `logdir` is empty
    or tensorboardX is not installed (said once, on rank 0). Unconvertible
    scalars are counted in `dropped` and reported once through
    `log_event`."""

    def __init__(self, logdir: str = ""):
        self._writer = None
        self.dropped = 0
        self._drop_warned = False
        if logdir:
            try:
                from tensorboardX import SummaryWriter

                self._writer = SummaryWriter(logdir)
            except ImportError:
                if _is_main_process():
                    info(f"tensorboardX unavailable; not writing scalars to {logdir}")

    def write(self, step: int, scalars: dict) -> None:
        if self._writer is None:
            return
        for name, value in scalars.items():
            try:
                self._writer.add_scalar(name, float(value), step)
            except (TypeError, ValueError):
                self.dropped += 1
                if not self._drop_warned:
                    self._drop_warned = True
                    log_event(
                        "scalar_writer",
                        f"dropped unconvertible scalar {name!r} "
                        f"({type(value).__name__}) at step {step}; further "
                        "drops are counted, see the run_end summary",
                        name=name, step=step,
                    )

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


def _is_main_process() -> bool:
    """Rank 0 of the default process group; True when no group is
    initialized."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return True
    return dist.get_rank() == 0


class DeviceTrace:
    """One `torch.profiler` trace at a time: `start(trace_dir)` begins
    recording the host and, where CUDA is available, the card's kernels;
    `stop()` ends it and writes `trace_<pid>.json` (Chrome-trace format)
    into that directory, returning the path."""

    def __init__(self):
        self._prof = None
        self._dir = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self, trace_dir: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        if self._prof is not None:
            raise RuntimeError("a device trace is already recording")
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        prof = profile(activities=activities)
        prof.__enter__()
        self._prof, self._dir = prof, trace_dir

    def stop(self) -> str | None:
        prof, self._prof = self._prof, None
        if prof is None:
            return None
        prof.__exit__(None, None, None)
        path = os.path.join(self._dir, f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        return path


class ProfilerWindow:
    """Trace steps [start, stop) with `torch.profiler` into `logdir`
    (`DeviceTrace`'s Chrome-trace file). Inactive when logdir == ""."""

    def __init__(self, logdir: str, start: int, stop: int):
        self.logdir, self.start, self.stop = logdir, start, stop
        self._trace = DeviceTrace()

    def maybe_toggle(self, step: int) -> None:
        if not self.logdir:
            return
        if not self._trace.active and self.start <= step < self.stop:
            # range check (not ==): a resumed run may start past `start`
            self._trace.start(self.logdir)
        elif self._trace.active and step >= self.stop:
            self._trace.stop()

    def close(self) -> None:
        self._trace.stop()
