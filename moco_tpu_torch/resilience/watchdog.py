"""Step-time watchdog (port of `moco_tpu/resilience/watchdog.py`).

A stuck collective or a wedged input pipeline looks like silence from the
driver: no step completes and nothing raises. The watchdog is a daemon
thread that flags it, through `log_event`, once an interval passes with no
`beat()`, and again after each further interval of silence. It only FLAGS:
killing the process from a thread would turn a transient stall into lost
work, and the kill is a supervisor's decision.
"""

from __future__ import annotations

import contextlib
import threading
import time

from moco_tpu_torch.utils.logging import log_event


class StepWatchdog:
    """Context manager; `beat(step)` after every completed step.

    `interval_secs <= 0` starts no thread: `beat` stays a cheap write, so
    callers need no gating. `stalls` counts the flags raised.
    """

    def __init__(self, interval_secs: float):
        self.interval = float(interval_secs)
        self.stalls = 0
        self._suspend = 0
        self._step = 0
        self._last = time.monotonic()
        # after one flag, the next comes only after a FURTHER full interval
        # of silence (one line an interval, not one a poll)
        self._warn_after = self.interval
        # the re-arm state is written from both threads
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def beat(self, step: int) -> None:
        with self._lock:
            self._step = int(step)
            self._last = time.monotonic()
            self._warn_after = self.interval

    @contextlib.contextmanager
    def suspended(self):
        """Scope for KNOWN-long work between steps (the kNN monitor, a
        blocking save), where a flag would be a false positive. Nests; the
        watchdog re-arms afresh when the outermost scope exits."""
        with self._lock:
            self._suspend += 1
        try:
            yield
        finally:
            with self._lock:
                self._suspend -= 1
                self._last = time.monotonic()
                self._warn_after = self.interval

    def _watch(self) -> None:
        poll = max(self.interval / 4.0, 0.01)
        while not self._stop.wait(poll):
            with self._lock:
                if self._suspend:
                    continue
                gap = time.monotonic() - self._last
                flag = gap > self._warn_after
                if flag:
                    self.stalls += 1
                    self._warn_after += self.interval
                    step = self._step
            if flag:
                log_event("watchdog",
                          f"no step completed in {gap:.1f}s (last completed step {step}, "
                          f"threshold {self.interval:.1f}s) — possible hang (stuck "
                          "collective / wedged input pipeline)")

    def __enter__(self) -> "StepWatchdog":
        if self.interval > 0:
            self._last = time.monotonic()
            self._stop.clear()
            self._thread = threading.Thread(target=self._watch, daemon=True,
                                            name="step-watchdog")
            self._thread.start()
        return self

    def __exit__(self, *exc) -> bool:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        return False
