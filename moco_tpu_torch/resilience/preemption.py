"""Preemption-safe shutdown (port of `moco_tpu/resilience/preemption.py`).

A preemptible machine gets a SIGTERM and a short grace window before it is
taken away. The handler turns the signal into a FLAG; the driver finishes
the step in flight, writes a step-tagged emergency checkpoint at the
mid-epoch position, and returns, so the resumed run is the uninterrupted
one bit for bit.
"""

from __future__ import annotations

import signal
import threading

from moco_tpu_torch.utils.logging import log_event


class PreemptionHandler:
    """Context manager that turns SIGTERM/SIGINT into a flag to poll.

    First signal: set the flag and keep running (the driver checkpoints and
    exits at the next step boundary). Second signal: chain to the previous
    disposition, so a double Ctrl-C exits at once.

    Signal handlers can only be installed from the main thread; entered from
    any other thread (a staging worker, a nested driver) the handler is
    inert and `triggered` stays False, so no other thread can take the
    signal from the main thread's handler.
    """

    def __init__(self, signums: tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)):
        self._signums = signums
        self._flag = threading.Event()
        self._prev: dict[int, object] = {}
        self._installed = False

    def _handle(self, signum, frame):
        if self._flag.is_set():
            log_event("preempt", f"second signal {signum}: chaining to the "
                                 "original handler (immediate exit)")
            prev = self._prev.get(signum, signal.SIG_DFL)
            if callable(prev):
                prev(signum, frame)
            else:
                signal.signal(signum, prev)
                signal.raise_signal(signum)
            return
        self._flag.set()
        log_event("preempt", f"caught signal {signum}; finishing the in-flight step, then "
                             "writing an emergency checkpoint and exiting cleanly")

    def __enter__(self) -> "PreemptionHandler":
        if threading.current_thread() is threading.main_thread():
            for s in self._signums:
                self._prev[s] = signal.signal(s, self._handle)
            self._installed = True
        return self

    @property
    def triggered(self) -> bool:
        return self._flag.is_set()

    def __exit__(self, *exc) -> bool:
        if self._installed:
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            self._installed = False
        return False
