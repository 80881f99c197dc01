"""Step-phase wall-clock splitting (port of `moco_tpu/telemetry/timing.py`).

A training step's wall time decomposes into:

  data_s    — loader wait: the host blocked on the next batch (prefetch
              misses, decode stalls)
  host_s    — dispatch: the view pair and the step's Python, which enqueue
              the step's kernels; in a healthy asynchronous pipeline the
              only host cost a step
  device_s  — device drain, measured ONLY on fenced steps (`step %
              stride == 0`): the fence pulls the step's loss to the host
              (`.item()`), a copy ordered after every kernel the step
              enqueued on the current stream, and device_s is the time
              from the dispatch's return to that copy's end: the device's
              backlog. Steps that are not fenced stay asynchronous
              (stride 0 never fences).
  comm_s    — the gradient sync's exposed tail, on the same fenced steps:
              the step records one CUDA event when the local gradients
              exist (after the backward, before `GradSync.finish`) and one
              after `finish`, both on the compute stream, and comm_s is
              their `elapsed_time`: DEVICE time from "local gradients
              exist" to "the synced gradients are visible". The JAX
              package measures the same window on the host, by draining
              two probe scalars in order; this is the torch measure of it.
              A reduce launched from the backward (the bucketed and
              quantized modes) overlaps the backward, so only its tail
              shows. On the CPU the step stamps the host clock instead
              (gloo's CPU collectives block the host). With no process
              group there is no sync, and no comm_s.
  telemetry_s — the telemetry stack's own time booked inside this step's
              window (span flushes, trigger-file polls, capture
              transitions, the per-step record): booked through
              `note_telemetry` and carved out of the window it would
              otherwise pollute, the next step's `data_s`.
  step_s    — the whole iteration; on fenced steps it includes the fence.

Usage per iteration (driver order):
    timer.epoch_start()                  # aligns the first data window
    ... loader yields ...
    timer.mark_data()
    ... the step returns ...
    timer.mark_dispatch()
    timer.maybe_fence(step, loss, comm_pre, comm_post)
    phases = timer.finish_step()         # {"data_s", "host_s", ...}
"""

from __future__ import annotations

import time


def comm_seconds(pre, post) -> float:
    """Seconds between two comm stamps: CUDA events (timed, both recorded;
    waits for `post`) or host `perf_counter` floats."""
    if isinstance(pre, float) and isinstance(post, float):
        return max(post - pre, 0.0)
    post.synchronize()
    return max(pre.elapsed_time(post) / 1e3, 0.0)


class StepPhaseTimer:
    def __init__(self, stride: int = 0):
        self.stride = max(int(stride), 0)
        self.fences = 0  # steps that paid a fence: never more than steps/stride
        self._t_iter = None
        self._t_data = None
        self._t_dispatch = None
        self._device_s = None
        self._comm_s = None
        self._telemetry_s = 0.0

    def epoch_start(self) -> None:
        now = time.perf_counter()
        self._t_iter = now
        self._t_data = self._t_dispatch = None
        self._device_s = None
        self._comm_s = None
        # telemetry time booked after the previous epoch's last step falls
        # outside every step window: carrying it would over-subtract from
        # the new epoch's first data phase
        self._telemetry_s = 0.0

    def note_telemetry(self, seconds: float) -> None:
        """Book the telemetry stack's own time into the CURRENT iteration
        window (the driver calls this right after its per-step telemetry
        work, which runs between finish_step and the next loader wait)."""
        self._telemetry_s += max(float(seconds), 0.0)

    def mark_data(self) -> None:
        self._t_data = time.perf_counter()

    def mark_dispatch(self) -> None:
        self._t_dispatch = time.perf_counter()

    def maybe_fence(self, step: int, sync_obj, comm_pre=None,
                    comm_post=None) -> float | None:
        """Stride-gated device fence; returns device_s on fenced steps.

        `sync_obj` is a scalar step output (the loss tensor, or a number):
        pulling it to the host waits for the step's kernels. `comm_pre` /
        `comm_post` are the step's gradient-sync stamps (`comm_seconds`);
        when both are given on a fenced step their gap is the comm_s
        phase."""
        if self.stride <= 0 or step % self.stride != 0:
            return None
        if self._t_dispatch is None:  # fence without a dispatch mark
            return None
        float(sync_obj.item() if hasattr(sync_obj, "item") else sync_obj)
        self._device_s = time.perf_counter() - self._t_dispatch
        if comm_pre is not None and comm_post is not None:
            self._comm_s = comm_seconds(comm_pre, comm_post)
        self.fences += 1
        return self._device_s

    def finish_step(self) -> dict:
        """Close the iteration; returns the phase dict and re-arms for the
        next step (the next data window starts now)."""
        now = time.perf_counter()
        t0 = self._t_iter if self._t_iter is not None else now
        t_data = self._t_data if self._t_data is not None else t0
        t_disp = self._t_dispatch if self._t_dispatch is not None else t_data
        # carve the booked telemetry time OUT of the loader-wait window it
        # landed in: data_s + host_s + telemetry_s still sums within step_s
        telemetry_s = min(self._telemetry_s, max(t_data - t0, 0.0))
        phases = {
            "step_s": now - t0,
            "data_s": max(t_data - t0 - telemetry_s, 0.0),
            "host_s": t_disp - t_data,
        }
        if telemetry_s > 0.0:
            phases["telemetry_s"] = telemetry_s
        if self._device_s is not None:
            phases["device_s"] = self._device_s
        if self._comm_s is not None:
            phases["comm_s"] = self._comm_s
        self._t_iter = now
        self._t_data = self._t_dispatch = None
        self._device_s = None
        self._comm_s = None
        self._telemetry_s = 0.0
        return phases
