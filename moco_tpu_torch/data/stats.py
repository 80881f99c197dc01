"""Input-pipeline instrumentation shared by the staging stack (port of
`moco_tpu/data/stats.py`, the port's own copy; the same `snapshot()` keys).

One `InputPipelineStats` lives for a whole training run and is threaded into
every `Prefetcher` and `CachedDataset` of that pass: epochs come and go,
the counters accumulate. Everything here is pure stdlib and updated from
staging/worker threads, so every mutation holds the lock.

Tracked:
  - staged-batch latency (decode -> device-queue wall per batch) p50/p95
    over a rolling window of recent batches, plus cumulative staged bytes
  - ready-queue depth at enqueue time (last + mean): a queue that is
    always 0 means the consumer is starved (host-bound); always full
    means the device is the bottleneck
  - worker-busy fraction: total worker decode seconds over
    workers x wall seconds
  - credit stalls: seconds the training loop waited on an empty ready queue
  - decode-once canvas-cache hits/misses (CachedDataset)
"""

from __future__ import annotations

import threading
import time


def _percentile(ordered: list[float], q: float) -> float:
    """Nearest-rank percentile of an ALREADY-SORTED list."""
    if not ordered:
        return 0.0
    rank = max(0, min(len(ordered) - 1, round(q / 100.0 * (len(ordered) - 1))))
    return ordered[int(rank)]


# staged-latency reservoir bound: snapshot() sorts it under the lock the
# staging coordinator shares, so it must stay small — keep a rolling
# window (recent behavior is also what an operator tunes against), trimmed
# amortized-O(1) at twice the window
_LATENCY_WINDOW = 4096


class InputPipelineStats:
    """Cumulative, thread-safe counters for one run's input pipeline."""

    def __init__(self):
        self._lock = threading.Lock()
        self._created = time.perf_counter()
        self.staged_batches = 0
        self.staged_bytes = 0
        self._staged_s: list[float] = []
        self.queue_depth_last = 0
        self._queue_depth_sum = 0
        self.workers = 1
        self._worker_busy_s = 0.0
        self.cache_hits = 0
        self.cache_misses = 0
        self._credit_stall_s = 0.0

    # -- producers ----------------------------------------------------------
    def note_workers(self, n: int) -> None:
        """Record the staging-worker count (max across loaders of the run:
        eval loaders may run narrower than the train loader)."""
        with self._lock:
            self.workers = max(self.workers, int(n))

    def note_staged(self, seconds: float, queue_depth: int, nbytes: int) -> None:
        """One batch fully staged (decoded + transferred + enqueued)."""
        with self._lock:
            self.staged_batches += 1
            self.staged_bytes += int(nbytes)
            self._staged_s.append(float(seconds))
            if len(self._staged_s) > 2 * _LATENCY_WINDOW:
                del self._staged_s[:-_LATENCY_WINDOW]
            self.queue_depth_last = int(queue_depth)
            self._queue_depth_sum += int(queue_depth)

    def note_worker_busy(self, seconds: float) -> None:
        with self._lock:
            self._worker_busy_s += float(seconds)

    def note_cache(self, hits: int, misses: int) -> None:
        with self._lock:
            self.cache_hits += int(hits)
            self.cache_misses += int(misses)

    def note_credit_stall(self, seconds: float) -> None:
        """Consumer-side starvation: time the training loop spent blocked
        on an EMPTY ready queue, the input pipeline failing to keep the
        device fed. A sustained high rate is a starving train host."""
        with self._lock:
            self._credit_stall_s += float(seconds)

    # -- consumer -----------------------------------------------------------
    def snapshot(self) -> dict:
        """One JSON-ready dict of everything above (cumulative)."""
        with self._lock:
            wall = max(time.perf_counter() - self._created, 1e-9)
            total_lookups = self.cache_hits + self.cache_misses
            ordered = sorted(self._staged_s)
            snap = {
                "staged_batches": self.staged_batches,
                "staged_mb": round(self.staged_bytes / 2**20, 1),
                "staged_batch_s_p50": round(_percentile(ordered, 50), 6),
                "staged_batch_s_p95": round(_percentile(ordered, 95), 6),
                "queue_depth": self.queue_depth_last,
                "queue_depth_mean": round(
                    self._queue_depth_sum / max(self.staged_batches, 1), 3
                ),
                "workers": self.workers,
                # busy fraction over run wall-clock: idle stretches (evals,
                # checkpoint stalls) dilute it — read it as "of the run so
                # far, how much worker capacity decode actually used"
                "worker_busy_frac": round(
                    self._worker_busy_s / (self.workers * wall), 4
                ),
                # cumulative pair: a windowed stall rate is the ratio of
                # their deltas
                "credit_stall_s": round(self._credit_stall_s, 3),
                "wall_s": round(wall, 3),
            }
            if total_lookups:
                snap["cache_hits"] = self.cache_hits
                snap["cache_misses"] = self.cache_misses
                snap["cache_hit_rate"] = round(self.cache_hits / total_lookups, 4)
            return snap
