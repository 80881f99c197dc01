"""Dynamic micro-batcher with admission control (port of
`moco_tpu/serve/batcher.py`, with its semantics and messages).

Online serving inverts pretraining's batching problem: requests arrive one
at a time, but the accelerator amortizes fixed per-call cost only over
LARGE calls. The batcher coalesces concurrent requests into few device
calls — flush on max-batch-size OR deadline, whichever comes first — the
same amortize-without-unbounded-latency tradeoff FAST (PAPERS.md) makes
for all-to-all scheduling.

Contracts the tests pin:

  - FIFO: requests are batched strictly in arrival order; a deadline
    flush takes the OLDEST prefix of the queue.
  - shed, never stall: the admission queue has a bounded depth — at
    capacity `submit` raises `OverloadedError` immediately (the caller
    gets a structured rejection with a retry hint, not unbounded
    latency). A request whose own deadline passed while it sat queued is
    resolved with `DeadlineExceededError` instead of wasting a device
    slot on an answer nobody is waiting for.
  - drain, never drop: `drain()` stops admission and flushes EVERYTHING
    already accepted — every in-flight request completes (SIGTERM
    semantics; `python -m moco_tpu_torch.serve` wires it through the
    resilience/preemption.py handler-chaining pattern).

The batcher never touches torch: `run_batch` is any `[n, ...] -> [n, D]`
callable (serve/engine.py's bucketed-compile `embed` in production, a
stub in the unit tests), so batching semantics are testable without a
compile in sight.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from moco_tpu_torch.telemetry.trace import SpikeDetector, null_tracer

# Admission tiers: interactive user traffic and bulk batch
# work (bank_build re-embeds) ride SEPARATE bounded queues with separate
# deadlines, so a batch flood can fill its own lane to the brim without
# ever costing an interactive request its admission slot. The flusher
# serves interactive strictly first and backfills spare bucket capacity
# with batch rows — priority, not partitioned throughput.
TIERS = ("interactive", "batch")


class RejectionError(Exception):
    """A request that got a structured DECISION instead of a result.

    `code` is the wire-visible discriminator (the HTTP front end maps it
    to a status + JSON error body); `fields` carry machine-readable
    context (e.g. `retry_after_ms`)."""

    code = "rejected"
    http_status = 503

    def __init__(self, msg: str, **fields):
        super().__init__(msg)
        self.fields = fields


class OverloadedError(RejectionError):
    """Admission queue at capacity — shed at the door, retry later."""

    code = "overloaded"
    http_status = 503


class DeadlineExceededError(RejectionError):
    """The request's own deadline passed before a device slot reached it."""

    code = "deadline_exceeded"
    http_status = 504


class DrainingError(RejectionError):
    """The service is shutting down; new work is rejected, in-flight
    work completes."""

    code = "draining"
    http_status = 503


def bucket_for(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest padded bucket shape that fits `n` requests. `buckets` is
    ascending; `n` must fit the largest (the batcher never pops more)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds the largest bucket {buckets[-1]}")


def validate_buckets(buckets) -> tuple[int, ...]:
    b = tuple(int(x) for x in buckets)
    if not b or any(x < 1 for x in b) or list(b) != sorted(set(b)):
        raise ValueError(
            f"buckets must be ascending unique positive sizes, got {buckets!r}"
        )
    return b


class PendingRequest:
    """One queued request: payload in, exactly-one-of (result, error) out.
    `enqueue_wall` is the wall-clock twin of the monotonic `enqueue_t` —
    the trace layer records the request's admission→resolve span
    retroactively at resolve time, and cross-process timelines
    merge on wall-clock."""

    __slots__ = ("payload", "enqueue_t", "enqueue_wall", "deadline_t",
                 "tier", "result", "error", "_done")

    def __init__(self, payload, enqueue_t: float, deadline_t: float,
                 tier: str = "interactive"):
        self.payload = payload
        self.enqueue_t = enqueue_t
        self.tier = tier
        # wall-clock by design: retroactive request spans must merge
        # with other processes' timelines on a shared clock; the value
        # never feeds computation
        self.enqueue_wall = time.time()
        self.deadline_t = deadline_t
        self.result = None
        self.error: Exception | None = None
        self._done = threading.Event()

    def resolve(self, result=None, error: Exception | None = None) -> None:
        self.result = result
        self.error = error
        self._done.set()

    def wait(self, timeout: float | None = None):
        """Block for the batcher's decision; raises the structured error
        for shed/failed requests. The batcher resolves every accepted
        request (execute, shed, or drain-reject), so a timeout here means
        the flusher thread itself died — surfaced as a hard error, never
        a silent None."""
        if not self._done.wait(timeout):
            raise RuntimeError(
                "batcher never resolved the request (flusher thread dead?)"
            )
        if self.error is not None:
            raise self.error
        return self.result


class MicroBatcher:
    """Deadline-or-size flushing over a bounded FIFO admission queue.

    `run_batch([n, ...]) -> [n, D]` executes one coalesced batch (n is
    ≤ `buckets[-1]`; padding to the bucket shape is the executor's
    concern — see serve/engine.py). `on_batch(n, bucket, wait_s)` fires
    after each executed batch with the real occupancy numerator, the
    padded bucket, and the oldest request's queue wait.
    """

    def __init__(
        self,
        run_batch,
        *,
        buckets: tuple[int, ...] = (1, 8, 32, 128),
        flush_ms: float = 10.0,
        max_queue: int = 256,
        default_deadline_ms: float = 2000.0,
        on_batch=None,
        name: str = "embed",
        tracer=None,
        shed_spike_min: int = 8,
        batch_max_queue: int | None = None,
        batch_deadline_ms: float | None = None,
    ):
        self.buckets = validate_buckets(buckets)
        if max_queue < self.buckets[-1]:
            raise ValueError(
                f"max_queue ({max_queue}) must hold at least one full "
                f"bucket ({self.buckets[-1]}) or the largest bucket can "
                "never fill"
            )
        self._run_batch = run_batch
        self._flush_s = float(flush_ms) / 1e3
        self.max_queue = int(max_queue)
        self._default_deadline_s = float(default_deadline_ms) / 1e3
        # batch lane defaults: same depth as interactive, a LONGER
        # deadline (bulk work tolerates queueing; it must not be shed by
        # a deadline tuned for user latency)
        self.max_queue_by_tier = {
            "interactive": int(max_queue),
            "batch": int(batch_max_queue if batch_max_queue is not None
                         else max_queue),
        }
        self._deadline_s_by_tier = {
            "interactive": self._default_deadline_s,
            "batch": (float(batch_deadline_ms) / 1e3
                      if batch_deadline_ms is not None
                      else self._default_deadline_s),
        }
        self._on_batch = on_batch
        # tracing: flush/engine spans + retroactive per-request
        # spans, and the shed-spike detector arming a budgeted capture
        # window. The null tracer keeps the request path branch-free.
        self._tracer = tracer if tracer is not None else null_tracer()
        self._shed_spike = SpikeDetector(min_events=shed_spike_min)
        self._flush_seq = 0
        self._queues: dict[str, deque[PendingRequest]] = {
            t: deque() for t in TIERS
        }
        self._cond = threading.Condition()
        self._draining = False
        self._closed = False
        self._inflight = 0
        # counters (read under the cond lock by stats consumers).
        # shed_overload/shed_deadline stay TOTALS across tiers (the
        # pre-tier stats contract); *_by_tier carry the breakdown.
        self.submitted = 0
        self.completed = 0
        self.shed_overload = 0
        self.shed_deadline = 0
        self.batch_errors = 0
        self.batches = 0
        self.occupancy_sum = 0.0
        self.submitted_by_tier = {t: 0 for t in TIERS}
        self.shed_overload_by_tier = {t: 0 for t in TIERS}
        self.shed_deadline_by_tier = {t: 0 for t in TIERS}
        self._thread = threading.Thread(
            target=self._flush_loop, daemon=True, name=f"{name}-flusher"
        )
        self._thread.start()

    # -- admission -----------------------------------------------------------
    def submit(self, payload, deadline_s: float | None = None,
               tier: str = "interactive") -> PendingRequest:
        """Admit one request or raise a structured rejection IMMEDIATELY
        (bounded queue: the overloaded answer must be cheap and instant,
        never a timeout the client discovers on their own). Admission is
        PER TIER: a full batch lane sheds batch work only."""
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r} (one of {TIERS})")
        now = time.monotonic()
        if deadline_s is None:
            deadline_s = self._deadline_s_by_tier[tier]
        pending = PendingRequest(payload, now, now + deadline_s, tier)
        queue_len = -1
        with self._cond:
            if self._draining or self._closed:
                raise DrainingError("service is draining; not accepting work")
            q = self._queues[tier]
            if len(q) >= self.max_queue_by_tier[tier]:
                self.shed_overload += 1
                self.shed_overload_by_tier[tier] += 1
                queue_len = len(q)
            else:
                self.submitted += 1
                self.submitted_by_tier[tier] += 1
                q.append(pending)
                self._cond.notify_all()
        if queue_len >= 0:
            # tracer work OUTSIDE the admission lock: a span-ring flush is
            # a file write, and an overload storm is exactly when the lock
            # must stay cheap — "shed, never stall" includes not stalling
            # the OTHER submitters on shed bookkeeping
            if self._shed_spike.note():
                # a shed SPIKE (vs a lone shed) is the moment worth a
                # profile: arm the capture window, budget-bounded
                self._tracer.maybe_autocapture("shed_spike")
            self._tracer.instant("shed_overload", cat="serve",
                                 queue=queue_len, tier=tier)
            # crude but honest hint: full queues ahead of this request
            # each take at least one flush window to clear
            depth_batches = 1 + queue_len // self.buckets[-1]
            raise OverloadedError(
                f"admission queue full "
                f"({self.max_queue_by_tier[tier]}, tier={tier})",
                retry_after_ms=round(depth_batches * self._flush_s * 1e3, 1),
                tier=tier,
            )
        return pending

    def _qlen(self) -> int:
        # caller holds self._cond
        return sum(len(q) for q in self._queues.values())

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return self._qlen() + self._inflight

    @property
    def queue_depth_by_tier(self) -> dict:
        with self._cond:
            return {t: len(q) for t, q in self._queues.items()}

    @property
    def occupancy_mean(self) -> float:
        with self._cond:
            return self.occupancy_sum / self.batches if self.batches else 0.0

    # -- the flusher ---------------------------------------------------------
    def _flush_loop(self) -> None:
        while True:
            with self._cond:
                while not self._qlen() and not self._closed:
                    self._cond.wait()
                if not self._qlen():  # closed and empty: done
                    return
                # coalesce window: more work may arrive until the oldest
                # request's flush deadline OR a full largest bucket,
                # whichever first; draining flushes immediately
                flush_at = min(
                    q[0].enqueue_t for q in self._queues.values() if q
                ) + self._flush_s
                while (self._qlen() < self.buckets[-1]
                       and not self._draining and not self._closed):
                    remaining = flush_at - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                # interactive first, batch backfills spare bucket slots
                take = min(self._qlen(), self.buckets[-1])
                batch = []
                for tier in TIERS:
                    q = self._queues[tier]
                    while q and len(batch) < take:
                        batch.append(q.popleft())
                self._inflight = len(batch)
            try:
                self._execute(batch)
            finally:
                with self._cond:
                    self._inflight = 0
                    self._cond.notify_all()

    def _execute(self, batch: list[PendingRequest]) -> None:
        now = time.monotonic()
        self._flush_seq += 1
        seq = self._flush_seq  # joins request spans to their flush span
        live, expired = [], []
        for p in batch:
            (live if p.deadline_t > now else expired).append(p)
        for p in expired:
            p.resolve(error=DeadlineExceededError(
                f"deadline passed after {now - p.enqueue_t:.3f}s in queue",
                queued_ms=round((now - p.enqueue_t) * 1e3, 1),
            ))
            self._request_span(p, now, "deadline_exceeded", seq)
        with self._cond:
            self.shed_deadline += len(expired)
            for p in expired:
                self.shed_deadline_by_tier[p.tier] += 1
        if not live:
            return
        bucket = bucket_for(len(live), self.buckets)
        with self._tracer.span("flush_batch", cat="serve", n=len(live),
                               bucket=bucket, seq=seq):
            try:
                with self._tracer.span("engine", cat="serve", detail=True,
                                       bucket=bucket):
                    # asANYarray: the service tags rows with the engine
                    # generation via an ndarray subclass (the dual
                    # swap); a plain asarray would strip the tag
                    out = np.asanyarray(self._run_batch(
                        np.stack([p.payload for p in live])
                    ))
            except Exception as e:  # executor failure: every rider sees it
                for p in live:
                    p.resolve(error=e)
                    self._request_span(p, time.monotonic(), "batch_error",
                                       seq)
                with self._cond:
                    self.batch_errors += 1
                return
            done = time.monotonic()
            for p, row in zip(live, out):
                p.resolve(result=np.asanyarray(row))
                self._request_span(p, done, "ok", seq)
        wait_s = now - live[0].enqueue_t
        with self._cond:
            self.completed += len(live)
            self.batches += 1
            self.occupancy_sum += len(live) / bucket
        if self._on_batch is not None:
            self._on_batch(len(live), bucket, wait_s)

    def _request_span(self, p: PendingRequest, t_mono: float, outcome: str,
                      seq: int) -> None:
        """Retroactive admission→resolve span for one request, recorded
        only at `full` detail (or inside a capture window): under load the
        per-request spans are the bulk of the volume, so the coarse level
        keeps just the flush spans. Correlate with the executing flush via
        the shared `seq` attr."""
        self._tracer.record_span(
            "request", p.enqueue_wall, t_mono - p.enqueue_t, cat="serve",
            detail=True, outcome=outcome, seq=seq,
        )

    # -- shutdown ------------------------------------------------------------
    def drain(self, timeout_s: float = 60.0) -> bool:
        """Stop admitting, flush everything already accepted, return True
        once every accepted request is resolved (False on timeout — the
        caller decides whether to hard-stop)."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            self._draining = True
            self._cond.notify_all()
            while self._qlen() or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=min(remaining, 0.1))
        return True

    def close(self, drain: bool = True, timeout_s: float = 60.0) -> None:
        """Drain (default) or reject-what's-queued, then stop the flusher."""
        if drain:
            self.drain(timeout_s)
        with self._cond:
            self._draining = True
            self._closed = True
            leftovers = [p for q in self._queues.values() for p in q]
            for q in self._queues.values():
                q.clear()
            self._cond.notify_all()
        for p in leftovers:
            p.resolve(error=DrainingError("batcher closed before execution"))
        self._thread.join(timeout=5.0)
