"""Host-to-device input pipeline (port of `moco_tpu/data/loader.py`).

- `epoch_permutation`: a deterministic per-epoch shuffle of the whole
  dataset, truncated to whole batches; `host_shard` takes one process's
  contiguous part of every global batch.
- `Prefetcher`: a coordinator thread stages the batches ahead of the
  consumer. Per batch it fans contiguous sub-slices out to the staging
  workers, which decode INTO disjoint rows of a pooled canvas (pinned host
  memory on a CUDA device; `get_batch_into` where the dataset has it), then
  copies the canvas to the device on a side stream, records an event, and
  returns the canvas to the pool only once that copy has completed. The
  ready queue holds device tensors; the consumer's stream waits on each
  batch's event. So decode, assembly and the H2D copy hide under the
  running train step. Batches are BIT-IDENTICAL to one-worker staging
  (contiguous sub-slices of the same index order into disjoint rows), and a
  transient read fault retries only its sub-slice, with backoff, without
  reordering or duplicating batches. Each read attempt first polls the
  installed `ChaosPlan`'s `loader_error_at_batch` (the fault drills).
- `epoch_loader`: one epoch of batches through a `Prefetcher`.
- Spans (`telemetry/trace.py`, the JAX package's names and categories): one
  `stage_batch` per batch on the coordinator, and at `trace_mode="full"`
  (or in a capture window) a `decode_slice` per worker sub-slice and an
  `h2d_shard` per host-to-device copy under it. The default tracer records
  nothing.
- `stage_eval_batch`: one padded eval batch on the device.

On `device="cpu"` nothing is pinned and there are no streams: each batch is
a copy of the canvas, since the canvas is recycled.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from typing import Iterator

import numpy as np
import torch

from moco_tpu_torch.resilience.chaos import active_chaos
from moco_tpu_torch.telemetry.trace import null_tracer


def epoch_permutation(n: int, epoch: int, seed: int, global_batch: int) -> np.ndarray:
    """Deterministic epoch shuffle, truncated to whole batches (drop_last)."""
    rng = np.random.RandomState((seed * 100003 + epoch) % (2**31))
    perm = rng.permutation(n)
    usable = (n // global_batch) * global_batch
    return perm[:usable]


def host_shard(indices: np.ndarray, global_batch: int, num_processes: int = 1,
               process_index: int = 0) -> np.ndarray:
    """This process's slice of every global batch (the identity for one
    process)."""
    if num_processes == 1:
        return indices
    if global_batch % num_processes:
        raise ValueError(f"global batch {global_batch} not divisible by process count "
                         f"{num_processes}")
    per = global_batch // num_processes
    batches = indices.reshape(-1, global_batch)
    return batches[:, process_index * per:(process_index + 1) * per].reshape(-1)


def _log(msg: str) -> None:
    print(f"[loader] {msg}", file=sys.stderr, flush=True)


class _CloseRequested(Exception):
    """close() was called while a staging read was in retry backoff: the
    read exits quietly instead of surfacing a transient error."""


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


class _Canvas:
    """One preallocated staging buffer: batch images + extents + labels, as
    torch tensors (pinned for a CUDA device) and numpy views of them that
    the workers write into."""

    def __init__(self, batch: int, img_shape: tuple, img_dtype, label_dtype, pin: bool):
        def empty(shape, dtype):
            t = torch.empty(shape, dtype=_torch_dtype(dtype), pin_memory=pin)
            return t, t.numpy()

        self.imgs_t, self.imgs = empty((batch,) + tuple(img_shape), img_dtype)
        self.extents_t, self.extents = empty((batch, 3), np.int32)
        self.labels_t, self.labels = empty((batch,), label_dtype)
        self.pin = pin
        self.compact_t: torch.Tensor | None = None  # trim_h2d's contiguous prefix

    def compact(self, th: int, tw: int) -> torch.Tensor:
        """The images' `[:, :th, :tw]` as one contiguous tensor (in pinned
        memory of this canvas for a CUDA device), for a trimmed copy."""
        if self.compact_t is None:
            self.compact_t = torch.empty(self.imgs_t.numel(), dtype=self.imgs_t.dtype,
                                         pin_memory=self.pin)
        b, _, _, c = self.imgs_t.shape
        out = self.compact_t[:b * th * tw * c].view(b, th, tw, c)
        out.copy_(self.imgs_t[:, :th, :tw])
        return out


class _BatchCollector:
    """Per-batch completion channel: workers report each finished (or
    failed) sub-slice; the coordinator drains one event per chunk."""

    def __init__(self):
        self.events: queue.Queue = queue.Queue()

    def done_ok(self) -> None:
        self.events.put(None)

    def done_err(self, err: BaseException) -> None:
        self.events.put(err)


def trim_extent(shape: tuple, extents: np.ndarray) -> tuple[int, int]:
    """(rows, cols) of the canvas a trimmed copy keeps: the batch's largest
    content extent rounded up to 64, at most the canvas. Content never
    fills less than that; the padding beyond it is edge replication the
    crop never samples."""
    h, w = shape[1], shape[2]
    th = min(h, -(-int(extents[:, 0].max()) // 64) * 64)
    tw = min(w, -(-int(extents[:, 1].max()) // 64) * 64)
    return th, tw


class Prefetcher:
    """Iterate device batches, staged ahead by background threads with the
    H2D copy on a side stream.

    A dataset with the `(images, labels, extents)` protocol is staged
    through a pool of two canvases: with `workers` > 1 by worker threads,
    each decoding a contiguous sub-slice, with one worker by the
    coordinator itself. Any other tuple is staged batch by batch through
    freshly pinned memory, and only with `workers=1`. `depth` is the ready
    queue's capacity in device batches. `trim_h2d` copies only the canvas
    prefix that the batch's extents cover (rounded up to 64). `stats` is an
    optional `InputPipelineStats`; `tracer` a `telemetry/trace.py::Tracer`
    (default: the null tracer)."""

    def __init__(self, dataset, indices: np.ndarray, batch: int, device,
                 depth: int = 2, retries: int = 3, backoff_secs: float = 0.5,
                 join_timeout: float = 5.0, workers: int = 1, stats=None,
                 trim_h2d: bool = False, tracer=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.dataset = dataset
        self.indices = indices
        self.batch = batch
        self.num_batches = len(indices) // batch
        self.retries = retries
        self.backoff_secs = backoff_secs
        self._join_timeout = join_timeout
        self.workers = max(1, min(int(workers), batch or 1))
        self.trim_h2d = bool(trim_h2d)
        self._stats = stats
        if stats is not None:
            stats.note_workers(self.workers)
        # the coordinator thread has no span stack of its own: its batch
        # spans parent under the constructing thread's current span
        self._tracer = tracer if tracer is not None else null_tracer()
        self._trace_parent = self._tracer.current_context()
        self._cuda = self.device.type == "cuda"
        # the copies' own stream, made here so a missing card raises in the
        # caller's thread
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._err_delivered = False
        self._free: queue.Queue = queue.Queue()  # recycled _Canvas pool
        self._pool_built = False
        self._tasks: queue.Queue = queue.Queue()
        self._wthreads: list[threading.Thread] = []
        if self.workers > 1:
            self._wthreads = [threading.Thread(target=self._worker_loop, daemon=True,
                                               name=f"staging-w{w}")
                              for w in range(self.workers)]
            for t in self._wthreads:
                t.start()
        self._thread = threading.Thread(target=self._coordinator, daemon=True,
                                        name="staging-coord")
        self._thread.start()

    # -- staging workers -----------------------------------------------------
    def _worker_loop(self):
        while not self._stop.is_set():
            try:
                task = self._tasks.get(timeout=0.1)
            except queue.Empty:
                continue
            b, lo, hi, idx, canvas, collector, trace_ctx = task
            try:
                # a detail span continuing the coordinator's stage_batch
                # span (explicit parent: thread-locals do not cross threads)
                with self._tracer.span("decode_slice", cat="input", detail=True,
                                       parent=trace_ctx, batch=b, lo=lo, hi=hi) as sp:
                    self._read_slice_into(b, idx, canvas, lo, hi, sp.context() or trace_ctx)
                collector.done_ok()
            except Exception as e:  # routed to the coordinator, which raises it
                collector.done_err(e)

    def _read_slice_into(self, b: int, idx: np.ndarray, canvas: _Canvas, lo: int, hi: int,
                         trace_ctx=None):
        """Decode `idx` into canvas rows [lo, hi), retrying a transient read
        fault (OSError) with exponential backoff per sub-slice. Worker-busy
        time books the decode attempts, not the backoff sleeps. `trace_ctx`
        is the span a remote fetch continues (`data/service/client.py`); a
        local decode has no use for it."""
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                plan = active_chaos()
                if plan is not None:  # an injected transient fault (the drills)
                    plan.maybe_loader_error(b)
                if hasattr(self.dataset, "get_batch_into"):
                    canvas.labels[lo:hi] = self.dataset.get_batch_into(
                        idx, canvas.imgs[lo:hi], canvas.extents[lo:hi])
                else:
                    imgs, labels, extents = self.dataset.get_batch(idx)
                    canvas.imgs[lo:hi] = imgs
                    canvas.labels[lo:hi] = labels
                    canvas.extents[lo:hi] = extents
            except OSError as e:
                if self._stats is not None:
                    self._stats.note_worker_busy(time.perf_counter() - t0)
                attempt += 1
                if attempt > self.retries:
                    raise
                delay = self.backoff_secs * (2 ** (attempt - 1))
                _log(f"batch {b} rows [{lo}:{hi}) read failed ({type(e).__name__}: {e}); "
                     f"retry {attempt}/{self.retries} in {delay:.2f}s")
                if self._stop.wait(delay):
                    raise _CloseRequested() from e
                continue
            if self._stats is not None:
                self._stats.note_worker_busy(time.perf_counter() - t0)
            return

    # -- coordinator ---------------------------------------------------------
    def _coordinator(self):
        # any dataset error must reach the consumer: a silently dead thread
        # would hang training on the queue
        try:
            for b in range(self.num_batches):
                t0 = time.perf_counter()
                with self._tracer.span("stage_batch", cat="input",
                                       parent=self._trace_parent, batch=b) as sp:
                    if self._pool_built:
                        item = self._stage_pooled(b, sp.context())
                    else:
                        item = self._stage_first(b)
                if item is None:  # close() during staging
                    return
                staged_s = time.perf_counter() - t0
                if not self._put(item):
                    return
                if self._stats is not None:
                    self._stats.note_staged(staged_s, self._q.qsize(),
                                            sum(t.nbytes for t in item[0]))
        except _CloseRequested:
            return
        except Exception as e:
            self._err = e
        self._put(None)

    def _read_batch(self, b: int):
        """One batch through a single dataset call (any tuple shape), with
        retry and backoff on transient read errors (OSError); anything else
        fails at once."""
        attempt = 0
        while True:
            try:
                plan = active_chaos()
                if plan is not None:
                    plan.maybe_loader_error(b)
                return self.dataset.get_batch(self.indices[b * self.batch:(b + 1) * self.batch])
            except OSError as e:
                attempt += 1
                if attempt > self.retries:
                    raise
                delay = self.backoff_secs * (2 ** (attempt - 1))
                _log(f"batch {b} read failed ({type(e).__name__}: {e}); retry "
                     f"{attempt}/{self.retries} in {delay:.2f}s")
                if self._stop.wait(delay):
                    raise _CloseRequested() from e

    def _stage_first(self, b: int):
        """A batch through a single dataset call and freshly pinned memory.
        The first batch of a 3-tuple dataset also sizes the canvas pool;
        every batch of any other dataset goes this way (one worker only)."""
        item = self._read_batch(b)
        if len(item) == 3:
            imgs, labels, _extents = item
            for _ in range(2):  # double-buffered canvas pool
                self._free.put(_Canvas(self.batch, imgs.shape[1:], imgs.dtype, labels.dtype,
                                       pin=self._cuda))
            self._pool_built = True
        elif self.workers > 1:
            raise TypeError("multi-worker staging requires the (images, labels, extents) "
                            f"batch protocol; got a {len(item)}-tuple")
        hosts = [torch.from_numpy(np.ascontiguousarray(a)) for a in item]
        if self.trim_h2d and len(item) == 3:
            th, tw = trim_extent(item[0].shape, item[2])
            hosts[0] = hosts[0][:, :th, :tw].contiguous()
        if self._cuda:
            hosts = [h.pin_memory() for h in hosts]
        return self._to_device(b, hosts)

    def _get_canvas(self) -> _Canvas | None:
        """Pop a pooled canvas; None on close()."""
        while not self._stop.is_set():
            try:
                return self._free.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def _stage_pooled(self, b: int, trace_ctx=None):
        """Decode one batch into a pooled canvas (fanned out to the workers,
        or by this thread with one worker), copy it to the device, and
        recycle the canvas once the copy has completed. None when close()
        interrupted the batch."""
        canvas = self._get_canvas()
        if canvas is None:
            return None
        try:
            batch_idx = self.indices[b * self.batch:(b + 1) * self.batch]
            if self.workers == 1:
                self._read_slice_into(b, batch_idx, canvas, 0, self.batch)
            elif not self._fan_out(b, batch_idx, canvas, trace_ctx):
                return None
            imgs = canvas.imgs_t
            if self.trim_h2d:
                th, tw = trim_extent(imgs.shape, canvas.extents)
                if (th, tw) != tuple(imgs.shape[1:3]):
                    imgs = canvas.compact(th, tw)
            item = self._to_device(b, [imgs, canvas.labels_t, canvas.extents_t], copy=True)
            if item[1] is not None:
                # the copy must COMPLETE before the canvas is written again
                item[1].synchronize()
        finally:
            self._free.put(canvas)
        return item

    def _fan_out(self, b: int, batch_idx: np.ndarray, canvas: _Canvas,
                 trace_ctx=None) -> bool:
        """Hand balanced contiguous row ranges to the workers and wait for
        all of them; raise the first worker error; False on close()."""
        collector = _BatchCollector()
        w = self.workers
        for c in range(w):
            lo, hi = self.batch * c // w, self.batch * (c + 1) // w
            self._tasks.put((b, lo, hi, batch_idx[lo:hi], canvas, collector, trace_ctx))
        pending, err = w, None
        while pending:
            try:
                cerr = collector.events.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    return False
                continue
            pending -= 1
            if cerr is not None and err is None:
                err = cerr
        if err is not None:
            raise err
        return True

    def _to_device(self, b: int, hosts: list, copy: bool = False):
        """(device tensors, event of their copy or None). On the CPU the
        tensors are the host ones, copied first where `copy` says the host
        memory is recycled. The `h2d_shard` detail span times the enqueue
        of the copy (on a card the copy itself runs on the side stream)."""
        with self._tracer.span("h2d_shard", cat="input", detail=True, batch=b,
                               rows=f"0:{hosts[0].shape[0]}"):
            if not self._cuda:
                return tuple(h.clone() if copy else h for h in hosts), None
            with torch.cuda.stream(self._stream):
                dev = tuple(h.to(self.device, non_blocking=True) for h in hosts)
                event = torch.cuda.Event()
                event.record(self._stream)
        return dev, event

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def qsize(self) -> int:
        """Ready-queue depth (device batches staged ahead of the consumer)."""
        return self._q.qsize()

    def close(self):
        """Unblock and join the staging threads (a consumer that leaves the
        iterator early MUST call this, or the threads and `depth` staged
        batches stay alive). A worker error the iterator never reached is
        raised here."""
        self._stop.set()
        while not self._q.empty():
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=self._join_timeout)
        for t in self._wthreads:
            t.join(timeout=self._join_timeout)
        if self._thread.is_alive() or any(t.is_alive() for t in self._wthreads):
            _log(f"staging thread still alive {self._join_timeout:.1f}s after close(): a "
                 "dataset read is wedged; leaving the daemon thread(s) behind")
        if self._err is not None and not self._err_delivered:
            self._err_delivered = True
            raise self._err

    def close_quietly(self) -> None:
        """close(), with a pending worker error logged instead of raised: it
        belongs to a batch staged ahead that the consumer never used, and on
        an unwind it must not replace the exception in flight."""
        try:
            self.close()
        except Exception as e:
            _log(f"staged-read error for a batch the consumer never used (stopped early), "
                 f"logged, not raised: {e!r}")

    def __iter__(self) -> Iterator:
        """Pop finished device batches. Time blocked on an empty ready queue
        is booked as a credit stall: the pipeline not keeping up."""
        while True:
            if self._stats is not None and self._q.empty():
                t0 = time.perf_counter()
                item = self._q.get()
                self._stats.note_credit_stall(time.perf_counter() - t0)
            else:
                item = self._q.get()
            if item is None:
                if self._err is not None:
                    self._err_delivered = True
                    raise self._err
                return
            tensors, event = item
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                for t in tensors:  # allocated on the copy stream, used on this one
                    t.record_stream(stream)
            yield tensors

    def __len__(self) -> int:
        return self.num_batches


def epoch_loader(dataset, epoch: int, seed: int, global_batch: int, device,
                 skip_batches: int = 0, retries: int = 3, backoff_secs: float = 0.5,
                 depth: int = 2, workers: int = 1, stats=None,
                 trim_h2d: bool = False, num_processes: int = 1,
                 process_index: int = 0, tracer=None) -> Prefetcher:
    """One epoch of this process's batches on `device`: its contiguous
    slice of every global batch of the epoch's permutation, which depends on
    `(seed, epoch)` alone. `skip_batches` drops the first N global batches
    at the index level (no decode, no copy), to resume mid-epoch;
    `retries`/`backoff_secs` set the transient-read retry policy;
    `depth`/`workers`/`stats`/`trim_h2d` configure the staging (config:
    `prefetch_depth`, `staging_workers`, `h2d_trim`); `tracer` records its
    spans."""
    perm = epoch_permutation(len(dataset), epoch, seed, global_batch)
    local = host_shard(perm, global_batch, num_processes, process_index)
    batch = global_batch // num_processes
    if skip_batches:
        local = local[skip_batches * batch:]
    return Prefetcher(dataset, local, batch, device, depth=depth, retries=retries,
                      backoff_secs=backoff_secs, workers=workers, stats=stats,
                      trim_h2d=trim_h2d, tracer=tracer)


def stage_eval_batch(item, batch: int, device, pad_label: int | None = None):
    """Pad a (possibly short) `(imgs, labels, extents)` host batch to `batch`
    rows and move it to `device` as tensors (labels int64). Padding rows
    are broadcast views of the last row until the one concatenate copy;
    `pad_label` fills the label tail (-1 never matches a prediction), else
    the label tail is left short (the caller keeps `[:valid]`). Shared by
    the kNN encoder and the probe's validation, so their staging cannot
    drift apart."""
    imgs, labels, extents = item
    valid = imgs.shape[0]
    if valid < batch:
        pad = batch - valid
        imgs = np.concatenate([imgs, np.broadcast_to(imgs[-1:], (pad,) + imgs.shape[1:])])
        extents = np.concatenate(
            [extents, np.broadcast_to(extents[-1:], (pad,) + extents.shape[1:])])
        if pad_label is not None:
            labels = np.concatenate([labels, np.full(pad, pad_label, labels.dtype)])
    device = torch.device(device)
    return (torch.from_numpy(np.ascontiguousarray(imgs)).to(device),
            torch.from_numpy(np.asarray(labels, np.int64)).to(device),
            torch.from_numpy(np.ascontiguousarray(extents)).to(device))
