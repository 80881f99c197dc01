"""ServiceClient: the train-host side of the input service (port of
`moco_tpu/data/service/client.py`).

A subclass of the port's `data/loader.py::Prefetcher`: the coordinator,
the pinned canvas pool, the H2D copy on a side stream, the ready queue, the
close semantics and the iterator of device tensors are all inherited. The
ONLY thing that changes is where canvas rows come from: instead of decoding
locally, each sub-slice is fetched from a staging server over the frame
protocol (`protocol.py`), by overriding `_read_batch` and
`_read_slice_into`. Because the client ships the exact dataset indices it
would have decoded itself and the server runs the same dataset code,
service-fed batches equal in-process staging's bit for bit on the same
seed and epoch, per rank of a process group too.

Flow control: the ready queue (`prefetch_depth` device batches) and the
double-buffered canvas pool bound how many batches are ever in flight; the
shard REQUESTS are the credits, announced in the hello frame, so a server
never decodes ahead of what the train host asked for. Time the consumer
spends blocked on an empty ready queue is booked as `credit_stall_s` in
`InputPipelineStats`.

Failure contract: a retryable server error (a transient read fault, an
injected `TransientDataError`) or a dead, torn or stalled connection (a
link is torn down at `request_timeout_s`) retries the SAME shard on ANOTHER
server at once; once every server has failed an attempt, exponential
backoff runs between further rounds, up to the loader's `retries` budget.
Batches are never reordered or duplicated: a retry lands the same rows in
the same canvas slice. Unreachable or drifted servers raise
`ServiceConfigError`; the client never decodes in-process instead.
"""

from __future__ import annotations

import itertools
import socket
import threading
import time

import numpy as np

from moco_tpu_torch.data.loader import (
    Prefetcher,
    _CloseRequested,
    epoch_permutation,
    host_shard,
)
from moco_tpu_torch.data.service import protocol
from moco_tpu_torch.resilience.chaos import active_chaos
from moco_tpu_torch.utils.logging import log_event


class ServiceConfigError(ValueError):
    """Client/server configuration drift (dataset length or canvas
    geometry disagreement) or no reachable server at construction: loud,
    at once. A mis-pointed service must fail where it was configured, not
    as silently wrong training data."""


# One shard request never asks for more than this many payload bytes:
# comfortably under protocol.MAX_PAYLOAD_BYTES (1 GiB), so a data answer can
# never trip the frame bound. At a 512x1024x3 uint8 canvas (1.5 MiB a row)
# this is ~170 rows a shard; the whole-batch shape-discovery fetch chunks
# instead of dying.
MAX_SHARD_BYTES = 256 << 20


class _Link:
    """One per-(thread, endpoint) connection. Thread-confined: the
    owning worker thread is the only user, so no lock."""

    __slots__ = ("sock", "meta")

    def __init__(self, sock: socket.socket, meta: dict):
        self.sock = sock
        self.meta = meta


class ServiceClient(Prefetcher):
    """Iterate device batches staged by remote servers.

    `endpoints` is `[(host, port), ...]` data-port addresses (or the
    `"host:port,host:port"` string form); `indices` this process's dataset
    indices, `batch_per_host` rows a batch, `device` where the batches go
    (the Prefetcher's). `streams` is the number of concurrent fetch
    threads (the in-flight shard window: the `staging_workers` knob);
    `request_timeout_s` bounds one shard round trip before the client
    gives up on that server and asks another."""

    def __init__(self, endpoints, indices: np.ndarray,
                 batch_per_host: int, device, *, depth: int = 2,
                 retries: int = 3, backoff_secs: float = 0.5,
                 join_timeout: float = 5.0, streams: int = 4,
                 stats=None, tracer=None, request_timeout_s: float = 30.0,
                 connect_timeout_s: float = 5.0,
                 expected_len: int | None = None,
                 max_shard_rows: int | None = None):
        if isinstance(endpoints, str):
            endpoints = protocol.parse_endpoints(endpoints)
        self.endpoints = [(str(h), int(p)) for h, p in endpoints]
        if not self.endpoints:
            raise ServiceConfigError("ServiceClient needs >= 1 endpoint")
        self._request_timeout_s = float(request_timeout_s)
        self._connect_timeout_s = float(connect_timeout_s)
        self._credits = max(int(depth), 1)
        self._tls = threading.local()
        self._socks_lock = threading.Lock()
        self._open_socks: set = set()
        self._rr = itertools.count()
        self.meta = self._handshake_meta(expected_len)
        # per-shard row cap from the wire geometry: one data answer is
        # imgs + extents + labels bytes per row, and must stay under the
        # frame payload bound regardless of batch size
        row_bytes = (
            int(np.prod(self.meta["img_shape"]))
            * np.dtype(self.meta["img_dtype"]).itemsize
            + 3 * np.dtype(np.int32).itemsize
            + np.dtype(self.meta["label_dtype"]).itemsize
        )
        self._max_shard_rows = int(max_shard_rows) if max_shard_rows \
            else max(1, MAX_SHARD_BYTES // max(row_bytes, 1))
        try:
            super().__init__(
                None, indices, batch_per_host, device, depth=depth,
                retries=retries, backoff_secs=backoff_secs,
                join_timeout=join_timeout, workers=streams, stats=stats,
                trim_h2d=False, tracer=tracer,
            )
        except BaseException:
            # construction failed AFTER the handshake: close() will
            # never run, so release the handshake socket here or it
            # (and the server's conn thread) outlives the refused client
            self._close_all_socks()
            raise

    # -- construction-time validation ---------------------------------------
    def _handshake_meta(self, expected_len: int | None) -> dict:
        """First reachable server's meta (dataset length, canvas
        geometry). Every endpoint is tried once; total unreachability is
        a configuration error, not a transient."""
        errors = []
        for host, port in self.endpoints:
            try:
                sock = self._connect(host, port)
            except (OSError, protocol.FrameError,
                    ServiceConfigError) as e:
                errors.append(f"{host}:{port}: {e}")
                continue
            meta = self._link_of(sock).meta
            if expected_len is not None and meta["n"] != expected_len:
                # __init__ aborts here, so close() never runs: release
                # the handshake socket now or it (and the server's conn
                # thread) outlives the refused client
                self._drop_link((host, port))
                raise ServiceConfigError(
                    f"staging server {host}:{port} serves {meta['n']} "
                    f"samples but this run's dataset has {expected_len} "
                    "— client and server must be pointed at the same "
                    "data"
                )
            return meta
        raise ServiceConfigError(
            "no staging server reachable: " + "; ".join(errors)
        )

    # -- connections ---------------------------------------------------------
    def _connect(self, host: str, port: int) -> socket.socket:
        sock = socket.create_connection(
            (host, port), timeout=self._connect_timeout_s)
        try:
            sock.settimeout(self._request_timeout_s)
            protocol.send_frame(sock, {
                "op": protocol.OP_HELLO, "role": "client",
                "credits": self._credits,
                "proto": protocol.PROTO_VERSION,
            })
            header, _ = protocol.recv_frame(sock)
            protocol.raise_if_error(header)
            if header.get("op") != protocol.OP_META:
                raise protocol.FrameError(
                    f"expected meta, got {header.get('op')!r}")
        except BaseException:
            sock.close()
            raise
        links = getattr(self._tls, "links", None)
        if links is None:
            links = self._tls.links = {}
        link = _Link(sock, {
            "n": int(header.get("n", 0)),
            "img_shape": tuple(header.get("img_shape", ())),
            "img_dtype": str(header.get("img_dtype", "uint8")),
            "label_dtype": str(header.get("label_dtype", "int32")),
            "server_id": header.get("server_id"),
            "prestaged": bool(header.get("prestaged", False)),
        })
        links[(host, port)] = link
        with self._socks_lock:
            self._open_socks.add(sock)
        # EVERY server must agree with the handshake meta, not just the
        # first reachable one: a same-length-different-data server would
        # otherwise silently serve wrong rows into the round-robin
        expected = getattr(self, "meta", None)
        if expected is not None:
            for key in ("n", "img_shape", "img_dtype", "label_dtype"):
                if link.meta[key] != expected[key]:
                    self._drop_link((host, port))
                    raise ServiceConfigError(
                        f"staging server {host}:{port} disagrees on "
                        f"{key} ({link.meta[key]!r} vs "
                        f"{expected[key]!r}) — all servers must serve "
                        "the same dataset/geometry"
                    )
        return sock

    def _link_of(self, sock: socket.socket) -> _Link:
        for link in getattr(self._tls, "links", {}).values():
            if link.sock is sock:
                return link
        raise KeyError("socket has no link (internal)")

    def _get_link(self, endpoint) -> _Link:
        links = getattr(self._tls, "links", None)
        if links is None:
            links = self._tls.links = {}
        link = links.get(endpoint)
        if link is None:
            self._connect(*endpoint)
            link = links[endpoint]
        return link

    def _drop_link(self, endpoint) -> None:
        links = getattr(self._tls, "links", None)
        link = links.pop(endpoint, None) if links else None
        if link is not None:
            with self._socks_lock:
                self._open_socks.discard(link.sock)
            try:
                link.sock.close()
            except OSError:
                pass

    # -- the remote fetch ----------------------------------------------------
    def _fetch_once(self, endpoint, b: int, lo: int, hi: int,
                    idx: np.ndarray, trace_ctx) -> tuple:
        """One shard round-trip against one server. Raises
        ConnectionError/timeout/RemoteShardError on failure; the caller
        owns retry placement."""
        link = self._get_link(endpoint)
        header = {"op": protocol.OP_SHARD, "batch": int(b),
                  "lo": int(lo), "hi": int(hi)}
        if trace_ctx:
            # the server's serve_shard span continues the coordinator's
            # stage_batch / decode_slice parent across the process edge
            header["trace"] = f"{trace_ctx[0]}:{trace_ctx[1]}"
        payload = np.ascontiguousarray(idx, dtype="<i8").tobytes()
        try:
            protocol.send_frame(link.sock, header, payload)
            answer, data = protocol.recv_frame(link.sock)
        except (ConnectionError, socket.timeout, OSError):
            self._drop_link(endpoint)
            raise
        protocol.raise_if_error(answer)
        if answer.get("op") != protocol.OP_DATA:
            self._drop_link(endpoint)
            raise protocol.FrameError(
                f"expected data, got {answer.get('op')!r}")
        try:
            shapes = answer["shapes"]
            dtypes = answer["dtypes"]
            n_img = int(np.prod(shapes["imgs"])) * np.dtype(
                dtypes["imgs"]).itemsize
            n_ext = int(np.prod(shapes["extents"])) * np.dtype(
                dtypes["extents"]).itemsize
            imgs = np.frombuffer(data, dtype=dtypes["imgs"],
                                 count=int(np.prod(shapes["imgs"]))
                                 ).reshape(shapes["imgs"])
            extents = np.frombuffer(
                data[n_img:], dtype=dtypes["extents"],
                count=int(np.prod(shapes["extents"]))
            ).reshape(shapes["extents"])
            labels = np.frombuffer(data[n_img + n_ext:],
                                   dtype=dtypes["labels"],
                                   count=int(np.prod(shapes["labels"])))
        except (KeyError, ValueError, TypeError) as e:
            # a malformed data answer (missing/garbage shapes or dtypes,
            # payload shorter than they imply) is a peer speaking
            # garbage: the same retry-on-another-server class as a torn
            # frame, and the link may be desynced — drop it
            self._drop_link(endpoint)
            raise protocol.FrameError(
                f"malformed data answer: {type(e).__name__}: {e}") from e
        if imgs.shape[0] != len(idx) or len(labels) != len(idx):
            self._drop_link(endpoint)
            raise protocol.FrameError(
                f"server answered {imgs.shape[0]} rows / "
                f"{len(labels)} labels for a {len(idx)}-row shard")
        return imgs, labels, extents

    def _fetch_rows(self, b: int, lo: int, hi: int, idx: np.ndarray,
                    trace_ctx=None) -> tuple:
        """Fetch rows with the retry contract: immediate
        retry-on-another-server per failure; exponential backoff only
        once a whole round of servers has failed; `retries` bounds the
        ROUNDS (matching the in-process per-sub-slice budget)."""
        plan = active_chaos()
        n = len(self.endpoints)
        round_no = 0
        last: BaseException | None = None
        start = next(self._rr)
        while True:
            for j in range(n):
                endpoint = self.endpoints[(start + j) % n]
                t0 = time.perf_counter()
                try:
                    # chaos polls INSIDE the retried region, exactly like
                    # Prefetcher._read_slice_into: an injected
                    # TransientDataError (an OSError) re-enters this
                    # attempt's budget instead of crossing the contract
                    if plan is not None:
                        plan.maybe_loader_error(b)
                    out = self._fetch_once(endpoint, b, lo, hi, idx,
                                           trace_ctx)
                    if self._stats is not None:
                        self._stats.note_worker_busy(
                            time.perf_counter() - t0)
                    return out
                except protocol.RemoteShardError as e:
                    if not e.retryable:
                        raise
                    last = e
                except (ConnectionError, socket.timeout, OSError) as e:
                    last = e
                if self._stats is not None:
                    self._stats.note_worker_busy(
                        time.perf_counter() - t0)
                log_event(
                    "loader",
                    f"shard batch {b} rows [{lo}:{hi}) failed on "
                    f"{endpoint[0]}:{endpoint[1]} "
                    f"({type(last).__name__}: {last}); trying another "
                    "server",
                )
            round_no += 1
            if round_no > self.retries:
                raise last if last is not None else ConnectionError(
                    "shard fetch failed with no recorded error")
            delay = self.backoff_secs * (2 ** (round_no - 1))
            log_event(
                "loader",
                f"all {n} staging server(s) failed batch {b} rows "
                f"[{lo}:{hi}); retry round {round_no}/{self.retries} "
                f"in {delay:.2f}s",
            )
            if self._stop.wait(delay):
                raise _CloseRequested() from last

    # -- Prefetcher overrides ------------------------------------------------
    def _read_batch(self, b: int):
        """Whole-batch fetch (the shape-discovery first batch), chunked to
        `_max_shard_rows` so a large per-process batch (1024 rows at the
        512 canvas is ~1.5 GiB) never builds a data answer past the frame
        payload bound."""
        idx = self.indices[b * self.batch: (b + 1) * self.batch]
        ctx = self._tracer.current_context()
        parts = []
        for lo in range(0, len(idx), self._max_shard_rows):
            hi = min(lo + self._max_shard_rows, len(idx))
            parts.append(self._fetch_rows(b, lo, hi, idx[lo:hi],
                                          trace_ctx=ctx))
        if len(parts) == 1:
            return parts[0]
        return tuple(np.concatenate([p[k] for p in parts]) for k in range(3))

    def _read_slice_into(self, b, idx, canvas, lo, hi, trace_ctx=None):
        """Fetch canvas rows [lo, hi) (chunked as `_read_batch` is); the
        server's `serve_shard` spans continue `trace_ctx`, else this
        thread's current span."""
        if trace_ctx is None:
            trace_ctx = self._tracer.current_context()
        for off in range(0, hi - lo, self._max_shard_rows):
            c_lo = lo + off
            c_hi = min(c_lo + self._max_shard_rows, hi)
            imgs, labels, extents = self._fetch_rows(
                b, c_lo, c_hi, idx[off:off + (c_hi - c_lo)],
                trace_ctx=trace_ctx)
            canvas.imgs[c_lo:c_hi] = imgs
            canvas.labels[c_lo:c_hi] = labels
            canvas.extents[c_lo:c_hi] = extents

    def _close_all_socks(self) -> None:
        with self._socks_lock:
            socks, self._open_socks = list(self._open_socks), set()
        for sock in socks:
            try:
                sock.close()
            except OSError:
                pass

    def close(self):
        # sockets first: a fetch thread blocked in recv (up to
        # request_timeout_s) cannot observe _stop, so joining before
        # closing would stall close() by join_timeout per thread and log
        # a spurious wedged-read incident. _stop gates new fetch rounds;
        # a thread mid-retry may reconnect once, so sweep again after.
        self._stop.set()
        self._close_all_socks()
        try:
            super().close()
        finally:
            self._close_all_socks()


def service_epoch_loader(
    endpoints, dataset_len: int, epoch: int, seed: int,
    global_batch: int, device, skip_batches: int = 0, retries: int = 3,
    backoff_secs: float = 0.5, depth: int = 2, streams: int = 4,
    stats=None, tracer=None, request_timeout_s: float = 30.0,
    num_processes: int = 1, process_index: int = 0,
) -> ServiceClient:
    """`epoch_loader`'s service twin: the SAME deterministic epoch
    permutation, per-process shard (`num_processes`, `process_index`, as
    `epoch_loader` takes them) and resume skip, computed client-side so
    every resume and rollback path works unchanged, feeding a
    ServiceClient instead of local decode. The servers are held against
    `dataset_len` at construction (the config-drift guard)."""
    perm = epoch_permutation(dataset_len, epoch, seed, global_batch)
    local = host_shard(perm, global_batch, num_processes, process_index)
    per_process = global_batch // num_processes
    if skip_batches:
        local = local[skip_batches * per_process:]
    return ServiceClient(
        endpoints, local, per_process, device, depth=depth, retries=retries,
        backoff_secs=backoff_secs, streams=streams, stats=stats,
        tracer=tracer, request_timeout_s=request_timeout_s,
        expected_len=dataset_len,
    )
