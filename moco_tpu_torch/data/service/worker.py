"""Decode worker: the numpy half of one staging server (port of
`moco_tpu/data/service/worker.py`).

    python -m moco_tpu_torch.data.service.worker --port 5600 \
        --dataset imagefolder --data-dir /data/imagenet/train

Runs as a SUBPROCESS of `python -m moco_tpu_torch.staging_server` (the
stdlib control plane never imports it: the supervisor half must outlive a
wedged decode runtime, so the split is a process boundary): binds the DATA
port, builds the dataset once with the port's numpy-only data modules
(`data/datasets.py` with ImageFolder's native chunked pool, a `--prestage`
mmap of `data/service/prestage.py`, the decode-once cache of
`data/canvas_cache.py`, synthetic), and serves the frame protocol
(`protocol.py`): each client connection is one thread running
recv(shard) -> decode into a reused scratch -> send(data). It imports no
torch, directly or through a package `__init__`: a decode process does not
pay torch's start-up.

The bytes are in-process staging's by construction: the client ships the
exact dataset indices it would have decoded itself, and the worker runs
the same dataset code over them.

Chaos (`MOCO_TPU_CHAOS` on the server process): `kill_at_shard=N`
self-SIGKILLs before answering the N-th served shard (fire-once across
relaunches via `MOCO_TPU_CHAOS_STATE`); `stall_at_shard=N,stall_ms=M` holds
one answer for M ms. Injected loader faults (`loader_error_at_batch`)
answer retryable `error` frames, which re-enter the client's retry budget.

Telemetry: a `kind: "input_server"` stats record (shard latency p50/p95,
bytes streamed, credit stalls, cache-hit rate) lands in the server's
events.jsonl on a time cadence, `serve_shard` spans continue the client
coordinator's `stage_batch` span ids across the process boundary, and
every `pong` carries the live stats snapshot (the supervisor's /stats).

Exit codes (`resilience/exitcodes.py`): EXIT_STAGING_BIND (50) when the
data port cannot be bound, EXIT_CONFIG_ERROR (45) for a dataset that
cannot be built (a misconfigured data dir), 1 for a read fault on the
probe decode (a restartable crash), 0 after a SIGTERM drain.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time

import numpy as np

from moco_tpu_torch.data.service import protocol
from moco_tpu_torch.data.stats import _percentile
from moco_tpu_torch.resilience.chaos import active_chaos
from moco_tpu_torch.resilience.exitcodes import (
    EXIT_CONFIG_ERROR,
    EXIT_OK,
    EXIT_STAGING_BIND,
)
from moco_tpu_torch.telemetry.trace import Tracer, null_tracer, parse_parent
from moco_tpu_torch.utils.logging import log_event

# rolling shard-latency window (sorted under the stats lock at snapshot
# time; the bound and discipline of data/stats.py)
_LATENCY_WINDOW = 4096


class WorkerStats:
    """Cumulative, thread-safe counters for one worker process. The
    snapshot is the wire/stats schema: consumers (pong answers, the
    periodic `input_server` record, telemetry_report's per-server rows)
    all read the same dict."""

    def __init__(self, server_id: int):
        self._lock = threading.Lock()
        self._created = time.perf_counter()
        self.server_id = server_id
        self.shards = 0
        self.bytes_streamed = 0
        self.errors = 0
        self._shard_s: list[float] = []
        self._decode_s = 0.0
        self._credit_stall_s = 0.0
        self.connections = 0
        self.connections_peak = 0

    def note_shard(self, decode_s: float, total_s: float,
                   nbytes: int) -> None:
        with self._lock:
            self.shards += 1
            self.bytes_streamed += int(nbytes)
            self._decode_s += float(decode_s)
            self._shard_s.append(float(total_s))
            if len(self._shard_s) > 2 * _LATENCY_WINDOW:
                del self._shard_s[:-_LATENCY_WINDOW]

    def note_error(self) -> None:
        with self._lock:
            self.errors += 1

    def note_credit_stall(self, seconds: float) -> None:
        """Server-side credit stall: a connection sat idle between
        answering one shard and receiving the next request — the CLIENT
        held the credit (device-bound pipeline, healthy). Near-zero
        stalls with saturated decode mean the train host is the starved
        side (its own client-side counter is the SLO input)."""
        with self._lock:
            self._credit_stall_s += float(seconds)

    def note_connection(self, delta: int) -> None:
        with self._lock:
            self.connections += delta
            # peak, not the live gauge: the FINAL stats snapshot lands
            # after clients disconnected (connections back at 0), and
            # the report needs the concurrency credit_stall_s actually
            # accumulated across to normalize idle-for-credit
            self.connections_peak = max(self.connections_peak,
                                        self.connections)

    def snapshot(self, dataset=None) -> dict:
        with self._lock:
            wall = max(time.perf_counter() - self._created, 1e-9)
            ordered = sorted(self._shard_s)
            snap = {
                "server_id": self.server_id,
                "shards": self.shards,
                "streamed_mb": round(self.bytes_streamed / 2**20, 1),
                "shard_s_p50": round(_percentile(ordered, 50), 6),
                "shard_s_p95": round(_percentile(ordered, 95), 6),
                "decode_s": round(self._decode_s, 3),
                "credit_stall_s": round(self._credit_stall_s, 3),
                "wall_s": round(wall, 3),
                "errors": self.errors,
                "connections": self.connections,
                "connections_peak": self.connections_peak,
            }
        hits = getattr(dataset, "hits", None)
        misses = getattr(dataset, "misses", None)
        if isinstance(hits, int) and isinstance(misses, int) \
                and hits + misses:
            snap["cache_hit_rate"] = round(hits / (hits + misses), 4)
        # server-side zero-canvas substitutions: the train host's dataset
        # is None under input_service, so its decode_abort_rate guard
        # cannot see these — the stats record/pong is the ONLY channel
        # that makes silent data poisoning visible to an operator
        fails = getattr(dataset, "decode_failures", None)
        total = getattr(dataset, "decode_total", None)
        if isinstance(fails, int) and isinstance(total, int) and total:
            snap["decode_failures"] = fails
            snap["decode_total"] = total
        return snap


class ProbeDecodeError(RuntimeError):
    """The row-0 probe decode at construction hit a read fault. A
    DISTINCT type on purpose: main() maps construction OSErrors to
    EXIT_STAGING_BIND (fatal — the supervisor abandons, reschedule
    beats racing the socket), but a flaky-storage EIO on one probe read
    is the transient class the retry machinery survives everywhere else
    — it must exit as a plain restartable crash, not a give_up."""


class DecodeWorker:
    """The data-port server. `serve_forever()` blocks; `stop()` (any
    thread / signal handler) drains: the listener closes, in-flight
    shards finish, later requests answer `error: shutdown` (retryable —
    the client re-lands them on another server)."""

    def __init__(self, dataset, host: str, port: int, *,
                 server_id: int = 0, telemetry_dir: str = "",
                 stats_every_secs: float = 10.0, tracer=None,
                 prestaged: bool = False):
        self.dataset = dataset
        self.server_id = server_id
        self.telemetry_dir = telemetry_dir
        self.stats_every_secs = float(stats_every_secs)
        self.stats = WorkerStats(server_id)
        self.prestaged = prestaged
        # null-object, never None: span call sites stay branch-free (the
        # Prefetcher pattern)
        self._tracer = tracer if tracer is not None else null_tracer()
        self._stop = threading.Event()
        self._conn_threads: list[threading.Thread] = []
        self._shard_count = 0          # served-shard chaos counter
        self._count_lock = threading.Lock()
        self._last_stats_emit = 0.0
        self._events_path = (
            os.path.join(telemetry_dir, "events.jsonl")
            if telemetry_dir else ""
        )
        # probe one row for the wire meta (also warms the native pool /
        # faults the mmap header pages before the first real shard)
        try:
            imgs, labels, _extents = dataset.get_batch(np.asarray([0]))
        except OSError as e:
            raise ProbeDecodeError(
                f"probe decode of row 0 failed: {type(e).__name__}: {e}"
            ) from e
        self._img_shape = tuple(int(d) for d in imgs.shape[1:])
        self._img_dtype = str(imgs.dtype)
        self._label_dtype = str(np.asarray(labels).dtype)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))   # OSError -> EXIT_STAGING_BIND in main
        self._sock.listen(32)
        self.host, self.port = self._sock.getsockname()[:2]

    # -- wire meta -----------------------------------------------------------
    def _meta(self) -> dict:
        return {
            "op": protocol.OP_META,
            "proto": protocol.PROTO_VERSION,
            "server_id": self.server_id,
            "n": len(self.dataset),
            "img_shape": list(self._img_shape),
            "img_dtype": self._img_dtype,
            "label_dtype": self._label_dtype,
            "prestaged": self.prestaged,
        }

    # -- serving -------------------------------------------------------------
    def serve_forever(self) -> None:
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listener closed under us: stop()
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="staging-conn")
            t.start()
            self._conn_threads.append(t)
            self._conn_threads = [t for t in self._conn_threads
                                  if t.is_alive()]
        self._sock.close()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        deadline = time.monotonic() + timeout_s
        for t in self._conn_threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.05))
        self._emit_stats(final=True)

    def _serve_conn(self, conn: socket.socket) -> None:
        self.stats.note_connection(+1)
        scratch: dict = {}  # per-connection reused decode buffers
        try:
            conn.settimeout(30.0)
            header, _ = protocol.recv_frame(conn)
            if header.get("op") != protocol.OP_HELLO:
                protocol.send_frame(conn, {
                    "op": protocol.OP_ERROR,
                    "code": protocol.ERR_PROTOCOL,
                    "detail": f"expected hello, got {header.get('op')!r}",
                    "retryable": False,
                })
                return
            protocol.send_frame(conn, self._meta())
            # t_wait0 marks when we LAST finished answering: it survives
            # the socket-timeout retries below so a 95 s client pause
            # books 95 s of credit stall, not just the tail < timeout
            t_wait0 = time.perf_counter()
            while not self._stop.is_set():
                try:
                    header, payload = protocol.recv_frame(conn)
                except socket.timeout:
                    continue  # idle probe/client connection: keep it
                # idle gap between requests on a live client connection =
                # the client held the credit (we were NOT the bottleneck)
                if header.get("op") == protocol.OP_SHARD:
                    self.stats.note_credit_stall(
                        time.perf_counter() - t_wait0)
                    self._serve_shard(conn, header, payload, scratch)
                elif header.get("op") == protocol.OP_PING:
                    protocol.send_frame(conn, {
                        "op": protocol.OP_PONG,
                        "stats": self.stats.snapshot(self.dataset),
                    })
                elif header.get("op") == protocol.OP_BYE:
                    return
                else:
                    protocol.send_frame(conn, {
                        "op": protocol.OP_ERROR,
                        "code": protocol.ERR_PROTOCOL,
                        "detail": f"unknown op {header.get('op')!r}",
                        "retryable": False,
                    })
                    return
                t_wait0 = time.perf_counter()  # next wait starts now
        except (ConnectionError, protocol.FrameError, socket.timeout,
                OSError):
            pass  # client went away: its retry machinery owns the story
        finally:
            self.stats.note_connection(-1)
            try:
                conn.close()
            except OSError:
                pass

    def _serve_shard(self, conn, header, payload, scratch) -> None:
        t0 = time.perf_counter()
        with self._count_lock:
            self._shard_count += 1
            n_shard = self._shard_count
        plan = active_chaos()
        try:
            # request parsing INSIDE the try: a malformed header field
            # or a payload that is not a whole number of <i8 indices
            # must answer an error frame, not kill this connection
            # thread with an unclassified traceback
            batch = int(header.get("batch", -1))
            lo = int(header.get("lo", 0))
            hi = int(header.get("hi", 0))
            if len(payload) % 8:
                raise protocol.RemoteShardError(
                    protocol.ERR_BAD_REQUEST,
                    f"shard payload of {len(payload)} bytes is not a "
                    "whole number of <i8 indices",
                    False,
                )
            indices = np.frombuffer(payload, dtype="<i8")
            rows = hi - lo
            if rows <= 0 or len(indices) != rows:
                raise protocol.RemoteShardError(
                    protocol.ERR_BAD_REQUEST,
                    f"shard rows [{lo}:{hi}) vs {len(indices)} indices",
                    False,
                )
            if len(self.dataset) and (
                    int(indices.max(initial=0)) >= len(self.dataset)
                    or int(indices.min(initial=0)) < 0):
                # negative indices would WRAP via numpy fancy indexing —
                # silently-wrong rows, the exact failure bad_request is for
                raise protocol.RemoteShardError(
                    protocol.ERR_BAD_REQUEST,
                    f"index range [{int(indices.min())}, "
                    f"{int(indices.max())}] outside dataset length "
                    f"{len(self.dataset)} — client/server dataset drift",
                    False,
                )
            if self._stop.is_set():
                raise protocol.RemoteShardError(
                    protocol.ERR_SHUTDOWN, "server draining", True)
            imgs, extents, labels, decode_s = self._decode(
                batch, indices, rows, scratch, header)
        except protocol.RemoteShardError as e:
            self.stats.note_error()
            protocol.send_frame(conn, {
                "op": protocol.OP_ERROR, "code": e.code,
                "detail": e.detail, "retryable": e.retryable,
            })
            return
        except OSError as e:
            # transient storage/read fault (incl. chaos TransientDataError):
            # the client's retry-with-backoff budget owns it
            self.stats.note_error()
            protocol.send_frame(conn, {
                "op": protocol.OP_ERROR, "code": protocol.ERR_TRANSIENT,
                "detail": f"{type(e).__name__}: {e}", "retryable": True,
            })
            return
        except (ValueError, TypeError, KeyError, IndexError) as e:
            # garbage request fields or a deterministic decode fault:
            # non-retryable (the same request would fail on every
            # server) — surfaced to the client instead of retried
            # blindly round after round
            self.stats.note_error()
            protocol.send_frame(conn, {
                "op": protocol.OP_ERROR, "code": protocol.ERR_BAD_REQUEST,
                "detail": f"{type(e).__name__}: {e}", "retryable": False,
            })
            return
        if plan is not None:
            # drills fire between decode and answer: the client observes a
            # stalled (then answered) or torn-mid-request connection
            plan.maybe_stall_shard(n_shard)
            plan.maybe_kill_shard(n_shard)
        # multi-chunk payload: the arrays stream straight from the decode
        # scratch, with no imgs+extents+labels concatenation copy on the
        # serving hot path (a 512-canvas shard is ~256 MiB)
        nbytes = imgs.nbytes + extents.nbytes + labels.nbytes
        protocol.send_frame(conn, {
            "op": protocol.OP_DATA, "batch": batch, "lo": lo, "hi": hi,
            "shapes": {"imgs": list(imgs.shape),
                       "extents": list(extents.shape),
                       "labels": list(labels.shape)},
            "dtypes": {"imgs": str(imgs.dtype),
                       "extents": str(extents.dtype),
                       "labels": str(labels.dtype)},
        }, (imgs, extents, labels))
        self.stats.note_shard(decode_s, time.perf_counter() - t0,
                              nbytes)
        self._maybe_emit_stats()

    def _decode(self, batch, indices, rows, scratch, header):
        """Decode `indices` into the connection's reused scratch rows.
        Returns (imgs, extents, labels, decode_seconds)."""
        plan = active_chaos()
        if plan is not None:
            plan.maybe_loader_error(batch)
        t0 = time.perf_counter()
        with self._tracer.span("serve_shard", cat="input",
                               parent=parse_parent(header.get("trace")),
                               batch=batch, rows=rows,
                               server=self.server_id):
            if ("imgs" not in scratch
                    or scratch["imgs"].shape[0] < rows):
                scratch["imgs"] = np.empty(
                    (rows,) + self._img_shape, np.dtype(self._img_dtype))
                scratch["extents"] = np.empty((rows, 3), np.int32)
            imgs = scratch["imgs"][:rows]
            extents = scratch["extents"][:rows]
            if hasattr(self.dataset, "get_batch_into"):
                labels = self.dataset.get_batch_into(indices, imgs,
                                                     extents)
            else:
                b_imgs, labels, b_extents = self.dataset.get_batch(
                    indices)
                imgs[:] = b_imgs
                extents[:] = b_extents
        labels = np.ascontiguousarray(np.asarray(labels))
        return imgs, extents, labels, time.perf_counter() - t0

    # -- telemetry -----------------------------------------------------------
    def _maybe_emit_stats(self) -> None:
        now = time.monotonic()
        if now - self._last_stats_emit < self.stats_every_secs:
            return
        self._last_stats_emit = now
        self._emit_stats()

    def _emit_stats(self, final: bool = False) -> None:
        if not self._events_path:
            return
        record = {
            "v": 1,
            "t": round(time.time(), 3),
            "kind": "input_server", "event": "stats", "final": final,
            # per-life marker: a relaunch changes the pid, so the report
            # detects counter resets exactly instead of heuristically
            "pid": os.getpid(),
        }
        if self._tracer.run_id:
            record["run_id"] = self._tracer.run_id
        record.update(self.stats.snapshot(self.dataset))
        try:
            protocol.append_jsonl(self._events_path, record)
        except OSError as e:
            log_event("input_server",
                      f"stats record write failed (non-fatal): {e}")


def build_worker_dataset(args) -> tuple[object, bool]:
    """(dataset, prestaged?) from the worker argv. `--prestage` wins: a
    hit epoch is then a pure mmap gather. `--cache-mb` wraps a decoding
    dataset in the decode-once canvas LRU, so epochs >= 2 serve at
    memcpy speed even without a prestage."""
    from moco_tpu_torch.data.canvas_cache import CachedDataset
    from moco_tpu_torch.data.datasets import build_dataset
    from moco_tpu_torch.data.service.prestage import PrestagedDataset

    if args.prestage:
        return PrestagedDataset(args.prestage), True
    kw = {}
    if args.dataset.startswith("synthetic"):
        kw["num_samples"] = args.num_samples
        kw["seed"] = args.seed
    if args.dataset == "imagefolder":
        kw["backend"] = args.backend
    dataset = build_dataset(
        args.dataset, data_dir=args.data_dir, image_size=args.image_size,
        stage_size=args.stage_size, num_workers=args.loader_workers, **kw
    )
    if args.cache_mb:
        dataset = CachedDataset(dataset, args.cache_mb)
    return dataset, False


def add_dataset_flags(parser: argparse.ArgumentParser) -> None:
    """Dataset/decode argv shared verbatim by `python -m
    moco_tpu_torch.staging_server` (which forwards them here): one flag
    surface, no drift."""
    parser.add_argument("--dataset", default="synthetic")
    parser.add_argument("--data-dir", default="")
    parser.add_argument("--image-size", type=int, default=32)
    parser.add_argument("--stage-size", type=int, default=0)
    parser.add_argument("--loader-workers", type=int, default=8)
    parser.add_argument("--num-samples", type=int, default=2048,
                        help="synthetic datasets only")
    parser.add_argument("--seed", type=int, default=0,
                        help="synthetic datasets only")
    parser.add_argument("--prestage", default="",
                        help="serve this pre-staged epoch cache instead "
                             "of decoding (python -m "
                             "moco_tpu_torch.data.service.prestage output)")
    parser.add_argument("--cache-mb", type=int, default=0,
                        help="decode-once canvas cache budget (MiB)")
    parser.add_argument("--backend", default="auto", choices=["auto", "native", "pil"],
                        help="imagefolder only: the JPEG decoder (auto: the native "
                             "stager where it builds, else PIL)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="decode worker of one staging server")
    add_dataset_flags(parser)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--server-id", type=int, default=0)
    parser.add_argument("--telemetry-dir", default="")
    parser.add_argument("--stats-every-secs", type=float, default=10.0)
    parser.add_argument("--trace-mode", default="off",
                        choices=["off", "steps", "full"])
    args = parser.parse_args(argv)

    try:
        dataset, prestaged = build_worker_dataset(args)
    except (ValueError, OSError) as e:
        # OSError, not just FileNotFoundError: --data-dir at a file
        # (NotADirectoryError) or unreadable (PermissionError) is the
        # same config class — without the exit code the supervisor
        # relaunch-loops a misconfigured worker through its whole budget
        log_event("input_server", f"cannot build dataset: {e}")
        return EXIT_CONFIG_ERROR

    tracer = None
    if args.telemetry_dir:
        tracer = Tracer(args.telemetry_dir, args.trace_mode,
                        proc=f"staging{args.server_id}")
    try:
        worker = DecodeWorker(
            dataset, args.host, args.port, server_id=args.server_id,
            telemetry_dir=args.telemetry_dir,
            stats_every_secs=args.stats_every_secs, tracer=tracer,
            prestaged=prestaged,
        )
    except ProbeDecodeError as e:
        # transient-class read fault, NOT a bind: exit as a plain crash
        # so the supervisor restarts within its budget instead of the
        # fatal staging_bind give_up
        log_event("input_server", str(e))
        return 1
    except OSError as e:
        log_event("input_server",
                  f"cannot bind {args.host}:{args.port}: {e}")
        return EXIT_STAGING_BIND

    import signal as _signal

    def _drain(signum, frame):
        worker.stop()

    _signal.signal(_signal.SIGTERM, _drain)
    log_event(
        "input_server",
        f"serving shards on {worker.host}:{worker.port} "
        f"(server {args.server_id}, {len(dataset)} samples, "
        f"{'prestaged' if prestaged else args.dataset})",
    )
    worker.serve_forever()
    if tracer is not None:
        tracer.close()
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
