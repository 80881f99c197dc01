"""Wire protocol of the input service (the port's own copy of
`moco_tpu/data/service/protocol.py`; the wire format is the JAX package's,
byte for byte, so either package's client reads either package's server).

One frame = an 8-byte prefix (`!II`: header length, payload length), a
UTF-8 JSON header, and an opaque payload. The header carries the message
`op` plus its small fields; the payload carries raw canvas/extent/label
bytes, so staged image data never round-trips through JSON.

Ops (client -> server):
    hello   first frame of a connection: {"op": "hello", "role":
            "client"|"probe", "credits": N, "proto": 1}. `credits` is the
            flow-control window the client announces (its prefetch depth).
            The server's per-connection serve loop is strictly
            request -> answer (one shard in flight a stream), so the
            client's streams x its ready-queue depth bound how much decoded
            data is ever in flight; the value in the hello is diagnostic.
    shard   {"op": "shard", "batch": b, "epoch": e, "lo": r0, "hi": r1,
            "trace": "tid:sid"?} + payload = the shard's dataset indices as
            little-endian int64. The client computes the epoch permutation
            (resume and rollback skips included) and the server decodes
            exactly the indices it is handed, so the bytes equal in-process
            staging by construction.
    ping    probe liveness: answered with `pong` + the server's stats
            snapshot (an ANSWER is the heartbeat).
    bye     clean connection close.

Ops (server -> client):
    meta    hello answer: canvas geometry, dtypes and dataset length, so the
            client builds its canvases before the first shard and refuses a
            server whose dataset disagrees with its own.
    data    shard answer: header {"batch", "lo", "hi", "shapes", "dtypes"}
            + payload = imgs || extents || labels bytes, in that order.
    pong    ping answer: {"stats": {...}}.
    error   structured failure: {"code": str, "detail": str, "retryable":
            bool}. Retryable errors (a transient read fault, an injected
            `TransientDataError`) re-enter the client's retry budget;
            non-retryable ones (protocol violation, index out of range)
            surface at once.

Pure stdlib: both halves of the staging server and the supervisor's probes
import it; numpy (de)serialization stays with the caller, which hands raw
bytes in and takes raw bytes out.
"""

from __future__ import annotations

import json
import os
import socket
import struct

PROTO_VERSION = 1

# frame prefix: header length, payload length (network byte order)
_PREFIX = struct.Struct("!II")

# sanity bounds: a corrupt or foreign prefix must fail loudly, not allocate
# gigabytes. A 1 GiB payload admits a ~680-row shard of 512x1024 uint8
# canvases; the client chunks its shard requests (client.MAX_SHARD_BYTES,
# 256 MiB), so a data answer never approaches this bound.
MAX_HEADER_BYTES = 1 << 20
MAX_PAYLOAD_BYTES = 1 << 30

OP_HELLO = "hello"
OP_SHARD = "shard"
OP_PING = "ping"
OP_BYE = "bye"
OP_META = "meta"
OP_DATA = "data"
OP_PONG = "pong"
OP_ERROR = "error"

ERR_TRANSIENT = "transient"      # retryable decode/read fault
ERR_PROTOCOL = "protocol"        # malformed frame / credit violation
ERR_BAD_REQUEST = "bad_request"  # out-of-range indices, wrong shapes
ERR_SHUTDOWN = "shutdown"        # server draining: retry elsewhere


class FrameError(ConnectionError):
    """Malformed or out-of-bounds frame; subclasses ConnectionError on
    purpose: the client's retry-on-another-server path treats a peer
    speaking garbage exactly like a peer hanging up mid-frame."""


class RemoteShardError(OSError):
    """A structured `error` frame, surfaced client-side. Subclasses OSError
    so a retryable server-side fault enters the SAME retry-with-backoff path
    as a local flaky read; `retryable=False` errors are re-raised past the
    budget at once."""

    def __init__(self, code: str, detail: str, retryable: bool):
        super().__init__(f"{code}: {detail}")
        self.code = code
        self.detail = detail
        self.retryable = bool(retryable)


def send_frame(sock: socket.socket, header: dict,
               payload=b"") -> None:
    """One frame (header dict -> JSON). `payload` is bytes-like OR a
    sequence of contiguous buffer-protocol chunks (numpy arrays
    included): multi-chunk payloads stream as back-to-back sendalls so
    a 256 MiB shard answer never materializes a concatenated copy; the
    receiver sees one contiguous payload either way."""
    raw = json.dumps(header).encode("utf-8")
    if isinstance(payload, (bytes, bytearray, memoryview)):
        payload = (payload,)
    parts = []
    for chunk in payload:
        view = memoryview(chunk)
        parts.append(view if view.format == "B" and view.ndim == 1
                     else view.cast("B"))
    total = sum(p.nbytes for p in parts)
    if len(raw) > MAX_HEADER_BYTES or total > MAX_PAYLOAD_BYTES:
        raise FrameError(
            f"frame exceeds protocol bounds (header {len(raw)} B, "
            f"payload {total} B)"
        )
    sock.sendall(_PREFIX.pack(len(raw), total) + raw)
    for part in parts:
        if part.nbytes:
            sock.sendall(part)


def _recv_exact(sock: socket.socket, n: int,
                mid_frame: bool = False) -> bytearray:
    """Read exactly n bytes or raise ConnectionError (a torn frame is a
    dead peer as far as the retry machinery is concerned). A
    socket.timeout at a FRAME BOUNDARY (nothing read yet, not `mid_frame`)
    propagates as-is: an idle connection the serve loop keeps. Once any
    byte of a frame is consumed, a timeout means the stream is
    desynchronized and only tearing the connection is safe.

    The bytes land in one buffer allocated up front (`recv_into`), with no
    per-chunk allocation and no joining copy: a 100 MiB shard answer is
    received once, into a writable buffer the caller can view as arrays."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            k = sock.recv_into(view[got:], min(n - got, 1 << 22))
        except socket.timeout:
            if mid_frame or got:
                raise ConnectionError(
                    f"timeout mid-frame ({got}/{n} bytes): "
                    "stream desynchronized"
                ) from None
            raise
        if not k:
            raise ConnectionError(
                f"peer closed mid-frame ({got}/{n} bytes)"
            )
        got += k
    return buf


def recv_frame(sock: socket.socket) -> tuple[dict, bytearray]:
    """(header, payload) of the next frame; ConnectionError on a closed
    peer, FrameError on garbage."""
    prefix = _recv_exact(sock, _PREFIX.size)
    header_len, payload_len = _PREFIX.unpack(prefix)
    if header_len > MAX_HEADER_BYTES or payload_len > MAX_PAYLOAD_BYTES:
        raise FrameError(
            f"frame prefix out of bounds (header {header_len} B, "
            f"payload {payload_len} B): not this protocol"
        )
    try:
        header = json.loads(_recv_exact(sock, header_len,
                                        mid_frame=True).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"unparseable frame header: {e}") from e
    if not isinstance(header, dict) or "op" not in header:
        raise FrameError(f"frame header is not an op dict: {header!r}")
    payload = (_recv_exact(sock, payload_len, mid_frame=True)
               if payload_len else b"")
    return header, payload


def raise_if_error(header: dict) -> None:
    """Surface a structured `error` frame as RemoteShardError."""
    if header.get("op") == OP_ERROR:
        raise RemoteShardError(
            str(header.get("code", "unknown")),
            str(header.get("detail", "")),
            bool(header.get("retryable", False)),
        )


def parse_endpoints(spec: str) -> list[tuple[str, int]]:
    """`"host:port,host:port"` (";" also accepted) -> [(host, port)].
    Loud on malformed entries: a typo'd endpoint that silently vanished
    would turn a two-server deployment into an unnoticed single point of
    failure."""
    endpoints = []
    for part in spec.replace(";", ",").split(","):
        part = part.strip()
        if not part:
            continue
        host, sep, port = part.rpartition(":")
        if not sep or not host:
            raise ValueError(
                f"input-service endpoint {part!r} is not host:port"
            )
        try:
            endpoints.append((host, int(port)))
        except ValueError:
            raise ValueError(
                f"input-service endpoint {part!r} has a non-integer port"
            ) from None
    if not endpoints:
        raise ValueError(f"no endpoints in input-service spec {spec!r}")
    return endpoints


def append_jsonl(path: str, record: dict) -> None:
    """One whole-line O_APPEND write + fsync: the event discipline of the
    per-server events.jsonl. The supervisor half and the decode worker
    (another process) both append to the same file, and whole-line appends
    interleave safely. Shared here (stdlib) so the two halves of one stream
    cannot drift."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(record) + "\n")
        f.flush()
        os.fsync(f.fileno())


def fetch_meta(host: str, port: int, timeout_s: float = 2.0) -> dict | None:
    """One hello round-trip as a probe: the server's meta answer header
    (dataset length `n`, canvas geometry, `prestaged`), or None on any
    failure. The cheap way for a train host to learn the dataset length
    without building, or even mounting, the dataset; drift between
    servers is still caught per connection by the client's meta check."""
    try:
        with socket.create_connection((host, port),
                                      timeout=timeout_s) as sock:
            send_frame(sock, {"op": OP_HELLO, "role": "probe",
                              "proto": PROTO_VERSION})
            header, _ = recv_frame(sock)
            if header.get("op") != OP_META:
                return None
            return header
    except (OSError, FrameError, ValueError):
        return None


def ping(host: str, port: int, timeout_s: float = 2.0) -> dict | None:
    """One probe round-trip: connect, hello(role=probe), ping, read
    pong. Returns the server's stats dict, or None on any failure (the
    caller treats None as a missed heartbeat)."""
    try:
        with socket.create_connection((host, port),
                                      timeout=timeout_s) as sock:
            send_frame(sock, {"op": OP_HELLO, "role": "probe",
                              "proto": PROTO_VERSION})
            header, _ = recv_frame(sock)
            if header.get("op") != OP_META:
                return None
            send_frame(sock, {"op": OP_PING})
            header, _ = recv_frame(sock)
            if header.get("op") != OP_PONG:
                return None
            stats = header.get("stats")
            return stats if isinstance(stats, dict) else {}
    except (OSError, FrameError, ValueError):
        return None
