"""The port's input service (`moco_tpu_torch/data/service/`), in-thread:
the port's copies of the JAX package's gates (`tests/test_input_service.py`).

- protocol: frame round trips, bounds and garbage, endpoints, structured
  remote errors;
- `ServiceClient` against the port's in-process `epoch_loader`: the same
  batches bit for bit (two servers, a prestage, chunked shards, each rank
  of two with a resume skip);
- the failure contract: retry on another server for a peer that hangs up,
  answers garbage or an injected transient; non-retryable errors surface at
  once; unreachable and drifted servers raise `ServiceConfigError`;
- the config knobs; the shard chaos hooks fire once across processes; the
  worker's exit codes (50, 45, a plain crash); the meta-probe length; the
  worker's `serve_shard` spans continue the client's trace.

Each decode worker here runs on a thread of this process (real sockets,
real frames); `tests/test_torch_input_service_drills.py` runs real server
processes. Every comparison is bit for bit.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time

import numpy as np
import pytest

from moco_tpu_torch.config import PretrainConfig
from moco_tpu_torch.data.datasets import SyntheticDataset
from moco_tpu_torch.data.loader import epoch_loader, epoch_permutation, host_shard
from moco_tpu_torch.data.service import protocol
from moco_tpu_torch.data.service.client import ServiceClient, ServiceConfigError, \
    service_epoch_loader
from moco_tpu_torch.data.service.prestage import PrestagedDataset, write_prestage
from moco_tpu_torch.data.service.worker import DecodeWorker, ProbeDecodeError, WorkerStats
from moco_tpu_torch.data.service.worker import main as worker_main
from moco_tpu_torch.resilience.chaos import ChaosPlan, chaos_context, parse_chaos_spec
from moco_tpu_torch.resilience.exitcodes import EXIT_CONFIG_ERROR, EXIT_STAGING_BIND

N_SAMPLES = 64
GLOBAL_BATCH = 16  # 4 batches an epoch


def _dataset(**kw):
    kw.setdefault("num_samples", N_SAMPLES)
    kw.setdefault("image_size", 32)
    kw.setdefault("seed", 0)
    return SyntheticDataset(**kw)


def _start_worker(dataset, **kw):
    """One in-thread DecodeWorker on an auto port."""
    worker = DecodeWorker(dataset, "127.0.0.1", 0, **kw)
    threading.Thread(target=worker.serve_forever, daemon=True, name="test-worker").start()
    return worker


def _drain(loader):
    """[(imgs, labels, extents) as numpy] of every batch."""
    return [tuple(np.array(t) for t in batch) for batch in loader]


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _reference_epoch(epoch=1, dataset=None, **kw):
    loader = epoch_loader(dataset if dataset is not None else _dataset(), epoch, 0,
                          GLOBAL_BATCH, "cpu", workers=2, **kw)
    try:
        return _drain(loader)
    finally:
        loader.close_quietly()


def _listener():
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.bind(("127.0.0.1", 0))
    sock.listen(8)
    sock.settimeout(0.1)
    return sock


def _serve_in_threads(lsock, stop, handle):
    def _serve():
        while not stop.is_set():
            try:
                conn, _ = lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=handle, args=(conn,), daemon=True).start()

    threading.Thread(target=_serve, daemon=True).start()


META = {"op": protocol.OP_META, "n": N_SAMPLES, "img_shape": [32, 32, 3],
        "img_dtype": "uint8", "label_dtype": "int32", "server_id": 7}


# ---------------------------------------------------------------------------
# protocol
# ---------------------------------------------------------------------------


def test_frame_roundtrip_over_socketpair():
    a, b = socket.socketpair()
    try:
        payload = np.arange(16, dtype="<i8").tobytes()
        protocol.send_frame(a, {"op": "shard", "batch": 3}, payload)
        header, got = protocol.recv_frame(b)
        assert header == {"op": "shard", "batch": 3} and got == payload
        protocol.send_frame(b, {"op": "pong", "stats": {}})
        header, got = protocol.recv_frame(a)
        assert header["op"] == "pong" and got == b""
        # a multi-chunk payload arrives as one contiguous payload
        parts = (np.ones((2, 3), np.uint8), np.arange(4, dtype=np.int32))
        protocol.send_frame(a, {"op": "data"}, parts)
        _, got = protocol.recv_frame(b)
        assert got == parts[0].tobytes() + parts[1].tobytes()
    finally:
        a.close()
        b.close()


def test_frame_bytes_are_the_reference_wire_format():
    """The prefix `!II` (header length, payload length), the JSON header,
    the payload: byte for byte what the JAX package's `send_frame` writes."""
    from moco_tpu.data.service import protocol as jax_protocol

    frames = []
    for mod in (protocol, jax_protocol):
        a, b = socket.socketpair()
        try:
            mod.send_frame(a, {"op": "shard", "batch": 2, "lo": 0, "hi": 3},
                           np.arange(3, dtype="<i8"))
            a.close()
            data = b""
            while chunk := b.recv(4096):
                data += chunk
            frames.append(data)
        finally:
            b.close()
    assert frames[0] == frames[1]
    assert frames[0][:8] == (len(b'{"op": "shard", "batch": 2, "lo": 0, "hi": 3}')).to_bytes(
        4, "big") + (24).to_bytes(4, "big")
    assert (protocol.PROTO_VERSION, protocol.MAX_HEADER_BYTES, protocol.MAX_PAYLOAD_BYTES) == (
        jax_protocol.PROTO_VERSION, jax_protocol.MAX_HEADER_BYTES,
        jax_protocol.MAX_PAYLOAD_BYTES)


def test_frame_bounds_and_garbage_rejected():
    a, b = socket.socketpair()
    try:
        with pytest.raises(protocol.FrameError, match="bounds"):
            protocol.send_frame(a, {"op": "x"}, b"\0" * (protocol.MAX_PAYLOAD_BYTES + 1))
        a.sendall(b"\xff\xff\xff\xff\xff\xff\xff\xff")
        with pytest.raises(protocol.FrameError, match="not this protocol"):
            protocol.recv_frame(b)
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    try:  # a header that is not an op dict
        raw = b"[1, 2]"
        a.sendall(len(raw).to_bytes(4, "big") + (0).to_bytes(4, "big") + raw)
        with pytest.raises(protocol.FrameError, match="not an op dict"):
            protocol.recv_frame(b)
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    try:  # a peer hanging up mid-frame is a ConnectionError (retry food)
        a.sendall(b"\x00\x00\x00\x08")
        a.close()
        with pytest.raises(ConnectionError):
            protocol.recv_frame(b)
    finally:
        b.close()


def test_parse_endpoints_forms_and_errors():
    assert protocol.parse_endpoints("h1:1, h2:2;h3:3,") == [("h1", 1), ("h2", 2), ("h3", 3)]
    with pytest.raises(ValueError, match="not host:port"):
        protocol.parse_endpoints("just-a-host")
    with pytest.raises(ValueError, match="non-integer port"):
        protocol.parse_endpoints("h:eighty")
    with pytest.raises(ValueError, match="no endpoints"):
        protocol.parse_endpoints(" , ")


def test_raise_if_error_surfaces_remote_shard_error():
    with pytest.raises(protocol.RemoteShardError) as exc:
        protocol.raise_if_error({"op": "error", "code": "transient", "detail": "flaky read",
                                 "retryable": True})
    assert exc.value.retryable and exc.value.code == "transient"
    assert isinstance(exc.value, OSError)
    protocol.raise_if_error({"op": "data"})


def test_append_jsonl_and_probes(tmp_path):
    path = str(tmp_path / "sub" / "events.jsonl")
    protocol.append_jsonl(path, {"a": 1})
    protocol.append_jsonl(path, {"b": 2})
    with open(path, encoding="utf-8") as f:
        assert [json.loads(line) for line in f] == [{"a": 1}, {"b": 2}]
    worker = _start_worker(_dataset())
    try:
        meta = protocol.fetch_meta(worker.host, worker.port)
        assert meta["n"] == N_SAMPLES and meta["img_shape"] == [32, 32, 3]
        assert protocol.ping(worker.host, worker.port)["server_id"] == 0
    finally:
        worker.stop(timeout_s=1.0)
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead_port = probe.getsockname()[1]
    probe.close()  # bound, then closed: the connection is refused
    assert protocol.fetch_meta("127.0.0.1", dead_port, timeout_s=0.5) is None
    assert protocol.ping("127.0.0.1", dead_port, timeout_s=0.5) is None


# ---------------------------------------------------------------------------
# the service's batches are the in-process loader's
# ---------------------------------------------------------------------------


def test_service_equals_inprocess_loader_bit_for_bit():
    want = _reference_epoch()
    w1, w2 = _start_worker(_dataset()), _start_worker(_dataset())
    client = None
    try:
        client = service_epoch_loader([(w1.host, w1.port), (w2.host, w2.port)], N_SAMPLES, 1,
                                      0, GLOBAL_BATCH, "cpu", streams=2, backoff_secs=0.05)
        assert len(client) == 4
        got = _drain(client)
    finally:
        if client is not None:
            client.close_quietly()
        w1.stop(timeout_s=1.0)
        w2.stop(timeout_s=1.0)
    _assert_batches_equal(got, want)
    assert w1.stats.shards >= 1 and w2.stats.shards >= 1  # streams round-robin


@pytest.mark.parametrize("world, rank, skip", [(1, 0, 2), (2, 0, 1), (2, 1, 1)])
def test_service_equals_inprocess_loader_per_rank_with_skip(world, rank, skip):
    """Each rank's client fetches its own shard of the same permutation,
    with the same resume skip, as `epoch_loader` stages it."""
    want = _reference_epoch(skip_batches=skip, num_processes=world, process_index=rank)
    worker = _start_worker(_dataset())
    client = None
    try:
        client = service_epoch_loader(f"{worker.host}:{worker.port}", N_SAMPLES, 1, 0,
                                      GLOBAL_BATCH, "cpu", skip_batches=skip, streams=2,
                                      num_processes=world, process_index=rank)
        got = _drain(client)
    finally:
        if client is not None:
            client.close_quietly()
        worker.stop(timeout_s=1.0)
    _assert_batches_equal(got, want)
    assert len(got) == 4 - skip and got[0][0].shape[0] == GLOBAL_BATCH // world


def test_service_equals_inprocess_loader_from_prestage(tmp_path):
    want = _reference_epoch()
    root = str(tmp_path / "pre")
    write_prestage(_dataset(), root)
    worker = _start_worker(PrestagedDataset(root), prestaged=True)
    client = None
    try:
        client = service_epoch_loader(f"{worker.host}:{worker.port}", N_SAMPLES, 1, 0,
                                      GLOBAL_BATCH, "cpu", streams=2)
        assert client.meta["prestaged"] is True
        got = _drain(client)
    finally:
        if client is not None:
            client.close_quietly()
        worker.stop(timeout_s=1.0)
    _assert_batches_equal(got, want)


def test_chunked_shards_equal_inprocess_loader():
    """A forced 3-row cap chunks every fetch, the whole-batch first fetch
    included; the epoch is still the in-process one."""
    want = _reference_epoch()
    indices = host_shard(epoch_permutation(N_SAMPLES, 1, 0, GLOBAL_BATCH), GLOBAL_BATCH)
    worker = _start_worker(_dataset())
    client = None
    try:
        client = ServiceClient([(worker.host, worker.port)], indices, GLOBAL_BATCH, "cpu",
                               streams=2, max_shard_rows=3)
        got = _drain(client)
    finally:
        if client is not None:
            client.close_quietly()
        worker.stop(timeout_s=1.0)
    _assert_batches_equal(got, want)
    assert worker.stats.shards >= 4 * 6


# ---------------------------------------------------------------------------
# the failure contract
# ---------------------------------------------------------------------------


def test_client_retries_shards_on_another_server():
    """A peer that accepts and hangs up at once: every shard offered to it
    lands on the healthy server, the epoch complete and the same bits."""
    want = _reference_epoch()
    stop = threading.Event()
    refuser = _listener()
    _serve_in_threads(refuser, stop, lambda conn: conn.close())
    worker = _start_worker(_dataset())
    client = None
    try:
        client = service_epoch_loader([refuser.getsockname(), (worker.host, worker.port)],
                                      N_SAMPLES, 1, 0, GLOBAL_BATCH, "cpu", streams=2,
                                      backoff_secs=0.05)
        got = _drain(client)
    finally:
        if client is not None:
            client.close_quietly()
        worker.stop(timeout_s=1.0)
        stop.set()
        refuser.close()
    _assert_batches_equal(got, want)
    assert worker.stats.shards >= 4


def test_client_retries_a_timed_out_server_elsewhere():
    """A server that answers the hello and then never the shard: the link is
    torn down at `request_timeout_s` and the shard asked of another server."""
    want = _reference_epoch()
    stop = threading.Event()
    lsock = _listener()

    def _silent(conn):
        try:
            conn.settimeout(10.0)
            header, _ = protocol.recv_frame(conn)
            if header.get("op") == protocol.OP_HELLO:
                protocol.send_frame(conn, META)
            stop.wait(10.0)
        except (ConnectionError, protocol.FrameError, OSError):
            pass
        finally:
            conn.close()

    _serve_in_threads(lsock, stop, _silent)
    worker = _start_worker(_dataset())
    client = None
    try:
        t0 = time.monotonic()
        client = service_epoch_loader([lsock.getsockname(), (worker.host, worker.port)],
                                      N_SAMPLES, 1, 0, GLOBAL_BATCH, "cpu", streams=2,
                                      backoff_secs=0.05, request_timeout_s=0.5)
        got = _drain(client)
        assert time.monotonic() - t0 < 8.0
    finally:
        if client is not None:
            client.close_quietly()
        worker.stop(timeout_s=1.0)
        stop.set()
        lsock.close()
    _assert_batches_equal(got, want)


def test_client_surfaces_nonretryable_error_immediately():
    """A non-retryable remote error skips the retry budget (50 rounds here)."""
    stop = threading.Event()
    lsock = _listener()

    def _bad_request(conn):
        try:
            conn.settimeout(10.0)
            header, _ = protocol.recv_frame(conn)
            if header.get("op") == protocol.OP_HELLO:
                protocol.send_frame(conn, META)
                header, _ = protocol.recv_frame(conn)
            if header.get("op") == protocol.OP_SHARD:
                protocol.send_frame(conn, {"op": protocol.OP_ERROR,
                                           "code": protocol.ERR_BAD_REQUEST,
                                           "detail": "dataset drift", "retryable": False})
        except (ConnectionError, protocol.FrameError, OSError):
            pass
        finally:
            conn.close()

    _serve_in_threads(lsock, stop, _bad_request)
    client = None
    try:
        t0 = time.monotonic()
        client = ServiceClient([lsock.getsockname()], np.arange(GLOBAL_BATCH), GLOBAL_BATCH,
                               "cpu", retries=50, backoff_secs=0.01, streams=1)
        with pytest.raises(protocol.RemoteShardError, match="drift"):
            _drain(client)
        assert time.monotonic() - t0 < 5.0
    finally:
        if client is not None:
            client.close_quietly()
        stop.set()
        lsock.close()


def test_worker_answers_error_on_garbage_shard_requests():
    """Garbage requests answer non-retryable `bad_request` frames and the
    connection serves the next, well-formed, request."""
    worker = _start_worker(_dataset())
    try:
        with socket.create_connection((worker.host, worker.port), timeout=5.0) as sock:
            protocol.send_frame(sock, {"op": protocol.OP_HELLO, "role": "client",
                                       "proto": protocol.PROTO_VERSION})
            assert protocol.recv_frame(sock)[0]["op"] == protocol.OP_META
            for header, payload in (
                    ({"op": protocol.OP_SHARD, "batch": 0, "lo": 0, "hi": 1}, b"1234567"),
                    ({"op": protocol.OP_SHARD, "batch": 0, "lo": 0, "hi": 2},
                     np.zeros(1, "<i8").tobytes()),
                    ({"op": protocol.OP_SHARD, "batch": 0, "lo": 0, "hi": 1},
                     np.asarray([-1], "<i8").tobytes()),
                    ({"op": protocol.OP_SHARD, "batch": "x", "lo": 0, "hi": 1},
                     np.zeros(1, "<i8").tobytes())):
                protocol.send_frame(sock, header, payload)
                answer, _ = protocol.recv_frame(sock)
                assert answer["op"] == protocol.OP_ERROR, answer
                assert answer["code"] == protocol.ERR_BAD_REQUEST
                assert answer["retryable"] is False
            protocol.send_frame(sock, {"op": protocol.OP_SHARD, "batch": 0, "lo": 0, "hi": 1},
                                np.zeros(1, "<i8").tobytes())
            answer, data = protocol.recv_frame(sock)
            assert answer["op"] == protocol.OP_DATA
            assert len(data) == 32 * 32 * 3 + 3 * 4 + 4
        assert worker.stats.errors == 4
    finally:
        worker.stop(timeout_s=1.0)


def test_client_retries_malformed_data_answer_on_another_server():
    """A well-framed data answer with no shapes is a peer speaking garbage:
    the retry-on-another-server class, not a run-killing KeyError."""
    worker = _start_worker(_dataset())
    stop = threading.Event()
    lsock = _listener()

    def _garbage(conn):
        try:
            conn.settimeout(10.0)
            while True:
                header, _ = protocol.recv_frame(conn)
                if header.get("op") == protocol.OP_HELLO:
                    protocol.send_frame(conn, META)
                elif header.get("op") == protocol.OP_SHARD:
                    protocol.send_frame(conn, {"op": protocol.OP_DATA}, b"")
                else:
                    return
        except (ConnectionError, protocol.FrameError, OSError):
            pass
        finally:
            conn.close()

    _serve_in_threads(lsock, stop, _garbage)
    client = None
    try:
        host, port = lsock.getsockname()
        client = service_epoch_loader(f"{host}:{port},{worker.host}:{worker.port}", N_SAMPLES,
                                      1, 0, GLOBAL_BATCH, "cpu", streams=2, backoff_secs=0.01)
        got = _drain(client)
    finally:
        if client is not None:
            client.close_quietly()
        stop.set()
        lsock.close()
        worker.stop(timeout_s=1.0)
    _assert_batches_equal(got, _reference_epoch())


def test_client_retries_injected_transient_faults():
    """An injected `TransientDataError` inside the fetch re-enters the retry
    budget, as the in-process Prefetcher's does."""
    want = _reference_epoch()
    worker = _start_worker(_dataset())
    client = None
    try:
        with chaos_context(ChaosPlan(loader_error_at_batch=1, loader_error_count=2)) as plan:
            client = service_epoch_loader(f"{worker.host}:{worker.port}", N_SAMPLES, 1, 0,
                                          GLOBAL_BATCH, "cpu", streams=2, retries=3,
                                          backoff_secs=0.01)
            got = _drain(client)
            assert plan._loader_errors_raised == 2
    finally:
        if client is not None:
            client.close_quietly()
        worker.stop(timeout_s=1.0)
    _assert_batches_equal(got, want)


def test_client_refuses_unreachable_and_drifted_servers():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead_port = probe.getsockname()[1]
    probe.close()
    with pytest.raises(ServiceConfigError, match="no staging server"):
        ServiceClient([("127.0.0.1", dead_port)], np.arange(GLOBAL_BATCH), GLOBAL_BATCH, "cpu",
                      connect_timeout_s=0.5)
    worker = _start_worker(_dataset(num_samples=32))
    try:
        with pytest.raises(ServiceConfigError, match="32 samples"):
            ServiceClient([(worker.host, worker.port)], np.arange(GLOBAL_BATCH), GLOBAL_BATCH,
                          "cpu", expected_len=N_SAMPLES)
    finally:
        worker.stop(timeout_s=1.0)
    # EVERY server is held to the handshake's meta: a same-length server
    # with another canvas geometry is refused when a fetch thread meets it
    w_a, w_b = _start_worker(_dataset()), _start_worker(_dataset(image_size=16))
    client = None
    try:
        with pytest.raises(ServiceConfigError, match="disagrees on"):
            client = service_epoch_loader([(w_a.host, w_a.port), (w_b.host, w_b.port)],
                                          N_SAMPLES, 1, 0, GLOBAL_BATCH, "cpu", streams=2)
            _drain(client)
    finally:
        if client is not None:
            client.close_quietly()
        w_a.stop(timeout_s=1.0)
        w_b.stop(timeout_s=1.0)


def test_config_knobs():
    with pytest.raises(ValueError, match="not host:port"):
        PretrainConfig(input_service="garbage")
    with pytest.raises(ValueError, match="mutually exclusive"):
        PretrainConfig(input_service="127.0.0.1:4000", h2d_trim=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        PretrainConfig(input_service="127.0.0.1:4000", input_prestage="/some/prestage")
    for bad in (0, -1.0):
        with pytest.raises(ValueError, match="input_request_timeout_s"):
            PretrainConfig(input_request_timeout_s=bad)
    assert PretrainConfig(input_service="h1:4000,h2:4000").input_service
    assert PretrainConfig().input_service == ""
    assert PretrainConfig().input_request_timeout_s == 30.0


# ---------------------------------------------------------------------------
# chaos, exit codes, telemetry
# ---------------------------------------------------------------------------


def test_chaos_shard_hooks_parse_and_fire_once_across_processes(tmp_path, monkeypatch):
    plan = parse_chaos_spec("kill_at_shard=3,stall_at_shard=2,stall_ms=40")
    assert plan.kill_at_shard == 3 and plan.stall_at_shard == 2
    plan.state_dir = str(tmp_path)
    t0 = time.perf_counter()
    plan.maybe_stall_shard(1)
    plan.maybe_stall_shard(2)
    assert time.perf_counter() - t0 >= 0.04
    assert os.path.exists(tmp_path / "fired_stall_shard")
    relaunched = ChaosPlan(stall_at_shard=2, stall_ms=40, state_dir=str(tmp_path))
    t0 = time.perf_counter()
    relaunched.maybe_stall_shard(2)
    assert time.perf_counter() - t0 < 0.04
    # the kill: one SIGKILL, the marker written before it
    kills = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append((pid, sig)))
    plan.maybe_kill_shard(2)
    plan.maybe_kill_shard(3)
    plan.maybe_kill_shard(3)
    ChaosPlan(kill_at_shard=3, state_dir=str(tmp_path)).maybe_kill_shard(3)
    assert len(kills) == 1 and os.path.exists(tmp_path / "fired_kill_shard")


def test_worker_bind_failure_exits_staging_bind():
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    try:
        rc = worker_main(["--dataset", "synthetic", "--num-samples", "8", "--image-size", "16",
                          "--port", str(blocker.getsockname()[1])])
    finally:
        blocker.close()
    assert rc == EXIT_STAGING_BIND == 50


def test_worker_misconfigured_data_dir_exits_config_error(tmp_path):
    not_a_dir = tmp_path / "data"
    not_a_dir.write_text("not a directory")
    rc = worker_main(["--dataset", "imagefolder", "--data-dir", str(not_a_dir / "train")])
    assert rc == EXIT_CONFIG_ERROR == 45


def test_probe_decode_fault_is_a_plain_crash():
    class _FlakyProbe:
        def __len__(self):
            return 8

        def get_batch(self, indices):
            raise OSError("EIO: storage blip")

    with pytest.raises(ProbeDecodeError):
        DecodeWorker(_FlakyProbe(), "127.0.0.1", 0)


def test_worker_stats_snapshot_and_events(tmp_path):
    stats = WorkerStats(3)
    stats.note_shard(0.01, 0.02, 2**20)
    stats.note_shard(0.01, 0.04, 2**20)
    stats.note_credit_stall(0.5)
    stats.note_connection(+1)
    stats.note_connection(-1)
    stats.note_error()
    snap = stats.snapshot()
    assert snap["server_id"] == 3 and snap["shards"] == 2 and snap["streamed_mb"] == 2.0
    assert snap["credit_stall_s"] == 0.5 and snap["errors"] == 1
    assert snap["connections"] == 0 and snap["connections_peak"] == 1
    worker = _start_worker(_dataset(), telemetry_dir=str(tmp_path), server_id=2)
    worker.stop(timeout_s=1.0)
    with open(tmp_path / "events.jsonl", encoding="utf-8") as f:
        record = json.loads(f.readline())
    assert record["kind"] == "input_server" and record["event"] == "stats"
    assert record["final"] is True and record["server_id"] == 2 and record["pid"] == os.getpid()


def test_service_dataset_len_from_meta_probe():
    from moco_tpu_torch.train import service_dataset_len

    worker = _start_worker(_dataset())
    try:
        assert service_dataset_len(f"{worker.host}:{worker.port}") == N_SAMPLES
    finally:
        worker.stop(timeout_s=1.0)
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    free_port = probe.getsockname()[1]
    probe.close()
    with pytest.raises(ServiceConfigError, match="meta probe"):
        service_dataset_len([("127.0.0.1", free_port)])


def test_serve_shard_spans_continue_the_client_trace(tmp_path):
    from moco_tpu_torch.telemetry.trace import Tracer

    client_tracer = Tracer(str(tmp_path / "driver"), "full", proc="driver")
    worker_tracer = Tracer(str(tmp_path / "staging0"), "full", proc="staging0")
    worker = _start_worker(_dataset(), tracer=worker_tracer)
    client = None
    try:
        client = service_epoch_loader(f"{worker.host}:{worker.port}", N_SAMPLES, 1, 0,
                                      GLOBAL_BATCH, "cpu", streams=2, tracer=client_tracer)
        _drain(client)
    finally:
        if client is not None:
            client.close_quietly()
        worker.stop(timeout_s=1.0)
        client_tracer.close()
        worker_tracer.close()
    with open(tmp_path / "staging0" / "spans.jsonl", encoding="utf-8") as f:
        served = [s for s in map(json.loads, f) if s["name"] == "serve_shard"]
    assert served and all(s.get("parent") for s in served)
    assert {s["trace"] for s in served} == {client_tracer.trace_id}
    with open(tmp_path / "driver" / "spans.jsonl", encoding="utf-8") as f:
        client_ids = {s["span"] for s in map(json.loads, f)}
    assert {s["parent"] for s in served} <= client_ids


@pytest.mark.parametrize("backend", ["pil", "auto"])
def test_worker_builds_the_dataset_its_flags_name(tmp_path, backend):
    """`--backend` picks ImageFolder's decoder (PIL here, as phase 4 of
    `chip_smoke.py` decodes); `--cache-mb` wraps the decode-once cache;
    `--prestage` serves the mmap."""
    import argparse

    from PIL import Image

    from moco_tpu_torch.data.canvas_cache import CachedDataset
    from moco_tpu_torch.data.datasets import ImageFolder
    from moco_tpu_torch.data.service.worker import add_dataset_flags, build_worker_dataset

    rng = np.random.RandomState(0)
    for c in range(2):
        (tmp_path / "tree" / f"c{c}").mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.randint(0, 256, (20, 30, 3), np.uint8)).save(
                tmp_path / "tree" / f"c{c}" / f"{i}.jpg")
    parser = argparse.ArgumentParser()
    add_dataset_flags(parser)
    args = parser.parse_args(["--dataset", "imagefolder", "--data-dir", str(tmp_path / "tree"),
                              "--stage-size", "32", "--backend", backend])
    dataset, prestaged = build_worker_dataset(args)
    assert isinstance(dataset, ImageFolder) and len(dataset) == 4 and not prestaged
    if backend == "pil":
        assert dataset._native is None
    cached, _ = build_worker_dataset(parser.parse_args(
        ["--dataset", "synthetic", "--num-samples", "8", "--cache-mb", "1"]))
    assert isinstance(cached, CachedDataset) and len(cached) == 8
    write_prestage(_dataset(num_samples=8), str(tmp_path / "pre"))
    served, prestaged = build_worker_dataset(parser.parse_args(
        ["--prestage", str(tmp_path / "pre")]))
    assert isinstance(served, PrestagedDataset) and prestaged
