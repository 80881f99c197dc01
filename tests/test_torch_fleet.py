"""The port's serving fleet (`moco_tpu_torch/serve/fleet.py`, `python -m
moco_tpu_torch.serve_fleet`) against the JAX package's
(`moco_tpu/serve/fleet.py`, `tools/serve_fleet.py`) on the CPU.

Both fleet modules are the standard library alone, so every scenario here
runs once for each package (`pkg`) on the same inputs and asserts what the
reference's own tests assert; where the two answer the same requests the
transcripts are compared whole (`*_equal_across_packages`):

- the router against in-thread stub backends (no child processes): the
  least-outstanding pick, one retry on a dead replica, the structured 502,
  the structured 503 shed, replica rejections passed through, the body's
  deadline, the admission-tier counters;
- the checkpoint watcher on identical step directories (deploys and
  quarantines), the reload roll's terminal 409, the paired-bank gate and
  the mismatch rollback against capture backends;
- the autoscaler's decisions on the same stats sequences, and the
  scale-down's floor and shard cover;
- the `/v1/knn` scatter-gather merge over two real ANN shards (equal to
  the full index) and the dead shard's `partial` flag;
- the `router_stats` record's keys, the constructor's and the CLI's
  validation and exit codes (45, 48).

The drills with child processes are `tests/test_torch_fleet_drills.py`;
the fleet of real port replicas is `tests/test_torch_fleet_replicas.py`.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import random
import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ["moco_tpu", "moco_tpu_torch"]

FAST_POLICY = dict(
    probe_secs=0.1, probe_timeout_s=0.5, health_stale_secs=1.0,
    startup_grace_secs=15.0, term_grace_secs=1.0,
    backoff_base_secs=0.05, backoff_max_secs=0.2, backoff_jitter=0.0,
    request_timeout_s=10.0, watch_poll_secs=0.1, stats_every_secs=1.0,
)
D = 8  # the stub embedding width


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Pkg:
    """One package's fleet and the modules its tests write artifacts with."""

    def __init__(self, name):
        self.name = name
        self.fleet = importlib.import_module(f"{name}.serve.fleet")
        self.integrity = importlib.import_module(f"{name}.resilience.integrity")
        self.chaos = importlib.import_module(f"{name}.resilience.chaos")
        self.supervisor = importlib.import_module(f"{name}.resilience.supervisor")
        self.exitcodes = importlib.import_module(f"{name}.resilience.exitcodes")
        self.ann = importlib.import_module(f"{name}.serve.ann")
        self.bankbuild = importlib.import_module(f"{name}.serve.bankbuild")

    def cli_main(self):
        if self.name == "moco_tpu":
            return _load_tool("serve_fleet").main
        return importlib.import_module("moco_tpu_torch.serve_fleet").main


_PKGS = {}


def _pkg(name) -> _Pkg:
    if name not in _PKGS:
        _PKGS[name] = _Pkg(name)
    return _PKGS[name]


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _pkg(request.param)


# ---------------------------------------------------------------------------
# in-thread stub backends and hand-built fleets (no child processes)
# ---------------------------------------------------------------------------


class _FakeProc:
    """Stands in for a live Popen in router-only tests."""

    pid = 4242

    def poll(self):
        return None

    def terminate(self):
        pass


def _serve(handler) -> ThreadingHTTPServer:
    class S(ThreadingHTTPServer):
        daemon_threads = True

    srv = S(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _send(h, status, obj):
    body = json.dumps(obj).encode()
    h.send_response(status)
    h.send_header("Content-Type", "application/json")
    h.send_header("Content-Length", str(len(body)))
    h.end_headers()
    h.wfile.write(body)


def _stub_backend(response=None, status=200):
    """One in-thread HTTP backend answering every POST with `response`."""
    class H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length") or 0))
            _send(self, status, response if response is not None
                  else {"embedding": [float(self.server.server_address[1])]})

    return _serve(H)


def _capture_backend(decide):
    """Records every POST body; answers with decide(body) -> (status, payload)."""
    bodies = []

    class H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_POST(self):
            raw = self.rfile.read(int(self.headers.get("Content-Length") or 0))
            try:
                req = json.loads(raw) if raw else {}
            except ValueError:
                req = {}
            bodies.append(dict(req, _path=self.path))
            status, payload = decide(req)
            _send(self, status, payload)

    return _serve(H), bodies


def _shard_backend(embedding, shard_obj=None, answer=None):
    """A stub replica: /v1/embed answers `embedding`; a candidates probe
    answers its REAL AnnShard's search (or a canned `answer`)."""
    class H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_POST(self):
            req = json.loads(self.rfile.read(int(self.headers.get("Content-Length") or 0))
                             or b"{}")
            if self.path == "/v1/knn" and req.get("candidates"):
                if answer is not None:
                    resp = answer
                else:
                    sims, labs, _rows = shard_obj.search(
                        np.asarray(req["embedding"], np.float32))
                    resp = {"candidates": [[float(s), int(lab)] for s, lab in zip(sims, labs)],
                            "temperature": shard_obj.temperature, "k": shard_obj.rerank,
                            "num_classes": shard_obj.num_classes}
            elif self.path == "/v1/knn":
                resp = {"class": 42, "cached": False}  # the exact-path stub
            else:
                resp = {"embedding": list(embedding() if callable(embedding) else embedding)}
            _send(self, 200, resp)

    return _serve(H)


def _router_fleet(pkg, tmp_path, ports, healthy=None, ann_shards=0, bank_dir=""):
    """A FleetSupervisor with hand-built replica states (no start(), no
    monitor thread): exactly the router and roll logic under test."""
    fleet = pkg.fleet.FleetSupervisor(
        lambda *a: ["true"], replicas=len(ports), telemetry_dir=str(tmp_path / "fleet_t"),
        policy=pkg.fleet.FleetPolicy(**FAST_POLICY), ann_shards=ann_shards,
        bank_dir=bank_dir)
    for i, port in enumerate(ports):
        r = pkg.fleet.ReplicaState(i, "127.0.0.1", port, str(tmp_path / f"r{i}"), budget=3)
        r.proc = _FakeProc()
        r.healthy = True if healthy is None else healthy[i]
        if ann_shards:
            r.shard = i % ann_shards
        fleet.replicas.append(r)
    return fleet


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


def test_router_least_outstanding_pick(pkg, tmp_path):
    fleet = _router_fleet(pkg, tmp_path, [1001, 1002, 1003])
    fleet.replicas[0].outstanding = 2
    fleet.replicas[1].outstanding = 0
    fleet.replicas[2].outstanding = 1
    picked = fleet.pick_backend()
    assert picked.index == 1
    assert picked.outstanding == 1  # a pick reserves a slot
    fleet.release_backend(picked)
    assert picked.outstanding == 0
    # draining, ejected and excluded replicas are never picked
    fleet.replicas[1].draining = True
    assert fleet.pick_backend(exclude=(2,)).index == 0


def test_router_retries_once_on_dead_replica_then_succeeds(pkg, tmp_path):
    live = _stub_backend()
    dead_port = pkg.fleet.pick_free_port()  # nothing listens: connection refused
    fleet = _router_fleet(pkg, tmp_path, [dead_port, live.server_address[1]])
    try:
        fleet.replicas[1].outstanding = 5  # the dead replica is picked first
        status, body = fleet.router_proxy("/v1/embed", b"{}")
        assert status == 200
        assert json.loads(body)["embedding"] == [live.server_address[1]]
        assert fleet.r_retries == 1 and fleet.r_retry_ok == 1
        # the dead replica was ejected: re-admission is the probe's job
        assert fleet.replicas[0].healthy is False
        assert [e["event"] for e in fleet.incidents].count("eject") == 1
    finally:
        live.shutdown()


def test_router_both_attempts_fail_structured_502(pkg, tmp_path):
    fleet = _router_fleet(pkg, tmp_path, [pkg.fleet.pick_free_port(),
                                          pkg.fleet.pick_free_port()])
    status, body = fleet.router_proxy("/v1/embed", b"{}")
    resp = json.loads(body)
    assert status == 502 and resp["error"] == "upstream_error"
    assert resp["retry_after_ms"] > 0
    assert fleet.r_upstream_error == 1


def test_router_sheds_structured_503_when_no_healthy_backend(pkg, tmp_path):
    fleet = _router_fleet(pkg, tmp_path, [1001], healthy=[False])
    t0 = time.monotonic()
    status, body = fleet.router_proxy("/v1/embed", b"{}")
    resp = json.loads(body)
    assert time.monotonic() - t0 < 1.0  # shed at once, never stalls
    assert status == 503 and resp["error"] == "no_healthy_backend"
    assert resp["retry_after_ms"] > 0
    assert fleet.r_shed_no_backend == 1
    assert any(e["event"] == "no_backend" for e in fleet.incidents)


def test_router_passes_replica_rejections_through(pkg, tmp_path):
    shed = _stub_backend(response={"error": "overloaded", "retry_after_ms": 5.0}, status=503)
    fleet = _router_fleet(pkg, tmp_path, [shed.server_address[1]])
    try:
        status, body = fleet.router_proxy("/v1/embed", b"{}")
        assert status == 503
        assert json.loads(body)["error"] == "overloaded"
        # a structured ANSWER from a live replica is not a router failure
        assert fleet.r_retries == 0
        assert fleet.replicas[0].healthy is True
        assert fleet.r_passthrough_error == 1
    finally:
        shed.shutdown()


def test_router_deadline_from_body_wins(pkg, tmp_path):
    fleet = _router_fleet(pkg, tmp_path, [1001])
    assert fleet._deadline_s(b'{"pixels": [1]}') == fleet.policy.request_timeout_s
    assert fleet._deadline_s(b'{"deadline_ms": 250}') == 0.25
    # a malformed body: the default deadline, the replica answers the 400
    assert fleet._deadline_s(b'{"deadline_ms": oops') == fleet.policy.request_timeout_s


def test_router_counts_tiers(pkg, tmp_path):
    stub = _shard_backend([0.0] * D)
    fleet = _router_fleet(pkg, tmp_path, [stub.server_address[1]])
    try:
        fleet.router_proxy("/v1/embed", b'{"pixels": [0]}')
        fleet.router_proxy("/v1/embed", b'{"tier": "batch"}')
        fleet.router_proxy("/v1/embed", b'{"tier": "interactive"}')
        assert fleet.r_tier == {"interactive": 2, "batch": 1}
        counters = fleet._router_counters()
        assert counters["requests_interactive"] == 2
        assert counters["requests_batch"] == 1
    finally:
        stub.shutdown()


def _router_transcript(pkg, tmp_path, live, shed):
    """Every router outcome against the same backends: (status, body bytes)
    and the counters after each."""
    dead = [pkg.fleet.pick_free_port() for _ in range(2)]
    out = []
    scenarios = [
        ([dead[0], live.server_address[1]], [True, True], [0, 5], "/v1/embed", b"{}"),
        (dead, [True, True], [0, 0], "/v1/embed", b"{}"),
        ([1001], [False], [0], "/v1/embed", b'{"tier": "batch"}'),
        ([shed.server_address[1]], [True], [0], "/v1/embed", b"{}"),
        ([live.server_address[1]], [True], [0], "/v1/knn", b'{"deadline_ms": 4000}'),
        ([live.server_address[1]], [True], [0], "/v1/embed", b'{"deadline_ms": 5}'),
    ]
    for i, (ports, healthy, outstanding, path, body) in enumerate(scenarios):
        fleet = _router_fleet(pkg, tmp_path / f"s{i}", ports, healthy=healthy)
        for r, n in zip(fleet.replicas, outstanding):
            r.outstanding = n
        status, data = fleet.router_proxy(path, body)
        detail = json.loads(data)
        if "detail" in detail:  # the error text names a port picked per package
            detail["detail"] = detail["detail"].split(":")[0]
        out.append((status, detail, fleet._router_counters(),
                    [r.healthy for r in fleet.replicas],
                    [e["event"] for e in fleet.incidents]))
    return out


def test_router_transcripts_equal_across_packages(tmp_path):
    live, shed = _stub_backend(), _stub_backend(
        response={"error": "overloaded", "retry_after_ms": 5.0}, status=503)
    try:
        jax_t = _router_transcript(_pkg("moco_tpu"), tmp_path / "jax", live, shed)
        port_t = _router_transcript(_pkg("moco_tpu_torch"), tmp_path / "port", live, shed)
    finally:
        live.shutdown()
        shed.shutdown()
    assert port_t == jax_t
    assert [t[0] for t in port_t][:4] == [200, 502, 503, 503]


# ---------------------------------------------------------------------------
# the checkpoint watcher
# ---------------------------------------------------------------------------


def _export_step(pkg, watch_dir, step, payload=b"w" * 4096, manifest=True,
                 name="encoder.npz"):
    d = watch_dir / str(step)
    d.mkdir(parents=True)
    (d / name).write_bytes(payload)
    if manifest:
        pkg.integrity.write_manifest(str(watch_dir), step)
    return str(d / name)


def _watcher(pkg, watch, events):
    return pkg.fleet.CheckpointWatcher(str(watch), emit=lambda e, **f: events.append((e, f)))


def test_watcher_deploys_only_manifested_verified_steps(pkg, tmp_path):
    watch = tmp_path / "export"
    watch.mkdir()
    w = _watcher(pkg, watch, [])
    assert w.poll_once() is None  # an empty dir
    _export_step(pkg, watch, 10, manifest=False)
    assert w.poll_once() is None  # no manifest = still being written
    pkg.integrity.write_manifest(str(watch), 10)
    step, payload = w.poll_once()
    assert step == 10 and payload.endswith("encoder.npz")
    assert w.poll_once() is None  # nothing new
    # the newest verified wins; older undeployed steps are skipped
    _export_step(pkg, watch, 20)
    _export_step(pkg, watch, 30)
    step, _ = w.poll_once()
    assert step == 30
    assert w.poll_once() is None


def test_watcher_quarantines_truncated_checkpoint(pkg, tmp_path):
    watch = tmp_path / "export"
    watch.mkdir()
    events = []
    w = _watcher(pkg, watch, events)
    _export_step(pkg, watch, 10)
    assert w.poll_once()[0] == 10
    _export_step(pkg, watch, 20)
    pkg.chaos.truncate_checkpoint(str(watch), 20)  # torn mid-write
    assert w.poll_once() is None
    assert [e for e, _ in events] == ["reload_quarantine"]
    assert events[0][1]["step"] == 20
    assert not (watch / "20").exists()
    assert os.path.isdir(str(watch / ".quarantine" / "20"))
    _export_step(pkg, watch, 21)
    assert w.poll_once()[0] == 21


def test_watcher_payload_selection(pkg, tmp_path):
    watch = tmp_path / "export"
    d = watch / "5"
    d.mkdir(parents=True)
    (d / "notes.txt").write_bytes(b"x")
    (d / "encoder.safetensors").write_bytes(b"w" * 512)
    pkg.integrity.write_manifest(str(watch), 5)
    step, payload = pkg.fleet.CheckpointWatcher(str(watch)).poll_once()
    assert step == 5 and payload.endswith("encoder.safetensors")


def _watcher_story(pkg, root):
    """One fixed sequence of exports, tears and layouts; returns every
    poll's answer and every event, with paths relative to `root`."""
    watch = root / "export"
    watch.mkdir(parents=True)
    events = []
    w = _watcher(pkg, watch, events)
    polls = [w.poll_once()]
    _export_step(pkg, watch, 3, manifest=False)
    polls.append(w.poll_once())
    pkg.integrity.write_manifest(str(watch), 3)
    polls.append(w.poll_once())
    _export_step(pkg, watch, 7)
    _export_step(pkg, watch, 9)
    pkg.chaos.truncate_checkpoint(str(watch), 9)
    polls.append(w.poll_once())
    d = watch / "11"
    d.mkdir()
    (d / "a.txt").write_bytes(b"a")
    (d / "b.txt").write_bytes(b"b")
    pkg.integrity.write_manifest(str(watch), 11)  # no single payload
    polls.append(w.poll_once())
    _export_step(pkg, watch, 12, name="encoder.bin")
    polls.append(w.poll_once())
    w.quarantine(12, "refused by the drift guard")
    polls.append(w.poll_once())

    def rel(v):
        return os.path.relpath(v, root) if isinstance(v, str) and v.startswith(str(root)) else v

    return ([None if p is None else (p[0], rel(p[1])) for p in polls],
            [(e, {k: rel(v) for k, v in f.items()}) for e, f in events],
            sorted(os.listdir(watch / ".quarantine")))


def test_watcher_decisions_equal_across_packages(tmp_path):
    jax_s = _watcher_story(_pkg("moco_tpu"), tmp_path / "jax")
    port_s = _watcher_story(_pkg("moco_tpu_torch"), tmp_path / "port")
    assert port_s == jax_s
    polls, events, quarantined = port_s
    assert polls == [None, None, (3, "export/3/encoder.npz"), (7, "export/7/encoder.npz"),
                     None, (12, "export/12/encoder.bin"), None]
    assert [e for e, _ in events] == ["reload_quarantine", "reload_bad_layout",
                                      "reload_quarantine"]
    assert quarantined == ["12", "9"]


def test_watchers_read_each_others_manifests(tmp_path):
    """The port's watcher deploys a step the JAX package's integrity module
    manifested and quarantines one it tore, and the other way round."""
    for writer, reader in (("moco_tpu", "moco_tpu_torch"), ("moco_tpu_torch", "moco_tpu")):
        watch = tmp_path / writer / "export"
        watch.mkdir(parents=True)
        events = []
        w = _watcher(_pkg(reader), watch, events)
        _export_step(_pkg(writer), watch, 4)
        assert w.poll_once()[0] == 4
        _export_step(_pkg(writer), watch, 5)
        _pkg(writer).chaos.truncate_checkpoint(str(watch), 5)
        assert w.poll_once() is None
        assert [e for e, _ in events] == ["reload_quarantine"]


# ---------------------------------------------------------------------------
# the reload roll against capture backends
# ---------------------------------------------------------------------------


def test_fleet_409_refusal_is_terminal_not_retried(pkg, tmp_path):
    refuse = _stub_backend(response={"error": "reload_refused", "detail": "kNN bank"},
                           status=409)
    fleet = _router_fleet(pkg, tmp_path, [refuse.server_address[1]])
    try:
        with fleet._lock:
            fleet._target_step, fleet._target_path = 7, "/x/encoder.npz"
        fleet._reload_sync()
        fleet._reload_sync()  # the converge loop coming around again
        r = fleet.replicas[0]
        assert r.reload_refused_step == 7
        assert r.deployed_step == -1
        assert len([e for e in fleet.incidents if e["event"] == "reload_failed"]) == 1
        assert not (r.deployed_step < fleet._target_step
                    and r.reload_refused_step < fleet._target_step)
    finally:
        refuse.shutdown()
    # a TRANSIENT failure (503 reload_failed) stays retryable
    flaky = _stub_backend(response={"error": "reload_failed", "detail": "NFS blip"}, status=503)
    fleet2 = _router_fleet(pkg, tmp_path / "f2", [flaky.server_address[1]])
    try:
        with fleet2._lock:
            fleet2._target_step, fleet2._target_path = 9, "/x/e.npz"
        fleet2._reload_sync()
        r = fleet2.replicas[0]
        assert r.reload_refused_step == -1
        assert r.deployed_step < fleet2._target_step
    finally:
        flaky.shutdown()


def _fleet_bank(pkg, bank_dir, step, rows=6):
    """A verified bank artifact in the fleet's bank_dir layout."""
    step_dir = os.path.join(bank_dir, str(step))
    os.makedirs(step_dir)
    np.savez(os.path.join(step_dir, "bank.npz"),
             features=np.full((rows, D), float(step), np.float32), labels=np.arange(rows) % 2)
    pkg.integrity.write_manifest(bank_dir, step)
    return os.path.join(step_dir, "bank.npz")


def test_fleet_pair_gating_waits_for_bank_then_dual_swaps(pkg, tmp_path):
    srv, bodies = _capture_backend(lambda b: (200, {"status": "reloaded"}))
    bank_dir = str(tmp_path / "bank")
    os.makedirs(bank_dir)
    fleet = _router_fleet(pkg, tmp_path, [srv.server_address[1]], bank_dir=bank_dir)
    try:
        with fleet._lock:
            fleet._target_step, fleet._target_path = 7, "/x/7/encoder.npz"
        fleet._reload_sync()
        fleet._reload_sync()
        assert bodies == []  # no replica was asked to half-swap
        assert fleet.replicas[0].deployed_step == -1
        waiting = [e for e in fleet.incidents if e["event"] == "bank_waiting"]
        assert len(waiting) == 1 and waiting[0]["step"] == 7
        bank_path = _fleet_bank(pkg, bank_dir, 7)
        fleet._reload_sync()
        assert fleet.replicas[0].deployed_step == 7
        assert bodies[-1]["bank"] == bank_path and bodies[-1]["bank_step"] == 7
        st = fleet.stats()["bank"]
        assert st["good_step"] == 7 and st["good_bank"] == bank_path
        # a corrupt LATER bank quarantines itself; the serving pair stays
        bank9 = _fleet_bank(pkg, bank_dir, 9)
        with open(bank9, "ab") as f:
            f.write(b"torn")
        with fleet._lock:
            fleet._target_step, fleet._target_path = 9, "/x/9/encoder.npz"
        fleet._reload_sync()
        assert fleet.replicas[0].deployed_step == 7
        assert os.path.isdir(os.path.join(bank_dir, ".quarantine", "9"))
        assert fleet.stats()["bank"]["quarantined"] == [9]
    finally:
        srv.shutdown()


def test_fleet_mismatch_quarantines_pair_and_rolls_back(pkg, tmp_path):
    srv0, bodies0 = _capture_backend(lambda b: (200, {"status": "reloaded"}))

    def judge(b):
        if b.get("bank_step") == 5:
            return 200, {"status": "reloaded"}
        return 409, {"error": "reload_bank_mismatch",
                     "detail": "space-agreement probe cosine 0.01"}

    srv1, bodies1 = _capture_backend(judge)
    bank_dir = str(tmp_path / "bank")
    os.makedirs(bank_dir)
    bank5 = _fleet_bank(pkg, bank_dir, 5)
    _fleet_bank(pkg, bank_dir, 7)
    fleet = _router_fleet(pkg, tmp_path, [srv0.server_address[1], srv1.server_address[1]],
                          bank_dir=bank_dir)
    try:
        with fleet._lock:
            fleet._target_step, fleet._target_path = 5, "/x/5/encoder.npz"
        fleet._reload_sync()
        assert all(r.deployed_step == 5 for r in fleet.replicas)
        with fleet._lock:
            fleet._target_step, fleet._target_path = 7, "/x/7/encoder.npz"
        fleet._reload_sync()
        # replica 0 half-swapped onto 7, then rolled back to the known-good pair
        assert [r.deployed_step for r in fleet.replicas] == [5, 5]
        assert bodies0[-1]["pretrained"] == "/x/5/encoder.npz"
        assert bodies0[-1]["bank"] == bank5 and bodies0[-1]["bank_step"] == 5
        assert os.path.isdir(os.path.join(bank_dir, ".quarantine", "7"))
        assert not os.path.exists(pkg.integrity.manifest_path(bank_dir, 7))
        st = fleet.stats()["bank"]
        assert st["good_step"] == 5 and st["good_bank"] == bank5 and st["quarantined"] == [7]
        assert fleet.replicas[1].reload_refused_step == 7
        with fleet._lock:
            assert fleet._target_path is None
        n_posts = len(bodies0) + len(bodies1)
        fleet._reload_sync()
        assert len(bodies0) + len(bodies1) == n_posts  # no churn on the condemned pair
        events = [e["event"] for e in fleet.incidents]
        assert "quarantine" in events and "bank_quarantine" in events
        rollbacks = [e for e in fleet.incidents if e["event"] == "rollback"]
        assert rollbacks and rollbacks[0]["mode"] == "reload"
        assert (rollbacks[0]["from_step"], rollbacks[0]["to_step"]) == (7, 5)
        assert all(e["kind"] == "bank" for e in fleet.incidents
                   if e["event"] in ("quarantine", "bank_quarantine", "rollback",
                                     "bank_waiting"))
    finally:
        srv0.shutdown()
        srv1.shutdown()


def test_fleet_launch_argv_pins_bank_and_tolerates_legacy_signature(pkg, tmp_path):
    calls = []

    def argv6(index, port, tdir, pretrained, bank, shard):
        calls.append((pretrained, bank, shard))
        return ["true"]

    def argv5(index, port, tdir, pretrained, bank):
        calls.append((pretrained, bank))
        return ["true"]

    def argv4(index, port, tdir, pretrained):
        calls.append((pretrained,))
        return ["true"]

    for i, fn in enumerate((argv6, argv5, argv4)):
        fleet = pkg.fleet.FleetSupervisor(fn, replicas=1, telemetry_dir=str(tmp_path / f"t{i}"),
                                          policy=pkg.fleet.FleetPolicy(**FAST_POLICY))
        with fleet._lock:
            fleet._current_pretrained = "/good/encoder.npz"
            fleet._good_bank = "/good/bank.npz"
        r = pkg.fleet.ReplicaState(0, "127.0.0.1", 1234, str(tmp_path / f"r{i}"), budget=3)
        r.shard = 1
        os.makedirs(r.telemetry_dir, exist_ok=True)
        fleet._launch(r)
        r.proc.wait(timeout=10.0)
    assert calls == [("/good/encoder.npz", "/good/bank.npz", 1),
                     ("/good/encoder.npz", "/good/bank.npz"), ("/good/encoder.npz",)]


# ---------------------------------------------------------------------------
# the autoscaler
# ---------------------------------------------------------------------------


def _stats(requests=0, sheds=0, outstanding=0, healthy=1, p99=0.0):
    return {"requests": requests, "upstream_timeout": sheds, "outstanding": outstanding,
            "healthy": healthy, "latency_ms": {"p99": p99} if p99 else {}}


def _policy(pkg, **kw):
    base = dict(FAST_POLICY)
    base.update(autoscale_max=4, autoscale_cooldown_s=10.0, autoscale_up_after=2,
                autoscale_down_after=2, autoscale_shed_high=0.02,
                autoscale_outstanding_high=4.0, autoscale_idle_low=0.25)
    base.update(kw)
    return pkg.fleet.FleetPolicy(**base)


def test_autoscale_shed_breach_needs_consecutive_windows(pkg):
    c = pkg.fleet.AutoscaleController(_policy(pkg))
    assert c.observe(_stats(100), now=0.0) is None  # no deltas yet
    assert c.observe(_stats(200, sheds=10), now=1.0) is None  # streak 1
    action = c.observe(_stats(300, sheds=20), now=2.0)
    assert action is not None and action[0] == "up" and "shed_rate" in action[1]


def test_autoscale_mixed_window_resets_streaks(pkg):
    c = pkg.fleet.AutoscaleController(_policy(pkg))
    c.observe(_stats(100), now=0.0)
    c.observe(_stats(200, sheds=10), now=1.0)
    c.observe(_stats(300, sheds=10, outstanding=1), now=2.0)  # mixed
    assert c.breach_streak == 0 and c.idle_streak == 0
    assert c.observe(_stats(400, sheds=20), now=3.0) is None


def test_autoscale_cooldown_defers_but_keeps_streak(pkg):
    c = pkg.fleet.AutoscaleController(_policy(pkg, autoscale_cooldown_s=100.0))
    c.observe(_stats(100), now=0.0)
    c.observe(_stats(200, sheds=10), now=1.0)
    assert c.observe(_stats(300, sheds=20), now=2.0)[0] == "up"
    c.observe(_stats(400, sheds=30), now=3.0)
    assert c.observe(_stats(500, sheds=40), now=4.0) is None
    assert c.breach_streak >= 2
    assert c.observe(_stats(600, sheds=50), now=200.0)[0] == "up"


def test_autoscale_depth_and_p99_breaches(pkg):
    c = pkg.fleet.AutoscaleController(_policy(pkg))
    c.observe(_stats(100), now=0.0)
    c.observe(_stats(200, outstanding=10, healthy=2), now=1.0)
    action = c.observe(_stats(300, outstanding=12, healthy=2), now=2.0)
    assert action[0] == "up" and "outstanding/healthy" in action[1]
    c2 = pkg.fleet.AutoscaleController(_policy(pkg, autoscale_p99_high_ms=50.0))
    c2.observe(_stats(100), now=0.0)
    c2.observe(_stats(200, p99=80.0), now=1.0)
    assert c2.observe(_stats(300, p99=90.0), now=2.0)[0] == "up"


def test_autoscale_idle_scales_down_zero_sheds_only(pkg):
    c = pkg.fleet.AutoscaleController(_policy(pkg))
    c.observe(_stats(100), now=0.0)
    c.observe(_stats(110), now=1.0)
    action = c.observe(_stats(120), now=2.0)
    assert action is not None and action[0] == "down"
    c.observe(_stats(130, sheds=21), now=3.0)
    assert c.idle_streak == 0


@pytest.mark.parametrize("policy_kw", [{}, dict(autoscale_p99_high_ms=40.0),
                                       dict(autoscale_cooldown_s=0.0, autoscale_up_after=1,
                                            autoscale_down_after=3)])
def test_autoscale_decisions_equal_across_packages(policy_kw):
    """The same 300 windows of random router_stats give the same decisions
    (and streaks) from both controllers."""
    rng = random.Random(20)
    seq, req, shed = [], 0, 0
    for i in range(300):
        idle = (i // 20) % 2 == 1  # blocks of 20 busy, then 20 quiet windows
        req += rng.randint(0, 200)
        if not idle:
            shed += rng.choice([0, 0, 0, rng.randint(0, 20)])
        seq.append((dict(_stats(req, shed, outstanding=0 if idle else rng.randint(0, 20),
                                healthy=rng.randint(0, 4), p99=rng.uniform(0, 80)),
                         shed_no_backend=0), float(i)))
    out = {}
    for name in PACKAGES:
        c = _pkg(name).fleet.AutoscaleController(_policy(_pkg(name), **policy_kw))
        out[name] = [(c.observe(s, now), c.breach_streak, c.idle_streak) for s, now in seq]
    assert out["moco_tpu_torch"] == out["moco_tpu"]
    assert {d[0][0] for d in out["moco_tpu"] if d[0]} == {"up", "down"}


def test_scale_down_respects_floor_and_shard_cover(pkg, tmp_path):
    fleet = _router_fleet(pkg, tmp_path, [1001, 1002], ann_shards=2)
    fleet._scale_down("idle")  # 2 replicas over 2 shards: the floor is 2
    assert not any(r.reaping for r in fleet.replicas)
    r = pkg.fleet.ReplicaState(2, "127.0.0.1", 1003, str(tmp_path / "r2"), budget=3)
    r.proc, r.healthy, r.shard = _FakeProc(), True, 0
    fleet.replicas.append(r)
    fleet._scale_down("idle")
    assert fleet.replicas[2].reaping and fleet.replicas[2].draining
    assert not fleet.replicas[1].reaping  # shard 1's sole owner


# ---------------------------------------------------------------------------
# the /v1/knn scatter-gather
# ---------------------------------------------------------------------------


def _embed_stub(batch):
    flat = np.asarray(batch, np.float32).reshape(len(batch), -1)
    return (flat[:, :D] / 255.0).astype(np.float32)


@pytest.fixture(scope="module")
def ann_bank(tmp_path_factory):
    """A real versioned bank (JAX builder) and its 16-cell IVF index."""
    pkg = _pkg("moco_tpu")
    root = tmp_path_factory.mktemp("ann")
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (256, 8, 8, 3), dtype=np.uint8)
    labels = (np.arange(256) % 5).astype(np.int64)
    ck = root / "export" / "7" / "encoder.npz"
    ck.parent.mkdir(parents=True)
    ck.write_bytes(b"weights " * 512)
    bank_dir = str(root / "bank")
    pkg.bankbuild.build_bank(bank_dir, 7, images, labels, _embed_stub,
                             checkpoint_path=str(ck), image_size=8, shards=1)
    pkg.ann.build_ann_index(bank_dir, 7, cells=16)
    return os.path.join(bank_dir, "7", "bank.npz")


def _shards(pkg, bank_path, shards):
    feats = np.load(bank_path)
    arrays, manifest = pkg.ann.load_ann(bank_path)
    cells = manifest["cells"]
    full = pkg.ann.AnnShard(feats["features"], feats["labels"], arrays, nprobe=cells,
                            rerank=50)
    parts = [pkg.ann.AnnShard(feats["features"], feats["labels"], arrays, shard=s,
                              shards=shards, nprobe=cells, rerank=50) for s in range(shards)]
    return feats["features"], full, parts


def _query(features, i, seed=5):
    q = features[i] + 0.1 * np.random.default_rng(seed + i).standard_normal(D).astype(
        np.float32)
    return (q / np.linalg.norm(q)).astype(np.float32)


def test_fanout_merge_matches_full_index_classify(pkg, ann_bank, tmp_path):
    """A 2-shard fan-out through the stdlib router (real AnnShard
    candidates, the pure-python merge and vote) answers EXACTLY what one
    full-index replica answers."""
    features, full, halves = _shards(pkg, ann_bank, 2)
    q = _query(features, 17)
    backends = [_shard_backend(q.tolist(), h) for h in halves]
    fleet = _router_fleet(pkg, tmp_path, [b.server_address[1] for b in backends], ann_shards=2)
    try:
        status, body = fleet.router_proxy("/v1/knn", b'{"pixels": [0]}')
        resp = json.loads(body)
        assert status == 200
        assert resp["partial"] is False and resp["shards_answered"] == 2
        assert resp["class"] == full.classify(q)[0]
        assert fleet.r_knn_fanout == 1 and fleet.r_knn_partial == 0
        assert fleet.r_ok == 1 and fleet.r_requests == 1  # the embed leg not counted twice
    finally:
        for b in backends:
            b.shutdown()


def test_fanout_dead_shard_flags_partial(pkg, tmp_path):
    live = _shard_backend([0.5] * D, answer={"candidates": [[0.9, 3], [0.2, 1]],
                                             "temperature": 0.07, "k": 10, "num_classes": 5})
    fleet = _router_fleet(pkg, tmp_path, [live.server_address[1], pkg.fleet.pick_free_port()],
                          ann_shards=2)
    try:
        status, body = fleet.router_proxy("/v1/knn", b'{"pixels": [0], "deadline_ms": 3000}')
        resp = json.loads(body)
        assert status == 200
        assert resp["partial"] is True and resp["shards_answered"] == 1
        assert resp["class"] == 3  # shard 0's candidates still vote
        assert fleet.r_knn_partial == 1
        assert fleet.replicas[1].healthy is False  # ejected for the probe to readmit
    finally:
        live.shutdown()


def test_single_shard_fleet_never_fans_out(pkg, tmp_path):
    stub = _shard_backend([0.0] * D)
    fleet = _router_fleet(pkg, tmp_path, [stub.server_address[1]], ann_shards=1)
    try:
        status, body = fleet.router_proxy("/v1/knn", b'{"pixels": [0]}')
        assert status == 200 and json.loads(body) == {"class": 42, "cached": False}
        assert fleet.r_knn_fanout == 0
    finally:
        stub.shutdown()


def test_fanout_answers_equal_across_packages(ann_bank, tmp_path):
    """Both routers over the same 3 shard backends (the port's AnnShard) on
    32 queries: the same bodies, each equal to the full index's class."""
    port = _pkg("moco_tpu_torch")
    features, full, parts = _shards(port, ann_bank, 3)
    current = {}
    backends = [_shard_backend(lambda: current["q"], p) for p in parts]
    ports = [b.server_address[1] for b in backends]
    fleets = {name: _router_fleet(_pkg(name), tmp_path / name, ports, ann_shards=3)
              for name in PACKAGES}
    try:
        for i in range(0, 256, 8):
            current["q"] = _query(features, i).tolist()
            answers = {name: fleets[name].router_proxy("/v1/knn", b'{"pixels": [0]}')
                       for name in PACKAGES}
            assert answers["moco_tpu_torch"] == answers["moco_tpu"]
            status, body = answers["moco_tpu_torch"]
            assert status == 200
            assert json.loads(body)["class"] == full.classify(
                np.asarray(current["q"], np.float32))[0]
    finally:
        for b in backends:
            b.shutdown()


# ---------------------------------------------------------------------------
# router_stats, validation and exit codes
# ---------------------------------------------------------------------------


def _router_stats_record(pkg, tmp_path, ann_shards=0):
    fleet = pkg.fleet.FleetSupervisor(
        lambda *a: ["true"], replicas=2, telemetry_dir=str(tmp_path / "fleet_t"),
        policy=pkg.fleet.FleetPolicy(stats_every_secs=0.1), seed=0, ann_shards=ann_shards)
    fleet.r_requests, fleet.r_ok = 100, 90
    fleet.r_shed_no_backend, fleet.r_upstream_timeout = 4, 3
    fleet.r_upstream_error, fleet.r_deadline_router = 2, 1
    for v in (0.010, 0.020, 0.030):
        fleet._router_latency.observe(v)
    if ann_shards:
        fleet._knn_merge.observe(0.004)
    fleet._emit_router_stats(final=True)
    (rec,) = [json.loads(line) for line in open(tmp_path / "fleet_t" / "events.jsonl")]
    return fleet, rec


def test_router_stats_record_schema(pkg, tmp_path):
    fleet, rec = _router_stats_record(pkg, tmp_path)
    assert rec["kind"] == "fleet" and rec["event"] == "router_stats"
    for key in ("requests", "ok", "retries", "retry_ok", "shed_no_backend",
                "upstream_timeout", "upstream_error", "shed_deadline_router",
                "passthrough_non_200", "outstanding", "healthy", "replicas", "interval_s",
                "run_id"):
        assert key in rec, key
    assert rec["requests"] == 100 and rec["shed_deadline_router"] == 1
    assert rec["latency_ms"]["p50"] == pytest.approx(20.0)
    assert rec["window"] == 3
    assert rec["run_id"] == fleet.run_id and rec["trace_id"] == fleet.tracer.trace_id
    from tools.telemetry_report import summarize

    flt = summarize([rec])["fleet"]
    assert flt["router"]["outstanding"] == 0
    assert flt["router"]["latency_ms"]["p95"] == pytest.approx(30.0)
    assert flt["router"]["shed_rate"] == pytest.approx(0.1)


@pytest.mark.parametrize("ann_shards", [0, 2])
def test_router_stats_keys_equal_across_packages(ann_shards, tmp_path):
    recs = {name: _router_stats_record(_pkg(name), tmp_path / name, ann_shards)[1]
            for name in PACKAGES}
    jax_rec, port_rec = recs["moco_tpu"], recs["moco_tpu_torch"]
    assert list(port_rec) == list(jax_rec)  # the same keys in the same order
    # run and trace ids and the wall clock are each fleet's own
    for key in ("t", "run_id", "trace_id"):
        jax_rec.pop(key), port_rec.pop(key)
    assert port_rec == jax_rec
    assert ("knn_merge_ms" in port_rec) == bool(ann_shards)


def test_policy_and_replica_state_defaults_equal_across_packages():
    jfleet, tfleet = _pkg("moco_tpu").fleet, _pkg("moco_tpu_torch").fleet
    import dataclasses

    assert dataclasses.asdict(tfleet.FleetPolicy()) == dataclasses.asdict(jfleet.FleetPolicy())
    rng_j, rng_t = random.Random(1), random.Random(1)
    assert [tfleet.FleetPolicy().backoff_secs(n, rng_t) for n in range(8)] == \
        [jfleet.FleetPolicy().backoff_secs(n, rng_j) for n in range(8)]
    jr = jfleet.ReplicaState(3, "h", 9, "/t", budget=5)
    tr = tfleet.ReplicaState(3, "h", 9, "/t", budget=5)
    assert vars(tr) == vars(jr) and tr.snapshot() == jr.snapshot()
    for name in ("SHED_NO_BACKEND", "SHED_UPSTREAM_TIMEOUT", "SHED_UPSTREAM_ERROR",
                 "SHED_DEADLINE_ROUTER", "EVENTS_FILENAME", "_EXPORT_SUFFIXES"):
        assert getattr(tfleet, name) == getattr(jfleet, name), name
    assert tfleet.AutoscaleController.SHED_KEYS == jfleet.AutoscaleController.SHED_KEYS


def test_fleet_constructor_validates_shards_and_autoscale(pkg, tmp_path):
    def mk(**kw):
        return pkg.fleet.FleetSupervisor(
            lambda *a: ["true"], replicas=kw.pop("replicas", 2),
            telemetry_dir=str(tmp_path / "t"),
            policy=pkg.fleet.FleetPolicy(**FAST_POLICY, **kw.pop("policy", {})), **kw)

    with pytest.raises(ValueError, match="replicas"):
        mk(replicas=0)
    with pytest.raises(ValueError, match="ann_shards"):
        mk(ann_shards=-1)
    with pytest.raises(ValueError, match="ann_shards"):
        mk(replicas=2, ann_shards=3)
    with pytest.raises(ValueError, match="autoscale_min"):
        mk(policy=dict(autoscale_max=4, autoscale_min=0))
    with pytest.raises(ValueError, match="autoscale_max"):
        mk(replicas=3, policy=dict(autoscale_max=2))
    mk(replicas=2, ann_shards=2, policy=dict(autoscale_max=4))  # clean


def test_fleet_bind_exit_code_is_fatal(pkg):
    assert pkg.exitcodes.EXIT_FLEET_BIND == 48
    cls, _detail = pkg.supervisor.classify_exit(48)
    assert cls == "fleet_bind" and "fleet_bind" in pkg.supervisor.FATAL_CLASSES


@pytest.mark.parametrize("flags", [
    ("--ann-shards", "-1"),
    ("--replicas", "2", "--ann-shards", "4"),
    ("--autoscale-max", "1", "--replicas", "2"),
    ("--autoscale-max", "2", "--autoscale-min", "0"),
    ("--autoscale-max", "2", "--autoscale-up-after", "0"),
    ("--replicas", "0"),
])
def test_serve_fleet_cli_bad_flags_exit_45(pkg, flags, tmp_path):
    assert pkg.cli_main()(["--telemetry-dir", str(tmp_path / "t"), "--port", "0", *flags,
                           "--", "true"]) == 45


def test_serve_fleet_cli_bind_failure_exits_48(pkg, tmp_path):
    main = pkg.cli_main()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        taken = s.getsockname()[1]
        assert main(["--replicas", "1", "--port", str(taken),
                     "--telemetry-dir", str(tmp_path / "t"), "--", "true"]) == 48
    # no replica command at all: a config error
    assert main(["--replicas", "1", "--telemetry-dir", str(tmp_path / "t2")]) == 45


def test_serve_fleet_cli_unspawnable_replica_exits_45_not_48(pkg, tmp_path):
    assert pkg.cli_main()(["--replicas", "2", "--port", "0",
                           "--telemetry-dir", str(tmp_path / "t"), "--",
                           str(tmp_path / "no_such_binary")]) == 45


def test_serve_fleet_cli_exits_1_when_every_replica_is_abandoned(pkg, tmp_path):
    """A replica command that dies at once, with no restart budget: the
    fleet gives up and the CLI exits 1."""
    cli = ([sys.executable, os.path.join(REPO, "tools", "serve_fleet.py")]
           if pkg.name == "moco_tpu" else [sys.executable, "-m", "moco_tpu_torch.serve_fleet"])
    proc = subprocess.run(
        cli + ["--replicas", "1", "--port", "0", "--telemetry-dir", str(tmp_path / "t"),
               "--max-restarts", "0", "--probe-secs", "0.1", "--", sys.executable, "-c",
               "import sys; sys.exit(1)"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "every replica abandoned" in proc.stdout + proc.stderr
    events = [json.loads(ln)["event"] for ln in open(tmp_path / "t" / "events.jsonl")]
    assert "fleet_give_up" in events and events[-1] == "fleet_stop"


def test_serve_fleet_cli_flags_and_defaults_equal_the_tool():
    """Every flag of `tools/serve_fleet.py`, with the same default."""
    tool = _load_tool("serve_fleet").build_parser()
    port = importlib.import_module("moco_tpu_torch.serve_fleet").build_parser()

    def flags(p):
        return {a.dest: (sorted(a.option_strings), a.default, a.type, a.nargs)
                for a in p._actions if a.dest != "help"}

    assert flags(port) == flags(tool)


def test_serve_fleet_module_entry_point_exits_45(tmp_path):
    """`python -m moco_tpu_torch.serve_fleet` with a bad flag: 45, before
    it binds or spawns anything."""
    proc = subprocess.run(
        [sys.executable, "-m", "moco_tpu_torch.serve_fleet", "--telemetry-dir",
         str(tmp_path / "t"), "--ann-shards", "-1", "--", "true"],
        capture_output=True, text=True, timeout=60, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 45, proc.stdout + proc.stderr
    assert "config error" in proc.stdout + proc.stderr
