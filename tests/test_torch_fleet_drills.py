"""Drills of the port's fleet supervisor (`moco_tpu_torch/serve/fleet.py`)
with the reference's stub replicas: the real supervision loop, router and
watcher driving tiny stdlib HTTP children, so each drill costs seconds. Each
test asserts what its counterpart in `tests/test_fleet.py` or
`tests/test_serve_scale.py` asserts:

- a crash loop exhausts the restart budget and the fleet fails;
- a wedge (accepting, never answering) is found by the probe, escalated
  SIGTERM -> SIGKILL, classified a hang and restarted;
- a rolling restart under load keeps N-1 replicas and loses nothing;
- a SIGKILL under 32 closed-loop clients loses no request, and the
  fleet's records render through `tools/telemetry_report.py`;
- the watcher's reload roll, the quarantine of a torn step, and a killed
  replica relaunched on the deployed payload;
- a roll skips a replica abandoned after it began;
- the autoscaler's scale-up, its drain-then-reap (never relaunched), and
  a load-driven surge up and back down;
- `python -m moco_tpu_torch.serve_fleet` itself: it routes, rolls the
  replicas on SIGHUP, drains on SIGTERM or SIGINT and exits 0.

Every wait is on a condition with its own time limit, and the policy's
probe windows leave room for a loaded host: a drill never depends on a
fixed sleep.
"""

from __future__ import annotations

import importlib.util
import json
import os
import signal
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request

import pytest

from moco_tpu_torch.resilience.chaos import truncate_checkpoint
from moco_tpu_torch.resilience.integrity import manifest_path, write_manifest
from moco_tpu_torch.serve.fleet import FleetPolicy, FleetSupervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 60.0  # the limit of every wait: generous, the waits return when met


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


serve_bench = _load_tool("serve_bench")
telemetry_report = _load_tool("telemetry_report")

# the reference's fast policy, with probe windows a loaded host still meets
# (a stub starved of the CPU for a second must not be killed as wedged)
DRILL_POLICY = dict(
    probe_secs=0.1, probe_timeout_s=2.0, health_stale_secs=6.0,
    startup_grace_secs=30.0, term_grace_secs=1.0,
    backoff_base_secs=0.05, backoff_max_secs=0.2, backoff_jitter=0.0,
    request_timeout_s=10.0, watch_poll_secs=0.1, stats_every_secs=1.0,
)

# the reference's stub replica (tests/test_fleet.py)
_STUB_REPLICA = textwrap.dedent("""\
    import argparse, json, os, signal, sys, threading, time
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--telemetry-dir", required=True)
    p.add_argument("--pretrained", default="boot")
    p.add_argument("--behavior", default="ok")
    args, _ = p.parse_known_args()

    state = {"draining": False, "wedged": False, "requests": 0,
             "pretrained": args.pretrained, "reloads": 0}

    if args.behavior == "exit1":
        sys.exit(1)
    wedge_after = None
    if args.behavior.startswith("wedge_after="):
        wedge_after = int(args.behavior.split("=")[1])
        signal.signal(signal.SIGTERM, signal.SIG_IGN)

    class H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        def log_message(self, *a):
            pass
        def _send(self, status, obj):
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        def _wedge(self):
            while state["wedged"]:
                time.sleep(3600.0)
        def do_GET(self):
            self._wedge()
            if self.path == "/healthz":
                if state["draining"]:
                    self._send(503, {"status": "draining"})
                else:
                    self._send(200, {"status": "ok"})
            elif self.path == "/stats":
                self._send(200, dict(state, pid=os.getpid()))
            else:
                self._send(404, {"error": "not_found"})
        def do_POST(self):
            self._wedge()
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n)
            if self.path == "/admin/reload":
                req = json.loads(body or b"{}")
                if not req.get("pretrained"):
                    self._send(400, {"error": "bad_request"})
                    return
                state["pretrained"] = req["pretrained"]
                state["reloads"] += 1
                self._send(200, {"status": "reloaded", "step": req.get("step")})
                return
            if self.path in ("/v1/embed", "/v1/knn"):
                state["requests"] += 1
                if wedge_after is not None and state["requests"] >= wedge_after:
                    state["wedged"] = True
                if state["draining"]:
                    self._send(503, {"error": "draining"})
                    return
                self._send(200, {"embedding": [1.0, float(args.port)],
                                 "cached": False, "pretrained": state["pretrained"]})
                return
            self._send(404, {"error": "not_found"})

    class S(ThreadingHTTPServer):
        daemon_threads = True
        request_queue_size = 128

    srv = S(("127.0.0.1", args.port), H)
    stop = threading.Event()
    def term(signum, frame):
        state["draining"] = True
        stop.set()
    if wedge_after is None:
        signal.signal(signal.SIGTERM, term)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    while not stop.is_set():
        time.sleep(0.02)
    time.sleep(0.05)
    srv.shutdown()
    sys.exit(0)
""")

# the reference's autoscale stub (tests/test_serve_scale.py)
_SCALE_STUB = textwrap.dedent("""\
    import argparse, json, os, signal, sys, threading, time
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--telemetry-dir", required=True)
    p.add_argument("--pretrained", default="boot")
    p.add_argument("--sleep-s", type=float, default=0.0)
    args, _ = p.parse_known_args()

    class H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        def log_message(self, *a):
            pass
        def _send(self, status, obj):
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok"})
            else:
                self._send(404, {"error": "not_found"})
        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length") or 0))
            if args.sleep_s:
                time.sleep(args.sleep_s)
            self._send(200, {"embedding": [1.0, float(args.port)], "cached": False})

    class S(ThreadingHTTPServer):
        daemon_threads = True
        request_queue_size = 128

    srv = S(("127.0.0.1", args.port), H)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda s, f: stop.set())
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    stop.wait()
    time.sleep(0.05)
    srv.shutdown()
    sys.exit(0)
""")


def _stub_fleet(tmp_path, n=2, behavior="ok", watch_dir="", **policy_kw):
    stub = tmp_path / "stub_replica.py"
    stub.write_text(_STUB_REPLICA)
    kw = dict(DRILL_POLICY)
    kw.update(policy_kw)

    def child_argv(index, port, tdir, pretrained):
        argv = [sys.executable, str(stub), "--port", str(port), "--telemetry-dir", tdir,
                "--behavior", behavior if index == 0 else "ok"]
        if pretrained:
            argv += ["--pretrained", pretrained]
        return argv

    return FleetSupervisor(child_argv, replicas=n, telemetry_dir=str(tmp_path / "fleet_t"),
                           policy=FleetPolicy(**kw), watch_dir=watch_dir, seed=0)


def _scale_fleet(tmp_path, n=1, sleep_s=0.0, **policy_kw):
    stub = tmp_path / "scale_stub.py"
    stub.write_text(_SCALE_STUB)
    kw = dict(DRILL_POLICY)
    kw.update(policy_kw)

    def child_argv(index, port, tdir, pretrained, bank=None, shard=None):
        return [sys.executable, str(stub), "--port", str(port), "--telemetry-dir", tdir,
                "--sleep-s", str(sleep_s)]

    return FleetSupervisor(child_argv, replicas=n, telemetry_dir=str(tmp_path / "fleet_t"),
                           policy=FleetPolicy(**kw), seed=0)


def _wait(cond, timeout_s=WAIT_S, msg="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out after {timeout_s} s waiting for {msg}")


def _post(url, body, timeout=10.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _export_step(watch_dir, step, payload=b"w" * 4096, torn=False):
    """A step made whole in a staging directory (torn after its manifest
    when asked) and moved into the watch directory, its manifest last: the
    watcher polls every 0.1 s and must never see it half written, or see a
    step meant to be torn before the tear."""
    stage = watch_dir.parent / f"stage_{step}"
    (stage / str(step)).mkdir(parents=True)
    (stage / str(step) / "encoder.npz").write_bytes(payload)
    write_manifest(str(stage), step)
    if torn:
        truncate_checkpoint(str(stage), step)
    os.rename(stage / str(step), watch_dir / str(step))
    os.makedirs(os.path.dirname(manifest_path(str(watch_dir), step)), exist_ok=True)
    os.rename(manifest_path(str(stage), step), manifest_path(str(watch_dir), step))
    return str(watch_dir / str(step) / "encoder.npz")


def _healthy(fleet):
    return sum(1 for r in fleet.replicas if r.healthy and not r.draining)


# ---------------------------------------------------------------------------
# supervision
# ---------------------------------------------------------------------------


def test_e2e_crash_loop_exhausts_budget_and_fleet_fails(tmp_path):
    fleet = _stub_fleet(tmp_path, n=1, behavior="exit1", max_restarts=2)
    fleet.start()
    try:
        _wait(lambda: fleet.failed, msg="fleet_give_up")
        r = fleet.replicas[0]
        assert r.abandoned and r.launches == 3  # the first launch and 2 restarts
        events = [e["event"] for e in fleet.incidents]
        assert "give_up" in events and "fleet_give_up" in events
        assert all(c == "crash" for c in r.classifications)
    finally:
        fleet.stop()


def test_e2e_wedge_is_probe_detected_killed_and_restarted(tmp_path):
    """After the wedge the probes stop answering; the fleet ejects,
    escalates SIGTERM (ignored) -> SIGKILL, classifies the death a hang and
    restores the replica, while the other replica serves throughout."""
    fleet = _stub_fleet(tmp_path, n=2, behavior="wedge_after=3", term_grace_secs=0.5,
                        probe_timeout_s=0.5, health_stale_secs=2.0)
    fleet.start()
    try:
        _wait(lambda: fleet.healthy_count() == 2, msg="fleet healthy")
        wedge_port = fleet.replicas[0].port
        for _ in range(3):  # at the wedging replica's own port
            _post(f"http://127.0.0.1:{wedge_port}/v1/embed", {"pixels": [1]})
        status, _ = _post(fleet.router.url + "/v1/embed", {"pixels": [1]})
        assert status == 200
        _wait(lambda: "hang" in fleet.replicas[0].classifications,
              msg="wedge killed and classified hang")
        _wait(lambda: fleet.healthy_count() == 2, msg="wedged replica restored")
        events = [e["event"] for e in fleet.incidents]
        assert "eject" in events and "kill" in events
        kills = [e for e in fleet.incidents if e["event"] == "kill"]
        assert any(k.get("phase") == "sigkill" for k in kills)
    finally:
        # the relaunched replica 0 wedges again and ignores SIGTERM: a short
        # drain window before the stop's SIGKILL
        fleet.stop(timeout_s=0.5)


def test_e2e_rolling_restart_keeps_capacity_under_load(tmp_path):
    fleet = _stub_fleet(tmp_path, n=2)
    fleet.start()
    try:
        _wait(lambda: fleet.healthy_count() == 2, msg="fleet healthy")
        pids_before = [r.pid for r in fleet.replicas]
        result = {}

        def load():
            result.update(serve_bench.run_load(fleet.router.url, concurrency=8,
                                               total_requests=400, image_size=8, pool=4,
                                               timeout_s=15.0))

        loader = threading.Thread(target=load)
        loader.start()
        assert fleet.rolling_restart(timeout_s=WAIT_S)
        loader.join(timeout=WAIT_S)
        assert not loader.is_alive()
        assert result["lost"] == 0, result["lost_detail"]
        assert fleet.r_shed_no_backend == 0  # capacity never reached zero
        assert all(a != b for a, b in zip(pids_before, [r.pid for r in fleet.replicas]))
        _wait(lambda: fleet.healthy_count() == 2, msg="both replicas back")
        events = [e["event"] for e in fleet.incidents]
        assert events.count("roll_replica") >= 4  # drain and done a replica
        assert "roll_end" in events
    finally:
        fleet.stop()


def test_e2e_kill_drill_32_clients_zero_lost(tmp_path):
    """32 closed-loop clients, SIGKILL one of two replicas mid-load: zero
    lost, the fleet restores N, every transition is a `kind:"fleet"` record
    under ONE run_id, and the report renders the fleet from its directory."""
    fleet = _stub_fleet(tmp_path, n=2)
    fleet.start()
    try:
        _wait(lambda: fleet.healthy_count() == 2, msg="fleet healthy")
        victim_pid = fleet.replicas[0].pid
        done = threading.Event()
        killed = {}

        def killer():
            # mid-load, not before it: once the router has answered 64
            _wait(lambda: fleet.r_ok >= 64 or done.is_set(), msg="load under way")
            if not done.is_set():
                os.kill(victim_pid, signal.SIGKILL)
                killed["pid"] = victim_pid

        kt = threading.Thread(target=killer)
        kt.start()
        summary = serve_bench.run_load(fleet.router.url, concurrency=32, total_requests=1024,
                                       image_size=8, pool=4, timeout_s=15.0)
        done.set()
        kt.join(timeout=5.0)
        assert killed["pid"] == victim_pid
        assert summary["lost"] == 0, summary["lost_detail"]
        assert summary["resolved"] == summary["sent"] == 1024
        assert summary["ok"] >= 1000  # at most a few structured sheds
        _wait(lambda: "killed" in fleet.replicas[0].classifications,
              msg="death observed and classified")
        _wait(lambda: fleet.healthy_count() == 2, msg="fleet restored to N replicas")
    finally:
        fleet.stop()

    events_path = os.path.join(str(tmp_path / "fleet_t"), "events.jsonl")
    records = [json.loads(ln) for ln in open(events_path) if ln.strip()]
    fleet_records = [r for r in records if r.get("kind") == "fleet"]
    assert {r["run_id"] for r in fleet_records} == {fleet.run_id}
    events = [r["event"] for r in fleet_records]
    for expected in ("fleet_start", "launch", "replica_exit", "replica_healthy",
                     "router_stats", "fleet_stop"):
        assert expected in events, expected
    pairs = telemetry_report.expand_events_arg(str(tmp_path / "fleet_t"))
    assert ("fleet", events_path) in pairs
    records, _ = telemetry_report.load_events_multi(pairs)
    flt = telemetry_report.summarize(records)["fleet"]
    assert flt["size"] == 2
    assert flt["replicas"][0]["restarts"] >= 1
    assert "killed" in flt["replicas"][0]["classifications"]
    assert flt["router"]["requests"] >= 1024
    rendered = telemetry_report.render(telemetry_report.summarize(records))
    assert "fleet:" in rendered and "replica 0:" in rendered


# ---------------------------------------------------------------------------
# the reload roll
# ---------------------------------------------------------------------------


def test_e2e_reload_roll_and_relaunch_convergence(tmp_path):
    """A verified step rolls across every replica via /admin/reload; a
    truncated later step is quarantined and never deployed; a replica
    KILLED after the roll comes back booted on the deployed payload."""
    watch = tmp_path / "export"
    watch.mkdir()
    fleet = _stub_fleet(tmp_path, n=2, watch_dir=str(watch))
    fleet.start()
    try:
        _wait(lambda: fleet.healthy_count() == 2, msg="fleet healthy")
        payload = _export_step(watch, 100)
        _wait(lambda: all(r.deployed_step == 100 for r in fleet.replicas),
              msg="reload rolled to both replicas")
        _wait(lambda: any(e["event"] == "reload_done" for e in fleet.incidents),
              msg="reload_done")
        events = [e["event"] for e in fleet.incidents]
        assert "reload_detected" in events
        assert events.count("reload_replica") == 2
        seen = set()
        for _ in range(8):
            _, resp = _post(fleet.router.url + "/v1/embed", {"pixels": [1]})
            seen.add(resp["pretrained"])
        assert seen == {payload}

        _export_step(watch, 200, torn=True)
        _wait(lambda: any(e["event"] == "reload_quarantine" for e in fleet.incidents),
              msg="truncated step quarantined")
        assert fleet._target_step == 100
        assert os.path.isdir(str(watch / ".quarantine" / "200"))

        os.kill(fleet.replicas[1].pid, signal.SIGKILL)
        _wait(lambda: "killed" in fleet.replicas[1].classifications, msg="death observed")
        _wait(lambda: fleet.healthy_count() == 2, msg="replica restored")
        with urllib.request.urlopen(f"http://127.0.0.1:{fleet.replicas[1].port}/stats",
                                    timeout=5) as r:
            stats = json.loads(r.read())
        assert stats["pretrained"] == payload
        assert fleet.replicas[1].deployed_step == 100
    finally:
        fleet.stop()


def test_roll_skips_abandoned_replica_instead_of_wedging(tmp_path):
    fleet = _stub_fleet(tmp_path, n=2)
    fleet.start()
    try:
        _wait(lambda: fleet.healthy_count() == 2, msg="fleet healthy")
        pid1 = fleet.replicas[1].pid
        with fleet._lock:
            fleet.replicas[0].abandoned = True
            fleet._roll = {"queue": [0, 1], "idx": None, "phase": "await", "t": 0.0}
        _wait(lambda: any(e["event"] == "roll_end" for e in fleet.incidents),
              msg="roll completed despite abandonment")
        assert fleet.replicas[1].pid != pid1
        skipped = [e for e in fleet.incidents
                   if e["event"] == "roll_replica" and e.get("phase") == "skipped"]
        assert skipped and skipped[0]["replica"] == 0
    finally:
        fleet.stop()


# ---------------------------------------------------------------------------
# the autoscaler
# ---------------------------------------------------------------------------


def test_scale_up_then_drain_reap_mechanics(tmp_path):
    """_scale_up spawns a replica on a fresh index; _scale_down drain-reaps
    the highest index and it is NEVER relaunched; indices are not reused."""
    fleet = _scale_fleet(tmp_path, n=1, autoscale_max=3, autoscale_cooldown_s=0.1,
                         autoscale_down_after=50)
    fleet.start()
    try:
        _wait(lambda: _healthy(fleet) == 1, msg="boot replica healthy")
        fleet._scale_up("test breach")
        _wait(lambda: _healthy(fleet) == 2, msg="scaled-up replica")
        assert [r.index for r in fleet.replicas] == [0, 1]
        fleet._scale_down("test idle")
        _wait(lambda: len(fleet.replicas) == 1, msg="victim reaped")
        assert fleet.replicas[0].index == 0
        # a reaped replica must not come back: held over several monitor passes
        deadline = time.monotonic() + 0.5
        while time.monotonic() < deadline:
            assert len(fleet.replicas) == 1
            time.sleep(0.05)
        events = [e["event"] for e in fleet.incidents]
        assert "autoscale_up" in events and "autoscale_down" in events
        fleet._scale_up("again")
        _wait(lambda: _healthy(fleet) == 2, msg="third replica")
        assert [r.index for r in fleet.replicas] == [0, 2]
    finally:
        fleet.stop()


def test_e2e_load_driven_scale_up_and_down(tmp_path):
    """A closed-loop surge drives outstanding/healthy over the breach line
    and capacity follows; the load stops and the fleet reaps back to its
    floor. Every request resolves structured through both transitions."""
    fleet = _scale_fleet(tmp_path, n=1, sleep_s=0.2, stats_every_secs=0.25,
                         autoscale_max=2, autoscale_cooldown_s=0.5, autoscale_up_after=2,
                         autoscale_down_after=2, autoscale_outstanding_high=2.0,
                         autoscale_idle_low=0.5)
    fleet.start()
    outcomes = {"ok": 0, "structured": 0, "lost": 0}
    lock = threading.Lock()
    stop = threading.Event()

    def client():
        while not stop.is_set():
            status, body = fleet.router_proxy("/v1/embed", b'{"pixels": [0], "tier": "batch"}')
            try:
                resp = json.loads(body)
            except ValueError:
                resp = None
            with lock:
                if status == 200 and isinstance(resp, dict):
                    outcomes["ok"] += 1
                elif isinstance(resp, dict) and "error" in resp:
                    outcomes["structured"] += 1
                else:
                    outcomes["lost"] += 1

    clients = [threading.Thread(target=client, daemon=True) for _ in range(6)]
    try:
        _wait(lambda: _healthy(fleet) == 1, msg="boot replica healthy")
        for t in clients:
            t.start()
        _wait(lambda: _healthy(fleet) == 2, msg="load-driven scale-up")
        stop.set()
        for t in clients:
            t.join(timeout=WAIT_S)
        _wait(lambda: len(fleet.replicas) == 1, msg="idle-driven drain-reap")
        assert outcomes["lost"] == 0, outcomes
        assert outcomes["ok"] > 0
        events = [e["event"] for e in fleet.incidents]
        assert "autoscale_up" in events and "autoscale_reaped" in events
    finally:
        stop.set()
        fleet.stop()


@pytest.mark.parametrize("signum", [signal.SIGTERM, signal.SIGINT])
def test_serve_fleet_cli_drains_on_signal_and_exits_0(tmp_path, signum):
    """`python -m moco_tpu_torch.serve_fleet` over stub replicas: it
    announces the router, routes, drains on the signal and exits 0."""
    import subprocess

    stub = tmp_path / "stub_replica.py"
    stub.write_text(_STUB_REPLICA)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "moco_tpu_torch.serve_fleet", "--replicas", "2",
         "--port", "0", "--telemetry-dir", str(tmp_path / "t"), "--probe-secs", "0.1",
         "--stats-every-secs", "1", "--", sys.executable, str(stub)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    try:
        url = None
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and url is None:
            line = proc.stdout.readline()
            if not line:
                break
            if "fleet serving on http://" in line:
                url = "http://" + line.split("http://")[1].split()[0]
        assert url, "the fleet never announced its router"
        _wait(lambda: json.loads(urllib.request.urlopen(url + "/stats", timeout=5).read())
              ["replicas"][1]["healthy"], msg="replicas healthy")
        status, resp = _post(url + "/v1/embed", {"pixels": [1]})
        assert status == 200 and resp["embedding"][0] == 1.0
        proc.send_signal(signum)
        out, _ = proc.communicate(timeout=WAIT_S)
        assert proc.returncode == 0, out
        assert "fleet drained cleanly" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)


def test_serve_fleet_cli_sighup_rolls_the_replicas(tmp_path):
    """SIGHUP to `python -m moco_tpu_torch.serve_fleet`: a drain-aware
    rolling restart (every replica's pid changes, `roll_end` recorded),
    then SIGTERM drains and the exit is 0."""
    import subprocess

    stub = tmp_path / "stub_replica.py"
    stub.write_text(_STUB_REPLICA)
    tel = tmp_path / "t"
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "moco_tpu_torch.serve_fleet", "--replicas", "2",
         "--port", "0", "--telemetry-dir", str(tel), "--probe-secs", "0.1",
         "--term-grace-secs", "2", "--", sys.executable, str(stub)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    try:
        url = None
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and url is None:
            line = proc.stdout.readline()
            if not line:
                break
            if "fleet serving on http://" in line:
                url = "http://" + line.split("http://")[1].split()[0]
        assert url, "the fleet never announced its router"
        threading.Thread(target=proc.stdout.read, daemon=True).start()

        def replicas():
            return json.loads(urllib.request.urlopen(url + "/stats", timeout=5).read())[
                "replicas"]

        _wait(lambda: all(r["healthy"] for r in replicas()), msg="replicas healthy")
        pids = [r["pid"] for r in replicas()]
        proc.send_signal(signal.SIGHUP)

        def rolled():
            with open(tel / "events.jsonl") as f:
                return any(json.loads(ln).get("event") == "roll_end" for ln in f)

        _wait(rolled, msg="the rolling restart's end")
        _wait(lambda: all(r["healthy"] for r in replicas()), msg="replicas back")
        assert all(a != b for a, b in zip(pids, [r["pid"] for r in replicas()]))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=WAIT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
