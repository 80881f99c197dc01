"""Staging-server control plane: the stdlib supervisor half (port of
`moco_tpu/data/service/server.py`).

One staging server is TWO processes:

    python -m moco_tpu_torch.staging_server  ->  StagingServer (THIS module,
                                                 pure stdlib)
        |-- health HTTP endpoint (/healthz, /stats)
        `-- DECODE WORKER subprocess (`python -m
            moco_tpu_torch.data.service.worker`): numpy and the native
            chunked pool, binds the DATA port

The supervisor half imports the standard library alone, transitively (the
JAX package's `staging-server-stdlib-only` rule, held by
`tests/test_torch_isolation.py`): a wedged native decode, an OOM'd worker or
a poisoned import must leave a live process that still answers /healthz
503, classifies the death and relaunches within a budget. Supervision
follows the serving fleet's: `FleetPolicy` knobs, `ReplicaState`
bookkeeping, a probe ANSWER as the heartbeat (a `ping` frame on the data
port, so it exercises the real serving path and catches a worker that
accepts but does not answer), SIGTERM -> grace -> SIGKILL,
`resilience/supervisor.py::classify_exit` for the death's class, and
restart budgets refunded by a healthy life.

Lifecycle transitions land as `kind: "input_server"` records in the
server's events.jsonl, with the JAX package's fields, in the same stream
the worker appends its `stats` records to (O_APPEND whole lines interleave
safely across the two processes), so `tools/telemetry_report.py` folds one
story per server.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from moco_tpu_torch.data.service import protocol
from moco_tpu_torch.resilience.exitcodes import (
    EXIT_CONFIG_ERROR,
    EXIT_STAGING_BIND,
)
from moco_tpu_torch.resilience.supervisor import (
    CLASS_CLEAN,
    CLASS_CONFIG_ERROR,
    CLASS_STAGING_BIND,
    FATAL_CLASSES,
    classify_exit,
)
from moco_tpu_torch.serve.fleet import FleetPolicy, ReplicaState, pick_free_port
from moco_tpu_torch.telemetry.trace import Tracer
from moco_tpu_torch.utils.logging import log_event

EVENTS_FILENAME = "events.jsonl"

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


class _HealthServer(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 32


def _make_health_handler(server: "StagingServer"):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _send(self, status: int, obj: dict) -> None:
            body = json.dumps(obj).encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                healthy = server.worker_healthy()
                self._send(200 if healthy else 503, {
                    "status": "ok" if healthy else "worker_unhealthy",
                    "data_port": server.data_port,
                    "server_id": server.server_id,
                })
            elif self.path == "/stats":
                self._send(200, server.stats())
            else:
                self._send(404, {"error": "not_found", "path": self.path})

    return Handler


class StagingServer:
    """Supervise one decode-worker subprocess behind a health endpoint.

    `worker_args` is the dataset/decode argv tail forwarded verbatim to
    `python -m moco_tpu_torch.data.service.worker` (the CLI forwards the
    flags it does not know; tests pass it directly). `data_port=0` picks a
    free port, announced by `/healthz`, `/stats` and `self.data_port`.
    `telemetry_dir` (events.jsonl, worker.log, spans) defaults to a fresh
    temporary directory."""

    def __init__(self, worker_args: list[str], *, host: str = "127.0.0.1",
                 data_port: int = 0, health_port: int = 0,
                 telemetry_dir: str = "", server_id: int = 0,
                 policy: FleetPolicy | None = None,
                 env: dict | None = None, worker_python: str | None = None):
        self.worker_args = list(worker_args)
        self.host = host
        self.server_id = int(server_id)
        # no directory given: a fresh temporary one, not the working directory
        self.telemetry_dir = telemetry_dir or tempfile.mkdtemp(
            prefix=f"staging_server{server_id}_")
        self.policy = policy or FleetPolicy()
        self._env = env
        self._python = worker_python or sys.executable
        self.data_port = data_port or pick_free_port(host)
        self.events_path = os.path.join(self.telemetry_dir,
                                        EVENTS_FILENAME)
        os.makedirs(self.telemetry_dir, exist_ok=True)
        self.tracer = Tracer(self.telemetry_dir, "steps",
                             proc=f"staging-sup{server_id}")
        self.run_id = self.tracer.run_id
        self._lock = threading.Lock()
        self._emit_lock = threading.Lock()
        self.worker = ReplicaState(self.server_id, host, self.data_port,
                                   self.telemetry_dir,
                                   self.policy.max_restarts)
        self.last_worker_stats: dict = {}
        self.incidents: list[dict] = []
        self._stop = threading.Event()
        self._monitor: threading.Thread | None = None
        self._rng = random.Random()  # system entropy: no fleet lockstep
        # the health endpoint binds FIRST: an occupied port fails the CLI
        # with EXIT_STAGING_BIND before any subprocess exists
        self.health = _HealthServer((host, health_port),
                                    _make_health_handler(self))
        self.health_port = self.health.server_address[1]
        self._health_thread: threading.Thread | None = None

    # -- events --------------------------------------------------------------
    def _emit(self, event: str, **fields) -> None:
        record = {"v": 1, "t": round(time.time(), 3),
                  "kind": "input_server", "event": event,
                  "server_id": self.server_id, "run_id": self.run_id}
        record.update(fields)
        with self._emit_lock:
            self.incidents.append(record)
            protocol.append_jsonl(self.events_path, record)
        detail = " ".join(f"{k}={v}" for k, v in fields.items())
        log_event("input_server", f"{event} {detail}".strip())

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self._emit("server_start", data_port=self.data_port,
                   health_port=self.health_port)
        self._launch()
        self._health_thread = threading.Thread(
            target=self.health.serve_forever, daemon=True,
            name="staging-health")
        self._health_thread.start()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True,
                                         name="staging-monitor")
        self._monitor.start()

    def stop(self, timeout_s: float = 15.0) -> None:
        """Drain-stop: SIGTERM the worker (it finishes in-flight shards),
        escalate a straggler, release the health port."""
        if self._stop.is_set():
            return
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
        r = self.worker
        with self._lock:
            r.expected_exit = True
        if r.alive():
            r.proc.terminate()
            deadline = time.monotonic() + timeout_s
            while r.proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if r.proc.poll() is None:
                r.proc.kill()
                r.proc.wait()
        self._emit("server_stop", launches=r.launches)
        if self._health_thread is not None:
            self.health.shutdown()
            self._health_thread.join(timeout=5.0)
            self._health_thread = None
        self.health.server_close()
        self.tracer.close()

    # the loaders' names: a construction closes in a finally
    def close(self) -> None:
        self.stop()

    def close_quietly(self) -> None:
        try:
            self.stop()
        except Exception as e:  # noqa: BLE001 — teardown must not unwind
            log_event("input_server", f"stop failed (ignored): {e!r}")

    # -- worker lifecycle ----------------------------------------------------
    def _worker_argv(self) -> list[str]:
        return [self._python, "-m", "moco_tpu_torch.data.service.worker",
                *self.worker_args,
                "--host", self.host, "--port", str(self.data_port),
                "--server-id", str(self.server_id),
                "--telemetry-dir", self.telemetry_dir]

    def _launch(self) -> None:
        r = self.worker
        env = dict(os.environ if self._env is None else self._env)
        env["PYTHONPATH"] = _REPO_ROOT + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        env.update(self.tracer.child_env())
        log_file = open(os.path.join(self.telemetry_dir, "worker.log"),
                        "ab")
        try:
            proc = subprocess.Popen(self._worker_argv(), stdout=log_file,
                                    stderr=subprocess.STDOUT, env=env)
        finally:
            log_file.close()
        now = time.monotonic()
        with self._lock:
            r.proc = proc
            r.pid = proc.pid
            r.launches += 1
            r.launched_at = now
            r.last_ok_life = None
            r.ever_healthy_life = False
            r.healthy = False
            r.kill_phase = None
            r.relaunch_at = None
            r.expected_exit = False
        self._emit("launch", attempt=r.launches - 1, pid=proc.pid,
                   data_port=self.data_port, budget_left=r.budget)

    def _handle_exit(self) -> None:
        r = self.worker
        rc = r.proc.returncode
        hang = r.kill_phase is not None
        cls, detail = classify_exit(rc, hang_killed=hang)
        now = time.monotonic()
        with self._lock:
            expected = r.expected_exit
            progressed = r.ever_healthy_life
            pid = r.pid
            r.proc = None
            r.healthy = False
            r.kill_phase = None
            r.expected_exit = False
            r.classifications.append(cls)
        self._emit("worker_exit", pid=pid, returncode=rc,
                   classification=cls, detail=detail,
                   progressed=progressed, expected=expected)
        if expected:
            return
        if cls in FATAL_CLASSES and cls != CLASS_CLEAN:
            # a staging server exists to serve: an unexpected clean exit
            # restarts (the fleet rule), real fatals abandon
            with self._lock:
                r.abandoned = True
            self._emit("give_up", reason=f"fatal class {cls}",
                       returncode=rc)
            return
        delay = 0.0
        with self._lock:
            if progressed:
                r.budget = self.policy.max_restarts
                r.consecutive_failures = 0
            else:
                r.consecutive_failures += 1
                if r.budget <= 0:
                    r.abandoned = True
                else:
                    r.budget -= 1
                    delay = self.policy.backoff_secs(
                        r.consecutive_failures, self._rng)
            abandoned = r.abandoned
            if not abandoned:
                r.relaunch_at = now + delay
        if abandoned:
            self._emit("give_up",
                       reason=(f"restart budget exhausted: "
                               f"{r.consecutive_failures} consecutive "
                               f"never-healthy deaths"))
        elif delay:
            self._emit("backoff", secs=round(delay, 3),
                       budget_left=r.budget)

    def _probe_and_update(self) -> None:
        r = self.worker
        stats = protocol.ping(self.host, self.data_port,
                              timeout_s=self.policy.probe_timeout_s)
        now = time.monotonic()
        if stats is not None:
            with self._lock:
                r.last_ok_life = now
                newly = not r.healthy
                r.healthy = True
                was_ever = r.ever_healthy_life
                r.ever_healthy_life = True
                self.last_worker_stats = stats
            if newly:
                self._emit("readmit" if was_ever else "worker_healthy",
                           pid=r.pid, shards=stats.get("shards", 0))
        else:
            with self._lock:
                was = r.healthy
                r.healthy = False
            if was:
                self._emit("eject", reason="probe failed")

    def _check_staleness(self, now: float) -> None:
        r = self.worker
        if r.expected_exit or not r.alive():
            return
        if r.kill_phase == "term":
            if now - r.term_at > self.policy.term_grace_secs:
                self._emit("kill", pid=r.pid, phase="sigkill",
                           reason="probe_stale")
                r.proc.kill()
                with self._lock:
                    r.kill_phase = "kill"
            return
        if r.kill_phase is not None:
            return
        ref = r.last_ok_life if r.last_ok_life is not None else r.launched_at
        window = (self.policy.health_stale_secs
                  if r.last_ok_life is not None
                  else self.policy.startup_grace_secs)
        stale_for = now - ref
        if stale_for > window:
            self._emit("kill", pid=r.pid, phase="sigterm",
                       reason="probe_stale",
                       stale_secs=round(stale_for, 3))
            r.proc.terminate()
            with self._lock:
                r.kill_phase = "term"
                r.term_at = now

    def _monitor_loop(self) -> None:
        poll = max(min(self.policy.probe_secs / 2.0, 0.5), 0.02)
        last_probe = 0.0
        while not self._stop.is_set():
            now = time.monotonic()
            r = self.worker
            if r.abandoned:
                self._stop.wait(poll)
                continue
            if r.proc is None:
                with self._lock:
                    due = (r.relaunch_at is not None
                           and now >= r.relaunch_at)
                if due:
                    try:
                        self._launch()
                    except OSError as e:
                        with self._lock:
                            r.abandoned = True
                        self._emit("give_up",
                                   reason=f"relaunch failed to spawn: {e}")
            elif r.proc.poll() is not None:
                self._handle_exit()
            else:
                if now - last_probe >= self.policy.probe_secs:
                    last_probe = now
                    self._probe_and_update()
                self._check_staleness(time.monotonic())
            self._stop.wait(poll)

    # -- introspection -------------------------------------------------------
    def worker_healthy(self) -> bool:
        with self._lock:
            return self.worker.healthy and not self.worker.abandoned

    def abandoned_class(self) -> str | None:
        """The worker's terminal classification once abandoned (the CLI's
        exit-code source), else None."""
        with self._lock:
            if not self.worker.abandoned:
                return None
            return (self.worker.classifications[-1]
                    if self.worker.classifications else "abandoned")

    def exit_code(self) -> int:
        """Map an abandoned worker to the CLI's own exit code: the
        supervisor speaks for the server it fronts."""
        cls = self.abandoned_class()
        if cls == CLASS_STAGING_BIND:
            return EXIT_STAGING_BIND
        if cls == CLASS_CONFIG_ERROR:
            return EXIT_CONFIG_ERROR
        return 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "run_id": self.run_id,
                "server_id": self.server_id,
                "data_port": self.data_port,
                "worker": self.worker.snapshot(),
                "worker_stats": dict(self.last_worker_stats),
            }

    def wait_healthy(self, timeout_s: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.worker_healthy():
                return True
            if self.abandoned_class() is not None:
                return False
            time.sleep(0.05)
        return False
