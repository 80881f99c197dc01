"""The replicated serving fleet of the port (port of
`moco_tpu/serve/fleet.py`): N `python -m moco_tpu_torch.serve` replicas
behind one router, supervised the way the run supervisor supervises a
training run.

  - `FleetSupervisor` spawns N replicas on distinct ports and supervises
    them: per-replica `/healthz` probes (a probe answer is the replica's
    heartbeat; staleness beyond the window gets SIGTERM → grace →
    SIGKILL, the wedged-collective treatment), death classification
    through the shared exit-code protocol
    (`resilience/supervisor.py::classify_exit`), and a per-replica restart
    budget REFUNDED whenever the dead replica had reached healthy in its
    last life: a crash-looping replica exhausts its budget, a long-serving
    one restarts forever.
  - `FleetRouter` (stdlib `ThreadingHTTPServer`) balances `/v1/embed` and
    `/v1/knn` across in-rotation replicas by least-outstanding, ejects a
    replica on any connection-level failure (re-admission only through a
    later probe success), retries connection-refused/reset EXACTLY once on
    a different replica under the request's own deadline, and, when no
    healthy backend exists, sheds with a structured 503 and a retry hint.
    Every request ends in an answer; the router never stalls and never
    drops one silently.
  - rolling restarts are DRAIN-AWARE and never take capacity below N−1:
    one replica at a time, and only while every other active replica is
    healthy: drain (the router stops picking it, SIGTERM lets the replica
    finish in-flight work), relaunch, wait for the probe to readmit it,
    then move on.
  - `CheckpointWatcher` and the reload roll: a watch directory of exported
    encoder steps (`<dir>/<step>/...` with integrity manifests,
    `resilience/integrity.py`) is polled; a step deploys only once its
    manifest exists AND verifies; a corrupt or partial step is quarantined
    to `.quarantine/` loudly, without crashing anything. A verified step
    rolls across the fleet through each replica's `POST /admin/reload`:
    the replica builds and captures the new engine off the request path
    and swaps atomically between micro-batches, so a live pretrain run
    deploys continuously with zero dropped requests. Replicas that were
    down during a roll converge on relaunch (the new checkpoint is pinned
    into their argv) or on the next watcher pass.
  - the versioned-bank lifecycle: with `bank_dir` set, a step deploys ONLY
    with a verifying paired bank built by `python -m
    moco_tpu_torch.bank_build` (`<bank_dir>/<step>/bank.npz` and an
    integrity manifest binding it to the checkpoint's content hash). The
    roll POSTs the pair and each replica dual-swaps (engine, bank) under
    one generation bump; a `reload_bank_mismatch` verdict (the replica's
    space-agreement probe) quarantines the PAIR as a unit, restores the
    pre-roll last-known-good pair, and rolls half-swapped replicas back. A
    bank without a manifest WAITS (a `bank_waiting` event); a bank-free
    fleet (empty bank_dir) is unaffected.
  - the sharded kNN: with `ann_shards` set, replica i serves the cell
    partition i % shards of the bank's IVF index and the router
    scatter-gathers `/v1/knn` over one healthy owner a shard; an answer
    missing a shard is flagged `partial: true`.
  - `AutoscaleController`: scale up on windows of breached router_stats,
    drain-then-reap down on windows of idle ones, with hysteresis and a
    cooldown.

Every lifecycle transition lands as a `kind: "fleet"` record in the
fleet's `events.jsonl`, stamped with the run and trace ids the replicas
inherit through `MOCO_TPU_RUN_ID` (`telemetry/trace.py`): one merged story
across the router, the supervisor and N serving processes. Knobs,
defaults, records and exit codes are the JAX package's.

The standard library alone, transitively (`tests/test_torch_isolation.py`):
the routing tier must stay alive and small while replicas run the card
out of memory, segfault or wedge.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import math
import os
import random
import socket
import subprocess
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from moco_tpu_torch.resilience.integrity import manifest_path, verify_step
from moco_tpu_torch.resilience.supervisor import (
    CLASS_CLEAN,
    FATAL_CLASSES,
    QUARANTINE_DIRNAME,
    classify_exit,
)
from moco_tpu_torch.telemetry.aggregate import PercentileWindow
from moco_tpu_torch.telemetry.trace import Tracer
from moco_tpu_torch.utils.logging import log_event

EVENTS_FILENAME = "events.jsonl"

# payload suffixes the reload roll recognizes inside a watched step dir
_EXPORT_SUFFIXES = (".safetensors", ".npz", ".bin")

# structured error codes the router itself originates (the replica-side
# codes — overloaded/deadline_exceeded/draining — pass through untouched)
SHED_NO_BACKEND = "no_healthy_backend"
SHED_UPSTREAM_TIMEOUT = "upstream_timeout"
SHED_UPSTREAM_ERROR = "upstream_error"
SHED_DEADLINE_ROUTER = "deadline_exceeded"  # budget elapsed AT the router
                                            # (same code the replica uses —
                                            # a client retries either the
                                            # same way — but counted in its
                                            # own router_stats bucket)


class FleetLaunchError(RuntimeError):
    """A replica COMMAND could not be spawned at fleet start (missing
    binary, exec failure). Distinct from the router's bind OSError on
    purpose: the CLI maps the bind to EXIT_FLEET_BIND=48 (reschedule —
    don't race the socket) and this to EXIT_CONFIG_ERROR=45 (the same
    argv can never succeed)."""


def pick_free_port(host: str = "127.0.0.1") -> int:
    """Ephemeral-port discovery for auto replica ports (tests, bench).
    Races are possible between close and the child's bind; a loser exits
    EXIT_SERVE_BIND and the fleet classifies it fatal — loud, not flaky."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class FleetPolicy:
    """Fleet supervision knobs (`python -m moco_tpu_torch.serve_fleet`
    exposes each; the staging server its supervision subset)."""

    probe_secs: float = 1.0            # per-replica /healthz cadence
    probe_timeout_s: float = 2.0       # one probe's connect+answer budget
    health_stale_secs: float = 10.0    # no probe ANSWER for this long
                                       # (once healthy this life) -> the
                                       # replica is wedged: kill it
    startup_grace_secs: float = 300.0  # launch -> first healthy probe
                                       # allowance (torch import + the
                                       # ladder's CUDA-graph captures on
                                       # a cold replica)
    term_grace_secs: float = 15.0      # SIGTERM -> grace -> SIGKILL
    max_restarts: int = 5              # consecutive never-healthy deaths
                                       # per replica before abandoning it;
                                       # a healthy life refunds in full
    backoff_base_secs: float = 0.5
    backoff_max_secs: float = 30.0
    backoff_jitter: float = 0.2
    request_timeout_s: float = 30.0    # router default per-request
                                       # deadline (body deadline_ms wins)
    watch_poll_secs: float = 1.0       # checkpoint-watcher cadence
    reload_timeout_s: float = 300.0    # one replica's /admin/reload budget
                                       # (checkpoint load + full ladder
                                       # warmup, off the request path)
    stats_every_secs: float = 30.0     # router_stats event cadence (the
                                       # autoscaler input stream; see
                                       # _emit_router_stats for the schema)
    stats_latency_window: int = 512    # router-latency ring size behind
                                       # the router_stats p50/p95/p99
    # telemetry-driven autoscaling: the controller consumes
    # the SAME windowed router_stats stream obsd reads — counter deltas
    # between consecutive emits — with hysteresis (consecutive breached/
    # idle windows) and a cooldown so one noisy window never flaps the
    # fleet. autoscale_max=0 (default) disables the whole subsystem.
    autoscale_min: int = 1             # never reap below this many
                                       # (shard cover raises the floor)
    autoscale_max: int = 0             # replica budget; 0 = autoscaler off
    autoscale_cooldown_s: float = 60.0 # min gap between scale actions
    autoscale_up_after: int = 2        # consecutive breached windows
    autoscale_down_after: int = 6      # consecutive idle windows
    autoscale_shed_high: float = 0.02  # shed-rate breach threshold
    autoscale_outstanding_high: float = 4.0  # in-flight per healthy
                                       # replica breach threshold
    autoscale_p99_high_ms: float = 0.0 # p99 breach threshold; 0 = off
    autoscale_idle_low: float = 0.25   # outstanding/healthy below this
                                       # (and zero sheds) counts as idle

    def backoff_secs(self, consecutive_failures: int,
                     rng: random.Random) -> float:
        base = min(
            self.backoff_base_secs
            * (2.0 ** max(consecutive_failures - 1, 0)),
            self.backoff_max_secs,
        )
        return base * (1.0 + self.backoff_jitter * rng.random())


class ReplicaState:
    """One replica's supervision state. Every mutable field is guarded by
    the fleet's lock; the router reads/writes `outstanding` under it."""

    def __init__(self, index: int, host: str, port: int,
                 telemetry_dir: str, budget: int):
        self.index = index
        self.host = host
        self.port = port
        self.telemetry_dir = telemetry_dir
        self.proc: subprocess.Popen | None = None
        self.pid: int | None = None
        self.launches = 0
        self.budget = budget
        self.consecutive_failures = 0
        self.healthy = False           # last probe answered 200 (rotation)
        self.draining = False          # roll/stop took it out on purpose
        self.abandoned = False         # fatal class or exhausted budget
        self.expected_exit = False     # WE asked it to exit (roll, stop)
        self.outstanding = 0           # router's in-flight count
        self.shard: int | None = None  # owned ANN cell partition; None
                                       # on ann-free fleets
        self.reaping = False           # autoscale drain-then-reap in
                                       # progress: never relaunched,
                                       # removed from the table once the
                                       # process is gone
        self.launched_at = 0.0
        self.last_ok_life: float | None = None  # newest probe ANSWER (200
                                       # or draining-503) this life
        self.ever_healthy_life = False
        self.kill_phase: str | None = None      # None | "term" | "kill"
        self.term_at = 0.0
        self.relaunch_at: float | None = None   # pending relaunch time
        self.deployed_step = -1        # newest hot-reloaded step
        self.reload_announced = -1     # dedupe for reload_failed events
        self.reload_refused_step = -1  # replica answered 409 for this
                                       # step: a TERMINAL refusal (kNN
                                       # bank, ladder change) — re-trying
                                       # every pass would make the
                                       # replica load+warm a checkpoint
                                       # just to refuse it again; cleared
                                       # on relaunch (fresh argv pins the
                                       # payload)
        self.classifications: list[str] = []

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def snapshot(self) -> dict:
        return {
            "replica": self.index,
            "port": self.port,
            "pid": self.pid,
            "healthy": self.healthy,
            "draining": self.draining,
            "abandoned": self.abandoned,
            "outstanding": self.outstanding,
            "shard": self.shard,
            "launches": self.launches,
            "restarts": max(self.launches - 1, 0),
            "budget_left": self.budget,
            "deployed_step": self.deployed_step,
            "classifications": list(self.classifications),
        }


# ---------------------------------------------------------------------------
# the front-end router
# ---------------------------------------------------------------------------


class _RouterServer(ThreadingHTTPServer):
    daemon_threads = True
    # same reasoning as serve/http.py: a backlog of 5 resets reconnecting
    # closed-loop clients; the structured shed is the admission control
    request_queue_size = 128


def _make_router_handler(fleet: "FleetSupervisor"):
    policy = fleet.policy

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: D102
            pass  # per-request stderr drowns the structured channel

        def _send(self, status: int, obj: dict) -> None:
            body = json.dumps(obj).encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_raw(self, status: int, body: bytes) -> None:
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                healthy = fleet.healthy_count()
                body = {
                    "status": "ok" if healthy else "no_healthy_backend",
                    "healthy": healthy,
                    "replicas": len(fleet.replicas),
                }
                self._send(200 if healthy else 503, body)
            elif self.path == "/stats":
                self._send(200, fleet.stats())
            else:
                self._send(404, {"error": "not_found", "path": self.path})

        def do_POST(self):
            # /admin/* is deliberately NOT proxied: reload/ops surface
            # stays on the replicas' own ports, reachable only by the
            # fleet supervisor (or an operator), never by public traffic
            if self.path not in ("/v1/embed", "/v1/knn"):
                self.rfile.read(int(self.headers.get("Content-Length") or 0))
                self._send(404, {"error": "not_found", "path": self.path})
                return
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length)
            status, out = fleet.router_proxy(self.path, body)
            self._send_raw(status, out)

    return Handler


class FleetRouter:
    """Owns the front-end `ThreadingHTTPServer`; the routing logic itself
    lives on the fleet (it needs the replica table). `port=0` binds an
    ephemeral port exposed as `.port`."""

    def __init__(self, fleet: "FleetSupervisor", host: str, port: int):
        self.server = _RouterServer((host, port),
                                    _make_router_handler(fleet))
        self.host, self.port = self.server.server_address[:2]
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True,
            name="fleet-router",
        )
        self._thread.start()

    def shutdown(self) -> None:
        if self._thread is not None:
            # BaseServer.shutdown() BLOCKS until serve_forever acks —
            # calling it on a bound-but-never-started server (the
            # partial-start cleanup path) would hang forever
            self.server.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self.server.server_close()


# ---------------------------------------------------------------------------
# checkpoint watcher (unit-testable standalone; the fleet runs it in a
# thread and rolls what it finds)
# ---------------------------------------------------------------------------


class CheckpointWatcher:
    """Poll a directory of exported encoder steps (`<dir>/<step>/<file>`
    + `.integrity/<step>.json` manifests, `resilience/integrity.py`) for new
    deployable checkpoints.

    Deployment gate, in order: a step WITHOUT a manifest is skipped
    silently (the exporter writes the manifest last, atomically — its
    absence means the step is still being written); a step whose
    manifest FAILS verification is quarantined to `.quarantine/<step>`
    with the supervisor's preflight pattern and never considered again; the
    NEWEST verifying step wins (older not-yet-deployed steps are
    skipped — serving wants the freshest weights, not a replay).
    `poll_once()` returns `(step, payload_path)` for a newly deployable
    step, else None."""

    def __init__(self, watch_dir: str, *, floor: int = -1, emit=None):
        self.watch_dir = watch_dir
        self.floor = floor          # newest step already seen/deployed
        self._emit = emit or (lambda event, **fields: None)
        self._bad_layout: set[int] = set()

    def poll_once(self) -> tuple[int, str] | None:
        try:
            names = os.listdir(self.watch_dir)
        except OSError:
            return None  # watch dir not created yet
        steps = sorted((int(n) for n in names if n.isdigit()), reverse=True)
        for step in steps:
            if step <= self.floor:
                break  # newest-first: everything older is already decided
            if step in self._bad_layout:
                continue
            if not os.path.exists(manifest_path(self.watch_dir, step)):
                continue  # still being exported: manifest lands last
            reason = verify_step(self.watch_dir, step)
            if reason is not None:
                self._quarantine(step, reason)
                continue
            payload = self._payload(step)
            if payload is None:
                self._bad_layout.add(step)
                self._emit("reload_bad_layout", step=step,
                           detail="no single export payload in step dir")
                continue
            self.floor = step
            return step, payload
        return None

    def _payload(self, step: int) -> str | None:
        step_dir = os.path.join(self.watch_dir, str(step))
        try:
            files = sorted(
                f for f in os.listdir(step_dir)
                if os.path.isfile(os.path.join(step_dir, f))
            )
        except OSError:
            return None
        known = [f for f in files if f.endswith(_EXPORT_SUFFIXES)]
        chosen = known[0] if known else (files[0] if len(files) == 1 else None)
        return os.path.join(step_dir, chosen) if chosen else None

    def quarantine(self, step: int, reason: str) -> None:
        """Quarantine a step AFTER discovery (the reload drift guard's
        path: the manifest verified — the bytes are intact —
        but the WEIGHTS are degenerate). Filesystem errors are emitted,
        not raised: the caller is the fleet's reload roll, which must
        keep rolling whatever the watch dir allows."""
        try:
            self._quarantine(step, reason)
        except OSError as e:
            self._emit("reload_watch_error",
                       detail=f"quarantine step {step}: "
                              f"{type(e).__name__}: {e}")

    def _quarantine(self, step: int, reason: str) -> None:
        qdir = os.path.join(self.watch_dir, QUARANTINE_DIRNAME)
        os.makedirs(qdir, exist_ok=True)
        target = os.path.join(qdir, str(step))
        if os.path.exists(target):
            target = f"{target}.{int(time.time())}"
        os.rename(os.path.join(self.watch_dir, str(step)), target)
        try:
            os.remove(manifest_path(self.watch_dir, step))
        except OSError:
            pass
        self._emit("reload_quarantine", step=step, reason=reason,
                   moved_to=target)
        log_event(
            "fleet",
            f"quarantined corrupt checkpoint step {step} ({reason}) "
            f"-> {target}; the fleet keeps serving the previous weights",
        )

    def run(self, poll_secs: float, stop: threading.Event, on_new) -> None:
        """Thread body: poll until `stop`; `on_new(step, path)` for each
        newly deployable step (the fleet's reload roll). A filesystem
        error mid-poll (unwritable quarantine dir, a file vanishing
        between stat and hash) must not kill the watcher thread — that
        would silently disable hot reload for the fleet's lifetime
        while everything reports healthy. Errors are emitted and the
        next poll retries."""
        while not stop.is_set():
            try:
                found = self.poll_once()
                if found is not None:
                    on_new(*found)
            except OSError as e:
                self._emit("reload_watch_error",
                           detail=f"{type(e).__name__}: {e}")
                log_event("fleet",
                          f"checkpoint watcher error (will retry): {e}")
            stop.wait(poll_secs)


# ---------------------------------------------------------------------------
# telemetry-driven autoscaling
# ---------------------------------------------------------------------------


class AutoscaleController:
    """Pure decision logic for telemetry-driven autoscaling.

    Feed it consecutive router_stats-shaped snapshots (cumulative
    counters + gauges) on the stats cadence; it answers ("up"|"down",
    reason) or None. Deliberately free of threads, wall clocks, and
    fleet state so the hysteresis is unit-testable with plain dicts:

      - breach: windowed shed RATE (Δsheds/Δrequests) above
        `autoscale_shed_high`, in-flight depth per healthy replica
        above `autoscale_outstanding_high`, or — when enabled — p99
        above `autoscale_p99_high_ms`;
      - idle: ZERO sheds this window AND depth per healthy replica
        below `autoscale_idle_low`;
      - hysteresis: `autoscale_up_after` consecutive breached windows
        scale up, `autoscale_down_after` consecutive idle ones scale
        down; a mixed window resets both streaks — one noisy sample
        never moves capacity;
      - cooldown: actions at least `autoscale_cooldown_s` apart.
        Streaks KEEP accumulating through a cooldown, so a sustained
        breach fires the moment the window reopens.
    """

    SHED_KEYS = ("shed_no_backend", "upstream_timeout", "upstream_error",
                 "shed_deadline_router")

    def __init__(self, policy: FleetPolicy):
        self.policy = policy
        self._prev: dict | None = None
        self.breach_streak = 0
        self.idle_streak = 0
        self.last_action_at = float("-inf")

    def observe(self, stats: dict, now: float) -> tuple[str, str] | None:
        p = self.policy
        prev, self._prev = self._prev, dict(stats)
        if prev is None:
            return None  # first window: no deltas yet
        d_req = stats.get("requests", 0) - prev.get("requests", 0)
        d_shed = sum(stats.get(k, 0) - prev.get(k, 0)
                     for k in self.SHED_KEYS)
        shed_rate = d_shed / max(d_req, 1)
        healthy = max(int(stats.get("healthy") or 0), 1)
        depth = float(stats.get("outstanding") or 0) / healthy
        p99 = float((stats.get("latency_ms") or {}).get("p99") or 0.0)
        breach = None
        if shed_rate > p.autoscale_shed_high:
            breach = (f"shed_rate {shed_rate:.4f} > "
                      f"{p.autoscale_shed_high} over the window")
        elif depth > p.autoscale_outstanding_high:
            breach = (f"outstanding/healthy {depth:.2f} > "
                      f"{p.autoscale_outstanding_high}")
        elif p.autoscale_p99_high_ms and p99 > p.autoscale_p99_high_ms:
            breach = f"p99 {p99:.1f}ms > {p.autoscale_p99_high_ms}ms"
        if breach is not None:
            self.breach_streak += 1
            self.idle_streak = 0
        elif d_shed == 0 and depth < p.autoscale_idle_low:
            self.idle_streak += 1
            self.breach_streak = 0
        else:
            self.breach_streak = 0
            self.idle_streak = 0
        if now - self.last_action_at < p.autoscale_cooldown_s:
            return None
        if self.breach_streak >= p.autoscale_up_after:
            self.breach_streak = 0
            self.last_action_at = now
            return "up", breach
        if self.idle_streak >= p.autoscale_down_after:
            self.idle_streak = 0
            self.last_action_at = now
            return "down", (f"idle for {p.autoscale_down_after} windows "
                            f"(outstanding/healthy {depth:.2f} < "
                            f"{p.autoscale_idle_low}, zero sheds)")
        return None


# ---------------------------------------------------------------------------
# the fleet supervisor
# ---------------------------------------------------------------------------


class FleetSupervisor:
    """Supervise N serve replicas behind one router.

    `child_argv(index, port, telemetry_dir, pretrained[, bank])` builds
    one replica's command (`serve_fleet.py` appends `--port`/
    `--telemetry-dir` — and, after a hot reload, `--pretrained` and,
    for dual-swap fleets, `--knn-bank` — to the operator's base
    command; tests point it at stub scripts; a 4-arg callable still
    works for bank-free fleets). `pretrained` is None until a watcher
    deployment happens, then the deployed payload path — a replica
    relaunched after a reload roll must come back with the NEW weights
    (and bank), not the boot-time ones."""

    def __init__(
        self,
        child_argv,
        *,
        replicas: int,
        telemetry_dir: str,
        host: str = "127.0.0.1",
        router_port: int = 0,
        base_port: int = 0,
        policy: FleetPolicy | None = None,
        watch_dir: str = "",
        bank_dir: str = "",
        env: dict | None = None,
        replica_env: dict | None = None,
        seed: int | None = None,
        ann_shards: int = 0,
    ):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if ann_shards < 0:
            raise ValueError(f"ann_shards must be >= 0, got {ann_shards}")
        if ann_shards and replicas < ann_shards:
            raise ValueError(
                f"ann_shards={ann_shards} needs at least that many "
                f"replicas to cover every cell partition, got "
                f"{replicas}"
            )
        self._child_argv = child_argv
        self.n_replicas = int(replicas)
        self.ann_shards = int(ann_shards)
        self.telemetry_dir = telemetry_dir
        self.host = host
        self._router_port = router_port
        self._base_port = base_port
        self.policy = policy or FleetPolicy()
        if self.policy.autoscale_max:
            if self.policy.autoscale_min < 1:
                raise ValueError("autoscale_min must be >= 1")
            if self.policy.autoscale_max < max(self.policy.autoscale_min,
                                               replicas):
                raise ValueError(
                    f"autoscale_max={self.policy.autoscale_max} below "
                    f"max(autoscale_min={self.policy.autoscale_min}, "
                    f"replicas={replicas})"
                )
        self.watch_dir = watch_dir
        self._env = env
        self._replica_env = dict(replica_env or {})
        self._rng = random.Random(seed)  # None -> system entropy (no
                                         # fleet-wide restart lockstep)
        self.events_path = os.path.join(telemetry_dir, EVENTS_FILENAME)
        self.incidents: list[dict] = []
        # ONE run id for router + supervisor + every replica:
        # replicas inherit it via env, so their serve snapshots and the
        # fleet's lifecycle records merge into one timeline
        self.tracer = Tracer(telemetry_dir, "steps", proc="fleet")
        self.run_id = self.tracer.run_id
        self._lock = threading.Lock()
        self._emit_lock = threading.Lock()
        self.replicas: list[ReplicaState] = []
        self.router: FleetRouter | None = None
        self.failed = False            # every replica abandoned
        self._stop = threading.Event()
        self._monitor_thread: threading.Thread | None = None
        self._watch_thread: threading.Thread | None = None
        self._watcher: CheckpointWatcher | None = None
        self._roll: dict | None = None
        self._roll_requested = False
        self._target_step = -1
        self._target_path: str | None = None
        self._announced_step = -1
        self._good_pretrained: str | None = None  # last payload every
                                       # replica deployed (quarantine
                                       # rollback target)
        # versioned-bank lifecycle: when bank_dir is set, a
        # checkpoint step deploys ONLY with a verifying paired bank
        # (`<bank_dir>/<step>/bank.npz` + `.integrity/<step>.json`) —
        # the dual swap rolls (engine, bank) together; a mismatched
        # pair is quarantined as a UNIT and half-swapped replicas roll
        # back to the last-known-good pair below. Empty bank_dir =
        # bank-free fleet: zero behavior change.
        self.bank_dir = bank_dir
        self._good_bank: str | None = None
        self._good_step = -1
        self._prev_good: tuple | None = None  # (pretrained, bank, step)
                                       # BEFORE the in-flight roll: a
                                       # mismatch caught on a LATER
                                       # replica must not call the bad
                                       # pair "last known good"
        self._bank_verified: set[int] = set()
        self._bad_banks: set[int] = set()
        self._bank_waiting_step = -1   # dedupe for bank_waiting emits
        # the roll runs from the watcher thread (new step) AND the
        # monitor thread (a recovered replica converging): serialize so
        # one replica never sees two concurrent /admin/reload POSTs
        self._reload_roll_lock = threading.Lock()
        self._current_pretrained: str | None = None
        self._last_shed_event = float("-inf")
        self._last_stats_event = 0.0
        # router counters (guarded by _lock)
        self.r_requests = 0
        self.r_ok = 0
        self.r_retries = 0
        self.r_retry_ok = 0
        self.r_shed_no_backend = 0
        self.r_upstream_timeout = 0
        self.r_upstream_error = 0
        self.r_deadline_router = 0     # budget elapsed AT the router before
                                       # an attempt could even be forwarded
        self.r_passthrough_error = 0   # replica answered non-200 (its own
                                       # structured shed: counted, passed)
        # tiered admission + sharded-kNN counters
        self.r_tier = {"interactive": 0, "batch": 0}
        self.r_knn_fanout = 0          # /v1/knn requests scatter-gathered
                                       # across ANN shards
        self.r_knn_partial = 0         # fan-outs answered with < every
                                       # shard (flagged partial: true)
        # answered-request latency window (lock-free GIL-atomic appends
        # from handler threads) behind router_stats' p50/p95/p99
        self._router_latency = PercentileWindow(
            self.policy.stats_latency_window)
        # end-to-end fan-out latency (embed leg + scatter + merge) — a
        # separate window so the merge overhead stays observable next to
        # the single-backend p99
        self._knn_merge = PercentileWindow(self.policy.stats_latency_window)
        # autoscaling: replica indices keep growing past the
        # boot count so a reaped index is never reused (telemetry dirs
        # and event streams stay unambiguous)
        self._next_index = self.n_replicas
        self._autoscaler = AutoscaleController(self.policy)

    # -- structured events ---------------------------------------------------
    def _emit(self, event: str, **fields) -> None:
        self._emit_record("fleet", event, **fields)

    def _emit_record(self, kind: str, event: str, **fields) -> None:
        """One structured record into events.jsonl + incidents. Fleet
        lifecycle stays `kind:"fleet"`; the bank lifecycle
        emits `kind:"bank"` under the SAME run_id so a promotion's
        build/swap/quarantine/rollback and the fleet's reload roll are
        one timeline for obsd and telemetry_report."""
        record = {"v": 1, "t": round(time.time(), 3), "kind": kind,
                  "event": event, "run_id": self.run_id,
                  "trace_id": self.tracer.trace_id}
        record.update(fields)
        os.makedirs(self.telemetry_dir, exist_ok=True)
        with self._emit_lock:
            self.incidents.append(record)
            with open(self.events_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(record) + "\n")
                f.flush()
                os.fsync(f.fileno())
        detail = " ".join(f"{k}={v}" for k, v in fields.items())
        log_event(kind, f"{event} {detail}".strip())

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Bind the router (its OSError propagates raw — the CLI maps it
        to EXIT_FLEET_BIND), launch every replica, start the monitor
        (and the checkpoint watcher when configured). Every OTHER
        OSError (unwritable telemetry dir, un-spawnable replica command)
        is re-raised as FleetLaunchError: 48 means 'reschedule me' and a
        filesystem/argv problem rescheduled is an infinite loop."""
        try:
            os.makedirs(self.telemetry_dir, exist_ok=True)
        except OSError as e:
            raise FleetLaunchError(
                f"cannot create telemetry dir {self.telemetry_dir!r}: {e}"
            ) from e
        self.router = FleetRouter(self, self.host, self._router_port)
        try:
            ports = []
            for i in range(self.n_replicas):
                port = (self._base_port + i if self._base_port
                        else pick_free_port(self.host))
                ports.append(port)
                rdir = os.path.join(self.telemetry_dir, f"replica{i}")
                os.makedirs(rdir, exist_ok=True)
                r = ReplicaState(i, self.host, port, rdir,
                                 self.policy.max_restarts)
                if self.ann_shards:
                    # round-robin cell-partition ownership: replicas
                    # i, i+shards, ... serve shard i%shards, so every
                    # shard keeps cover while any ⌈N/shards⌉ subset of
                    # its owners is healthy
                    r.shard = i % self.ann_shards
                self.replicas.append(r)
            self._emit("fleet_start", replicas=self.n_replicas,
                       ports=ports, router=self.router.url,
                       ann_shards=self.ann_shards or None,
                       watch_dir=self.watch_dir or None)
            for r in self.replicas:
                self._launch(r)
        except OSError as e:
            # a replica COMMAND that cannot spawn (FileNotFoundError,
            # EMFILE...) or a replica dir/log that cannot be written:
            # kill whatever did launch and release the router — a
            # partial start must not leak processes — and re-raise as a
            # non-OSError so the CLI can't mistake it for a bind failure
            for r in self.replicas:
                if r.alive():
                    r.proc.kill()
                    r.proc.wait()
            self.router.shutdown()
            raise FleetLaunchError(
                f"cannot start the fleet: {e}"
            ) from e
        self.router.start()
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, daemon=True, name="fleet-monitor"
        )
        self._monitor_thread.start()
        if self.watch_dir:
            self._watcher = CheckpointWatcher(self.watch_dir,
                                              emit=self._emit)
            self._watch_thread = threading.Thread(
                target=self._watch_loop, daemon=True, name="fleet-watcher"
            )
            self._watch_thread.start()

    def stop(self, timeout_s: float = 30.0) -> None:
        """Drain-stop: SIGTERM every replica (it finishes accepted
        work), wait, escalate stragglers, then stop the router."""
        with self._lock:
            already = self._stop.is_set()
        if already:
            return
        self._emit("fleet_stop_begin", healthy=self.healthy_count())
        self._stop.set()
        for t in (self._monitor_thread, self._watch_thread):
            if t is not None:
                t.join(timeout=max(self.policy.probe_timeout_s * 2, 5.0))
        for r in self.replicas:
            with self._lock:
                r.draining = True
                r.expected_exit = True
            if r.alive():
                r.proc.terminate()
        deadline = time.monotonic() + timeout_s
        for r in self.replicas:
            if r.proc is None:
                continue
            while r.proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if r.proc.poll() is None:
                r.proc.kill()
                r.proc.wait()
        self._emit_router_stats(final=True)
        self._emit("fleet_stop",
                   launches=sum(r.launches for r in self.replicas))
        if self.router is not None:
            self.router.shutdown()
        self.tracer.close()

    def healthy_count(self) -> int:
        with self._lock:
            return sum(
                1 for r in self.replicas
                if r.healthy and not r.draining and not r.abandoned
            )

    def stats(self) -> dict:
        with self._lock:
            out = {
                "run_id": self.run_id,
                "router": self._router_counters(),
                "replicas": [r.snapshot() for r in self.replicas],
                "target_step": self._target_step,
                "rolling_restart": self._roll is not None,
            }
            if self.bank_dir:
                out["bank"] = {
                    "dir": self.bank_dir,
                    "good_step": self._good_step,
                    "good_bank": self._good_bank,
                    "quarantined": sorted(self._bad_banks),
                }
            return out

    def _router_counters(self) -> dict:
        # caller holds the lock
        return {
            "requests": self.r_requests,
            "ok": self.r_ok,
            "retries": self.r_retries,
            "retry_ok": self.r_retry_ok,
            "shed_no_backend": self.r_shed_no_backend,
            "upstream_timeout": self.r_upstream_timeout,
            "upstream_error": self.r_upstream_error,
            "shed_deadline_router": self.r_deadline_router,
            "passthrough_non_200": self.r_passthrough_error,
            "requests_interactive": self.r_tier["interactive"],
            "requests_batch": self.r_tier["batch"],
            "knn_fanout": self.r_knn_fanout,
            "knn_partial": self.r_knn_partial,
        }

    # -- routing (called from router handler threads) ------------------------
    def pick_backend(self, exclude=()) -> ReplicaState | None:
        with self._lock:
            cands = [
                r for r in self.replicas
                if r.healthy and not r.draining and not r.abandoned
                and r.proc is not None and r.index not in exclude
            ]
            if not cands:
                return None
            r = min(cands, key=lambda c: (c.outstanding, c.index))
            r.outstanding += 1
            return r

    def release_backend(self, r: ReplicaState) -> None:
        with self._lock:
            r.outstanding = max(r.outstanding - 1, 0)

    def eject(self, r: ReplicaState, reason: str) -> None:
        """Take a replica out of rotation NOW (router-observed failure or
        probe failure). Re-admission only through a later probe success —
        one bad connect must not flap it back in by itself."""
        with self._lock:
            was = r.healthy
            r.healthy = False
        if was:
            self._emit("eject", replica=r.index, reason=reason)

    def router_proxy(self, path: str, body: bytes) -> tuple[int, bytes]:
        """One client request: count its admission tier, then either
        scatter-gather `/v1/knn` across the ANN shards or
        route it to one backend. Returns (status, response bytes)."""
        with self._lock:
            self.r_requests += 1
            self.r_tier[self._tier_of(body)] += 1
        if path == "/v1/knn" and self.ann_shards > 1:
            return self._knn_fanout(body)
        return self._routed_request(path, body)

    def _tier_of(self, body: bytes) -> str:
        """The request's admission tier for the router's per-tier
        counters (the replica's MicroBatcher enforces the lanes; the
        router only accounts). Same substring pre-check as _deadline_s:
        the common untagged path never pays a JSON parse."""
        if b'"tier"' in body:
            try:
                if json.loads(body).get("tier") == "batch":
                    return "batch"
            except (ValueError, json.JSONDecodeError):
                pass  # malformed body: the replica answers 400 either way
        return "interactive"

    def _routed_request(self, path: str, body: bytes,
                        leg: bool = False) -> tuple[int, bytes]:
        """Pick → forward → (maybe) retry once on a DIFFERENT replica →
        answer. `leg=True` (a fan-out's embed phase) suppresses the
        success-path ok/latency accounting — the fan-out counts its own
        end-to-end outcome — while every shed/timeout path still counts
        and observes: those ARE the client's final answer."""
        t_start = time.monotonic()
        deadline = t_start + self._deadline_s(body)
        tried: list[int] = []
        last_err = "?"
        for attempt in (0, 1):
            replica = self.pick_backend(exclude=tried)
            if replica is None:
                if tried:
                    # the client DID wait through a failed attempt before
                    # this shed — that time belongs in the window (a
                    # zero-wait first-attempt shed does not: thousands of
                    # instant 503s during an outage would bury the tail)
                    self._router_latency.observe(
                        time.monotonic() - t_start)
                return self._shed_no_backend()
            tried.append(replica.index)
            remaining = deadline - time.monotonic()
            if remaining <= 0.01:
                # the picked replica never saw the request: hand its
                # outstanding slot back (leaking it here would skew
                # least-outstanding AND the autoscaler's depth gauge
                # upward forever), and the elapsed time — the client DID
                # wait the whole deadline — belongs in the latency
                # window like the upstream-timeout case
                self.release_backend(replica)
                self._router_latency.observe(time.monotonic() - t_start)
                with self._lock:
                    self.r_deadline_router += 1
                return 504, json.dumps({
                    "error": SHED_DEADLINE_ROUTER,
                    "detail": "request deadline elapsed at the router",
                }).encode()
            try:
                status, data = self._forward(replica, path, body, remaining)
            except (ConnectionError, http.client.HTTPException) as e:
                # the replica died under us (refused / reset / torn
                # response). Embeddings are pure functions of the input,
                # so a replay is safe — retry ONCE on a different replica
                self.eject(replica, f"connect:{type(e).__name__}")
                last_err = f"{type(e).__name__}: {e}"
                with self._lock:
                    self.r_retries += 1
                continue
            except (TimeoutError, OSError) as e:
                # a timeout consumed the request's own deadline: answer
                # structured, eject (the probe readmits a merely-slow
                # replica on its next success), do NOT replay. The elapsed
                # time IS the client-observed latency — it belongs in the
                # window (the autoscaler's p99 must see the timeouts)
                self._router_latency.observe(time.monotonic() - t_start)
                self.eject(replica, f"timeout:{type(e).__name__}")
                with self._lock:
                    self.r_upstream_timeout += 1
                return 504, json.dumps({
                    "error": SHED_UPSTREAM_TIMEOUT,
                    "replica": replica.index,
                    "detail": f"{type(e).__name__}: {e}",
                }).encode()
            finally:
                self.release_backend(replica)
            if not leg or status != 200:
                # a leg's 200 is an intermediate hop (the fan-out
                # observes the end-to-end total); its non-200 passes
                # through as the client's final answer
                self._router_latency.observe(time.monotonic() - t_start)
            with self._lock:
                if status == 200:
                    if not leg:
                        self.r_ok += 1
                        if attempt:
                            self.r_retry_ok += 1
                else:
                    self.r_passthrough_error += 1
            return status, data
        # both attempts failed: the client-observed wait is real and the
        # autoscaler's p99 must see it, like the timeout/deadline paths
        self._router_latency.observe(time.monotonic() - t_start)
        with self._lock:
            self.r_upstream_error += 1
        return 502, json.dumps({
            "error": SHED_UPSTREAM_ERROR,
            "detail": f"both attempts failed; last: {last_err}",
            "retry_after_ms": round(self.policy.probe_secs * 1e3, 1),
        }).encode()

    def _knn_fanout(self, body: bytes) -> tuple[int, bytes]:
        """Sharded /v1/knn: embed ONCE through the normal
        routed path, scatter the embedding to one healthy owner of every
        ANN shard as a `candidates` probe, merge the per-shard rerank
        lists and vote in pure python (this module is stdlib-only by
        contract, gated in the isolation tests — so the replica-side numpy
        vote in serve/ann.py is REIMPLEMENTED here, byte-equivalent tie-breaks
        and all). The whole scatter runs under the request's own
        deadline; shards that miss it are dropped and the answer is
        flagged `partial: true` — a degraded answer beats a stall."""
        t_start = time.monotonic()
        deadline = t_start + self._deadline_s(body)
        with self._lock:
            self.r_knn_fanout += 1
        status, data = self._routed_request("/v1/embed", body, leg=True)
        if status != 200:
            return status, data  # the leg already counted the shed
        try:
            embedding = json.loads(data)["embedding"]
        except (ValueError, KeyError, json.JSONDecodeError):
            self._router_latency.observe(time.monotonic() - t_start)
            with self._lock:
                self.r_upstream_error += 1
            return 502, json.dumps({
                "error": SHED_UPSTREAM_ERROR,
                "detail": "embed leg returned a malformed body",
            }).encode()
        # one least-outstanding healthy owner per shard, slots reserved
        # under the lock exactly like pick_backend
        targets: dict[int, ReplicaState] = {}
        with self._lock:
            for r in self.replicas:
                if (r.healthy and not r.draining and not r.abandoned
                        and r.proc is not None and r.shard is not None):
                    cur = targets.get(r.shard)
                    if cur is None or ((r.outstanding, r.index)
                                       < (cur.outstanding, cur.index)):
                        targets[r.shard] = r
            for r in targets.values():
                r.outstanding += 1
        if not targets:
            self._router_latency.observe(time.monotonic() - t_start)
            return self._shed_no_backend()
        probe = json.dumps({"candidates": True,
                            "embedding": embedding}).encode()
        results: dict[int, dict] = {}
        res_lock = threading.Lock()

        def one_shard(shard: int, r: ReplicaState) -> None:
            try:
                remaining = deadline - time.monotonic()
                if remaining <= 0.01:
                    return  # this shard missed the budget: partial
                st, raw = self._forward(r, "/v1/knn", probe, remaining)
                if st != 200:
                    return
                ans = json.loads(raw)
                if not isinstance(ans.get("candidates"), list):
                    return
                with res_lock:
                    results[shard] = ans
            except (OSError, http.client.HTTPException, ValueError):
                self.eject(r, "knn_fanout")
            finally:
                self.release_backend(r)

        threads = [
            threading.Thread(target=one_shard, args=(s, r), daemon=True,
                             name=f"knn-fanout-s{s}")
            for s, r in sorted(targets.items())
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0.0) + 0.05)
        with res_lock:
            answers = dict(results)
        elapsed = time.monotonic() - t_start
        if not answers:
            self._router_latency.observe(elapsed)
            expired = time.monotonic() >= deadline
            with self._lock:
                if expired:
                    self.r_deadline_router += 1
                else:
                    self.r_upstream_error += 1
            if expired:
                return 504, json.dumps({
                    "error": SHED_DEADLINE_ROUTER,
                    "detail": "no ANN shard answered inside the "
                              "fan-out deadline",
                }).encode()
            return 502, json.dumps({
                "error": SHED_UPSTREAM_ERROR,
                "detail": "every ANN shard leg failed",
            }).encode()
        first = next(iter(answers.values()))
        k = int(first.get("k") or 200)
        temperature = float(first.get("temperature") or 0.07)
        merged = []
        for shard in sorted(answers):
            for cand in answers[shard]["candidates"]:
                merged.append((float(cand[0]), int(cand[1])))
        # global top-k across shards; ties broken toward the LOWER label
        # — the same (−sim, label) order AnnShard.search emits, so a
        # 1-shard fan-out reproduces the replica-local answer exactly
        merged.sort(key=lambda c: (-c[0], c[1]))
        votes: dict[int, float] = {}
        for sim, label in merged[:k]:
            votes[label] = votes.get(label, 0.0) + math.exp(
                sim / max(temperature, 1e-8))
        # max() keeps the FIRST maximum while scanning ascending labels:
        # lowest label wins ties, matching np.argmax in ann.vote
        pred = max(sorted(votes), key=lambda lab: votes[lab])
        partial = len(answers) < self.ann_shards
        self._router_latency.observe(elapsed)
        self._knn_merge.observe(elapsed)
        with self._lock:
            self.r_ok += 1
            if partial:
                self.r_knn_partial += 1
        return 200, json.dumps({
            "class": int(pred),
            "cached": False,
            "partial": partial,
            "shards": self.ann_shards,
            "shards_answered": len(answers),
        }).encode()

    def _forward(self, r: ReplicaState, path: str, body: bytes,
                 timeout_s: float) -> tuple[int, bytes]:
        """One attempt against one replica. A FRESH connection per
        attempt: a dead replica then fails at connect() — a clean,
        immediately-retryable signal — instead of a half-dead pooled
        socket ambiguously timing out."""
        conn = http.client.HTTPConnection(r.host, r.port,
                                          timeout=max(timeout_s, 0.01))
        try:
            conn.request("POST", path, body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def _deadline_s(self, body: bytes) -> float:
        """The request's own deadline_ms when present, else the router
        default. The substring pre-check keeps the common no-deadline
        path from paying a JSON parse of a ~200 KB image body."""
        if b'"deadline_ms"' in body:
            try:
                v = json.loads(body).get("deadline_ms")
                if v:
                    return min(max(float(v) / 1e3, 0.05), 600.0)
            except (ValueError, json.JSONDecodeError):
                pass  # malformed body: the replica answers 400 either way
        return self.policy.request_timeout_s

    def _shed_no_backend(self) -> tuple[int, bytes]:
        now = time.monotonic()
        emit = False
        with self._lock:
            self.r_shed_no_backend += 1
            if now - self._last_shed_event > 5.0:  # rate-limited event
                self._last_shed_event = now
                emit = True
        if emit:
            self._emit("no_backend", healthy=0,
                       sheds=self.r_shed_no_backend)
        retry_ms = round(
            max(self.policy.probe_secs, self.policy.backoff_base_secs)
            * 1e3, 1,
        )
        return 503, json.dumps({
            "error": SHED_NO_BACKEND,
            "retry_after_ms": retry_ms,
        }).encode()

    # -- replica lifecycle ---------------------------------------------------
    def _launch(self, r: ReplicaState) -> None:
        with self._lock:
            pretrained = self._current_pretrained
            target = self._target_step
            bank = self._good_bank
        try:
            # sharded-ANN fleets pin the replica's cell partition
            # into the argv alongside the dual-swap pair: a
            # relaunched replica must come back serving ITS shard
            argv = self._child_argv(r.index, r.port, r.telemetry_dir,
                                    pretrained, bank, r.shard)
        except TypeError:
            try:
                # dual-swap fleets pin the deployed BANK into
                # the relaunch argv alongside the weights: a replica
                # dying after a dual swap must boot on the (weights,
                # bank) pair, never new weights over its boot-time bank
                # (cross-space answers)
                argv = self._child_argv(r.index, r.port, r.telemetry_dir,
                                        pretrained, bank)
            except TypeError:
                # 4-arg child_argv (bank-free fleets, older test stubs)
                argv = self._child_argv(r.index, r.port, r.telemetry_dir,
                                        pretrained)
        env = dict(os.environ if self._env is None else self._env)
        env.update(self.tracer.child_env())
        env.update(self._replica_env.get(r.index, {}))
        log_file = open(os.path.join(r.telemetry_dir, "child.log"), "ab")
        try:
            proc = subprocess.Popen(argv, stdout=log_file,
                                    stderr=subprocess.STDOUT, env=env)
        finally:
            log_file.close()  # the child holds its own descriptor
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
            # a relaunch boots on the newest deployed checkpoint (pinned
            # into argv above): it converges without a reload roll
            r.deployed_step = target
            r.reload_refused_step = -1
        self._emit("launch", replica=r.index, attempt=r.launches - 1,
                   pid=proc.pid, port=r.port, budget_left=r.budget,
                   pretrained=pretrained)

    def _try_launch(self, r: ReplicaState) -> bool:
        """RE-launch path (monitor loop, roll machine): a spawn failure
        here — the binary vanished mid-run, fd exhaustion — must abandon
        the replica loudly, never unwind the monitor thread."""
        try:
            self._launch(r)
            return True
        except OSError as e:
            with self._lock:
                r.abandoned = True
            self._emit("give_up", replica=r.index,
                       reason=f"relaunch failed to spawn: {e}")
            self._check_all_abandoned()
            return False

    def _handle_exit(self, r: ReplicaState) -> None:
        rc = r.proc.returncode
        hang = r.kill_phase is not None
        cls, detail = classify_exit(rc, hang_killed=hang)
        now = time.monotonic()
        with self._lock:
            expected = r.expected_exit
            reaping = r.reaping
            progressed = r.ever_healthy_life
            pid = r.pid
            r.proc = None
            r.healthy = False
            r.kill_phase = None
            r.expected_exit = False
            r.classifications.append(cls)
        self._emit("replica_exit", replica=r.index, pid=pid, returncode=rc,
                   classification=cls, detail=detail,
                   progressed=progressed, expected=expected)
        if expected or reaping:
            # the roll machine, stop(), or the autoscale reap owns this
            # death — a reaping replica is never relaunched, even when
            # it crashed before our SIGTERM landed (the reap removes it
            # from the table on the next monitor pass either way)
            return
        if cls in FATAL_CLASSES and cls != CLASS_CLEAN:
            # CLEAN is fatal for a RUN supervisor (the run is over); a
            # serve fleet wants N replicas — an unexpected clean exit
            # (someone SIGTERM'd a replica) restarts like any death
            with self._lock:
                r.abandoned = True
            self._emit("give_up", replica=r.index,
                       reason=f"fatal class {cls}", returncode=rc)
            self._check_all_abandoned()
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
                        r.consecutive_failures, self._rng
                    )
            abandoned = r.abandoned
            if not abandoned:
                r.relaunch_at = now + delay
        if abandoned:
            self._emit(
                "give_up", replica=r.index,
                reason=(f"restart budget exhausted: "
                        f"{r.consecutive_failures} consecutive "
                        f"never-healthy deaths "
                        f"(max_restarts={self.policy.max_restarts})"),
            )
            self._check_all_abandoned()
        elif delay:
            self._emit("backoff", replica=r.index, secs=round(delay, 3),
                       consecutive_failures=r.consecutive_failures,
                       budget_left=r.budget)

    def _check_all_abandoned(self) -> None:
        with self._lock:
            dead = all(r.abandoned for r in self.replicas)
            self.failed = dead
        if dead:
            self._emit("fleet_give_up",
                       reason="every replica is abandoned")

    # -- probing -------------------------------------------------------------
    def _probe(self, r: ReplicaState) -> str:
        """GET /healthz with the probe budget; returns "ok", "draining",
        or an error string."""
        conn = http.client.HTTPConnection(
            r.host, r.port, timeout=self.policy.probe_timeout_s
        )
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            resp.read()
            if resp.status == 200:
                return "ok"
            if resp.status == 503:
                return "draining"
            return f"status {resp.status}"
        except (OSError, http.client.HTTPException) as e:
            return f"{type(e).__name__}: {e}"
        finally:
            conn.close()

    def _probe_and_update(self, r: ReplicaState) -> None:
        result = self._probe(r)
        now = time.monotonic()
        event = None
        if result == "ok":
            with self._lock:
                r.last_ok_life = now
                if not r.healthy and not r.draining:
                    event = ("readmit" if r.ever_healthy_life
                             else "replica_healthy")
                    r.healthy = True
                    r.ever_healthy_life = True
            if event:
                self._emit(event, replica=r.index, pid=r.pid)
        elif result == "draining":
            # alive (an answer IS a heartbeat) but not routable
            with self._lock:
                r.last_ok_life = now
                was = r.healthy
                r.healthy = False
            if was:
                self._emit("eject", replica=r.index, reason="draining")
        else:
            self.eject(r, f"probe:{result}")

    def _check_staleness(self, r: ReplicaState, now: float) -> None:
        """The wedge killer: a replica whose socket accepts but whose
        handler never answers (or whose process is silently stuck) gets
        the SIGTERM → grace → SIGKILL escalation once its last probe
        ANSWER is older than the window."""
        if r.expected_exit or not r.alive():
            return
        if r.kill_phase == "term":
            if now - r.term_at > self.policy.term_grace_secs:
                self._emit("kill", replica=r.index, pid=r.pid,
                           reason="probe_stale", phase="sigkill")
                r.proc.kill()
                with self._lock:
                    r.kill_phase = "kill"
            return
        if r.kill_phase is not None:
            return
        ref = r.last_ok_life if r.last_ok_life is not None else r.launched_at
        window = (self.policy.health_stale_secs if r.last_ok_life is not None
                  else self.policy.startup_grace_secs)
        stale_for = now - ref
        if stale_for > window:
            self._emit("kill", replica=r.index, pid=r.pid,
                       reason="probe_stale",
                       stale_secs=round(stale_for, 3), phase="sigterm")
            r.proc.terminate()
            with self._lock:
                r.kill_phase = "term"
                r.term_at = now

    # -- rolling restart -----------------------------------------------------
    def request_rolling_restart(self) -> None:
        with self._lock:
            self._roll_requested = True
        self._emit("roll_requested")

    def rolling_restart(self, timeout_s: float = 120.0) -> bool:
        """Blocking convenience (tests, SIGHUP handler thread): request a
        roll and wait for it to finish. True when the roll completed."""
        self.request_rolling_restart()
        deadline = time.monotonic() + timeout_s
        started = False
        while time.monotonic() < deadline:
            with self._lock:
                rolling = self._roll is not None or self._roll_requested
            if rolling:
                started = True
            elif started:
                return True
            time.sleep(0.05)
        return False

    def _replica_by_index(self, index: int) -> ReplicaState | None:
        """Replica lookup by its STABLE index. List position stopped
        being the index once the autoscaler started appending and
        reaping replicas; None means it was reaped."""
        with self._lock:
            for r in self.replicas:
                if r.index == index:
                    return r
        return None

    def _advance_roll(self, now: float) -> None:
        with self._lock:
            if self._roll is None:
                if not self._roll_requested:
                    return
                self._roll_requested = False
                queue = [r.index for r in self.replicas
                         if not r.abandoned and not r.reaping]
                if not queue:
                    return
                self._roll = {"queue": queue, "idx": None,
                              "phase": "await", "t": now}
                begin = True
            else:
                begin = False
            roll = self._roll
        if begin:
            self._emit("roll_begin", replicas=roll["queue"])
        if roll["idx"] is None:
            if not roll["queue"]:
                # record FIRST, then publish completion: rolling_restart
                # polls `_roll is None`, and clearing first lets a caller
                # observe "roll done" before the roll_end record exists
                # (its next read of the incident log misses the event)
                self._emit("roll_end")
                with self._lock:
                    self._roll = None
                return
            idx = roll["queue"][0]
            r = self._replica_by_index(idx)
            if r is None or r.reaping:
                # reaped by the autoscaler since roll-begin: it is on
                # its way out of the table — nothing to roll
                with self._lock:
                    roll["queue"].pop(0)
                self._emit("roll_replica", replica=idx, phase="skipped",
                           reason="reaped")
                return
            if r.abandoned:
                # abandoned since roll-begin: it will never come alive —
                # skip it, or the roll (and every future roll) wedges
                # waiting on a replica nobody will relaunch
                with self._lock:
                    roll["queue"].pop(0)
                self._emit("roll_replica", replica=idx, phase="skipped",
                           reason="abandoned")
                return
            # capacity guard (never below N−1): take the next replica out
            # only while every OTHER active replica is in rotation
            with self._lock:
                others_ok = all(
                    c.healthy for c in self.replicas
                    if c.index != idx and not c.abandoned
                    and not c.reaping
                )
            if not others_ok or not r.alive():
                return  # wait for the fleet to be whole first
            with self._lock:
                roll["queue"].pop(0)
                roll["idx"] = idx
                roll["phase"] = "wait_exit"
                roll["t"] = now
                r.draining = True      # router stops picking it NOW
                r.expected_exit = True
            self._emit("roll_replica", replica=idx, phase="drain")
            r.proc.terminate()         # the replica drains, exits EXIT_OK
            return
        r = self._replica_by_index(roll["idx"])
        if r is None:
            with self._lock:
                roll["idx"] = None  # reaped mid-roll: move on
            return
        if roll["phase"] == "wait_exit":
            if r.proc is None:         # _handle_exit consumed the death
                with self._lock:
                    r.draining = False
                if not self._try_launch(r):
                    self._emit("roll_abort", replica=r.index,
                               reason="relaunch failed to spawn")
                    with self._lock:
                        self._roll = None
                    return
                with self._lock:
                    roll["phase"] = "wait_healthy"
                    roll["t"] = now
            elif (now - roll["t"] > self.policy.term_grace_secs
                    and r.alive()):
                self._emit("roll_replica", replica=r.index,
                           phase="sigkill")
                r.proc.kill()
        elif roll["phase"] == "wait_healthy":
            if r.healthy:
                self._emit("roll_replica", replica=r.index, phase="done")
                with self._lock:
                    roll["idx"] = None
            elif now - roll["t"] > self.policy.startup_grace_secs:
                # the relaunch never came up: abort the roll (capacity is
                # already degraded; the normal restart policy owns the
                # sick replica from here)
                self._emit("roll_abort", replica=r.index,
                           reason="relaunch never became healthy")
                with self._lock:
                    self._roll = None

    # -- hot reload ----------------------------------------------------------
    def _watch_loop(self) -> None:
        self._watcher.run(
            self.policy.watch_poll_secs, self._stop, self._on_new_step
        )

    def _on_new_step(self, step: int, path: str) -> None:
        with self._lock:
            self._target_step = step
            self._target_path = path
            # deliberately NOT _current_pretrained yet: the relaunch argv
            # pins a payload with no boot-time drift guard, so it only
            # ever carries VERIFIED weights (first successful guarded
            # deploy below) — a replica dying during the minutes-long
            # first reload attempt must not boot straight onto a
            # checkpoint no guard has judged; it boots on the last good
            # payload and converges via /admin/reload once healthy
        self._emit("reload_detected", step=step, path=path)
        self._reload_sync()

    def _reload_sync(self) -> None:
        """Bring every in-rotation replica to the target step, one at a
        time (the reload happens OFF the replica's request path, so
        capacity never drops during the roll). Replicas that are down or
        unhealthy converge later: on relaunch (argv pins the new
        payload) or on the next watcher pass."""
        if not self._reload_roll_lock.acquire(blocking=False):
            return  # a roll is in flight; the next pass converges
        try:
            self._reload_sync_locked()
        finally:
            self._reload_roll_lock.release()

    def _reload_sync_locked(self) -> None:
        with self._lock:
            step, path = self._target_step, self._target_path
        if path is None:
            return
        bank = self._paired_bank(step)
        if self.bank_dir and bank is None:
            return  # pair incomplete (bank still building / corrupt):
            # the step WAITS — encoder-only deployments on bank-free
            # fleets are untouched (bank_dir empty never gets here)
        for r in list(self.replicas):
            if self._stop.is_set():
                return
            with self._lock:
                skip = (r.abandoned or not r.healthy
                        or r.deployed_step >= step
                        or r.reload_refused_step >= step)
            if skip:
                continue
            ok, detail = self._post_reload(r, step, path, bank)
            if ok:
                with self._lock:
                    r.deployed_step = step
                    # known-good from the FIRST successful deploy (the
                    # replica's drift guard passed it), not only from a
                    # completed roll: with one replica down, a later
                    # quarantine must still roll the relaunch argv back
                    # to this payload, never past it to the boot weights
                    # — and only NOW may the relaunch argv pin it.
                    # The PREVIOUS pair is retained first: a bank
                    # mismatch surfacing on a LATER replica of this same
                    # roll rolls back to it, never to the bad pair.
                    if self._good_step != step:
                        self._prev_good = (self._good_pretrained,
                                           self._good_bank,
                                           self._good_step)
                    self._good_pretrained = path
                    self._good_bank = bank
                    self._good_step = step
                    self._current_pretrained = path
                self._emit("reload_replica", replica=r.index, step=step,
                           status="ok", detail=detail)
            else:
                with self._lock:
                    announce = r.reload_announced != step
                    r.reload_announced = step
                    if detail.startswith("status 409"):
                        # 409 is reload_refused ONLY (bank without a
                        # pair, ladder change — http.py maps transient
                        # load failures to 503): terminal for this step,
                        # stop re-attempting; transient failures retry
                        # on the next pass
                        r.reload_refused_step = step
                if announce:
                    self._emit("reload_failed", replica=r.index,
                               step=step, detail=detail)
                if "reload_bank_mismatch" in detail:
                    # dual swap: the replica judged the
                    # (checkpoint, bank) PAIR inconsistent (hash binding
                    # or the space-agreement probe). The verdict is
                    # deterministic — quarantine the pair as a unit, pin
                    # last-known-good, roll back half-swapped replicas
                    self._quarantine_pair(step, detail)
                    return
                if "reload_collapsed" in detail:
                    # drift guard: the replica judged the
                    # CHECKPOINT collapsed (degenerate probe embeddings),
                    # not its own config — quarantine the step dir so no
                    # other replica, relaunch argv, or later fleet ever
                    # promotes it, and stop targeting it
                    self._quarantine_collapsed(step, detail)
                    return
        with self._lock:
            done = all(
                r.deployed_step >= step
                for r in self.replicas if not r.abandoned
            ) and self._announced_step < step
            if done:
                self._announced_step = step
        if done:
            self._emit("reload_done", step=step, path=path,
                       replicas=self.n_replicas)

    def _quarantine_collapsed(self, step: int, detail: str) -> None:
        """A replica's reload drift guard judged step's checkpoint
        COLLAPSED (degenerate probe embeddings). The refusal
        is deterministic (same probe batch, same weights), so one
        replica's verdict stands for the fleet: quarantine the step dir
        (never re-discovered, never promoted by a later fleet), drop it
        as the reload target, and roll the relaunch argv back to the
        last known-good payload so a replica dying NOW does not boot on
        the refused weights."""
        with self._lock:
            if self._target_step == step:
                self._target_path = None
                self._current_pretrained = self._good_pretrained
        if self._watcher is not None:
            self._watcher.quarantine(
                step, f"reload drift guard: {detail[:160]}"
            )
        if self.bank_dir:
            # the pair dies as a unit: a bank built by a collapsed
            # checkpoint's encoder is as unusable as the weights
            self._quarantine_bank(step, "paired checkpoint collapsed")
        log_event(
            "fleet",
            f"checkpoint step {step} refused by the reload drift guard "
            f"(collapsed probe embeddings); quarantined — the fleet "
            f"keeps serving the previous weights",
        )

    # -- versioned-bank lifecycle ----------------------------------------------
    def _paired_bank(self, step: int) -> str | None:
        """The verified bank payload paired with checkpoint `step`, or
        None when the pair is incomplete. stdlib-only:
        the integrity hash check, not numpy, decides eligibility here —
        the replica's space-agreement probe is the deep check.

        A MISSING manifest means the build is still in flight (the
        builder writes it last): the step waits and a deduped
        `bank_waiting` event carries how far serving lags. A manifest
        that fails verification quarantines the bank immediately."""
        if not self.bank_dir:
            return None
        if step in self._bad_banks:
            return None
        if not os.path.exists(manifest_path(self.bank_dir, step)):
            with self._lock:
                announce = self._bank_waiting_step != step
                self._bank_waiting_step = step
                good_step = self._good_step
            if announce:
                self._emit_record(
                    "bank", "bank_waiting", step=step,
                    age_steps=(step - good_step if good_step >= 0
                               else None),
                    detail="no bank manifest yet — build in flight?",
                )
            return None
        if step not in self._bank_verified:
            reason = verify_step(self.bank_dir, step)
            if reason is not None:
                self._bad_banks.add(step)
                self._quarantine_bank(
                    step, f"bank manifest verification failed: {reason}"
                )
                return None
            self._bank_verified.add(step)
        step_dir = os.path.join(self.bank_dir, str(step))
        try:
            names = sorted(
                f for f in os.listdir(step_dir) if f.endswith(".npz")
            )
        except OSError:
            return None
        return os.path.join(step_dir, names[0]) if names else None

    def _quarantine_pair(self, step: int, detail: str) -> None:
        """A replica's space-agreement check judged the (checkpoint,
        bank) pair INCONSISTENT. The verdict is deterministic (seeded
        probe rows, content-hashed artifacts), so one replica's verdict
        stands for the fleet: quarantine BOTH halves as a unit, restore
        the pre-roll last-known-good pair, and roll back any replica
        that already swapped onto the bad pair."""
        with self._lock:
            if self._good_step == step and self._prev_good is not None:
                # a half-swapped roll advanced known-good onto the bad
                # pair before the mismatch surfaced: un-advance it
                (self._good_pretrained, self._good_bank,
                 self._good_step) = self._prev_good
            if self._target_step == step:
                self._target_path = None
                self._target_step = max(self._good_step, -1)
            self._current_pretrained = self._good_pretrained
        self._emit_record("bank", "quarantine", step=step,
                          detail=detail[:200])
        if self._watcher is not None:
            self._watcher.quarantine(
                step, f"bank/encoder space mismatch: {detail[:160]}"
            )
        self._quarantine_bank(step, "pair failed the space-agreement "
                                    "check")
        self._rollback_half_swapped(step)
        log_event(
            "fleet",
            f"(checkpoint, bank) pair for step {step} failed the "
            f"space-agreement check; quarantined as a unit — the fleet "
            f"keeps serving the last-known-good pair",
        )

    def _quarantine_bank(self, step: int, reason: str) -> None:
        """Move `<bank_dir>/<step>` to `.quarantine/` and drop its
        manifest — the preflight pattern the checkpoint watcher
        uses, applied to the bank half of a condemned pair. Best-effort:
        filesystem errors are emitted, never raised into the roll."""
        if not self.bank_dir:
            return
        self._bad_banks.add(step)
        self._bank_verified.discard(step)
        src = os.path.join(self.bank_dir, str(step))
        if not os.path.exists(src):
            return
        try:
            qdir = os.path.join(self.bank_dir, QUARANTINE_DIRNAME)
            os.makedirs(qdir, exist_ok=True)
            target = os.path.join(qdir, str(step))
            if os.path.exists(target):
                target = f"{target}.{int(time.time())}"
            os.rename(src, target)
            try:
                os.remove(manifest_path(self.bank_dir, step))
            except OSError:
                pass
            self._emit_record("bank", "bank_quarantine", step=step,
                              reason=reason, moved_to=target)
        except OSError as e:
            self._emit_record("bank", "bank_quarantine_error", step=step,
                              detail=f"{type(e).__name__}: {e}")

    def _rollback_half_swapped(self, step: int) -> None:
        """Return every replica already swapped onto the condemned pair
        to the last-known-good one. With a good pair on record the
        rollback is itself a dual swap (reload POST — zero downtime); a
        fleet condemned on its FIRST roll has no reloadable good pair,
        so the replica restarts onto its boot-time (weights, bank) argv
        — capacity dips to N−1 briefly, correctness never."""
        with self._lock:
            good = (self._good_pretrained, self._good_bank,
                    self._good_step)
            victims = [r for r in self.replicas
                       if not r.abandoned and r.deployed_step >= step]
        for r in victims:
            if good[0] is not None and good[2] >= 0:
                ok, detail = self._post_reload(r, good[2], good[0],
                                               good[1])
                if ok:
                    with self._lock:
                        r.deployed_step = good[2]
                    self._emit_record("bank", "rollback", replica=r.index,
                                      from_step=step, to_step=good[2],
                                      mode="reload")
                    continue
                self._emit("reload_failed", replica=r.index,
                           step=good[2],
                           detail=f"rollback failed: {detail}")
            # no reloadable good pair (or the rollback POST failed):
            # restart the replica onto its boot argv — the launch path
            # pins _current_pretrained, already reset to known-good
            with self._lock:
                r.deployed_step = -1
                alive = r.alive()
            if alive:
                r.proc.terminate()
            self._emit_record("bank", "rollback", replica=r.index,
                              from_step=step, to_step=good[2],
                              mode="restart")

    def _post_reload(self, r: ReplicaState, step: int, path: str,
                     bank: str | None = None) -> tuple[bool, str]:
        req = {"pretrained": path, "step": step}
        if bank is not None:
            # the dual swap: the replica verifies the pair (manifest,
            # checkpoint-hash binding, space-agreement probe) and rolls
            # engine + bank under one generation bump
            req["bank"] = bank
            req["bank_step"] = step
        body = json.dumps(req).encode()
        conn = http.client.HTTPConnection(
            r.host, r.port, timeout=self.policy.reload_timeout_s
        )
        try:
            conn.request("POST", "/admin/reload", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status == 200:
                return True, data.decode("utf-8", errors="replace")[:200]
            return False, (f"status {resp.status}: "
                           + data.decode("utf-8", errors="replace")[:200])
        except (OSError, http.client.HTTPException) as e:
            return False, f"{type(e).__name__}: {e}"
        finally:
            conn.close()

    # -- the monitor loop ----------------------------------------------------
    def _monitor_loop(self) -> None:
        poll = max(min(self.policy.probe_secs / 2.0, 0.5), 0.02)
        while not self._stop.is_set():
            now = time.monotonic()
            # snapshot: the autoscaler appends and reaps mid-iteration
            for r in list(self.replicas):
                if r.abandoned:
                    continue
                if r.reaping:
                    self._advance_reap(r, now)
                    continue
                if r.proc is None:
                    with self._lock:
                        due = (r.relaunch_at is not None
                               and now >= r.relaunch_at)
                    if due:
                        self._try_launch(r)
                    continue
                if r.proc.poll() is not None:
                    self._handle_exit(r)
                    continue
                if now - getattr(r, "_last_probe", 0.0) \
                        >= self.policy.probe_secs:
                    r._last_probe = now
                    self._probe_and_update(r)
                self._check_staleness(r, now)
            self._advance_roll(time.monotonic())
            # a reload target may predate a replica's recovery: converge
            # — on a THROWAWAY thread, never this one: one reload blocks
            # for a checkpoint load + ladder warmup, and the monitor
            # must keep probing/killing/relaunching the OTHER replicas
            # meanwhile (_reload_sync itself no-ops when a roll is
            # already in flight, so the spawn is cheap and un-duplicated)
            with self._lock:
                need_sync = any(
                    not r.abandoned and r.healthy
                    and r.deployed_step < self._target_step
                    and r.reload_refused_step < self._target_step
                    for r in self.replicas
                ) if self._target_path else False
            if need_sync and not self._reload_roll_lock.locked():
                threading.Thread(target=self._reload_sync, daemon=True,
                                 name="fleet-reload-converge").start()
            now = time.monotonic()
            if now - self._last_stats_event >= self.policy.stats_every_secs:
                with self._lock:
                    self._last_stats_event = now
                self._emit_router_stats()
                # the autoscaler consumes the SAME windowed stream it
                # just emitted: one cadence, one source of truth
                self._autoscale_tick(now)
            self._stop.wait(poll)

    # -- autoscaling ------------------------------------------------------------
    def _autoscale_tick(self, now: float) -> None:
        """One controller observation per stats emit. The snapshot fed
        to the controller is the SAME shape `_emit_router_stats` just
        wrote, so an operator replaying events.jsonl through an
        AutoscaleController reproduces every decision."""
        if self.policy.autoscale_max <= 0:
            return
        with self._lock:
            stats = self._router_counters()
            stats["healthy"] = sum(
                1 for r in self.replicas
                if r.healthy and not r.draining and not r.abandoned
            )
            stats["outstanding"] = sum(
                r.outstanding for r in self.replicas)
        if self._router_latency.count:
            stats["latency_ms"] = self._router_latency.percentiles_ms()
        decision = self._autoscaler.observe(stats, now)
        if decision is None:
            return
        action, reason = decision
        if action == "up":
            self._scale_up(reason)
        else:
            self._scale_down(reason)

    def _active_replicas(self) -> list[ReplicaState]:
        # caller holds the lock
        return [r for r in self.replicas
                if not r.abandoned and not r.reaping]

    def _scale_up(self, reason: str) -> None:
        with self._lock:
            if len(self._active_replicas()) >= self.policy.autoscale_max:
                return  # at the replica budget: breach stays visible in
                # router_stats; capacity does not follow
            index = self._next_index
            self._next_index += 1
        port = (self._base_port + index if self._base_port
                else pick_free_port(self.host))
        rdir = os.path.join(self.telemetry_dir, f"replica{index}")
        try:
            os.makedirs(rdir, exist_ok=True)
        except OSError as e:
            self._emit("autoscale_error", replica=index,
                       detail=f"cannot create {rdir!r}: {e}")
            return
        r = ReplicaState(index, self.host, port, rdir,
                         self.policy.max_restarts)
        if self.ann_shards:
            r.shard = index % self.ann_shards
        with self._lock:
            self.replicas.append(r)
            total = len(self.replicas)
        self._emit("autoscale_up", replica=index, port=port,
                   shard=r.shard, reason=reason, replicas=total)
        self._try_launch(r)

    def _scale_down(self, reason: str) -> None:
        with self._lock:
            active = self._active_replicas()
            # the floor: operator minimum, and never below one healthy
            # owner per ANN cell partition (shard cover)
            floor = max(self.policy.autoscale_min, self.ann_shards, 1)
            if len(active) <= floor:
                return

            def reapable(v: ReplicaState) -> bool:
                if not v.healthy or v.draining:
                    return False
                if v.shard is None:
                    return True
                # shard-cover guard: never reap a partition's last
                # healthy owner
                return any(
                    c is not v and c.shard == v.shard and c.healthy
                    and not c.draining
                    for c in active
                )

            cands = [r for r in active if reapable(r)]
            if not cands:
                return
            victim = max(cands, key=lambda r: r.index)
            victim.reaping = True
            victim.draining = True  # the router stops picking it NOW
            total = len(self.replicas)
        self._emit("autoscale_down", replica=victim.index,
                   shard=victim.shard, reason=reason, replicas=total)

    def _advance_reap(self, r: ReplicaState, now: float) -> None:
        """Drain-then-reap, one monitor pass at a time: `draining`
        already keeps new picks away, so wait for the router's
        in-flight count to hit zero, SIGTERM (the replica finishes
        accepted work and exits cleanly), escalate a straggler past
        the grace window, and drop the replica from the table once the
        process is gone. Zero accepted requests lost by construction."""
        if r.proc is None:
            with self._lock:
                if r in self.replicas:
                    self.replicas.remove(r)
                remaining = len(self.replicas)
            self._emit("autoscale_reaped", replica=r.index,
                       replicas=remaining)
            return
        if r.proc.poll() is not None:
            self._handle_exit(r)  # reaping => no relaunch scheduled
            return
        term = kill = False
        with self._lock:
            if not r.expected_exit:
                if r.outstanding == 0:
                    r.expected_exit = True
                    r.term_at = now
                    term = True
            elif now - r.term_at > self.policy.term_grace_secs:
                r.term_at = now
                kill = True
        if term:
            r.proc.terminate()
        elif kill:
            self._emit("kill", replica=r.index, pid=r.pid,
                       reason="reap_straggler", phase="sigkill")
            r.proc.kill()

    def _emit_router_stats(self, final: bool = False) -> None:
        """The autoscaler input record: one
        `kind:"fleet", event:"router_stats"` line on a fixed time
        cadence (`stats_every_secs`, plus one `final` at stop). STABLE
        SCHEMA — obsd and the autoscaler key on it:

          requests/ok/retries/retry_ok        cumulative counters
          shed_no_backend / upstream_timeout /
          upstream_error / shed_deadline_router /
          passthrough_non_200                 cumulative per-code sheds
          outstanding                         in-flight depth gauge NOW
          healthy / replicas                  rotation-eligible / total
          latency_ms {p50,p95,p99} + window   answered-request latency
                                              over the trailing ring
                                              (absent until any answer)
          interval_s                          the emit cadence, so a
                                              consumer can rate-convert
                                              counter deltas

        ADDITIVE keys (a consumer of the keys above keeps working):

          requests_interactive /
          requests_batch                      cumulative per-tier demand
          knn_fanout / knn_partial            cumulative sharded-kNN
                                              scatters / partial answers
          ann_shards                          cell-partition count
                                              (absent on ann-free fleets)
          knn_merge_ms {p50,p95,p99}          end-to-end fan-out latency
                                              (absent until any fan-out)

        Consumers take DELTAS between consecutive records for rates (the
        counters are cumulative — a last-snapshot fold stays valid)."""
        with self._lock:
            counters = self._router_counters()
            healthy = sum(
                1 for r in self.replicas
                if r.healthy and not r.draining and not r.abandoned
            )
            outstanding = sum(r.outstanding for r in self.replicas)
        extras: dict = {
            "outstanding": outstanding,
            "replicas": len(self.replicas),
            "interval_s": self.policy.stats_every_secs,
        }
        if self._router_latency.count:
            extras["latency_ms"] = self._router_latency.percentiles_ms()
            extras["window"] = self._router_latency.count
        if self.ann_shards:
            extras["ann_shards"] = self.ann_shards
        if self._knn_merge.count:
            extras["knn_merge_ms"] = self._knn_merge.percentiles_ms()
        self._emit("router_stats", final=final, healthy=healthy,
                   **counters, **extras)
