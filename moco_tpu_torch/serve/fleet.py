"""Supervision pieces of the serving fleet (the port's own copy of the part
of `moco_tpu/serve/fleet.py` that the input service's staging server uses).

- `FleetLaunchError`: a replica command that could not be spawned.
- `pick_free_port`: an ephemeral port for an auto-assigned data port.
- `FleetPolicy`: the supervision knobs (probe cadence, staleness window,
  start-up grace, SIGTERM grace, restart budget, backoff), with the JAX
  package's defaults; the router's, reload's and autoscaler's knobs come
  with the fleet itself.
- `ReplicaState`: one supervised process's bookkeeping (the router's,
  reload's and ANN shard's fields come with the fleet).

Pure stdlib: the supervisor that imports it must outlive the decode and
serving runtimes it supervises.
"""

from __future__ import annotations

import dataclasses
import random
import socket
import subprocess


class FleetLaunchError(RuntimeError):
    """A replica COMMAND could not be spawned at fleet start (missing
    binary, exec failure). Distinct from a bind OSError on purpose: a bind
    failure means reschedule (EXIT_FLEET_BIND), this one means the same
    argv can never succeed (EXIT_CONFIG_ERROR)."""


def pick_free_port(host: str = "127.0.0.1") -> int:
    """Ephemeral-port discovery for auto ports (tests, the local pool).
    A race is possible between the close and the child's bind; the loser
    exits with its bind code and the supervisor classifies it fatal: loud,
    not flaky."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class FleetPolicy:
    """Supervision knobs (`python -m moco_tpu_torch.staging_server` exposes
    the staging server's)."""

    probe_secs: float = 1.0            # per-replica probe cadence
    probe_timeout_s: float = 2.0       # one probe's connect+answer budget
    health_stale_secs: float = 10.0    # no probe ANSWER for this long (once
                                       # healthy this life): wedged, kill it
    startup_grace_secs: float = 300.0  # launch -> first healthy probe
    term_grace_secs: float = 15.0      # SIGTERM -> grace -> SIGKILL
    max_restarts: int = 5              # consecutive never-healthy deaths
                                       # before abandoning; a healthy life
                                       # refunds the budget in full
    backoff_base_secs: float = 0.5
    backoff_max_secs: float = 30.0
    backoff_jitter: float = 0.2

    def backoff_secs(self, consecutive_failures: int, rng: random.Random) -> float:
        base = min(self.backoff_base_secs * (2.0 ** max(consecutive_failures - 1, 0)),
                   self.backoff_max_secs)
        return base * (1.0 + self.backoff_jitter * rng.random())


class ReplicaState:
    """One supervised process's state. Every mutable field is guarded by the
    supervisor's lock."""

    def __init__(self, index: int, host: str, port: int, telemetry_dir: str, budget: int):
        self.index = index
        self.host = host
        self.port = port
        self.telemetry_dir = telemetry_dir
        self.proc: subprocess.Popen | None = None
        self.pid: int | None = None
        self.launches = 0
        self.budget = budget
        self.consecutive_failures = 0
        self.healthy = False           # last probe answered
        self.abandoned = False         # fatal class or exhausted budget
        self.expected_exit = False     # WE asked it to exit
        self.launched_at = 0.0
        self.last_ok_life: float | None = None  # newest probe ANSWER this life
        self.ever_healthy_life = False
        self.kill_phase: str | None = None      # None | "term" | "kill"
        self.term_at = 0.0
        self.relaunch_at: float | None = None   # pending relaunch time
        self.classifications: list[str] = []

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def snapshot(self) -> dict:
        return {
            "replica": self.index,
            "port": self.port,
            "pid": self.pid,
            "healthy": self.healthy,
            "abandoned": self.abandoned,
            "launches": self.launches,
            "restarts": max(self.launches - 1, 0),
            "budget_left": self.budget,
            "classifications": list(self.classifications),
        }
