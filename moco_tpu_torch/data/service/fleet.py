"""LocalServerPool: N staging servers on this host (port of
`moco_tpu/data/service/fleet.py`).

The multi-server deployments the tests, `chip_smoke.py` and the drills
need, without N `python -m moco_tpu_torch.staging_server` terminals: each
member is one full `StagingServer` (stdlib supervisor + decode-worker
subprocess), so everything a drill exercises (probe liveness, budgeted
relaunch, the EXIT_STAGING_BIND class) is the code a deployment runs.

`per_server_env` overlays the environment by server index: a drill poisons
exactly ONE server with `MOCO_TPU_CHAOS=kill_at_shard=N` (and a per-server
`MOCO_TPU_CHAOS_STATE` directory, so the supervisor's relaunch is not
poisoned again) while its peers stay healthy.

Pure stdlib: the pool is control-plane code and must outlive the decode
runtimes it supervises.
"""

from __future__ import annotations

import os
import time

from moco_tpu_torch.data.service.server import StagingServer
from moco_tpu_torch.serve.fleet import FleetPolicy
from moco_tpu_torch.utils.logging import log_event


class LocalServerPool:
    """Spawn and own `n` StagingServers with auto-picked ports.

    `worker_args` is the dataset/decode argv tail every server forwards
    to its decode worker (one flag surface — see
    `worker.add_dataset_flags`). Every construction closes in a
    `finally`, as a loader's does."""

    def __init__(self, n: int, worker_args: list[str], *,
                 host: str = "127.0.0.1", telemetry_root: str = "",
                 policy: FleetPolicy | None = None,
                 per_server_env: dict[int, dict] | None = None,
                 worker_python: str | None = None):
        if n < 1:
            raise ValueError(f"pool needs >= 1 server, got {n}")
        self.servers: list[StagingServer] = []
        per_server_env = per_server_env or {}
        try:
            for i in range(n):
                env = None
                overlay = per_server_env.get(i)
                if overlay is not None:
                    env = dict(os.environ)
                    env.update(overlay)
                self.servers.append(StagingServer(
                    list(worker_args), host=host, server_id=i,
                    telemetry_dir=(os.path.join(
                        telemetry_root, f"staging_server{i}")
                        if telemetry_root else ""),
                    policy=policy, env=env, worker_python=worker_python,
                ))
        except BaseException:
            self.close_quietly()
            raise

    def start(self) -> None:
        for server in self.servers:
            server.start()

    def wait_healthy(self, timeout_s: float = 60.0) -> bool:
        """True when EVERY server answered a probe. A server that went
        terminal (abandoned) fails the wait immediately — a pool that
        silently came up short would turn a two-server drill into an
        unnoticed single point of failure. ONE shared deadline: servers
        come up concurrently, so a dead pool reports in timeout_s, not
        n x timeout_s."""
        deadline = time.monotonic() + timeout_s
        return all(
            s.wait_healthy(max(deadline - time.monotonic(), 0.05))
            for s in self.servers)

    def endpoints(self) -> list[tuple[str, int]]:
        return [(s.host, s.data_port) for s in self.servers]

    def endpoints_spec(self) -> str:
        """The `"host:port,host:port"` form PretrainConfig.input_service
        takes."""
        return ",".join(f"{h}:{p}" for h, p in self.endpoints())

    def worker_pids(self) -> list[int | None]:
        """Live decode-worker pids by server index (drills SIGKILL one)."""
        return [s.worker.pid if s.worker.alive() else None
                for s in self.servers]

    def close(self) -> None:
        for server in self.servers:
            server.close_quietly()

    def close_quietly(self) -> None:
        try:
            self.close()
        except Exception as e:  # noqa: BLE001 — teardown must not unwind
            log_event("input_server", f"pool stop failed (ignored): {e!r}")
