"""Run a replicated serving fleet: N port replicas behind one router (the
port's counterpart of `tools/serve_fleet.py`).

    python -m moco_tpu_torch.serve_fleet --replicas 2 --port 8080 \
        --telemetry-dir runs/fleet --watch-dir runs/export -- \
        python -m moco_tpu_torch.serve --pretrained runs/encoder.npz --arch resnet50

Everything after `--` is ONE replica's base command; the fleet appends
`--port <p>` and `--telemetry-dir <dir>/replica<i>` per replica (and,
after a hot reload, `--pretrained <newest verified payload>` so a
relaunched replica boots on the deployed weights). The front-end router
serves `POST /v1/embed` / `POST /v1/knn` (health-routed least-outstanding
with single-retry), `GET /healthz`, `GET /stats`; replica `/admin/*`
stays on the replicas' own ports, never proxied. Without `--device cpu`
in the base command every replica serves from card 0.

Signals: SIGTERM/SIGINT drain the whole fleet (replicas finish accepted
work) and exit 0; a second signal exits immediately. SIGHUP triggers a
drain-aware ROLLING restart that never takes capacity below N−1.

`--watch-dir` arms the hot-reload watcher: new integrity-manifested
steps are verified, corrupt ones quarantined to `.quarantine/`, and
verified ones rolled across the fleet via each replica's
`POST /admin/reload` — zero dropped requests. `--bank-dir` pairs each
step with its versioned kNN bank (`python -m moco_tpu_torch.bank_build`).

`--ann-shards N` partitions a bank's IVF index across the fleet: replica
i serves cell partition i%N (`--ann-shard`/`--ann-shards` appended to its
command) and the router scatter-gathers `/v1/knn` across one healthy
owner per shard, merging top-k under the request's deadline — shards
that miss it are dropped and the answer is flagged `partial: true`.
`--autoscale-max > 0` arms the telemetry-driven autoscaler: sustained
shed/depth/p99 breaches in the router_stats stream spawn replicas up to
the budget, sustained idle drains-then-reaps down to
max(--autoscale-min, shard cover).

`--chaos`/`--chaos-replica` install a drill fault (e.g.
`kill_at_request=200`, `wedge_at_request=200`) on ONE replica via
MOCO_TPU_CHAOS, with fire-once state persisted per replica dir so the
restarted replica doesn't re-fire the drill.

The standard library alone, transitively: this process must outlive
replicas that run out of memory or segfault.

Exit codes (`resilience/exitcodes.py`): 0 clean drain · 45 bad flags or
a replica command that cannot be spawned · 48 could not bind the router
host:port · 1 every replica abandoned.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time

from moco_tpu_torch.resilience.exitcodes import EXIT_CONFIG_ERROR, EXIT_FLEET_BIND, EXIT_OK
from moco_tpu_torch.serve.fleet import FleetLaunchError, FleetPolicy, FleetSupervisor
from moco_tpu_torch.utils.logging import info


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m moco_tpu_torch.serve_fleet",
        description="Run a replicated serving fleet: N port replicas behind one router.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="front-end router port (0 = ephemeral, printed)")
    p.add_argument("--base-port", type=int, default=0,
                   help="replica i binds base-port+i; 0 picks free "
                        "ephemeral ports")
    p.add_argument("--telemetry-dir", required=True,
                   help="fleet events.jsonl + per-replica dirs live here")
    p.add_argument("--watch-dir", default="",
                   help="checkpoint export dir to watch for hot reloads "
                        "(<step>/ layout + integrity manifests)")
    p.add_argument("--bank-dir", default="",
                   help="versioned kNN-bank dir (python -m "
                        "moco_tpu_torch.bank_build layout): a watched step "
                        "deploys ONLY with its verifying paired bank, rolled "
                        "as an atomic (engine, bank) dual swap")
    p.add_argument("--probe-secs", type=float, default=1.0)
    p.add_argument("--probe-timeout-s", type=float, default=2.0)
    p.add_argument("--health-stale-secs", type=float, default=10.0,
                   help="kill a replica whose newest probe answer is "
                        "older than this (accepting-but-not-answering "
                        "wedge)")
    p.add_argument("--startup-grace-secs", type=float, default=300.0,
                   help="launch -> first healthy probe allowance (cold "
                        "torch import + the ladder's CUDA-graph captures)")
    p.add_argument("--term-grace-secs", type=float, default=15.0)
    p.add_argument("--max-restarts", type=int, default=5,
                   help="consecutive never-healthy deaths per replica "
                        "before abandoning it (a healthy life refunds)")
    p.add_argument("--backoff-base-secs", type=float, default=0.5)
    p.add_argument("--backoff-max-secs", type=float, default=30.0)
    p.add_argument("--backoff-jitter", type=float, default=0.2)
    p.add_argument("--request-timeout-s", type=float, default=30.0,
                   help="router default per-request deadline (a body "
                        "deadline_ms wins)")
    p.add_argument("--watch-poll-secs", type=float, default=1.0)
    p.add_argument("--reload-timeout-s", type=float, default=300.0)
    p.add_argument("--stats-every-secs", type=float, default=30.0,
                   help="router_stats emit cadence — the autoscaler/obsd "
                        "input stream (cumulative per-code sheds, "
                        "outstanding depth, latency p50/p95/p99)")
    p.add_argument("--ann-shards", type=int, default=0,
                   help="ANN cell partitions: replica i "
                        "serves shard i%%N of the bank's IVF index and "
                        "the router scatter-gathers /v1/knn; 0 = every "
                        "replica answers exact/full-index kNN alone. "
                        "Requires --replicas >= this and replica "
                        "commands with --ann-cells")
    p.add_argument("--autoscale-max", type=int, default=0,
                   help="replica budget for telemetry-driven "
                        "autoscaling; 0 disables the autoscaler")
    p.add_argument("--autoscale-min", type=int, default=1,
                   help="never reap below this many replicas (ANN "
                        "shard cover raises the effective floor)")
    p.add_argument("--autoscale-cooldown-s", type=float, default=60.0,
                   help="minimum gap between scale actions")
    p.add_argument("--autoscale-up-after", type=int, default=2,
                   help="consecutive breached stats windows before a "
                        "scale-up")
    p.add_argument("--autoscale-down-after", type=int, default=6,
                   help="consecutive idle stats windows before a "
                        "drain-then-reap")
    p.add_argument("--autoscale-shed-high", type=float, default=0.02,
                   help="windowed shed-rate breach threshold")
    p.add_argument("--autoscale-outstanding-high", type=float,
                   default=4.0,
                   help="in-flight depth per healthy replica breach "
                        "threshold")
    p.add_argument("--autoscale-p99-high-ms", type=float, default=0.0,
                   help="p99 latency breach threshold in ms; 0 disables "
                        "the latency trigger")
    p.add_argument("--autoscale-idle-low", type=float, default=0.25,
                   help="depth per healthy replica below this (with "
                        "zero sheds) counts as an idle window")
    p.add_argument("--chaos", default="",
                   help="drill fault spec for ONE replica, e.g. "
                        "kill_at_request=200 (see resilience/chaos.py)")
    p.add_argument("--chaos-replica", type=int, default=0,
                   help="which replica gets --chaos")
    p.add_argument("replica_cmd", nargs=argparse.REMAINDER,
                   help="-- then one replica's base command")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    cmd = args.replica_cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        info("config error: no replica command given (append `-- python "
             "-m moco_tpu_torch.serve --pretrained ...`)")
        return EXIT_CONFIG_ERROR
    if args.replicas < 1:
        info(f"config error: --replicas must be >= 1, got {args.replicas}")
        return EXIT_CONFIG_ERROR
    if args.ann_shards < 0:
        info(f"config error: --ann-shards must be >= 0, "
             f"got {args.ann_shards}")
        return EXIT_CONFIG_ERROR
    if args.ann_shards and args.replicas < args.ann_shards:
        info(f"config error: --ann-shards {args.ann_shards} needs at "
             f"least that many replicas to cover every cell partition, "
             f"got --replicas {args.replicas}")
        return EXIT_CONFIG_ERROR
    if args.autoscale_max:
        if args.autoscale_min < 1:
            info(f"config error: --autoscale-min must be >= 1, "
                 f"got {args.autoscale_min}")
            return EXIT_CONFIG_ERROR
        if args.autoscale_max < max(args.autoscale_min, args.replicas):
            info(f"config error: --autoscale-max {args.autoscale_max} "
                 f"below max(--autoscale-min {args.autoscale_min}, "
                 f"--replicas {args.replicas})")
            return EXIT_CONFIG_ERROR
        if args.autoscale_cooldown_s < 0:
            info("config error: --autoscale-cooldown-s must be >= 0")
            return EXIT_CONFIG_ERROR
        if args.autoscale_up_after < 1 or args.autoscale_down_after < 1:
            info("config error: --autoscale-up-after and "
                 "--autoscale-down-after must be >= 1")
            return EXIT_CONFIG_ERROR

    def child_argv(index: int, port: int, telemetry_dir: str,
                   pretrained: str | None,
                   bank: str | None = None,
                   shard: int | None = None) -> list:
        out = list(cmd) + ["--port", str(port),
                           "--telemetry-dir", telemetry_dir]
        if pretrained:
            # argparse last-wins: this overrides the base command's
            # --pretrained so a relaunch boots on the deployed weights
            out += ["--pretrained", pretrained]
        if bank:
            # dual-swap fleets: pin the deployed bank too —
            # a relaunch must boot on the (weights, bank) PAIR, never
            # new weights over the boot-time bank
            out += ["--knn-bank", bank]
        if shard is not None and args.ann_shards:
            # sharded ANN: pin the replica's cell partition
            # so a relaunch comes back serving ITS shard
            out += ["--ann-shard", str(shard),
                    "--ann-shards", str(args.ann_shards)]
        return out

    replica_env = {}
    if args.chaos:
        replica_env[args.chaos_replica] = {
            "MOCO_TPU_CHAOS": args.chaos,
            "MOCO_TPU_CHAOS_STATE": os.path.join(
                args.telemetry_dir, f"replica{args.chaos_replica}",
                "chaos_state",
            ),
        }

    policy = FleetPolicy(
        probe_secs=args.probe_secs,
        probe_timeout_s=args.probe_timeout_s,
        health_stale_secs=args.health_stale_secs,
        startup_grace_secs=args.startup_grace_secs,
        term_grace_secs=args.term_grace_secs,
        max_restarts=args.max_restarts,
        backoff_base_secs=args.backoff_base_secs,
        backoff_max_secs=args.backoff_max_secs,
        backoff_jitter=args.backoff_jitter,
        request_timeout_s=args.request_timeout_s,
        watch_poll_secs=args.watch_poll_secs,
        reload_timeout_s=args.reload_timeout_s,
        stats_every_secs=args.stats_every_secs,
        autoscale_min=args.autoscale_min,
        autoscale_max=args.autoscale_max,
        autoscale_cooldown_s=args.autoscale_cooldown_s,
        autoscale_up_after=args.autoscale_up_after,
        autoscale_down_after=args.autoscale_down_after,
        autoscale_shed_high=args.autoscale_shed_high,
        autoscale_outstanding_high=args.autoscale_outstanding_high,
        autoscale_p99_high_ms=args.autoscale_p99_high_ms,
        autoscale_idle_low=args.autoscale_idle_low,
    )
    fleet = FleetSupervisor(
        child_argv,
        replicas=args.replicas,
        telemetry_dir=args.telemetry_dir,
        host=args.host,
        router_port=args.port,
        base_port=args.base_port,
        policy=policy,
        watch_dir=args.watch_dir,
        bank_dir=args.bank_dir,
        replica_env=replica_env,
        ann_shards=args.ann_shards,
    )
    try:
        fleet.start()
    except FleetLaunchError as e:
        # the replica COMMAND can't spawn: the same argv can never
        # succeed — config error, NOT the reschedule-semantics 48
        info(f"config error: {e}")
        return EXIT_CONFIG_ERROR
    except OSError as e:
        info(f"cannot bind the fleet router {args.host}:{args.port}: {e}")
        return EXIT_FLEET_BIND

    if hasattr(signal, "SIGHUP"):
        signal.signal(
            signal.SIGHUP,
            lambda signum, frame: fleet.request_rolling_restart(),
        )

    from moco_tpu_torch.resilience.preemption import PreemptionHandler

    with PreemptionHandler() as pre:
        info(
            f"fleet serving on {fleet.router.url} "
            f"({args.replicas} replicas on ports "
            f"{[r.port for r in fleet.replicas]}; SIGHUP = rolling "
            f"restart)"
        )
        while not pre.triggered and not fleet.failed:
            time.sleep(0.2)
    fleet.stop()
    if fleet.failed:
        info("fleet failed: every replica abandoned")
        return 1
    info("fleet drained cleanly")
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
