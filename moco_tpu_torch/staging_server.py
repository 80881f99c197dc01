"""One input-service staging server (port of `tools/staging_server.py`).

    python -m moco_tpu_torch.staging_server --data-port 5600 --health-port 8080 \\
        --dataset imagefolder --data-dir /data/imagenet/train

then train with `python -m moco_tpu_torch.train ... --input-service
host:5600[,host2:5600]`.

Runs the stdlib supervisor half of one staging server
(`data/service/server.py`): it binds the health endpoint (`/healthz`,
`/stats`), starts the decode worker as a SUBPROCESS (`python -m
moco_tpu_torch.data.service.worker`) on the data port, probes it over the
real serving path (a `ping` frame: an answer is the heartbeat), kills a
probe-stale worker (SIGTERM -> grace -> SIGKILL) and relaunches it within a
restart budget a healthy life refunds.

Flags this CLI does not know are forwarded VERBATIM to the decode worker
(its `--dataset/--data-dir/--prestage/--cache-mb/--trace-mode/...` surface;
`worker.add_dataset_flags` is the one source), so the supervisor stays pure
stdlib without re-declaring the worker's numpy-side flags.

Exit codes (`resilience/exitcodes.py`): EXIT_STAGING_BIND (50) when the
health port cannot be bound (or, classified from the worker, the data
port): reschedule, do not retry; 45 on a config-class worker death (a
dataset that cannot be built); 0 after a SIGTERM or SIGINT drain.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

from moco_tpu_torch.data.service.server import StagingServer
from moco_tpu_torch.resilience.exitcodes import EXIT_OK, EXIT_STAGING_BIND
from moco_tpu_torch.serve.fleet import FleetPolicy
from moco_tpu_torch.utils.logging import log_event


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="one staging server: stdlib supervisor + decode-worker subprocess "
                    "(unrecognized flags forward to the worker)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--data-port", type=int, default=0,
                        help="frame-protocol port (0 = auto)")
    parser.add_argument("--health-port", type=int, default=0,
                        help="/healthz + /stats port (0 = auto)")
    parser.add_argument("--server-id", type=int, default=0)
    parser.add_argument("--telemetry-dir", default="",
                        help="events.jsonl + worker.log + spans land here (default: a "
                             "fresh temporary directory)")
    parser.add_argument("--probe-secs", type=float, default=1.0)
    parser.add_argument("--health-stale-secs", type=float, default=10.0)
    parser.add_argument("--startup-grace-secs", type=float, default=60.0)
    parser.add_argument("--max-restarts", type=int, default=5)
    args, worker_args = parser.parse_known_args(argv)

    policy = FleetPolicy(probe_secs=args.probe_secs,
                         health_stale_secs=args.health_stale_secs,
                         startup_grace_secs=args.startup_grace_secs,
                         max_restarts=args.max_restarts)
    try:
        server = StagingServer(worker_args, host=args.host, data_port=args.data_port,
                               health_port=args.health_port,
                               telemetry_dir=args.telemetry_dir, server_id=args.server_id,
                               policy=policy)
    except OSError as e:
        log_event("input_server",
                  f"cannot bind health port {args.host}:{args.health_port}: {e}")
        return EXIT_STAGING_BIND

    stop = threading.Event()

    def _drain(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    try:
        server.start()
        log_event("input_server",
                  f"staging server {args.server_id}: data {server.host}:{server.data_port}, "
                  f"health http://{server.host}:{server.health_port}/healthz, telemetry "
                  f"{server.telemetry_dir}")
        while not stop.is_set():
            if server.abandoned_class() is not None:
                # the worker died a fatal class or spent its budget: the
                # supervisor speaks for the server it fronts
                return server.exit_code()
            time.sleep(0.2)
        return EXIT_OK
    finally:
        server.close_quietly()


if __name__ == "__main__":
    sys.exit(main())
