"""Run the pretrain driver under the out-of-process supervisor (the port's
counterpart of `tools/supervise.py`).

    python -m moco_tpu_torch.supervise --telemetry-dir runs/r1/telemetry \\
        --ckpt-dir runs/r1/ckpt -- \\
        python -m moco_tpu_torch.train --preset imagenet-moco-v2 --num-devices 8 \\
            --telemetry-dir runs/r1/telemetry --ckpt-dir runs/r1/ckpt

Everything after `--` is the child command, launched verbatim (plus
`--resume auto` unless it already carries a `--resume`). The supervisor
detects hangs from heartbeat.json staleness, classifies every death (the
exit-code protocol, the death signal, events-tail forensics), restarts
within a progress-refunded budget with exponential backoff, quarantines
checkpoints that fail their integrity manifest before each relaunch, and
relaunches a resized run with `--num-devices N` appended. Its records land
as `kind: "supervisor"` lines in the child's events.jsonl, which
`tools/telemetry_report.py` renders.

Give the child its own rank launcher (`--num-devices N`), not torchrun: the
resize appends `--num-devices` to the child's argv, the classification
reads the child's own exit code, and a resize request reaches the child as
SIGUSR2; torchrun takes its count before the script, turns a rank's 43 or
49 into its own exit 1, and dies of SIGUSR2 leaving its ranks behind.

SIGUSR2 to the supervisor requests a resize: the next monitor cycle claims
any pending `resize.request` payload (or an empty "resize to what is
visible" request) and signals the child.

Exit code: 0 when the child finished cleanly; the child's final exit code
when the supervisor gave up (a fatal class or an exhausted budget), so one
level further up (cron, systemd) still sees the structured code.

Stdlib only, like the modules it drives.
"""

from __future__ import annotations

import argparse
import signal
import sys

from moco_tpu_torch.resilience.supervisor import RestartPolicy, Supervisor
from moco_tpu_torch.utils.logging import info


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m moco_tpu_torch.supervise",
        description="Run the pretrain driver under the out-of-process supervisor.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--telemetry-dir", required=True,
                   help="the child's telemetry dir (heartbeat.json and events.jsonl "
                        "live here; must match the child's --telemetry-dir)")
    p.add_argument("--ckpt-dir", default="",
                   help="the child's checkpoint dir: enables the resume-integrity "
                        "preflight and the checkpoint-step progress fallback")
    p.add_argument("--max-restarts", type=int, default=5,
                   help="consecutive no-progress restarts before giving up (any step "
                        "progress refunds the full budget)")
    p.add_argument("--heartbeat-stale-secs", type=float, default=120.0,
                   help="kill the child when its newest step-phase beat is older than "
                        "this; 0 disables hang detection")
    p.add_argument("--startup-grace-secs", type=float, default=900.0,
                   help="staleness allowance before each launch's first step beat "
                        "(imports, kernel load, restore)")
    p.add_argument("--term-grace-secs", type=float, default=30.0,
                   help="SIGTERM -> grace -> SIGKILL escalation window")
    p.add_argument("--backoff-base-secs", type=float, default=1.0)
    p.add_argument("--backoff-max-secs", type=float, default=60.0)
    p.add_argument("--backoff-jitter", type=float, default=0.2)
    p.add_argument("--poll-secs", type=float, default=2.0)
    p.add_argument("--oom-rss-bytes", type=float, default=0.0,
                   help="classify an external SIGKILL as OOM when the events-tail RSS "
                        "is >= this (0 = never)")
    p.add_argument("--no-force-resume", action="store_true",
                   help="do NOT append `--resume auto` to the child's argv")
    p.add_argument("--resize-device-flag", default="--num-devices",
                   help="flag that pins the device count on a resize relaunch")
    p.add_argument("--resize-slow-cadence", type=int, default=0,
                   help="grad_sync_cadence appended when a resize request flags the new "
                        "cards slowly linked (`slow=1` in resize.request); 0 = never")
    p.add_argument("--child-log", default="",
                   help="child stdout/stderr log path (default <telemetry-dir>/child.log)")
    p.add_argument("child", nargs=argparse.REMAINDER,
                   help="-- then the child command")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    child = args.child
    if child and child[0] == "--":
        child = child[1:]
    if not child:
        parser.error("no child command given (append `-- python -m moco_tpu_torch.train "
                     "...`)")
    policy = RestartPolicy(
        max_restarts=args.max_restarts,
        heartbeat_stale_secs=args.heartbeat_stale_secs,
        startup_grace_secs=args.startup_grace_secs,
        term_grace_secs=args.term_grace_secs,
        backoff_base_secs=args.backoff_base_secs,
        backoff_max_secs=args.backoff_max_secs,
        backoff_jitter=args.backoff_jitter,
        poll_secs=args.poll_secs,
        oom_rss_bytes=args.oom_rss_bytes,
    )
    sup = Supervisor(
        child,
        telemetry_dir=args.telemetry_dir,
        ckpt_dir=args.ckpt_dir,
        policy=policy,
        force_resume=not args.no_force_resume,
        child_log_path=args.child_log,
        resize_device_flag=args.resize_device_flag,
        resize_slow_cadence=args.resize_slow_cadence,
    )
    signal.signal(signal.SIGUSR2, lambda *_: sup.resize.signal_resize())
    result = sup.run()
    info(
        f"supervisor: {result.final_class} after {result.launches} launch(es)"
        f" ({result.restarts} restart(s)"
        f"{', budget exhausted' if result.gave_up else ''})"
    )
    if result.final_class == "clean":
        return 0
    return result.exit_code if result.exit_code and result.exit_code > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
