"""obsd: the always-on telemetry aggregator and SLO engine (the port's
counterpart of `tools/obsd.py`).

    python -m moco_tpu_torch.obsd runs/train/telemetry runs/fleet \
        --rules tools/slo_rules/serve_scale.json --port 9100

Tails every telemetry stream under the given roots (a directory
contributes its own events.jsonl plus every replica*/ and
staging_server*/ events.jsonl under it — the fleet and input-service
layouts; a .jsonl FILE is one stream; new replica dirs are discovered
live), folds the records into per-run_id rolling windows, and evaluates a
declarative SLO rule file each tick. Alert/recovery transitions are
appended as `kind:"slo"` records into the PRODUCING run's own
events.jsonl — the stream `tools/telemetry_report.py` (its `slo:` section
and `--follow` lines) already reads. obsd is a pure READER of producer
telemetry: its only write is that one O_APPEND alert line, and no
producer ever blocks on obsd being up, slow, or dead.

Endpoints (one ThreadingHTTPServer):

    /metrics   Prometheus text exposition 0.0.4 (step-time percentiles,
               data-stall share, MFU, router depth/latency/sheds, serve
               latency, per-event counters, SLO states — labeled by
               run_id)
    /slo       rule spec + per-run alert state (JSON)
    /runs      every observed run: sources, record kinds, staleness,
               last step (JSON)
    /healthz   liveness

The rule-file reference is the `SLORule` docstring in
`moco_tpu_torch/telemetry/aggregate.py`; the shipped rule files are
`tools/slo_rules/*.json` (learning health, bank lifecycle, serving scale).

The standard library alone, transitively: obsd must keep answering while
the runtimes it watches run out of memory, wedge, or crash-loop.

Exit codes (`resilience/exitcodes.py`): 0 clean (SIGTERM/SIGINT drain) ·
45 bad flags or rule file.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading

from moco_tpu_torch.resilience.exitcodes import EXIT_CONFIG_ERROR, EXIT_OK
from moco_tpu_torch.telemetry.aggregate import Aggregator, ObsServer, load_rules
from moco_tpu_torch.utils.logging import info


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m moco_tpu_torch.obsd",
        description="obsd: the telemetry aggregator and SLO engine.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("roots", nargs="+",
                   help="telemetry directories (train run, fleet dir) "
                        "or events.jsonl files to tail")
    p.add_argument("--rules", default="",
                   help="SLO rule file (JSON list or {\"rules\": [...]}); "
                        "empty = the built-in default set")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9100,
                   help="HTTP endpoint port (0 = ephemeral, printed)")
    p.add_argument("--tick-secs", type=float, default=1.0,
                   help="poll + SLO evaluation cadence")
    p.add_argument("--ring", type=int, default=2048,
                   help="per-run ring size (records kept per window)")
    p.add_argument("--retire-secs", type=float, default=6 * 3600.0,
                   help="drop a run's window + rule state once it ended "
                        "or went silent this long (and is not alerting) "
                        "— bounded state for an always-on daemon; 0 "
                        "keeps everything forever")
    p.add_argument("--no-emit", action="store_true",
                   help="do NOT append kind:\"slo\" records to producer "
                        "streams (endpoint-only mode)")
    p.add_argument("--once", action="store_true",
                   help="one poll + evaluation, print the /runs snapshot "
                        "as JSON, exit (smoke/debug)")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        rules = load_rules(args.rules or None)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        info(f"config error: cannot load rules {args.rules!r}: {e}")
        return EXIT_CONFIG_ERROR
    if args.tick_secs <= 0:
        info(f"config error: --tick-secs must be > 0, got {args.tick_secs}")
        return EXIT_CONFIG_ERROR
    try:
        agg = Aggregator(args.roots, rules=rules, ring=args.ring,
                         emit_slo=not args.no_emit,
                         retire_after_s=args.retire_secs)
    except ValueError as e:
        info(f"config error: {e}")
        return EXIT_CONFIG_ERROR

    if args.once:
        agg.poll_once()
        print(json.dumps(agg.runs_snapshot()))
        return EXIT_OK

    server = ObsServer(agg, host=args.host, port=args.port)
    server.start()
    stop = threading.Event()

    def _drain(signum, frame):
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _drain)
    info(
        f"obsd watching {len(args.roots)} root(s) -> {server.url} "
        f"(/metrics /slo /runs; {len(rules)} rule(s), "
        f"tick {args.tick_secs}s)"
    )
    try:
        agg.run(tick_secs=args.tick_secs, stop=stop)
    finally:
        agg.poll_once()  # land anything the stop raced
        server.shutdown()
    info("obsd drained cleanly")
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
