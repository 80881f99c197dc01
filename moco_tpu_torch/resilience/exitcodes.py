"""Structured driver exit codes (the port's own copy of
`moco_tpu/resilience/exitcodes.py`, with the same numbers and names).

A supervisor restarts a dead driver according to WHY it died, and the exit
code is the only channel that survives every death short of SIGKILL. The
drivers therefore exit through these named constants, never a bare
`sys.exit(<int>)`.

The codes start at 43 to stay clear of the shells' own vocabulary (0
success, 1 a Python traceback, 2 an argparse usage error, 126/127 exec
failures, 128+N signal deaths); an unknown positive code reads as a
generic crash.
"""

from __future__ import annotations

EXIT_OK = 0                    # the train loop ran to its configured end
EXIT_PREEMPTED = 43            # SIGTERM/SIGINT honored: emergency checkpoint
                               # written, clean exit; a relaunch resumes it
EXIT_ROLLBACK_EXHAUSTED = 44   # RollbackExhaustedError: a structural divergence,
                               # restarting would loop; a human has to look
EXIT_CONFIG_ERROR = 45         # a bad preset, flag or config: the same argv
                               # can never succeed
EXIT_DATA_QUALITY = 46         # DataQualityError: the dataset itself is bad
                               # (decode-abort threshold)
EXIT_SERVE_BIND = 47           # the serving front end could not bind its
                               # host:port (reschedule, do not retry-loop)
EXIT_FLEET_BIND = 48           # the fleet router could not bind its port
EXIT_STAGING_BIND = 50         # a staging server could not bind its port
EXIT_RESIZE = 49               # elastic resize honored: a clean checkpoint was
                               # written and the relaunch goes onto another mesh

# argparse's own usage-error exit: not raised here, but a supervisor treats
# it like EXIT_CONFIG_ERROR (the same argv can never succeed)
USAGE_ERROR = 2

EXIT_CODE_NAMES: dict[int, str] = {
    EXIT_OK: "clean",
    EXIT_PREEMPTED: "preempted",
    EXIT_ROLLBACK_EXHAUSTED: "rollback_exhausted",
    EXIT_CONFIG_ERROR: "config_error",
    EXIT_DATA_QUALITY: "data_quality",
    EXIT_SERVE_BIND: "serve_bind",
    EXIT_FLEET_BIND: "fleet_bind",
    EXIT_RESIZE: "resize",
    EXIT_STAGING_BIND: "staging_bind",
    USAGE_ERROR: "usage_error",
}
