"""Resilience of the port (port of `moco_tpu/resilience/`): the typed
errors, the exit codes, the checkpoint integrity sidecars, the every-step
sentinels, SIGTERM/SIGINT preemption, the step watchdog, the deterministic
fault injection that drills them, the elastic resize (`resize.py`) and the
out-of-process run supervisor (`supervisor.py`). `train.train` wires the
in-process ones into the bounded rollback loop; `python -m
moco_tpu_torch.supervise` runs the driver under the supervisor.

This __init__ is LAZY (PEP 562), as `telemetry/__init__.py` is: each public
name resolves its submodule on first access, so the stdlib modules
(`exitcodes`, `integrity`, `resize`, `supervisor`) import without torch, and
a supervisor stays small while its child runs the card out of memory.
"""

from __future__ import annotations

import importlib

# public name -> submodule that defines it
_EXPORTS = {
    "ChaosPlan": "chaos",
    "active_chaos": "chaos",
    "chaos_context": "chaos",
    "clear_chaos": "chaos",
    "install_chaos": "chaos",
    "parse_chaos_spec": "chaos",
    "truncate_checkpoint": "chaos",
    "CollapseError": "errors",
    "DataQualityError": "errors",
    "NonFiniteLossError": "errors",
    "RollbackExhaustedError": "errors",
    "TransientDataError": "errors",
    "EXIT_CODE_NAMES": "exitcodes",
    "EXIT_CONFIG_ERROR": "exitcodes",
    "EXIT_DATA_QUALITY": "exitcodes",
    "EXIT_OK": "exitcodes",
    "EXIT_PREEMPTED": "exitcodes",
    "EXIT_RESIZE": "exitcodes",
    "EXIT_ROLLBACK_EXHAUSTED": "exitcodes",
    "manifest_path": "integrity",
    "verify_step": "integrity",
    "write_manifest": "integrity",
    "PreemptionHandler": "preemption",
    "CollapseSentinel": "sentinel",
    "NaNSentinel": "sentinel",
    "StepWatchdog": "watchdog",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        submodule = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    value = getattr(
        importlib.import_module(f"{__name__}.{submodule}"), name
    )
    globals()[name] = value  # cache: later accesses skip __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
