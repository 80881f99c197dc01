"""Resilience of the port (port of `moco_tpu/resilience/`, without its
supervisor and elastic resize): the typed errors, the exit codes, the
checkpoint integrity sidecars, the every-step sentinels, SIGTERM/SIGINT
preemption, the step watchdog and the deterministic fault injection that
drills them. `train.train` wires them into the bounded rollback loop."""

from moco_tpu_torch.resilience.chaos import (
    ChaosPlan,
    active_chaos,
    chaos_context,
    clear_chaos,
    install_chaos,
    parse_chaos_spec,
    truncate_checkpoint,
)
from moco_tpu_torch.resilience.errors import (
    CollapseError,
    DataQualityError,
    NonFiniteLossError,
    RollbackExhaustedError,
    TransientDataError,
)
from moco_tpu_torch.resilience.exitcodes import (
    EXIT_CODE_NAMES,
    EXIT_CONFIG_ERROR,
    EXIT_DATA_QUALITY,
    EXIT_OK,
    EXIT_PREEMPTED,
    EXIT_RESIZE,
    EXIT_ROLLBACK_EXHAUSTED,
)
from moco_tpu_torch.resilience.integrity import manifest_path, verify_step, write_manifest
from moco_tpu_torch.resilience.preemption import PreemptionHandler
from moco_tpu_torch.resilience.sentinel import CollapseSentinel, NaNSentinel
from moco_tpu_torch.resilience.watchdog import StepWatchdog

__all__ = [
    "ChaosPlan",
    "CollapseError",
    "CollapseSentinel",
    "DataQualityError",
    "EXIT_CODE_NAMES",
    "EXIT_CONFIG_ERROR",
    "EXIT_DATA_QUALITY",
    "EXIT_OK",
    "EXIT_PREEMPTED",
    "EXIT_RESIZE",
    "EXIT_ROLLBACK_EXHAUSTED",
    "NaNSentinel",
    "NonFiniteLossError",
    "PreemptionHandler",
    "RollbackExhaustedError",
    "StepWatchdog",
    "TransientDataError",
    "active_chaos",
    "chaos_context",
    "clear_chaos",
    "install_chaos",
    "manifest_path",
    "parse_chaos_spec",
    "truncate_checkpoint",
    "verify_step",
    "write_manifest",
]
