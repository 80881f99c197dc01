"""Structured run telemetry and learning health of the port (port of
`moco_tpu/telemetry/`, without the `aggregate` module).

Step-phase timing (data / host / device / comm), analytic-FLOPs MFU against
the card's peak, device and host memory, pod-aggregated JSONL events, the
heartbeat, the `log_event` bridge, the span layer with its capture windows
(`trace.py`) and the in-step collapse diagnostics (`health.py`). The files
they write are the JAX package's: `tools/telemetry_report.py` renders an
`events.jsonl` of either, `tools/trace_report.py` merges their spans.

This __init__ is LAZY (PEP 562): each public name resolves its submodule on
first access, so `import moco_tpu_torch.telemetry.trace` (stdlib only)
touches nothing heavy.
"""

from __future__ import annotations

import importlib

# public name -> submodule that defines it
_EXPORTS = {
    "DeviceMonitor": "device",
    "host_rss_bytes": "device",
    "MFUEstimator": "mfu",
    "detect_peak_flops": "mfu",
    "model_fwd_flops": "mfu",
    "resnet_fwd_flops": "mfu",
    "train_step_flops": "mfu",
    "vit_fwd_flops": "mfu",
    "POD_FIELDS": "pod",
    "PodAggregator": "pod",
    "EVENTS_FILENAME": "registry",
    "HEARTBEAT_FILENAME": "registry",
    "SCHEMA_VERSION": "registry",
    "Counter": "registry",
    "Gauge": "registry",
    "Heartbeat": "registry",
    "Histogram": "registry",
    "MetricsRegistry": "registry",
    "percentiles_ms": "registry",
    "RunTelemetry": "run",
    "StepPhaseTimer": "timing",
    "Tracer": "trace",
    "SlowSampleDetector": "trace",
    "SpikeDetector": "trace",
    "SPANS_FILENAME": "trace",
    "TRIGGER_FILENAME": "trace",
    "TRACES_DIRNAME": "trace",
    "TRACE_MODES": "trace",
    "null_tracer": "trace",
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
