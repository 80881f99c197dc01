"""Serving-side control plane of the port (port of `moco_tpu/serve/`). So
far `fleet.py` holds the supervision pieces the input service's staging
server uses: `FleetLaunchError`, `pick_free_port`, `FleetPolicy` and
`ReplicaState`; the router, autoscaler and fleet supervisor are not ported
yet.

This __init__ is LAZY (PEP 562), as `telemetry/__init__.py` is: a stdlib
staging supervisor that imports `serve.fleet` loads nothing else.
"""

from __future__ import annotations

import importlib

# public name -> submodule that defines it
_EXPORTS = {
    "FleetLaunchError": "fleet",
    "FleetPolicy": "fleet",
    "ReplicaState": "fleet",
    "pick_free_port": "fleet",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        submodule = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    value = getattr(importlib.import_module(f"{__name__}.{submodule}"), name)
    globals()[name] = value  # cache: later accesses skip __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
