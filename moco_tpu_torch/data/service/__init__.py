"""The port's input service (port of `moco_tpu/data/service/`).

    protocol.py   length-prefixed frame protocol and probes (stdlib)
    worker.py     decode worker subprocess: data port, numpy and the native
                  chunked pool, chaos hooks, per-server stats and spans
                  (no torch)
    server.py     stdlib supervisor half: health HTTP endpoint, worker
                  lifecycle (probe, staleness kill, budgeted relaunch)
    client.py     ServiceClient, the Prefetcher's subclass on the train host
                  (bit for bit the in-process staging, over sockets)
    prestage.py   mmap-able pre-staged epoch cache (decode-once format)
    fleet.py      local N-server pool (tests, chip_smoke, drills)

LAZY (PEP 562), as `telemetry/__init__.py` is: the control plane
(`server.py`, `fleet.py`, `python -m moco_tpu_torch.staging_server`) imports
the standard library alone and the worker no torch, and both import this
package, so nothing here may eagerly import the numpy or torch halves.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "FrameError": "protocol",
    "RemoteShardError": "protocol",
    "parse_endpoints": "protocol",
    "ServiceClient": "client",
    "ServiceConfigError": "client",
    "service_epoch_loader": "client",
    "PrestageError": "prestage",
    "PrestagedDataset": "prestage",
    "write_prestage": "prestage",
    "DecodeWorker": "worker",
    "StagingServer": "server",
    "LocalServerPool": "fleet",
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
