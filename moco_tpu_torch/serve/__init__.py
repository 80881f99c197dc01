"""moco_tpu_torch.serve — the online embedding service of the port (port of
`moco_tpu/serve/`). Layers, from the wire down to the card:

    http.py      stdlib-HTTP front end (`python -m moco_tpu_torch.serve`
                 mounts it): /v1/embed, /v1/knn, /admin/reload,
                 /admin/bank, /healthz, /stats
    service.py   the request path: validation → cache → batcher →
                 engine (+ optional kNN or ANN classify), hot weight
                 reload with the drift guard and the atomic dual swap of
                 (engine, paired bank), telemetry snapshots
    cache.py     content-hash embedding LRU (byte-budgeted)
    batcher.py   dynamic micro-batching (flush on size OR deadline),
                 bounded admission per tier, load shedding, drain
    engine.py    the bucketed engine: one CUDA graph per bucket of the
                 ladder 1/8/32/128 (a fixed program set, no capture under
                 load); eager on the CPU
    bankbuild.py versioned kNN-bank builder (`python -m
                 moco_tpu_torch.bank_build`): sharded, resumable corpus
                 re-embed bound to its checkpoint by an integrity manifest
    ann.py       IVF ANN index over a versioned bank (numpy)
    fleet.py     the replicated fleet (`python -m
                 moco_tpu_torch.serve_fleet` mounts it): the router,
                 the fleet supervisor, the checkpoint watcher and its
                 reload roll, the ANN scatter-gather, the autoscaler;
                 pure stdlib (the input service's staging server
                 reuses its supervision pieces)

Train-free: nothing here imports `train`, `train_step`, `v3_step` or
`ops/optim.py` (`tests/test_torch_isolation.py`), so the server stays
import-light and never grows a training dependency by accident.

This __init__ is LAZY (PEP 562, as `telemetry/__init__.py` is): a stdlib
staging supervisor that imports `serve.fleet` executes this package body
and must load nothing else; each public name resolves its submodule on
first attribute access, so `from moco_tpu_torch.serve import EmbedService`
works while `import moco_tpu_torch.serve.fleet` touches nothing heavy.
"""

from __future__ import annotations

import importlib

# public name -> submodule that defines it
_EXPORTS = {
    "DeadlineExceededError": "batcher",
    "DrainingError": "batcher",
    "MicroBatcher": "batcher",
    "OverloadedError": "batcher",
    "PendingRequest": "batcher",
    "RejectionError": "batcher",
    "bucket_for": "batcher",
    "EmbeddingCache": "cache",
    "DEFAULT_BUCKETS": "engine",
    "EmbeddingEngine": "engine",
    "ServeFrontend": "http",
    "decode_image": "http",
    "BankMismatchError": "service",
    "CollapsedCheckpointError": "service",
    "EmbedService": "service",
    "ReloadRefusedError": "service",
    "BankBuildError": "bankbuild",
    "build_bank": "bankbuild",
    "load_bank": "bankbuild",
    "read_bank_meta": "bankbuild",
    "CheckpointWatcher": "fleet",
    "FleetLaunchError": "fleet",
    "FleetPolicy": "fleet",
    "FleetRouter": "fleet",
    "FleetSupervisor": "fleet",
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
