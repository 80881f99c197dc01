"""Pod-level aggregation (the port's copy of `moco_tpu/telemetry/pod.py`).

Per-host telemetry is a lie about a pod: one slow host sets the step time
for everyone (collectives synchronize), and the interesting signals are
exactly the cross-host spread (straggler detection) and the sums
(delivered throughput). Every host builds the same fixed vector of
scalars; the driver allgathers it at the EXISTING `resilience_sync_steps`
cadence (one extra small allgather at an already-synchronizing step — no
new sync points), and process 0 folds the matrix into one `pod` record.

The vector layout is versioned by position — append only, never reorder —
so a mixed-version pod degrades to ignoring trailing fields instead of
misreading them.
"""

from __future__ import annotations

import numpy as np

# positional layout of the per-host scalar vector (append-only)
POD_FIELDS = (
    "step_s",           # most recent step wall time on this host
    "imgs_per_sec",     # rolling host throughput
    "data_s",           # most recent loader-wait time
    "hbm_peak_bytes",   # HBM high-water (0 when the backend can't report)
    "host_rss_bytes",   # host resident set
    "incidents",        # structured events this host has seen so far
)


class PodAggregator:
    """Builds the local vector; folds the allgathered matrix on process 0."""

    def __init__(self, registry, n_procs: int, process_index: int):
        self.registry = registry
        self.n_procs = int(n_procs)
        self.process_index = int(process_index)
        self._local = {name: 0.0 for name in POD_FIELDS}

    def update(self, **scalars) -> None:
        for name, value in scalars.items():
            if name in self._local and value is not None:
                self._local[name] = float(value)

    def local_vector(self) -> np.ndarray:
        return np.asarray([self._local[name] for name in POD_FIELDS], np.float64)

    def record(self, step: int, gathered: np.ndarray) -> None:
        """Fold an allgathered [n_hosts, len(POD_FIELDS)] matrix into one
        pod record (process 0 only — other hosts contribute and return)."""
        if self.process_index != 0 or self.registry is None:
            return
        g = np.asarray(gathered, np.float64).reshape(-1, len(POD_FIELDS))
        col = {name: g[:, i] for i, name in enumerate(POD_FIELDS)}
        self.registry.emit(
            "pod",
            step=int(step),
            hosts=int(g.shape[0]),
            step_s_max=round(float(col["step_s"].max()), 6),
            step_s_min=round(float(col["step_s"].min()), 6),
            data_s_max=round(float(col["data_s"].max()), 6),
            imgs_per_sec_sum=round(float(col["imgs_per_sec"].sum()), 2),
            hbm_peak_bytes_max=int(col["hbm_peak_bytes"].max()),
            host_rss_bytes_max=int(col["host_rss_bytes"].max()),
            incidents_total=int(col["incidents"].sum()),
        )
