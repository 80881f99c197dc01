"""IVF-style ANN index over a versioned kNN bank (port of
`moco_tpu/serve/ann.py`: numpy, so the same bank and seed give the same
index arrays in both packages).

Exact kNN over a million-row bank costs N·D flops per query on EVERY
replica. The index here cuts that to nprobe/cells of the bank with the
classic IVF recipe: a k-means coarse quantizer over the l2-normalized
bank rows, bank rows re-ordered cell-contiguously, and per-cell EXACT
cosine rerank inside the probed cells — the same similarity + exp(sim/T)
vote protocol as ``ops/knn.knn_predict``, so an exact-mode deployment
(``ann_cells=0``) stays bit-identical to today's ``/v1/knn``.

Three contracts matter more than speed:

* **Determinism.** The build is a pure function of the bank
  BYTES + (cells, seed): seeded rng permutation init, fixed Lloyd
  iterations, ``np.argmax``/stable-sort tie-breaks, deterministic
  empty-cell re-seeding. Since bank bytes are already shard-count
  invariant, a 1-shard and an N-shard bank build yield a
  byte-identical ``ann.npz`` and manifest.
* **Atomicity.** ``ann.npz`` lands via bankbuild's
  ``atomic_save_npz`` (deterministic ZIP_STORED bytes), the manifest
  via ``atomic_write_json`` — manifest LAST, so a torn index is never
  promotable.
* **Pairing.** The manifest (``.integrity/<step>.ann.json``, next to
  the bank's own manifest) binds the index sha to the bank sha AND the
  bank's checkpoint sha: a replica refuses an index whose bank bytes
  drifted, exactly like the bank refuses a drifted checkpoint.

Fleet sharding is CELL-partitioned: replica ``shard`` of ``shards``
owns cells where ``cell % shards == shard`` and answers with its local
top candidates; the stdlib-only router fans out and merges (fleet.py
never imports this module — candidates cross the wire as plain JSON).

numpy + stdlib only: no torch on this path, nothing to capture at serve
time.
"""

from __future__ import annotations

import json
import os

import numpy as np

from moco_tpu_torch.resilience.integrity import INTEGRITY_DIRNAME, digest_file
from moco_tpu_torch.serve.bankbuild import (
    PROBE_SEED,
    atomic_save_npz,
    atomic_write_json,
    load_bank,
    read_bank_meta,
)

ANN_FILENAME = "ann.npz"
# fixed build seed — part of the artifact contract (manifest records it;
# changing it is a format bump, not a knob)
ANN_SEED = 20200607
ANN_KMEANS_ITERS = 10


class AnnIndexError(ValueError):
    """A missing / torn / mispaired index artifact."""


def ann_index_path(bank_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(bank_dir), str(step), ANN_FILENAME)


def ann_manifest_path(bank_dir: str, step: int) -> str:
    """Sidecar manifest for the index. Lives in ``.integrity/`` next to
    the bank's own ``<step>.json`` but under ``<step>.ann.json`` so
    ``verify_bank``/``verify_step`` semantics over the bank manifest are
    untouched."""
    return os.path.join(
        os.path.abspath(bank_dir), INTEGRITY_DIRNAME, f"{step}.ann.json"
    )


def _l2(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def _kmeans(rows: np.ndarray, cells: int, iters: int, seed: int):
    """Deterministic spherical k-means: (centroids [C,D], assign [N]).

    Every tie-break is pinned: init is a seeded permutation prefix,
    assignment is ``np.argmax`` (lowest cell wins ties), empty cells are
    re-seeded with the rows WORST-served by their current centroid
    (stable sort order), updates use ``np.add.at`` (sequential
    accumulation). Same rows + cells + seed => same float32 output.
    """
    n = rows.shape[0]
    rng = np.random.default_rng(seed)
    centroids = rows[np.sort(rng.permutation(n)[:cells])].copy()
    assign = np.zeros(n, dtype=np.int64)
    for _ in range(iters):
        sims = rows @ centroids.T                      # [N, C]
        assign = np.argmax(sims, axis=1)
        counts = np.bincount(assign, minlength=cells)
        sums = np.zeros_like(centroids)
        np.add.at(sums, assign, rows)
        live = counts > 0
        centroids[live] = sums[live] / counts[live, None]
        empty = np.flatnonzero(~live)
        if empty.size:
            # rows least similar to their own centroid, stable order
            own = sims[np.arange(n), assign]
            worst = np.argsort(own, kind="stable")[: empty.size]
            centroids[empty] = rows[worst]
        centroids = _l2(centroids)
    assign = np.argmax(rows @ centroids.T, axis=1)
    return centroids, assign.astype(np.int64)


def build_ann_index(bank_dir: str, step: int, *, cells: int,
                    kmeans_iters: int = ANN_KMEANS_ITERS,
                    seed: int = ANN_SEED, emit=None) -> dict:
    """Build + atomically persist the IVF index for one bank step.

    Returns the manifest dict. The artifact is ``<step>/ann.npz`` with
    ``centroids [C,D] f32``, ``row_order [N] i64`` (bank row index of
    each cell-contiguous slot), ``cell_offsets [C+1] i64``; the manifest
    (written LAST) binds index sha -> bank sha -> checkpoint sha.
    """
    if cells < 1:
        raise ValueError(f"ann cells must be >= 1, got {cells}")
    bank_path = os.path.join(os.path.abspath(bank_dir), str(step),
                             "bank.npz")
    features, _labels, meta = load_bank(bank_path)
    if meta is None:
        raise AnnIndexError(
            f"bank at {bank_path!r} has no integrity manifest — ANN "
            "indexes pair only with versioned banks"
        )
    n = features.shape[0]
    cells = min(cells, n)
    rows = _l2(features)
    centroids, assign = _kmeans(rows, cells, kmeans_iters, seed)
    row_order = np.argsort(assign, kind="stable").astype(np.int64)
    counts = np.bincount(assign, minlength=cells)
    cell_offsets = np.zeros(cells + 1, dtype=np.int64)
    np.cumsum(counts, out=cell_offsets[1:])

    index_path = ann_index_path(bank_dir, step)
    atomic_save_npz(index_path, {
        "centroids": centroids,
        "row_order": row_order,
        "cell_offsets": cell_offsets,
    })
    manifest = {
        "v": 1,
        "kind": "ann",
        "step": int(step),
        "cells": int(cells),
        "rows": int(n),
        "feat_dim": int(features.shape[1]),
        "kmeans_iters": int(kmeans_iters),
        "seed": int(seed),
        "files": {
            ANN_FILENAME: {
                "size": os.path.getsize(index_path),
                "sha256": digest_file(index_path),
            },
        },
        "bank": {
            "file": "bank.npz",
            "sha256": digest_file(bank_path),
        },
        "checkpoint_sha256": meta.get("checkpoint_sha256"),
    }
    atomic_write_json(ann_manifest_path(bank_dir, step), manifest)
    if emit is not None:
        emit("ann_built", step=int(step), cells=int(cells), rows=int(n))
    return manifest


def verify_ann(bank_dir: str, step: int):
    """None when the index verifies against its manifest AND its bank
    binding, else the failure reason (same contract as verify_bank)."""
    mpath = ann_manifest_path(bank_dir, step)
    if not os.path.exists(mpath):
        return f"no ann manifest at {mpath}"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return f"unreadable ann manifest: {e}"
    index_path = ann_index_path(bank_dir, step)
    if not os.path.exists(index_path):
        return f"manifested index missing: {index_path}"
    rec = (manifest.get("files") or {}).get(ANN_FILENAME) or {}
    if os.path.getsize(index_path) != rec.get("size"):
        return "ann.npz size mismatch"
    if digest_file(index_path) != rec.get("sha256"):
        return "ann.npz sha256 mismatch"
    bank_path = os.path.join(os.path.abspath(bank_dir), str(step),
                             "bank.npz")
    want_bank = (manifest.get("bank") or {}).get("sha256")
    if not os.path.exists(bank_path):
        return f"paired bank missing: {bank_path}"
    if digest_file(bank_path) != want_bank:
        return "bank bytes drifted since the index was built"
    return None


def load_ann(bank_npz_path: str):
    """(arrays dict, manifest dict) for the index paired with a bank
    npz, or None when the bank has no (verifying) index.

    Raises AnnIndexError on a PRESENT-but-torn/mispaired index — silent
    fallback to exact over a bad artifact would mask corruption.
    """
    meta = read_bank_meta(bank_npz_path)
    if meta is None:
        return None
    bank_dir, step = meta["bank_dir"], meta["step"]
    mpath = ann_manifest_path(bank_dir, step)
    if not os.path.exists(mpath):
        return None
    reason = verify_ann(bank_dir, step)
    if reason is not None:
        raise AnnIndexError(f"ann index for step {step} rejected: {reason}")
    with open(mpath) as f:
        manifest = json.load(f)
    with np.load(ann_index_path(bank_dir, step)) as z:
        arrays = {k: z[k] for k in ("centroids", "row_order",
                                    "cell_offsets")}
    return arrays, manifest


def vote(candidates, temperature: float, num_classes: int) -> int:
    """exp(sim/T) class vote over (sim, label) pairs — the ops/knn
    protocol, restated over merged candidates. Ties break to the lowest
    label (argmax semantics). fleet.py reimplements this in pure python
    for the router merge; test_serve_scale pins the two equal."""
    weights = np.zeros(num_classes, dtype=np.float64)
    t = max(float(temperature), 1e-8)
    for sim, label in candidates:
        weights[int(label)] += float(np.exp(float(sim) / t))
    return int(np.argmax(weights))


class AnnShard:
    """One replica's cell-partitioned view of an IVF index.

    ``shard`` of ``shards`` owns cells with ``cell % shards == shard``
    (shards=1 => the whole index). ``search`` probes the top-``nprobe``
    OWNED cells by centroid similarity, exact-reranks their rows, and
    returns the top-``rerank`` candidates; ``classify`` votes over them
    locally (the single-replica serving path), while the fleet router
    merges ``search`` candidates across shards instead.
    """

    def __init__(self, features, labels, arrays, *, shard: int = 0,
                 shards: int = 1, nprobe: int = 8, rerank: int = 200,
                 temperature: float = 0.07, num_classes: int = 0):
        if shards < 1 or not (0 <= shard < shards):
            raise ValueError(
                f"need 0 <= shard < shards, got shard={shard} "
                f"shards={shards}"
            )
        centroids = np.asarray(arrays["centroids"], np.float32)
        row_order = np.asarray(arrays["row_order"], np.int64)
        offsets = np.asarray(arrays["cell_offsets"], np.int64)
        n, cells = row_order.shape[0], centroids.shape[0]
        if features.shape[0] != n or offsets.shape[0] != cells + 1:
            raise AnnIndexError(
                f"index shape mismatch: bank rows {features.shape[0]} "
                f"vs row_order {n}, cells {cells} vs offsets "
                f"{offsets.shape[0] - 1}"
            )
        self.shard, self.shards = int(shard), int(shards)
        self.cells = cells
        self.nprobe = max(1, int(nprobe))
        self.rerank = max(1, int(rerank))
        self.temperature = float(temperature)
        labels = np.asarray(labels)
        self.num_classes = int(num_classes) if num_classes else (
            int(labels.max()) + 1 if labels.size else 1)
        self._centroids = centroids
        self._offsets = offsets
        self._owned = np.flatnonzero(
            np.arange(cells, dtype=np.int64) % shards == shard)
        # cell-contiguous copies so a probe reads dense slices
        self._rows = _l2(features)[row_order]
        self._labels = labels[row_order].astype(np.int64)
        self._row_ids = row_order  # slot -> original bank row index
        self._owned_slots = (np.concatenate(
            [np.arange(offsets[c], offsets[c + 1]) for c in self._owned]
        ) if self._owned.size else np.zeros(0, dtype=np.int64))
        self.owned_rows = int(self._owned_slots.size)

    def search(self, embedding, *, k: int | None = None,
               nprobe: int | None = None):
        """Top candidates among this shard's owned cells.

        Returns (sims [M] f32, labels [M] i64, rows [M] i64) sorted by
        descending similarity, ties to the lower cell-slot (stable) —
        ``rows`` are original bank row indices, which is what the recall
        probe compares against exact search.
        """
        q = _l2(np.asarray(embedding, np.float32).reshape(-1))
        probe = min(nprobe or self.nprobe, self._owned.size)
        if probe == 0:
            empty = np.zeros(0)
            return (empty.astype(np.float32), empty.astype(np.int64),
                    empty.astype(np.int64))
        csims = self._centroids[self._owned] @ q
        # descending centroid sim, ties to the lower cell id
        order = np.lexsort((self._owned, -csims))[:probe]
        picked = self._owned[order]
        spans = [np.arange(self._offsets[c], self._offsets[c + 1])
                 for c in picked]
        slots = (np.concatenate(spans) if spans
                 else np.zeros(0, dtype=np.int64))
        if slots.size == 0:
            empty = np.zeros(0)
            return (empty.astype(np.float32), empty.astype(np.int64),
                    empty.astype(np.int64))
        sims = self._rows[slots] @ q
        top = min(k or self.rerank, slots.size)
        # descending sim, ties to the lower slot (deterministic merge)
        best = np.lexsort((slots, -sims))[:top]
        sel = slots[best]
        return (sims[best].astype(np.float32), self._labels[sel],
                self._row_ids[sel])

    def classify(self, embedding, *, k: int | None = None):
        """(predicted class, candidate count) by local exp(sim/T) vote —
        the single-process ANN serving path (shards=1 sees the whole
        bank; a true shard votes over its partition only, and the fleet
        merge is the authoritative answer)."""
        sims, labels, _rows = self.search(embedding, k=k)
        if sims.size == 0:
            return 0, 0
        pred = vote(zip(sims.tolist(), labels.tolist()),
                    self.temperature, self.num_classes)
        return pred, int(sims.size)

    def recall_probe(self, *, queries: int = 64,
                     seed: int = PROBE_SEED) -> float:
        """recall@1 vs EXACT search over this shard's own rows, on a
        seeded probe set of perturbed bank rows (near the data manifold,
        so the measure reflects real traffic). Deterministic: same
        index + seed => same score. The tests pin >= 0.95 on
        the shards=1 view."""
        owned = self._owned_slots
        if owned.size == 0:
            return 1.0
        rng = np.random.default_rng(seed)
        base = owned[rng.integers(0, owned.size,
                                  size=min(queries, owned.size))]
        noise = rng.standard_normal(
            (base.size, self._rows.shape[1])).astype(np.float32)
        qs = _l2(self._rows[base] + 0.1 * noise)
        hits = 0
        for q in qs:
            exact_sims = self._rows[owned] @ q
            exact_slot = owned[np.lexsort((owned, -exact_sims))[0]]
            _sims, _labels, rows = self.search(q, k=1)
            hits += int(rows.size > 0
                        and rows[0] == self._row_ids[exact_slot])
        return hits / qs.shape[0]

    def stats(self) -> dict:
        return {
            "cells": self.cells,
            "nprobe": self.nprobe,
            "rerank": self.rerank,
            "shard": self.shard,
            "shards": self.shards,
            "owned_rows": self.owned_rows,
        }
