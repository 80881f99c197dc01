"""Decode-once canvas cache (port of `moco_tpu/data/canvas_cache.py`).

The staged canvas does not depend on the augmentation: every randomized
transform runs on the device over the staging canvas, so the host decode of
image i is a deterministic function of the file bytes. Decode it once, and
every later epoch pays a memcpy instead of a JPEG decode. `CachedDataset`
wraps any dataset with the `(images, labels, extents)` batch protocol in a
byte-budgeted LRU of per-image `(canvas, extent, label)` entries.

Invariants:
  - bit-identical: a cache-hit batch equals the freshly decoded batch.
    Lookups COPY rows into the output, so consumers never touch the cache.
  - keyed by DATASET INDEX, not batch position, so `skip_batches` simply
    never asks for the skipped indices: no positional state to invalidate.
  - failures are never frozen: if the inner dataset's decode-failure
    counter moved during a miss fill, none of that fill is inserted.

Thread-safe: staging workers fill disjoint sub-slices of a batch at once;
the lock guards only the dict bookkeeping, copies happen outside it.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np


class CachedDataset:
    """LRU canvas cache in front of `dataset`. Budget is `cache_mb` MiB of
    canvas+extent bytes; an entry larger than the whole budget is simply
    never cached. Unknown attributes (labels, num_classes, decode
    counters, stage geometry) delegate to the inner dataset, so the
    training loop's meters see the wrapper as the dataset itself."""

    def __init__(self, dataset, cache_mb: int, stats=None):
        if cache_mb <= 0:
            raise ValueError(f"cache_mb must be positive, got {cache_mb}")
        self.dataset = dataset
        self.budget_bytes = int(cache_mb) * 2**20
        self._stats = stats
        self._lock = threading.Lock()
        self._entries: OrderedDict[int, tuple[np.ndarray, np.ndarray, int]] = (
            OrderedDict()
        )
        self._bytes = 0
        # local counters mirrored into `stats` (when given): benches and
        # tests read them without a telemetry registry
        self.hits = 0
        self.misses = 0

    def __len__(self):
        return len(self.dataset)

    def __getattr__(self, name):
        # only called for attributes NOT found on the wrapper: live
        # delegation, so decode_failures/decode_total read current values
        return getattr(self.dataset, name)

    # -- internals ----------------------------------------------------------
    def _lookup(self, indices) -> dict[int, tuple]:
        """Hit entries for `indices` (refreshing LRU recency), under lock."""
        found = {}
        with self._lock:
            for i in indices:
                entry = self._entries.get(i)
                if entry is not None:
                    self._entries.move_to_end(i)
                    found[i] = entry
        return found

    def _insert(self, idx: int, canvas: np.ndarray, extent: np.ndarray,
                label) -> None:
        cost = canvas.nbytes + extent.nbytes
        if cost > self.budget_bytes:
            return
        with self._lock:
            old = self._entries.pop(idx, None)
            if old is not None:
                self._bytes -= old[0].nbytes + old[1].nbytes
            while self._bytes + cost > self.budget_bytes and self._entries:
                _, (ev_c, ev_e, _) = self._entries.popitem(last=False)
                self._bytes -= ev_c.nbytes + ev_e.nbytes
            self._entries[idx] = (canvas, extent, label)
            self._bytes += cost

    def _fill_misses(self, miss_idx: list[int]):
        """Decode the missing indices through the inner dataset; returns its
        (imgs, labels, extents). Inserts into the cache only when the inner
        decode-failure counter did not move."""
        before = getattr(self.dataset, "decode_failures", 0)
        imgs, labels, extents = self.dataset.get_batch(np.asarray(miss_idx))
        clean = getattr(self.dataset, "decode_failures", 0) == before
        if clean:
            for j, i in enumerate(miss_idx):
                # row copies: a row VIEW would pin the whole miss batch's
                # array in memory for the life of one cached image
                self._insert(i, np.array(imgs[j]), np.array(extents[j]),
                             labels[j])
        return imgs, labels, extents

    def _account(self, hits: int, misses: int) -> None:
        self.hits += hits
        self.misses += misses
        if self._stats is not None:
            self._stats.note_cache(hits, misses)

    # -- batch protocol -----------------------------------------------------
    def get_batch(self, indices):
        idx = [int(i) for i in np.asarray(indices)]
        found = self._lookup(idx)
        miss_idx = [i for i in idx if i not in found]
        if not miss_idx:  # pure-hit fast path: assemble straight from cache
            imgs = np.stack([found[i][0] for i in idx])
            extents = np.stack([found[i][1] for i in idx])
            labels = np.asarray([found[i][2] for i in idx])
            self._account(len(idx), 0)
            return imgs, labels, extents
        m_imgs, m_labels, m_extents = self._fill_misses(miss_idx)
        if not found:  # pure-miss fast path: no assembly copy needed
            self._account(0, len(idx))
            return m_imgs, m_labels, m_extents
        imgs = np.empty((len(idx),) + m_imgs.shape[1:], m_imgs.dtype)
        extents = np.empty((len(idx),) + m_extents.shape[1:], m_extents.dtype)
        labels = np.empty((len(idx),), np.asarray(m_labels).dtype)
        pos_of_miss = iter(range(len(miss_idx)))
        for j, i in enumerate(idx):
            if i in found:
                canvas, extent, label = found[i]
                imgs[j], extents[j], labels[j] = canvas, extent, label
            else:
                k = next(pos_of_miss)
                imgs[j], extents[j], labels[j] = m_imgs[k], m_extents[k], m_labels[k]
        self._account(len(found), len(miss_idx))
        return imgs, labels, extents

    def get_batch_into(self, indices, out_imgs, out_extents):
        """Staging-canvas protocol (see `ImageFolder.get_batch_into`): fill
        caller-owned rows, return labels. Hits memcpy straight from the
        cache; misses decode through the inner dataset and populate it."""
        idx = [int(i) for i in np.asarray(indices)]
        found = self._lookup(idx)
        miss_idx = [i for i in idx if i not in found]
        if not found and hasattr(self.dataset, "get_batch_into"):
            # pure-miss fast path (the steady state whenever the budget is
            # smaller than the dataset): decode straight into the caller's
            # pooled rows — no intermediate batch allocation — and insert
            # copies only of what the cache keeps
            before = getattr(self.dataset, "decode_failures", 0)
            labels = self.dataset.get_batch_into(idx, out_imgs, out_extents)
            if getattr(self.dataset, "decode_failures", 0) == before:
                for j, i in enumerate(idx):
                    self._insert(i, np.array(out_imgs[j]),
                                 np.array(out_extents[j]), labels[j])
            self._account(0, len(idx))
            return labels
        labels = np.empty((len(idx),), np.int32)
        if miss_idx:
            m_imgs, m_labels, m_extents = self._fill_misses(miss_idx)
            pos_of_miss = {i: k for k, i in enumerate(miss_idx)}
        for j, i in enumerate(idx):
            if i in found:
                canvas, extent, label = found[i]
                out_imgs[j], out_extents[j], labels[j] = canvas, extent, label
            else:
                k = pos_of_miss[i]
                out_imgs[j] = m_imgs[k]
                out_extents[j] = m_extents[k]
                labels[j] = m_labels[k]
        self._account(len(found), len(miss_idx))
        return labels

    # -- introspection ------------------------------------------------------
    @property
    def cached_entries(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def cached_bytes(self) -> int:
        with self._lock:
            return self._bytes
