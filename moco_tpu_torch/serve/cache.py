"""Content-hash embedding LRU (port of `moco_tpu/serve/cache.py`).

Identical inputs embed identically under a frozen encoder, so a repeat
request is pure waste on the device — the serve-side analogue of the
decode-once observation behind `data/canvas_cache.py`, whose
byte-budgeted LRU pattern this reuses: a MiB budget over stored bytes,
eviction from the LRU end, entries immutable by convention, dict
bookkeeping under a lock with the heavy work (hashing) outside it.

Keys are content hashes (sha256 over shape + dtype + pixel bytes), not
client-supplied ids: two clients sending the same image share one entry,
and a client mutating its buffer after submit can never corrupt a stored
embedding (the stored row is a private copy)."""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np


class EmbeddingCache:
    """Byte-budgeted LRU of `content_key -> embedding row`."""

    def __init__(self, cache_mb: int):
        if cache_mb <= 0:
            raise ValueError(f"cache_mb must be positive, got {cache_mb}")
        self.budget_bytes = int(cache_mb) * 2**20
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, np.ndarray] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key_for(image: np.ndarray) -> str:
        """Content hash of one image. Shape and dtype are folded in so a
        reshaped view of the same bytes is a different key — embeddings
        are functions of the IMAGE, not of its raveled buffer."""
        h = hashlib.sha256()
        h.update(repr((image.shape, str(image.dtype))).encode("ascii"))
        h.update(image.tobytes())
        return h.hexdigest()

    def get(self, key: str) -> np.ndarray | None:
        with self._lock:
            row = self._entries.get(key)
            if row is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return row  # immutable by convention; stored rows are copies

    def put(self, key: str, embedding: np.ndarray) -> None:
        row = np.array(embedding)  # private copy: callers keep their buffer
        cost = row.nbytes
        if cost > self.budget_bytes:
            return  # larger than the whole budget: never cached
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            while self._bytes + cost > self.budget_bytes and self._entries:
                _, evicted = self._entries.popitem(last=False)
                self._bytes -= evicted.nbytes
            self._entries[key] = row
            self._bytes += cost

    def clear(self) -> None:
        """Drop every entry (hot weight reload: cached rows are functions
        of the old weights). Hit/miss counters survive — they describe the
        process's traffic, not one model version."""
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    @property
    def entries(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def cached_bytes(self) -> int:
        with self._lock:
            return self._bytes

    @property
    def hit_rate(self) -> float:
        lookups = self.hits + self.misses
        return self.hits / lookups if lookups else 0.0
