"""Bounded decoded-tile LRU cache (the store's hot-read fast path; a
copy of ``repro.store.cache``).

Entries are decoded tile *interiors* — the ``(t0, t1, t2)`` float
arrays the engine's tile decode produces — keyed by ``(array name,
tile id, content crc)``.  The crc is the tile's own entry crc from the
v2 section table, so the key is content-addressed: overwriting an array
changes every tile crc and the stale entries simply stop matching (the
store additionally drops them eagerly on overwrite/delete, so a bounded
budget is not wasted on unreachable keys).

Cached values are marked read-only and returned as-is; assembly from a
cache hit is byte-for-byte identical to a cold decode because the entry
*is* the cold decode's output (tested in tests/test_torch_store.py).

Thread safety: one lock around the OrderedDict + counters — the store
is shared between client threads and the service worker.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

DEFAULT_CACHE_BYTES = 64 << 20


class TileCache:
    """LRU over decoded tiles, bounded by total payload bytes.

    ``get``/``put`` count hits, misses, and evictions; ``stats()``
    freezes the counters (the service's cache metrics read them before
    and after a batched read to attribute deltas per batch).
    """

    def __init__(self, max_bytes: int = DEFAULT_CACHE_BYTES):
        if max_bytes < 0:
            raise ValueError("max_bytes must be >= 0")
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: tuple) -> np.ndarray | None:
        with self._lock:
            v = self._entries.get(key)
            if v is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return v

    def put(self, key: tuple, value: np.ndarray) -> None:
        value = np.asarray(value)
        if value.nbytes > self.max_bytes:
            return  # larger than the whole budget: never cacheable
        if value.base is not None or value.flags.writeable:
            # own the bytes outright: a view (e.g. one row of a batched
            # decode) would pin its whole base array, and freezing a
            # caller-owned writable array in place would be a side
            # effect on the caller — copy, then freeze the copy
            value = value.copy()
            value.flags.writeable = False
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = value
            self._bytes += value.nbytes
            while self._bytes > self.max_bytes:
                _, dropped = self._entries.popitem(last=False)
                self._bytes -= dropped.nbytes
                self.evictions += 1

    def invalidate(self, array: str) -> int:
        """Drop every entry of one array (overwrite/delete) -> count."""
        with self._lock:
            doomed = [k for k in self._entries if k[0] == array]
            for k in doomed:
                self._bytes -= self._entries.pop(k).nbytes
            return len(doomed)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
            }
