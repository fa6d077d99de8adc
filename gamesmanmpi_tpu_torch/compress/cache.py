"""BlockCache (port of gamesmanmpi_tpu/compress/cache.py).

A bounded, thread-safe LRU over decoded payloads, budgeted in bytes
(blocks and arrays vary in decoded size). Lookup and insert hold the
lock; decoding never does, so two threads racing one cold key both
decode and the second insert wins. The counters are read through
:meth:`BlockCache.stats`, and also land in registry series when the
owner hands in ``instruments`` (store.TieredCache's
``gamesman_store_cache_*``).
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class BlockCache:
    """LRU of decoded payloads, bounded by total decoded bytes."""

    def __init__(self, budget_bytes: int, *, instruments=None):
        """instruments: pre-built (hits, misses, evictions, bytes)
        registry children, or None. Metric names stay literal at their
        creation site (gamesman-lint GM403), so the owner builds them."""
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.Lock()
        self._map: OrderedDict = OrderedDict()  # guarded-by: _lock
        self._bytes = 0  # guarded-by: _lock
        self._hits = 0  # guarded-by: _lock
        self._misses = 0  # guarded-by: _lock
        self._evictions = 0  # guarded-by: _lock
        self._m_hits = self._m_misses = None
        self._m_evictions = self._m_bytes = None
        if instruments is not None:
            (self._m_hits, self._m_misses, self._m_evictions,
             self._m_bytes) = instruments

    def get(self, key):
        """The cached value for key (refreshing recency), or None."""
        with self._lock:
            entry = self._map.get(key)
            if entry is not None:
                self._map.move_to_end(key)
                self._hits += 1
            else:
                self._misses += 1
        # Metrics outside the lock: registry children take their own
        # lock, and nested unrelated locks are how deadlocks start.
        if self._m_hits is not None:
            (self._m_hits if entry is not None else self._m_misses).inc()
        return entry[0] if entry is not None else None

    def put(self, key, value, nbytes: int) -> None:
        """Insert a decoded payload of `nbytes` decoded bytes. An oversized
        value is still admitted and evicts everything else, so the hottest
        entry of a tiny budget is never permanently cold."""
        evicted = 0
        with self._lock:
            old = self._map.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._map[key] = (value, int(nbytes))
            self._bytes += int(nbytes)
            while self._bytes > self.budget_bytes and len(self._map) > 1:
                _, (_, dropped) = self._map.popitem(last=False)
                self._bytes -= dropped
                evicted += 1
            self._evictions += evicted
            now_bytes = self._bytes
        if self._m_bytes is not None:
            if evicted:
                self._m_evictions.inc(evicted)
            self._m_bytes.set(now_bytes)

    def contains(self, key) -> bool:
        """Residency peek: no recency refresh, no hit/miss accounting."""
        with self._lock:
            return key in self._map

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def clear(self) -> None:
        with self._lock:
            self._map.clear()
            self._bytes = 0
        if self._m_bytes is not None:
            self._m_bytes.set(0)

    def stats(self) -> dict:
        """Point-in-time counters: hits/misses/evictions/bytes/blocks."""
        with self._lock:
            return {
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "bytes": self._bytes,
                "blocks": len(self._map),
            }
