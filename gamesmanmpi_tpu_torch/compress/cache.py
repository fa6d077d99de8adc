"""BlockCache (port of gamesmanmpi_tpu/compress/cache.py).

A bounded, thread-safe LRU over decoded payloads, budgeted in bytes
(blocks and arrays vary in decoded size). Lookup and insert hold the
lock; decoding never does, so two threads racing one cold key both
decode and the second insert wins. The counters are read through
:meth:`BlockCache.stats`, and also land in registry series: the
``gamesman_db_cache_*`` family when the owner hands in a ``registry``
(with ``labels``), or the owner's own family through ``instruments``
(store.TieredCache's ``gamesman_store_cache_*``).
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class BlockCache:
    """LRU of decoded payloads, bounded by total decoded bytes."""

    def __init__(self, budget_bytes: int, *, registry=None, labels=None,
                 instruments=None):
        """registry: a metrics registry to export the counters into as
        ``gamesman_db_cache_*`` (hits, misses, evictions, resident
        bytes), with ``labels`` (e.g. ``{"db": name}``) on every series;
        None keeps the counters local. instruments: pre-built (hits,
        misses, evictions, bytes) registry children of another family
        instead; it wins over ``registry``. Metric names stay literal at
        their creation site (gamesman-lint GM403), so an owner with its
        own family builds them."""
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
        elif registry is not None:
            lbl = dict(labels or {})
            self._m_hits = registry.counter(
                "gamesman_db_cache_hits_total",
                "probes answered from an already-decoded hot block", **lbl)
            self._m_misses = registry.counter(
                "gamesman_db_cache_misses_total",
                "probes that had to decode a cold block", **lbl)
            self._m_evictions = registry.counter(
                "gamesman_db_cache_evictions_total",
                "decoded blocks evicted by the byte budget "
                "(GAMESMAN_DB_CACHE_MB)", **lbl)
            self._m_bytes = registry.gauge(
                "gamesman_db_cache_bytes",
                "decoded bytes resident in the hot-block cache", **lbl)

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
