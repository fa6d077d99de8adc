"""TieredCache (port of gamesmanmpi_tpu/store/cache.py): the block
store's host-RAM tier.

One byte-budget LRU per :class:`~gamesmanmpi_tpu_torch.store.BlockStore`
(``GAMESMAN_STORE_CACHE_MB``) in front of the disk tier, which is the
sealed checkpoint files themselves: a miss falls through to a
crc-verified sealed read, never to a wrong answer. The mechanics are
compress/cache.BlockCache's; the difference is the metric family: a
store cache's behavior is a process-level observable
(``gamesman_store_cache_*``), unlabeled by default (a private
``GAMESMAN_DB_CACHE_MB`` cache passes a ``db=`` label to stay separable).
"""

from __future__ import annotations

from gamesmanmpi_tpu_torch.compress.cache import BlockCache


class TieredCache(BlockCache):
    """Byte-budget LRU over decoded arrays, host-RAM tier."""

    def __init__(self, budget_bytes: int, *, registry=None, labels=None):
        instruments = None
        if registry is not None:
            lbl = dict(labels or {})
            instruments = (
                registry.counter(
                    "gamesman_store_cache_hits_total",
                    "store reads answered from the host-RAM tier",
                    **lbl,
                ),
                registry.counter(
                    "gamesman_store_cache_misses_total",
                    "store reads that fell through to the disk tier",
                    **lbl,
                ),
                registry.counter(
                    "gamesman_store_cache_evictions_total",
                    "entries evicted by the byte budget "
                    "(GAMESMAN_STORE_CACHE_MB)",
                    **lbl,
                ),
                registry.gauge(
                    "gamesman_store_cache_bytes",
                    "decoded bytes resident in the host-RAM tier",
                    **lbl,
                ),
            )
        super().__init__(int(budget_bytes), instruments=instruments)
