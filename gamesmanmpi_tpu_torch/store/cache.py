"""TieredCache (port of gamesmanmpi_tpu/store/cache.py): the block
store's host-RAM tier.

One byte-budget LRU per :class:`~gamesmanmpi_tpu_torch.store.BlockStore`
(``GAMESMAN_STORE_CACHE_MB``) in front of the disk tier, which is the
sealed checkpoint files themselves: a miss falls through to a
crc-verified sealed read, never to a wrong answer. The mechanics are
compress/cache.BlockCache's.
"""

from __future__ import annotations

from gamesmanmpi_tpu_torch.compress.cache import BlockCache


class TieredCache(BlockCache):
    """Byte-budget LRU over decoded arrays, host-RAM tier."""
