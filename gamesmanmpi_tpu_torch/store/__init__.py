"""The block store (port of gamesmanmpi_tpu/store/).

Sealed crc-verified reads (:mod:`store.sealed`), a byte-budget host-RAM
tier (:class:`TieredCache`) and the prefetch engine
(:class:`BlockStore`). The port's consumer is the checkpointer
(utils/checkpoint.py). The reference's write-behind comes with the DB
writer, and ``store/shm.py`` with serving; neither is ported yet.
"""

from gamesmanmpi_tpu_torch.store.blockstore import (  # noqa: F401
    BlockStore,
    default_store,
    file_key,
)
from gamesmanmpi_tpu_torch.store.cache import TieredCache  # noqa: F401
from gamesmanmpi_tpu_torch.store.sealed import (  # noqa: F401
    BLOCKS_META_MEMBER,
    BlockedNpzView,
    CorruptSealError,
    TORN_SEAL_ERRORS,
    file_crc32,
    loadz,
    read_npz_members,
    verify_crc,
)
