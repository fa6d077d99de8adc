"""The block store (port of gamesmanmpi_tpu/store/).

Sealed crc-verified reads (:mod:`store.sealed`), a byte-budget host-RAM
tier (:class:`TieredCache`) and the prefetch and write-behind engine
(:class:`BlockStore`). Its consumers are the checkpointer
(utils/checkpoint.py) and the DB (db/writer.py, db/reader.py).
:class:`ShmBlockCache` (store/shm.py) is the serving fleet's
cross-worker decoded-block tier.
"""

from gamesmanmpi_tpu_torch.store.blockstore import (  # noqa: F401
    BlockStore,
    WriteTicket,
    default_store,
    file_key,
)
from gamesmanmpi_tpu_torch.store.cache import TieredCache  # noqa: F401
from gamesmanmpi_tpu_torch.store.shm import ShmBlockCache  # noqa: F401
from gamesmanmpi_tpu_torch.store.sealed import (  # noqa: F401
    BLOCKS_META_MEMBER,
    BlockedNpzView,
    CorruptSealError,
    SealedBlockStream,
    TORN_SEAL_ERRORS,
    file_crc32,
    loadz,
    open_npy_mmap,
    read_npz_members,
    verify_crc,
)
