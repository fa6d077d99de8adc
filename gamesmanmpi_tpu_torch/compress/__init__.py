"""Block-compressed storage (port of gamesmanmpi_tpu/compress/).

The codec registry (sorted keys delta-coded, packed cells split into
2-bit values and remoteness), block framing with a separate per-block
index and crc32, and a thread-safe byte-budget LRU. Its consumer in the
port is the checkpointer's ``GAMESMAN_CKPT_COMPRESS=blocks`` mode
(utils/checkpoint.py). Pure numpy + stdlib.
"""

from gamesmanmpi_tpu_torch.compress.blocks import (
    DEFAULT_BLOCK_POSITIONS,
    block_bounds,
    decode_array,
    decode_block,
    encode_array,
    index_offsets,
    num_blocks,
    validate_index,
)
from gamesmanmpi_tpu_torch.compress.cache import BlockCache
from gamesmanmpi_tpu_torch.compress.codecs import (
    CELL_CANDIDATES,
    CODECS,
    GENERIC_CANDIDATES,
    KEY_CANDIDATES,
    BlockCorruptError,
    encode_best,
    get_codec,
)

__all__ = [
    "BlockCache",
    "BlockCorruptError",
    "CELL_CANDIDATES",
    "CODECS",
    "DEFAULT_BLOCK_POSITIONS",
    "GENERIC_CANDIDATES",
    "KEY_CANDIDATES",
    "block_bounds",
    "decode_array",
    "decode_block",
    "encode_array",
    "encode_best",
    "get_codec",
    "index_offsets",
    "num_blocks",
    "validate_index",
]
