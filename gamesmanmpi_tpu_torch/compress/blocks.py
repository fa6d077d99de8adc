"""Block framing (port of gamesmanmpi_tpu/compress/blocks.py).

An array is split into fixed position-count blocks (the last ragged),
each encoded independently by codecs.encode_best. The per-array index
(dtype, count, block_positions, and per block its codec, encoded length
and crc32) travels apart from the data, in a manifest or an npz's
``__blocks__`` member; offsets are derived from the lengths.
``decode_block`` checks the crc32 before decoding, so a torn or
bit-rotted block raises BlockCorruptError (a ValueError) instead of
returning a wrong array.

``encode_array`` encodes the blocks of a large array on a thread pool
(zlib and numpy's array loops release the GIL): the blocks are
independent, so the bytes are the reference's single-threaded ones.
"""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from gamesmanmpi_tpu_torch.compress.codecs import (
    BlockCorruptError,
    encode_best,
    get_codec,
)

#: Default positions per block. 64Ki positions is ~512 KiB of raw uint64
#: keys — big enough that DEFLATE reaches its asymptotic ratio, small
#: enough that a point probe decodes well under a millisecond and a
#: hot-block cache holds hundreds of blocks in a few tens of MB.
DEFAULT_BLOCK_POSITIONS = 65536


def split_blocks(n: int, block_positions: int):
    """Yield (start, stop) of each block of an n-element array."""
    if block_positions <= 0:
        raise ValueError(f"block_positions must be positive, "
                         f"got {block_positions}")
    for start in range(0, n, block_positions):
        yield start, min(start + block_positions, n)


#: Blocks per array below which encode_array stays on the calling thread.
_PARALLEL_MIN_BLOCKS = 8


def encode_array(arr: np.ndarray, block_positions: int,
                 candidates) -> tuple[dict, list]:
    """Encode one 1-D array into framed blocks. -> (index, [bytes]).

    The index is the JSON-serializable per-array record the caller
    embeds in its manifest: dtype, count, block_positions, and the
    parallel per-block lists (codec, encoded length, crc32). Arrays of
    _PARALLEL_MIN_BLOCKS blocks or more encode on one thread per CPU.
    """
    arr = np.ascontiguousarray(arr)
    if arr.ndim != 1:
        raise ValueError("block framing is for 1-D arrays")
    blocks = [arr[start:stop] for start, stop in
              split_blocks(arr.shape[0], block_positions)]
    workers = min(os.cpu_count() or 1, len(blocks))
    if len(blocks) >= _PARALLEL_MIN_BLOCKS and workers > 1:
        with ThreadPoolExecutor(workers) as pool:
            encoded = list(pool.map(
                lambda block: encode_best(block, candidates), blocks))
    else:
        encoded = [encode_best(block, candidates) for block in blocks]
    codecs, lengths, crcs, blobs = [], [], [], []
    for name, blob in encoded:
        codecs.append(name)
        lengths.append(len(blob))
        crcs.append(zlib.crc32(blob) & 0xFFFFFFFF)
        blobs.append(blob)
    index = {
        "dtype": arr.dtype.name,
        "count": int(arr.shape[0]),
        "block_positions": int(block_positions),
        "codecs": codecs,
        "lengths": lengths,
        "crc32": crcs,
    }
    return index, blobs


def index_offsets(index: dict) -> np.ndarray:
    """Byte offset of each block in the concatenated stream (derived,
    never stored: lengths are the single source of truth)."""
    lengths = np.asarray(index["lengths"], dtype=np.int64)
    out = np.zeros(lengths.shape[0] + 1, dtype=np.int64)
    np.cumsum(lengths, out=out[1:])
    return out


def num_blocks(index: dict) -> int:
    return len(index["lengths"])


def block_bounds(index: dict, b: int) -> tuple[int, int]:
    """(start position, stop position) of block b within the array."""
    bp = int(index["block_positions"])
    start = b * bp
    return start, min(start + bp, int(index["count"]))


def validate_index(index: dict, stream_bytes: int | None = None) -> None:
    """Structural sanity of one per-array index; raises BlockCorruptError.

    Catches the index-vs-data mismatches a reader would otherwise turn
    into out-of-range reads: parallel lists of unequal length, a block
    count that cannot cover ``count`` positions, lengths that do not sum
    to the stream size.
    """
    try:
        n = int(index["count"])
        bp = int(index["block_positions"])
        codecs = index["codecs"]
        lengths = index["lengths"]
        crcs = index["crc32"]
        np.dtype(index["dtype"])
    except (KeyError, TypeError, ValueError) as e:
        raise BlockCorruptError(f"malformed block index: {e}") from None
    if bp <= 0:
        raise BlockCorruptError(f"block index: block_positions {bp}")
    if not (len(codecs) == len(lengths) == len(crcs)):
        raise BlockCorruptError(
            f"block index: parallel lists disagree "
            f"({len(codecs)} codecs, {len(lengths)} lengths, "
            f"{len(crcs)} crcs)"
        )
    want_blocks = (n + bp - 1) // bp
    if len(lengths) != want_blocks:
        raise BlockCorruptError(
            f"block index: {len(lengths)} blocks cannot hold {n} "
            f"positions at {bp}/block (expected {want_blocks})"
        )
    if stream_bytes is not None and int(sum(lengths)) != int(stream_bytes):
        raise BlockCorruptError(
            f"block index: lengths sum to {int(sum(lengths))} bytes but "
            f"the stream holds {stream_bytes}"
        )


def decode_block(index: dict, b: int, blob: bytes) -> np.ndarray:
    """Decode block b's bytes, crc-verified first. -> array slice."""
    if not 0 <= b < num_blocks(index):
        raise BlockCorruptError(
            f"block {b} out of range (index holds {num_blocks(index)})"
        )
    want_crc = int(index["crc32"][b])
    if len(blob) != int(index["lengths"][b]):
        raise BlockCorruptError(
            f"block {b}: {len(blob)} bytes, index says "
            f"{int(index['lengths'][b])}"
        )
    got = zlib.crc32(blob) & 0xFFFFFFFF
    if got != want_crc:
        raise BlockCorruptError(
            f"block {b}: crc32 {got:#010x} != indexed {want_crc:#010x} "
            "— torn or bit-rotted block"
        )
    start, stop = block_bounds(index, b)
    out = get_codec(index["codecs"][b]).decode(
        blob, np.dtype(index["dtype"]), stop - start
    )
    if out.shape[0] != stop - start:
        raise BlockCorruptError(
            f"block {b}: decoded {out.shape[0]} positions, "
            f"expected {stop - start}"
        )
    return out


def decode_array(index: dict, stream: bytes) -> np.ndarray:
    """Decode a whole framed stream back into one array (checkpoint
    loads and integrity checks consume arrays whole; probes use
    decode_block through the reader's hot-block cache instead)."""
    validate_index(index, stream_bytes=len(stream))
    offs = index_offsets(index)
    parts = [
        decode_block(index, b, stream[offs[b]:offs[b + 1]])
        for b in range(num_blocks(index))
    ]
    if not parts:
        return np.zeros(0, dtype=np.dtype(index["dtype"]))
    return np.concatenate(parts)
