"""Solved-position database: on-disk format + the shared probe primitive
(port of gamesmanmpi_tpu/db/format.py, numpy and stdlib only; a DB either
package writes is byte for byte the other's).

A strongly-solved game is only useful as a *queryable database* — the
Pentago solve culminates in a served lookup DB, and "Compressed Game
Solving" is entirely about shipping such tables (PAPERS.md). This module
defines the immutable directory format both halves of that story share:

    db_dir/
      manifest.json             format id, version, game identity, per-level
                                records with counts + sha256 checksums
      level_NNNN.keys.npy       sorted canonical states (game state dtype)
      level_NNNN.cells.npy      packed (value, remoteness) uint32 cells
                                (core/codec.py), parallel to the keys

Format **v2** (ISSUE 9, `export-db --compress`) replaces the per-level
.npy pair with block-compressed streams the reader decodes on probe:

      level_NNNN.keys.gmb       framed key blocks (compress/blocks):
                                fixed position-count blocks, each
                                independently decodable
      level_NNNN.cells.gmb      framed cell blocks, parallel blocking
                                — block b of cells scores block b of keys

with the per-block index (codec, length, crc32) and each block's first
key in the manifest level record, so a probe touches exactly the blocks
its queries land in. v1 stays readable forever; both versions share
this manifest, the same probe contract, and the same checker.

Design rules, in order of importance:

* **Immutable once finalized.** The manifest is written last (atomic
  os.replace, same discipline as utils/checkpoint.py): a directory without
  a manifest is an aborted export, never a half-readable DB.
* **Plain .npy per level, not .npz**: `np.load(mmap_mode="r")` memory-maps
  .npy directly, so a reader probes a multi-GB level by touching O(log n)
  pages — .npz would force a full decompress-to-RAM on open.
* **The cell layout IS the HBM table layout** (sorted keys + packed u32
  cells), so export from a live solve or a checkpoint is a copy, not a
  transform, and `pack_cells`/`unpack_cells` round-trip bit-exactly.

`probe_sorted_np` (re-exported from core/probe.py, where it lives so the
solver and checkpoint layers can share it without importing upward) is
the one host-side canonicalize→probe search all query paths use: the
NumPy twin of ops/lookup.py's sorted-level search — index by
searchsorted, clip, confirm by equality, sentinel never matches because
writers refuse to store it.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib

import numpy as np

# Re-exported here because the probe is part of the DB format's API; it
# lives in core/ (numpy-only) so solve/ and utils/ can share it without
# importing upward into this package.
from gamesmanmpi_tpu_torch.core.probe import probe_sorted_np  # noqa: F401

FORMAT_NAME = "gamesman-db"
FORMAT_VERSION = 1
#: Format v2 (ISSUE 9): per-level keys/cells stored as block-compressed
#: streams (compress/blocks framing) with the per-block index in this
#: manifest; v1 levels are plain mmap-able .npy. Readers speak both,
#: forever — v1 directories never need re-exporting.
FORMAT_VERSION_BLOCKS = 2
SUPPORTED_VERSIONS = (FORMAT_VERSION, FORMAT_VERSION_BLOCKS)

MANIFEST_NAME = "manifest.json"


class DbFormatError(ValueError):
    """The directory is not a valid solved-position database."""


def level_key_name(level: int) -> str:
    return f"level_{level:04d}.keys.npy"


def level_cell_name(level: int) -> str:
    return f"level_{level:04d}.cells.npy"


def level_key_blocks_name(level: int) -> str:
    """v2: the level's framed key-block stream (compress/blocks)."""
    return f"level_{level:04d}.keys.gmb"


def level_cell_blocks_name(level: int) -> str:
    """v2: the level's framed cell-block stream."""
    return f"level_{level:04d}.cells.gmb"


def level_is_blocked(rec: dict) -> bool:
    """True when a manifest level record is block-compressed (v2)."""
    return "keys_blocks" in rec


def file_sha256(path, chunk: int = 1 << 22) -> str:
    """Streaming sha256 of a file (levels can be larger than RAM)."""
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def write_manifest(directory, manifest: dict) -> None:
    """Atomic manifest write: readers see a complete DB or none at all."""
    directory = pathlib.Path(directory)
    tmp = directory / f"{MANIFEST_NAME}.{os.getpid()}.tmp"
    tmp.write_text(json.dumps(manifest, indent=1, sort_keys=True))
    os.replace(tmp, directory / MANIFEST_NAME)


def read_manifest(directory) -> dict:
    """Load + structurally validate a DB manifest; raises DbFormatError."""
    path = pathlib.Path(directory) / MANIFEST_NAME
    if not path.exists():
        raise DbFormatError(
            f"{directory}: no {MANIFEST_NAME} — not a solved-position "
            "database (or an export that never finalized)"
        )
    try:
        manifest = json.loads(path.read_text())
    except json.JSONDecodeError as e:
        raise DbFormatError(
            f"{path}: manifest is not valid JSON ({e})"
        ) from e
    if manifest.get("format") != FORMAT_NAME:
        raise DbFormatError(
            f"{path}: format {manifest.get('format')!r}, "
            f"expected {FORMAT_NAME!r}"
        )
    if manifest.get("version") not in SUPPORTED_VERSIONS:
        raise DbFormatError(
            f"{path}: version {manifest.get('version')!r} not supported "
            f"(reader speaks {', '.join(map(str, SUPPORTED_VERSIONS))})"
        )
    for field in ("game", "spec", "state_dtype", "levels"):
        if field not in manifest:
            raise DbFormatError(f"{path}: missing manifest field {field!r}")
    return manifest


def parse_position(game, raw) -> int:
    """Parse one user-supplied position and range-check it.

    raw: an int, or a decimal / 0x-hex string (the CLI --query spelling).
    The shared front door of `cli query` and the HTTP server's
    POST /query, so both routes accept and refuse exactly the same
    inputs. Raises ValueError/TypeError with a per-position message.
    Non-integer JSON numbers (42.7) and booleans are refused, not
    truncated — int(42.7) would silently answer for a different position
    than the one queried.
    """
    if isinstance(raw, str):
        # Length-cap before int(): a 63-bit position needs <= 19 decimal
        # (or 2+16 hex) characters, while int() on a multi-MB digit
        # string is quadratic on this runtime — a client could pin a
        # handler thread with one absurd literal.
        if len(raw) > 32:
            raise ValueError("position literal too long")
        state = int(raw, 0)
    elif isinstance(raw, int) and not isinstance(raw, bool):
        state = raw
    else:
        raise TypeError(
            f"expected an integer or a numeric string, got "
            f"{type(raw).__name__}"
        )
    if not 0 <= state < (1 << game.state_bits):
        raise ValueError(
            f"outside the game's {game.state_bits}-bit state space"
        )
    return state


# Payload streams to its final name; the caller records the returned
# sha256 in the manifest, which write_manifest replaces atomically — a
# death mid-write leaves an unsealed stray, never a half-readable DB.
# sealed-write: GM801 write-then-seal payload helper (see above)
def save_npy_hashed(path, arr: np.ndarray) -> str:
    """np.save + sha256 of the written bytes in ONE pass.

    Hashing the stream as it is written (instead of re-reading the file
    afterward) halves export I/O per level — the writer runs
    synchronously inside the solver's backward loop via level_sink, and
    levels are multi-GB at the design target.
    """

    class _HashingWriter:
        # Duck-typed file object WITHOUT fileno(): np.save then routes
        # the array through buffered write() calls we can hash.
        def __init__(self, fh):
            self.fh = fh
            self.h = hashlib.sha256()

        def write(self, data):
            self.h.update(data)
            return self.fh.write(data)

    with open(path, "wb") as fh:
        writer = _HashingWriter(fh)
        np.save(writer, arr)
        return writer.h.hexdigest()


# sealed-write: same write-then-seal contract as save_npy_hashed.
def save_blocks_hashed(path, blobs) -> str:
    """Write a framed block stream (compress/blocks.encode_array output)
    + sha256 of the written bytes in ONE pass — the v2 twin of
    save_npy_hashed, same export-I/O discipline."""
    h = hashlib.sha256()
    with open(path, "wb") as fh:
        for blob in blobs:
            h.update(blob)
            fh.write(blob)
    return h.hexdigest()
