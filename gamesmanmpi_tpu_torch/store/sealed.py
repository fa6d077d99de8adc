"""The sealed-read path (port of gamesmanmpi_tpu/store/sealed.py).

Every payload file is *sealed*: its crc32 goes into the checkpoint
manifest, atomically, after the payload lands. This module is the read
half of that contract:

* :data:`TORN_SEAL_ERRORS` — every exception shape a torn, truncated,
  deleted or bit-rotted sealed read can raise; loaders that degrade
  (quarantine and recompute) catch exactly this tuple;
* :func:`verify_crc` — a streaming crc32 check against the sealed value,
  raising :class:`CorruptSealError` (a ValueError, so in the tuple). It
  is pure: quarantine is the caller's move, on the caller's thread, so
  it may run on a prefetch thread;
* :func:`loadz` / :class:`BlockedNpzView` — the one np.load door for
  checkpoint npz files, transparent to ``blocks`` framing.

The reference's DB-side handles (``SealedBlockStream``, ``open_npy_mmap``)
belong to DB export and serving, not ported yet.
"""

from __future__ import annotations

import json
import pathlib
import zipfile
import zlib

import numpy as np

from gamesmanmpi_tpu_torch.compress import decode_array


class CorruptSealError(ValueError):
    """A sealed file failed its recorded crc32 — silent bit-rot or an
    overwrite the torn-zip errors cannot see. Subclasses ValueError so
    every TORN_SEAL_ERRORS degrade path treats it as one more torn-file
    shape. (``utils/checkpoint.CorruptCheckpointError`` is this class.)"""


#: What a torn/truncated/deleted sealed read can raise: a missing file,
#: a zip whose central directory never landed, a short read surfacing as
#: a bare OSError, a zip that lost a member (KeyError on z["name"]), or
#: garbage content (np.load raises ValueError when the bytes are neither
#: zip nor npy; CorruptSealError and compress' BlockCorruptError are
#: ValueErrors too). Loaders that degrade to an intact prefix catch
#: exactly this tuple.
TORN_SEAL_ERRORS = (
    FileNotFoundError, zipfile.BadZipFile, OSError, KeyError, ValueError
)


def file_crc32(path, chunk: int = 1 << 20) -> int:
    """Streaming crc32 of a file (zlib polynomial, chunked reads: disk
    speed, constant memory)."""
    crc = 0
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def verify_crc(path, want) -> None:
    """Check one sealed file against its recorded crc32.

    ``want`` is the sealed value (int) or None (nothing recorded —
    pre-integrity files keep loading). Raises CorruptSealError on
    mismatch. Pure: no quarantine, no manifest writes — safe on any
    thread (the prefetch pool runs it; the error re-raises at the
    consuming read and the caller quarantines there)."""
    if want is None:
        return
    path = pathlib.Path(path)
    if not path.exists():
        return
    got = file_crc32(path)
    if got != int(want):
        raise CorruptSealError(
            f"{path.name}: crc32 {got:#010x} != sealed {int(want):#010x}"
            " — quarantine and recompute"
        )


#: npz member name of the block-framing metadata (GAMESMAN_CKPT_COMPRESS=
#: blocks): JSON bytes mapping each framed member to its block index.
#: Double-underscored so it can never collide with a real array name
#: (states/cells/level_NNNN...).
BLOCKS_META_MEMBER = "__blocks__"


class BlockedNpzView:
    """Dict-like view over a block-framed npz (the ``blocks`` flavor of
    checkpoint._savez): same ``files`` / ``[]`` / context-manager
    surface as np.load's NpzFile, decoding framed members on access.
    Corrupt blocks raise BlockCorruptError (ValueError) from ``[]`` —
    exactly where a torn plain npz raises — so every TORN_SEAL_ERRORS
    consumer degrades identically for both storage flavors."""

    def __init__(self, z, meta: dict):
        self._z = z
        self._meta = meta

    @property
    def files(self):
        return [n for n in self._z.files if n != BLOCKS_META_MEMBER]

    def __getitem__(self, name):
        raw = self._z[name]
        index = self._meta.get(name)
        if index is None:
            return raw
        return decode_array(index, raw.tobytes())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._z.close()
        return False

    def close(self):
        self._z.close()


def loadz(path):
    """np.load for checkpoint npz files, transparent to block framing:
    a plain npz returns as-is; one with a ``__blocks__`` member returns
    the decoding view. Every checkpoint read goes through here, which
    keeps the compressed format invisible to the resume and quarantine
    machinery above it."""
    z = np.load(path)
    if BLOCKS_META_MEMBER not in z.files:
        return z
    try:
        meta = json.loads(bytes(z[BLOCKS_META_MEMBER]))
    except (ValueError, KeyError):
        z.close()
        raise  # ValueError: a TORN_SEAL_ERRORS member — degrade as torn
    return BlockedNpzView(z, meta)


def read_npz_members(path, names=None, crc=None):
    """The sealed-read primitive for npz payloads: crc-verify, load,
    materialize. -> tuple of arrays (``names`` given) or {name: array}.

    Materializing (np.asarray) here — not at the consumer — is what
    makes prefetch useful: a hinted file is *decoded* on the pool
    thread, so the solve thread's later read is a pure cache hit.
    Raises a TORN_SEAL_ERRORS member on any corruption; never mutates
    anything (see verify_crc)."""
    verify_crc(path, crc)
    with loadz(path) as z:
        if names is None:
            return {n: np.asarray(z[n]) for n in z.files}
        return tuple(np.asarray(z[n]) for n in names)
