"""Block codecs (port of gamesmanmpi_tpu/compress/codecs.py).

Typed 1-D numpy arrays <-> compressed bytes, byte for byte the
reference's encodings:

* ``raw``      — identity passthrough; always wins ties.
* ``zlib``     — DEFLATE of the array bytes, the shape-agnostic backstop.
* ``keydelta`` — sorted unsigned keys: first key + min-width deltas +
  DEFLATE; declines (None) an input it cannot represent.
* ``cellpack`` — packed uint32 cells: 2-bit values four to a byte and a
  min-width remoteness stream, each DEFLATE'd.

Encoding is pure and deterministic and decode(encode(a)) round-trips
exactly. Pure numpy + stdlib: no torch here.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


class BlockCorruptError(ValueError):
    """An encoded block failed structural validation (bad header, crc
    mismatch at the framing layer, wrong decoded count). Subclasses
    ValueError so checkpoint loaders treat it as one more torn-file
    shape (store/sealed.TORN_SEAL_ERRORS: quarantine and degrade)."""


def _writable_frombuffer(data: bytes, dtype) -> np.ndarray:
    # bytes -> writable array with ONE copy (np.frombuffer over immutable
    # bytes yields a read-only view; loaders hand these arrays to code
    # that sorts/slices in place).
    return np.frombuffer(bytearray(data), dtype=dtype)


def _min_unsigned_dtype(max_value: int) -> np.dtype:
    for dt in (np.uint8, np.uint16, np.uint32, np.uint64):
        if max_value <= np.iinfo(dt).max:
            return np.dtype(dt)
    raise BlockCorruptError(f"delta {max_value} exceeds uint64")


class RawCodec:
    """Identity: the passthrough every block can fall back to."""

    name = "raw"

    def encode(self, arr: np.ndarray):
        return arr.tobytes()

    def decode(self, blob: bytes, dtype, count: int) -> np.ndarray:
        dtype = np.dtype(dtype)
        if len(blob) != count * dtype.itemsize:
            raise BlockCorruptError(
                f"raw block: {len(blob)} bytes for {count} x {dtype}"
            )
        return _writable_frombuffer(blob, dtype)


class ZlibCodec:
    """DEFLATE over the array bytes — the shape-agnostic backstop."""

    name = "zlib"

    def __init__(self, level: int = 6):
        self.level = level

    def encode(self, arr: np.ndarray):
        return zlib.compress(arr.tobytes(), self.level)

    def decode(self, blob: bytes, dtype, count: int) -> np.ndarray:
        dtype = np.dtype(dtype)
        try:
            data = zlib.decompress(blob)
        except zlib.error as e:
            raise BlockCorruptError(f"zlib block: {e}") from None
        if len(data) != count * dtype.itemsize:
            raise BlockCorruptError(
                f"zlib block: decoded {len(data)} bytes for "
                f"{count} x {dtype}"
            )
        return _writable_frombuffer(data, dtype)


class KeyDeltaCodec:
    """Sorted unsigned keys: first key + min-width deltas + DEFLATE.

    Declines (returns None) for non-integer/unsorted/2-D inputs rather
    than producing an encoding whose decode could not reproduce them;
    strictly-ascending is the DB key invariant, but merely
    non-descending data (checkpoint cells sorted by key, say) encodes
    fine — only a *descending* pair is unrepresentable.
    """

    name = "keydelta"
    _HEADER = struct.Struct("<BQ")  # delta width byte, first key (u64)

    def encode(self, arr: np.ndarray):
        if arr.dtype.kind != "u" or arr.ndim != 1 or arr.shape[0] == 0:
            return None
        if arr.shape[0] > 1 and bool(np.any(arr[1:] < arr[:-1])):
            return None  # descending somewhere: not delta-codable
        # Unsigned subtraction is exact here because non-descending was
        # just established (np.diff on unsorted unsigned data would wrap,
        # not go negative — hence the explicit check above).
        deltas = arr[1:] - arr[:-1]
        width_dt = _min_unsigned_dtype(
            int(deltas.max()) if deltas.size else 0
        )
        payload = zlib.compress(deltas.astype(width_dt).tobytes(), 6)
        return self._HEADER.pack(width_dt.itemsize, int(arr[0])) + payload

    def decode(self, blob: bytes, dtype, count: int) -> np.ndarray:
        dtype = np.dtype(dtype)
        if count == 0:
            return np.zeros(0, dtype=dtype)
        if len(blob) < self._HEADER.size:
            raise BlockCorruptError("keydelta block: truncated header")
        width, first = self._HEADER.unpack_from(blob)
        if width not in (1, 2, 4, 8):
            raise BlockCorruptError(f"keydelta block: delta width {width}")
        try:
            data = zlib.decompress(blob[self._HEADER.size:])
        except zlib.error as e:
            raise BlockCorruptError(f"keydelta block: {e}") from None
        deltas = np.frombuffer(data, dtype=np.dtype(f"u{width}"))
        if deltas.shape[0] != count - 1:
            raise BlockCorruptError(
                f"keydelta block: {deltas.shape[0]} deltas for "
                f"{count} keys"
            )
        out = np.empty(count, dtype=np.uint64)
        out[0] = first
        np.cumsum(deltas, dtype=np.uint64, out=out[1:])
        out[1:] += np.uint64(first)
        return out.astype(dtype, copy=False)


class CellPackCodec:
    """Packed uint32 cells: 2-bit values four-to-a-byte + min-width
    remoteness stream, each DEFLATE'd (core/codec.py layout: value in
    the low 2 bits, remoteness in the high 30)."""

    name = "cellpack"
    _HEADER = struct.Struct("<BI")  # remoteness width byte, value bytes

    def encode(self, arr: np.ndarray):
        if arr.dtype != np.uint32 or arr.ndim != 1 or arr.shape[0] == 0:
            return None
        values = (arr & np.uint32(3)).astype(np.uint8)
        rem = arr >> np.uint32(2)
        pad = (-values.shape[0]) % 4
        if pad:
            values = np.concatenate([values, np.zeros(pad, np.uint8)])
        quads = values.reshape(-1, 4)
        vbytes = (
            quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4)
            | (quads[:, 3] << 6)
        ).tobytes()
        width_dt = _min_unsigned_dtype(int(rem.max()) if rem.size else 0)
        vblob = zlib.compress(vbytes, 6)
        rblob = zlib.compress(rem.astype(width_dt).tobytes(), 6)
        return (
            self._HEADER.pack(width_dt.itemsize, len(vblob)) + vblob + rblob
        )

    def decode(self, blob: bytes, dtype, count: int) -> np.ndarray:
        if np.dtype(dtype) != np.uint32:
            raise BlockCorruptError(
                f"cellpack block: cells must be uint32, not {dtype}"
            )
        if count == 0:
            return np.zeros(0, dtype=np.uint32)
        if len(blob) < self._HEADER.size:
            raise BlockCorruptError("cellpack block: truncated header")
        width, vlen = self._HEADER.unpack_from(blob)
        if width not in (1, 2, 4, 8):
            raise BlockCorruptError(
                f"cellpack block: remoteness width {width}"
            )
        body = blob[self._HEADER.size:]
        try:
            vbytes = zlib.decompress(body[:vlen])
            rbytes = zlib.decompress(body[vlen:])
        except zlib.error as e:
            raise BlockCorruptError(f"cellpack block: {e}") from None
        packed = np.frombuffer(vbytes, dtype=np.uint8)
        if packed.shape[0] * 4 < count:
            raise BlockCorruptError(
                f"cellpack block: {packed.shape[0] * 4} packed values "
                f"for {count} cells"
            )
        values = np.empty((packed.shape[0], 4), dtype=np.uint32)
        for j in range(4):
            values[:, j] = (packed >> (2 * j)) & 3
        values = values.reshape(-1)[:count]
        rem = np.frombuffer(rbytes, dtype=np.dtype(f"u{width}"))
        if rem.shape[0] != count:
            raise BlockCorruptError(
                f"cellpack block: {rem.shape[0]} remotenesses for "
                f"{count} cells"
            )
        return (values | (rem.astype(np.uint32) << np.uint32(2))).astype(
            np.uint32
        )


#: The codec registry: every name a block index may reference. Append-only
#: by design — a reader must be able to decode every codec any historical
#: writer recorded, forever (the "v1 stays readable" contract applied to
#: codecs).
CODECS = {
    c.name: c
    for c in (RawCodec(), ZlibCodec(), KeyDeltaCodec(), CellPackCodec())
}

#: Candidate orderings by payload shape: the writer tries these in order
#: and keeps the smallest (raw included, so compression can only win).
KEY_CANDIDATES = ("keydelta", "zlib")
CELL_CANDIDATES = ("cellpack", "zlib")
GENERIC_CANDIDATES = ("zlib",)


def get_codec(name: str):
    codec = CODECS.get(name)
    if codec is None:
        raise BlockCorruptError(
            f"unknown block codec {name!r} — written by a newer version?"
        )
    return codec


def encode_best(arr: np.ndarray, candidates) -> tuple[str, bytes]:
    """Encode one block with the smallest of ``candidates``, falling back
    to raw passthrough whenever compression loses (or every candidate
    declines). -> (codec name, encoded bytes).

    Raw competes by size (arr.nbytes) without materializing its bytes:
    tobytes() runs only when raw actually wins.
    """
    best_name, best = None, None
    best_len = arr.nbytes
    for name in candidates:
        blob = get_codec(name).encode(arr)
        if blob is not None and len(blob) < best_len:
            best_name, best, best_len = name, blob, len(blob)
    if best is None:
        return "raw", arr.tobytes()
    return best_name, best
