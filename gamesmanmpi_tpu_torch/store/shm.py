"""Cross-worker shared decoded-block cache (port of
gamesmanmpi_tpu/store/shm.py).

Fork-mode fleet workers each keep a *private* decoded-block cache
(``DbReader``'s per-process ``BlockStore``), so N workers decode the
same hot block N times — once per process — even though the decoded
bytes are identical. This module puts the decoded (keys, cells) pairs
in one ``multiprocessing.shared_memory`` segment per host so a block
any worker decoded is a memcpy for every sibling, including workers
respawned after a crash (they re-attach by name and inherit the warm
set).

Design — correctness first, and "a stale slot is a miss, never a wrong
answer":

* **Direct-mapped slot directory.** The segment is a header page, an
  array of fixed-layout slot metadata records, and a data region of
  ``nslots`` fixed-size payload slots. A block keyed by
  ``(st_dev, st_ino, block_index)`` hashes (splitmix64) to exactly one
  slot; collisions overwrite (an eviction), which bounds memory by
  construction — there is no free list to leak and no LRU chain to
  corrupt across processes.
* **Epoch stamping.** Every slot records the DB *epoch* (the manifest
  sha, see ``DbReader.epoch``) it was filled under. A reader presents
  its own epoch on ``get``; any mismatch is a miss. A rolling reload
  that swaps the DB therefore invalidates the whole segment without
  touching it — and because the key includes the inode pair of the
  sealed keys file (fresh inodes on every overwrite swap, same trick
  ``BlockStore`` uses for its private tier), even an epoch collision
  cannot alias two different files' blocks.
* **Per-slot seqlock, lock-striped writers.** Writers serialize per
  slot stripe through ``fcntl.lockf`` on tempdir lock files (path
  locks, so fork- and exec-spawned workers interoperate — no inherited
  fd plumbing). Each slot carries a sequence number: odd while a write
  is in flight, bumped even when it lands. Readers take NO lock: read
  seq (odd -> miss), copy the payload, re-read seq — any change means
  a torn read and the reader falls back to decoding. Fleet reads are
  wait-free on the hot path.

The supervisor owns segment lifecycle (`create`/`unlink` — including a
fresh segment per reload generation); workers only ever `attach`.
Sizing comes from ``GAMESMAN_SHM_CACHE_MB`` (docs/CONFIG.md) resolved
by the supervisor into ``budget_bytes`` here.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import struct
import tempfile

import numpy as np

__all__ = ["ShmBlockCache"]

_MAGIC = b"GMSHM1\x00\x00"
_HEADER_BYTES = 4096
_HEADER_FMT = "<8sQQQ"  # magic, nslots, slot_bytes, nstripes
_M64 = (1 << 64) - 1

#: Slot metadata: the seqlock word, the block identity (device, inode,
#: block index), the epoch words, and the payload shape. Fixed layout
#: (explicit little-endian fields) so fork- and exec-spawned workers
#: agree byte-for-byte.
_META_DTYPE = np.dtype(
    [
        ("seq", "<u8"),
        ("dev", "<u8"),
        ("ino", "<u8"),
        ("block", "<u8"),
        ("epoch_hi", "<u8"),
        ("epoch_lo", "<u8"),
        ("keys_nbytes", "<u8"),
        ("cells_nbytes", "<u8"),
        ("keys_dtype", "<u1"),
        ("cells_dtype", "<u1"),
    ]
)

#: Payload dtype code table (code = index + 1; 0 = empty slot). Codes,
#: not dtype strings, keep the metadata record fixed-width.
_DTYPES = ("u1", "u2", "u4", "u8", "i1", "i2", "i4", "i8")


def _dtype_code(dtype) -> int:
    name = np.dtype(dtype).str.lstrip("<>|=")
    try:
        return _DTYPES.index(name) + 1
    except ValueError:
        return 0


def _mix64(x: int) -> int:
    """splitmix64 finalizer — a deterministic cross-process hash (the
    builtin ``hash`` is salted per-process for strings and must not
    decide slot placement)."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _epoch_words(epoch: str) -> tuple:
    """The epoch string folded to two u64 slot-record words."""
    d = hashlib.blake2b(epoch.encode(), digest_size=16).digest()
    hi, lo = struct.unpack("<QQ", d)
    return hi, lo


class ShmBlockCache:
    """One host-wide decoded-block cache over a shared-memory segment.

    ``create`` (supervisor) or ``attach`` (worker), then ``get``/``put``
    decoded (keys, cells) pairs keyed by ``(dev, ino, block)`` under a
    DB epoch string. ``get`` returns ``None`` on any miss — absent,
    stale epoch, torn read, or foreign key — and never a wrong pair.
    """

    def __init__(self, shm, *, owner: bool, registry=None):
        self._shm = shm
        self._owner = owner
        magic, nslots, slot_bytes, nstripes = struct.unpack_from(
            _HEADER_FMT, shm.buf, 0
        )
        if magic != _MAGIC:
            raise ValueError(
                f"shm segment {shm.name!r} is not a GMSHM1 block cache"
            )
        self.nslots = int(nslots)
        self.slot_bytes = int(slot_bytes)
        self._nstripes = int(nstripes)
        meta_off = _HEADER_BYTES
        data_off = meta_off + self.nslots * _META_DTYPE.itemsize
        self._meta = np.frombuffer(
            shm.buf, dtype=_META_DTYPE, count=self.nslots, offset=meta_off
        )
        self._data = np.frombuffer(
            shm.buf, dtype=np.uint8,
            count=self.nslots * self.slot_bytes, offset=data_off,
        ).reshape(self.nslots, self.slot_bytes)
        self._lock_fds: dict = {}
        self._epoch_memo: dict = {}
        self._counts = {"hits": 0, "misses": 0, "stores": 0,
                        "evictions": 0}
        if registry is not None:
            self._m_hits = registry.counter(
                "gamesman_shm_hits_total",
                "decoded-block reads served from the cross-worker "
                "shared-memory cache",
            )
            self._m_misses = registry.counter(
                "gamesman_shm_misses_total",
                "shared-memory cache probes that fell through to a "
                "real block decode (absent, stale epoch, or torn slot)",
            )
            self._m_stores = registry.counter(
                "gamesman_shm_stores_total",
                "decoded blocks published into the shared-memory cache",
            )
            self._m_evictions = registry.counter(
                "gamesman_shm_evictions_total",
                "shared-memory slots overwritten while holding a "
                "different live block (direct-mapped collision)",
            )
            registry.gauge(
                "gamesman_shm_bytes",
                "total size of the attached shared decoded-block "
                "cache segment",
            ).set(float(shm.size))
        else:
            self._m_hits = self._m_misses = None
            self._m_stores = self._m_evictions = None

    # -- lifecycle ----------------------------------------------------

    @classmethod
    def create(cls, name: str, *, slot_bytes: int, budget_bytes: int,
               nstripes: int = 16, registry=None) -> "ShmBlockCache":
        """Supervisor-side: size, create and format a fresh segment.

        ``slot_bytes`` is the payload capacity per slot (the largest
        decoded (keys, cells) pair the fleet's DBs can produce);
        ``budget_bytes`` bounds the whole segment. Raises ``ValueError``
        when the budget cannot hold even one slot.
        """
        from multiprocessing import shared_memory

        slot_bytes = int(slot_bytes)
        per_slot = slot_bytes + _META_DTYPE.itemsize
        nslots = int(max(0, budget_bytes - _HEADER_BYTES) // per_slot)
        if nslots < 1:
            raise ValueError(
                f"shm budget {budget_bytes}B cannot hold one "
                f"{slot_bytes}B block slot"
            )
        size = _HEADER_BYTES + nslots * _META_DTYPE.itemsize \
            + nslots * slot_bytes
        shm = shared_memory.SharedMemory(name=name, create=True, size=size)
        # Fresh POSIX segments are zero-filled: every slot starts with
        # seq=0/dtype=0, i.e. empty. Only the header needs writing.
        struct.pack_into(_HEADER_FMT, shm.buf, 0, _MAGIC, nslots,
                         slot_bytes, int(max(1, min(nstripes, nslots))))
        return cls(shm, owner=True, registry=registry)

    @classmethod
    def attach(cls, name: str, registry=None) -> "ShmBlockCache":
        """Worker-side: attach to a supervisor-created segment by name."""
        from multiprocessing import shared_memory

        # Python < 3.13 registers ATTACHED segments with the resource
        # tracker too, and an exec-spawned worker gets its own tracker —
        # which would unlink the segment from under the whole fleet the
        # first time that worker exits. Suppress registration for the
        # attach (SharedMemory(track=False) is 3.13+): lifecycle belongs
        # to the supervisor, which created — and will unlink — the
        # segment under ITS tracker.
        from multiprocessing import resource_tracker

        orig = resource_tracker.register
        resource_tracker.register = lambda name_, rtype: None
        try:
            shm = shared_memory.SharedMemory(name=name)
        finally:
            resource_tracker.register = orig
        return cls(shm, owner=False, registry=registry)

    @property
    def name(self) -> str:
        return self._shm.name

    def close(self) -> None:
        """Drop this process's mapping (the segment itself survives)."""
        self._meta = None
        self._data = None
        for fd in self._lock_fds.values():
            try:
                os.close(fd)
            except OSError:
                pass
        self._lock_fds = {}
        try:
            self._shm.close()
        except (OSError, BufferError):
            pass

    def __del__(self):
        # Drop the numpy views BEFORE SharedMemory.__del__ runs: its
        # mmap close raises BufferError while exported views are alive
        # (interpreter-shutdown noise in every fleet worker otherwise).
        try:
            self.close()
        except Exception:
            pass

    def unlink(self) -> None:
        """Supervisor-side: close and destroy the segment + lock files."""
        name = self._shm.name
        self.close()
        try:
            self._shm.unlink()
        except (FileNotFoundError, OSError):
            pass
        for stripe in range(self._nstripes):
            try:
                os.unlink(self._lock_path(name, stripe))
            except OSError:
                pass

    # -- internals ----------------------------------------------------

    @staticmethod
    def _lock_path(name: str, stripe: int) -> str:
        return os.path.join(
            tempfile.gettempdir(), f"gamesman-{name}.s{stripe}.lock"
        )

    def _stripe_fd(self, stripe: int) -> int:
        fd = self._lock_fds.get(stripe)
        if fd is None:
            fd = os.open(
                self._lock_path(self._shm.name, stripe),
                os.O_CREAT | os.O_RDWR, 0o600,
            )
            self._lock_fds[stripe] = fd
        return fd

    def _slot_of(self, dev: int, ino: int, block: int) -> int:
        h = _mix64(_mix64(_mix64(dev & _M64) ^ (ino & _M64))
                   ^ (block & _M64))
        return h % self.nslots

    def _epoch(self, epoch: str) -> tuple:
        words = self._epoch_memo.get(epoch)
        if words is None:
            words = _epoch_words(epoch)
            if len(self._epoch_memo) > 8:  # reloads are rare; stay tiny
                self._epoch_memo.clear()
            self._epoch_memo[epoch] = words
        return words

    def _count(self, what: str, inst, n: int = 1) -> None:
        self._counts[what] += n
        if inst is not None:
            inst.inc(n)

    # -- hot path -----------------------------------------------------

    def get(self, key: tuple, epoch: str):
        """Wait-free probe: -> (keys, cells) arrays or None on miss."""
        dev, ino, block = key
        slot = self._slot_of(int(dev), int(ino), int(block))
        meta = self._meta[slot]
        seq0 = int(meta["seq"])
        ehi, elo = self._epoch(epoch)
        if (
            seq0 & 1
            or int(meta["keys_dtype"]) == 0
            or int(meta["dev"]) != int(dev)
            or int(meta["ino"]) != int(ino)
            or int(meta["block"]) != int(block)
            or int(meta["epoch_hi"]) != ehi
            or int(meta["epoch_lo"]) != elo
        ):
            self._count("misses", self._m_misses)
            return None
        kb = int(meta["keys_nbytes"])
        cb = int(meta["cells_nbytes"])
        kcode = int(meta["keys_dtype"])
        ccode = int(meta["cells_dtype"])
        if (
            kb + cb > self.slot_bytes
            or not 1 <= kcode <= len(_DTYPES)
            or not 1 <= ccode <= len(_DTYPES)
        ):
            self._count("misses", self._m_misses)
            return None
        payload = bytes(self._data[slot, : kb + cb])  # the copy
        if int(self._meta[slot]["seq"]) != seq0:
            # A writer landed mid-copy: torn — fall back to decode.
            self._count("misses", self._m_misses)
            return None
        keys = np.frombuffer(payload, dtype="<" + _DTYPES[kcode - 1],
                             count=kb // np.dtype(_DTYPES[kcode - 1]).itemsize)
        cells = np.frombuffer(payload, dtype="<" + _DTYPES[ccode - 1],
                              offset=kb)
        self._count("hits", self._m_hits)
        return keys, cells

    def put(self, key: tuple, epoch: str, keys, cells) -> bool:
        """Publish a decoded pair; False when it cannot be cached
        (oversized payload, unsupported dtype, or already present)."""
        keys = np.ascontiguousarray(keys)
        cells = np.ascontiguousarray(cells)
        kcode, ccode = _dtype_code(keys.dtype), _dtype_code(cells.dtype)
        nbytes = keys.nbytes + cells.nbytes
        if nbytes > self.slot_bytes or not kcode or not ccode:
            return False
        dev, ino, block = (int(k) for k in key)
        slot = self._slot_of(dev, ino, block)
        ehi, elo = self._epoch(epoch)
        fd = self._stripe_fd(slot % self._nstripes)
        fcntl.lockf(fd, fcntl.LOCK_EX)
        try:
            meta = self._meta[slot]
            seq = int(meta["seq"])
            occupied = int(meta["keys_dtype"]) != 0 and not seq & 1
            if (
                occupied
                and int(meta["dev"]) == dev
                and int(meta["ino"]) == ino
                and int(meta["block"]) == block
                and int(meta["epoch_hi"]) == ehi
                and int(meta["epoch_lo"]) == elo
            ):
                return False  # a sibling already published this block
            if occupied:
                self._count("evictions", self._m_evictions)
            meta["seq"] = (seq + 1) & _M64  # odd: write in flight
            self._data[slot, : keys.nbytes] = np.frombuffer(
                keys.astype(keys.dtype.newbyteorder("<"), copy=False)
                .tobytes(), dtype=np.uint8,
            )
            self._data[slot, keys.nbytes: nbytes] = np.frombuffer(
                cells.astype(cells.dtype.newbyteorder("<"), copy=False)
                .tobytes(), dtype=np.uint8,
            )
            meta["dev"] = dev
            meta["ino"] = ino
            meta["block"] = block
            meta["epoch_hi"] = ehi
            meta["epoch_lo"] = elo
            meta["keys_nbytes"] = keys.nbytes
            meta["cells_nbytes"] = cells.nbytes
            meta["keys_dtype"] = kcode
            meta["cells_dtype"] = ccode
            meta["seq"] = (seq + 2) & _M64  # even: slot live
        finally:
            fcntl.lockf(fd, fcntl.LOCK_UN)
        self._count("stores", self._m_stores)
        return True

    def stats(self) -> dict:
        """This process's probe counters plus the segment geometry."""
        return dict(
            self._counts, nslots=self.nslots, slot_bytes=self.slot_bytes,
            segment_bytes=int(self._shm.size),
        )
