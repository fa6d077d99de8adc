"""BlockStore (port of gamesmanmpi_tpu/store/blockstore.py): the async
engine under the checkpointer's I/O.

Read side. ``read(key, loader)`` is the one door: a cache hit returns;
an in-flight prefetch of the same key is waited for (the wait, not the
whole load, is the calling thread's I/O cost); otherwise the loader runs
synchronously. ``hint`` schedules the loader on the prefetch pool, so a
level hinted ahead of its use is decoded before the solve asks. A loader
exception on the pool is stored and re-raised at the consuming ``read``,
on the caller's thread, where quarantine decisions live; loaders must
therefore be pure (store/sealed.py).

The reference's write side (``write``/``drain`` write-behind on one
ordered worker thread) has no caller in this package yet: checkpoint
seals write inline on the solve thread. It comes with the DB writer.

Accounting: ``io_wait_secs`` sums every second the calling thread spent
blocked on store I/O (synchronous loads and waits on in-flight
prefetches). The reference's metric-registry series, query spans and
flight-recorder events belong to the observability layer, not ported
yet; the counters are read through :meth:`BlockStore.stats`.
"""

from __future__ import annotations

import collections
import os
import threading
import time

from gamesmanmpi_tpu_torch.store.cache import TieredCache
from gamesmanmpi_tpu_torch.utils.env import env_int

#: Host-RAM tier default, in MB (GAMESMAN_STORE_CACHE_MB).
_DEFAULT_CACHE_MB = 256
_DEFAULT_PREFETCH_THREADS = 2


class _Inflight:
    """One key's in-progress background load."""

    __slots__ = ("event", "value", "error")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error = None


def file_key(path):
    """Cache key of a sealed file: (path, mtime_ns, size), so a rewritten,
    truncated or quarantined file never serves stale cached arrays.
    None (bypass the cache) when the file cannot be stat'ed; the loader
    then raises the honest FileNotFoundError."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (str(path), st.st_mtime_ns, st.st_size)


class BlockStore:
    """Tiered cache + prefetch pool."""

    def __init__(self, *, cache: TieredCache | None = None,
                 prefetch_threads: int = _DEFAULT_PREFETCH_THREADS):
        self.cache = cache if cache is not None else TieredCache(
            _DEFAULT_CACHE_MB << 20)
        self.prefetch_threads = max(0, int(prefetch_threads))
        self._lock = threading.Lock()
        self._inflight: dict = {}  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        self._io_wait_secs = 0.0  # guarded-by: _lock
        self._prefetch_hits = 0  # guarded-by: _lock
        self._prefetch_misses = 0  # guarded-by: _lock
        self._prefetch_issued = 0  # guarded-by: _lock
        self._reads = 0  # guarded-by: _lock
        # Prefetch pool: lazy daemon threads over one work deque.
        self._pf_cond = threading.Condition(self._lock)
        self._pf_queue: collections.deque = collections.deque()
        self._pf_started = 0  # guarded-by: _lock

    # -------------------------------------------------------------- reads

    def read(self, key, loader, nbytes=None):
        """The one read door; see read_ex."""
        return self.read_ex(key, loader, nbytes=nbytes)[0]

    def read_ex(self, key, loader, nbytes=None):
        """-> (value, hit). A cache hit or a wait on an in-flight prefetch
        is a hit; a synchronous load is a miss. ``key=None`` bypasses the
        cache (an unstat-able file, see file_key). ``nbytes`` sizes the
        cache entry; None derives it from the value's ``.nbytes``."""
        if key is not None:
            with self._lock:
                self._reads += 1
            # Cache lookup outside the store lock: the cache has its own.
            value = self.cache.get(key)
            if value is not None:
                with self._lock:
                    self._prefetch_hits += 1
                return value, True
            with self._lock:
                entry = self._inflight.get(key)
            if entry is not None:
                t0 = time.perf_counter()
                entry.event.wait()
                self._note_wait(time.perf_counter() - t0)
                with self._lock:
                    if entry.error is not None:
                        self._prefetch_misses += 1
                    else:
                        self._prefetch_hits += 1
                if entry.error is not None:
                    # Background corruption re-raises HERE, on the
                    # consuming thread; the worker already dropped the
                    # entry, so a retry reloads fresh.
                    raise entry.error
                return entry.value, True
        with self._lock:
            if key is None:
                self._reads += 1
            self._prefetch_misses += 1
        t0 = time.perf_counter()
        try:
            value = loader()
        finally:
            self._note_wait(time.perf_counter() - t0)
        if key is not None:
            self.cache.put(key, value, self._sizeof(value, nbytes))
        return value, False

    def hint(self, key, loader, nbytes=None) -> None:
        """Schedule a background load of ``key``. No-op when the key is
        None, already cached or in flight, or the pool is disabled
        (GAMESMAN_STORE_PREFETCH_THREADS=0)."""
        if key is None or self.prefetch_threads <= 0:
            return
        if self.cache.contains(key):
            return  # a peek: a hint must not skew hit accounting
        spawn = 0
        with self._lock:
            if self._closed or key in self._inflight:
                return
            self._inflight[key] = _Inflight()
            self._prefetch_issued += 1
            self._pf_queue.append((key, loader, nbytes))
            if self._pf_started < self.prefetch_threads:
                self._pf_started += 1
                spawn = self._pf_started
            self._pf_cond.notify()
        if spawn:
            threading.Thread(
                target=self._prefetch_loop,
                name=f"gamesman-store-prefetch-{spawn - 1}",
                daemon=True,
            ).start()

    def _prefetch_loop(self) -> None:
        while True:
            with self._pf_cond:
                while not self._pf_queue and not self._closed:
                    self._pf_cond.wait()
                if self._closed and not self._pf_queue:
                    return
                key, loader, nbytes = self._pf_queue.popleft()
                entry = self._inflight.get(key)
            if entry is None:  # pragma: no cover - defensive
                continue
            try:
                value = loader()
            except BaseException as e:  # noqa: BLE001 - re-raised at read
                entry.error = e
                with self._lock:
                    self._inflight.pop(key, None)
                entry.event.set()
                continue
            entry.value = value
            self.cache.put(key, value, self._sizeof(value, nbytes))
            with self._lock:
                self._inflight.pop(key, None)
            entry.event.set()

    @staticmethod
    def _sizeof(value, nbytes) -> int:
        if nbytes is not None:
            return int(nbytes)
        if hasattr(value, "nbytes"):
            return int(value.nbytes)
        if isinstance(value, dict):
            vals = value.values()
        elif isinstance(value, (tuple, list)):
            vals = value
        else:
            return 0
        return int(sum(getattr(v, "nbytes", 0) for v in vals))

    # -------------------------------------------------------------- misc

    def _note_wait(self, secs: float) -> None:
        with self._lock:
            self._io_wait_secs += secs

    def stats(self) -> dict:
        """Point-in-time counters (solvers report per-solve deltas)."""
        with self._lock:
            reads = self._prefetch_hits + self._prefetch_misses
            return {
                "io_wait_secs": self._io_wait_secs,
                "reads": self._reads,
                "prefetch_hits": self._prefetch_hits,
                "prefetch_misses": self._prefetch_misses,
                "prefetch_issued": self._prefetch_issued,
                "prefetch_hit_rate": (
                    self._prefetch_hits / reads if reads else 0.0
                ),
            }

    def close(self) -> None:
        """Stop accepting background work and release the cache. Late
        ``hint`` calls no-op, so a holder of a stale store stays correct."""
        with self._pf_cond:
            self._closed = True
            self._pf_cond.notify_all()
        self.cache.clear()


#: Process-wide store, keyed on the env knobs it was built from: a change
#: of GAMESMAN_STORE_* gets a fresh store at the next default_store().
_DEFAULT_LOCK = threading.Lock()
_DEFAULT: tuple | None = None  # guarded-by: _DEFAULT_LOCK


def default_store() -> BlockStore:
    """The shared store (one byte budget and one prefetch pool per
    process), configured by GAMESMAN_STORE_CACHE_MB and
    GAMESMAN_STORE_PREFETCH_THREADS."""
    global _DEFAULT
    knobs = (
        env_int("GAMESMAN_STORE_CACHE_MB", _DEFAULT_CACHE_MB),
        env_int("GAMESMAN_STORE_PREFETCH_THREADS", _DEFAULT_PREFETCH_THREADS),
    )
    with _DEFAULT_LOCK:
        if _DEFAULT is not None and _DEFAULT[0] == knobs:
            return _DEFAULT[1]
        old = _DEFAULT[1] if _DEFAULT is not None else None
        store = BlockStore(
            cache=TieredCache(max(1, knobs[0]) << 20),
            prefetch_threads=knobs[1],
        )
        _DEFAULT = (knobs, store)
    if old is not None:
        old.close()
    return store
