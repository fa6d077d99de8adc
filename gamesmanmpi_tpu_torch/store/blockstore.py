"""BlockStore (port of gamesmanmpi_tpu/store/blockstore.py): the async
engine under the checkpointer's reads and the DB's I/O.

Read side. ``read(key, loader)`` is the one door: a cache hit returns;
an in-flight prefetch of the same key is waited for (the wait, not the
whole load, is the calling thread's I/O cost); otherwise the loader runs
synchronously. ``hint`` schedules the loader on the prefetch pool, so a
level hinted ahead of its use is decoded before the solve asks. A loader
exception on the pool is stored and re-raised at the consuming ``read``,
on the caller's thread, where quarantine decisions live; loaders must
therefore be pure (store/sealed.py).

Write side. ``write(fn, path=...)`` enqueues a payload write on ONE
ordered worker thread and returns a :class:`WriteTicket`; ``drain()``
waits for the queue and re-raises the first failure. Its caller is the
DB writer (db/writer.py): level payloads ride the worker, and the seal
(the manifest) is written on the caller's thread after every ticket
resolved, so a payload always lands before its seal; a death mid-queue
leaves a directory without a manifest, which the reader refuses (the
``store.writebehind`` fault point fires after each payload lands).
Checkpoint seals write inline on the solve thread, as before.

Accounting: ``io_wait_secs`` sums every second the calling thread spent
blocked on store I/O (synchronous loads, waits on in-flight prefetches,
drains, inline writes). The counters are read through
:meth:`BlockStore.stats` and land in the ``gamesman_store_*`` registry
series (docs/OBSERVABILITY.md); a read under an active query trace
records a ``store_read`` span (obs/qtrace.py). A failed prefetch or
write-behind payload is a ``store_read_error`` / ``store_write_error``
event in the flight recorder (obs/flightrec.py).
"""

from __future__ import annotations

import collections
import os
import threading
import time

from gamesmanmpi_tpu_torch.obs import default_registry, flightrec
from gamesmanmpi_tpu_torch.obs.qtrace import qspan
from gamesmanmpi_tpu_torch.resilience import faults
from gamesmanmpi_tpu_torch.store.cache import TieredCache
from gamesmanmpi_tpu_torch.utils.env import env_bool, env_int

#: Host-RAM tier default, in MB (GAMESMAN_STORE_CACHE_MB).
_DEFAULT_CACHE_MB = 256
_DEFAULT_PREFETCH_THREADS = 2


class WriteTicket:
    """One enqueued write-behind payload write.

    ``result()`` blocks until the write lands and returns the write fn's
    return value, re-raising the write's failure. Resolved synchronously
    when write-behind is off."""

    __slots__ = ("path", "consumed", "_event", "_value", "_error")

    def __init__(self, path=None):
        self.path = path
        #: True once result() delivered the outcome to a caller: a failure
        #: somebody already handled is not re-raised at a later drain().
        self.consumed = False
        self._event = threading.Event()
        self._value = None
        self._error = None

    def _resolve(self, value=None, error=None) -> None:
        self._value = value
        self._error = error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"write-behind of {self.path} still queued")
        self.consumed = True
        if self._error is not None:
            raise self._error
        return self._value


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
    """Tiered cache + prefetch pool + write-behind worker."""

    def __init__(self, *, cache: TieredCache | None = None,
                 prefetch_threads: int = _DEFAULT_PREFETCH_THREADS,
                 writebehind: bool = True, registry=None, labels=None):
        """labels: metric labels for THIS store's gamesman_store_*
        series. The process default store emits unlabeled; a private
        store (DbReader's GAMESMAN_DB_CACHE_MB budget) passes
        ``db=<name>`` so its counts never fold into the shared store's
        series."""
        reg = registry if registry is not None else default_registry()
        lbl = dict(labels or {})
        self.cache = cache if cache is not None else TieredCache(
            _DEFAULT_CACHE_MB << 20, registry=reg)
        self.prefetch_threads = max(0, int(prefetch_threads))
        self.writebehind = bool(writebehind)
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
        # Write-behind: ONE ordered daemon worker (FIFO order is the
        # correctness argument).
        self._wb_cond = threading.Condition(self._lock)
        self._wb_queue: collections.deque = collections.deque()
        self._wb_busy = False  # guarded-by: _lock
        self._wb_failed = None  # guarded-by: _lock (first failed ticket)
        self._wb_thread = None
        self._wb_writes = 0  # guarded-by: _lock
        self._wb_depth_peak = 0  # guarded-by: _lock
        self._m_io_wait = reg.counter(
            "gamesman_store_io_wait_seconds_total",
            "seconds calling threads spent blocked on store I/O "
            "(sync loads, prefetch waits, drains, inline writes)",
            **lbl,
        )
        self._m_pf_hits = reg.counter(
            "gamesman_store_prefetch_hits_total",
            "store reads satisfied by the cache or an in-flight prefetch",
            **lbl,
        )
        self._m_pf_misses = reg.counter(
            "gamesman_store_prefetch_misses_total",
            "store reads that fell back to a synchronous sealed load",
            **lbl,
        )
        self._m_wb_depth = reg.gauge(
            "gamesman_store_writebehind_queue_depth",
            "payload writes parked behind the write-behind worker now",
            **lbl,
        )
        self._m_wb_writes = reg.counter(
            "gamesman_store_writebehind_writes_total",
            "payload writes executed by the write-behind worker",
            **lbl,
        )

    # -------------------------------------------------------------- reads

    def read(self, key, loader, nbytes=None):
        """The one read door; see read_ex."""
        return self.read_ex(key, loader, nbytes=nbytes)[0]

    def read_ex(self, key, loader, nbytes=None):
        """-> (value, hit). A cache hit or a wait on an in-flight prefetch
        is a hit; a synchronous load is a miss. ``key=None`` bypasses the
        cache (an unstat-able file, see file_key). ``nbytes`` sizes the
        cache entry; None derives it from the value's ``.nbytes``.

        Under an active query trace (the serving path, obs/qtrace.py) the
        read records a ``store_read`` span carrying which path answered:
        ``hit`` (cache), ``wait`` (in-flight prefetch) or ``sync`` (the
        loader ran on this thread)."""
        with qspan("store_read") as sp:
            return self._read_ex_traced(key, loader, nbytes, sp)

    def _read_ex_traced(self, key, loader, nbytes, sp):
        if key is not None:
            with self._lock:
                self._reads += 1
            # Cache lookup outside the store lock: the cache has its own.
            value = self.cache.get(key)
            if value is not None:
                with self._lock:
                    self._prefetch_hits += 1
                self._m_pf_hits.inc()
                if sp is not None:
                    sp["path"] = "hit"
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
                    self._m_pf_misses.inc()
                    raise entry.error
                self._m_pf_hits.inc()
                if sp is not None:
                    sp["path"] = "wait"
                return entry.value, True
        with self._lock:
            if key is None:
                self._reads += 1
            self._prefetch_misses += 1
        self._m_pf_misses.inc()
        if sp is not None:
            sp["path"] = "sync"
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
                # A torn block surfacing minutes later reads back to this.
                flightrec.record("store_read_error", key=str(key)[:120],
                                 error=str(e)[:120])
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

    # ------------------------------------------------------------- writes

    def write(self, fn, path=None) -> WriteTicket:
        """Enqueue one payload write (write-behind on) or run it inline
        (off, or after close), returning its ticket. ``path`` names the
        target file for diagnostics and the ``store.writebehind`` fault
        point's torn-write target."""
        ticket = WriteTicket(path)
        if self.writebehind:
            enqueued = False
            with self._wb_cond:
                if not self._closed:
                    self._wb_queue.append((ticket, fn))
                    depth = len(self._wb_queue) + (1 if self._wb_busy else 0)
                    self._wb_depth_peak = max(self._wb_depth_peak, depth)
                    if self._wb_thread is None:
                        self._wb_thread = threading.Thread(
                            target=self._writebehind_loop,
                            name="gamesman-store-writebehind", daemon=True,
                        )
                        self._wb_thread.start()
                    self._wb_cond.notify()
                    enqueued = True
            if enqueued:
                # Outside the lock: registry children take their own.
                self._m_wb_depth.set(depth)
                return ticket
        self._run_write(ticket, fn)
        return ticket

    def _run_write(self, ticket: WriteTicket, fn) -> None:
        """One write on the CALLING thread (write-behind off): it blocks
        the caller, so it counts as io_wait. A failure raises directly and
        is not recorded for drain(), which would surface it twice."""
        t0 = time.perf_counter()
        try:
            value = fn()
            # Inside the try: an armed transient/fatal here behaves like a
            # write failure (the ticket resolves; kill/torn exit outright).
            faults.fire("store.writebehind", path=ticket.path)
        except BaseException as e:  # noqa: BLE001 - also surfaced via ticket
            ticket._resolve(error=e)
            self._note_wait(time.perf_counter() - t0)
            with self._lock:
                self._wb_writes += 1
            raise
        self._note_wait(time.perf_counter() - t0)
        with self._lock:
            self._wb_writes += 1
        ticket._resolve(value)

    def _writebehind_loop(self) -> None:
        while True:
            with self._wb_cond:
                self._wb_busy = False
                self._wb_cond.notify_all()  # wake drain()ers
                while not self._wb_queue and not self._closed:
                    self._wb_cond.wait()
                if not self._wb_queue:
                    return  # closed and drained
                ticket, fn = self._wb_queue.popleft()
                self._wb_busy = True
                depth = len(self._wb_queue) + 1
            self._m_wb_depth.set(depth)
            try:
                value = fn()
                # After the payload lands, before any seal can run (seals
                # drain first): a kill here is the death between payload
                # and seal. Inside the try, so an injected transient/fatal
                # resolves the ticket instead of killing this thread.
                faults.fire("store.writebehind", path=ticket.path)
            except BaseException as e:  # noqa: BLE001 - surfaced at drain
                flightrec.record(
                    "store_write_error",
                    path=str(ticket.path)[:160], error=str(e)[:120],
                )
                with self._lock:
                    self._wb_writes += 1
                    if self._wb_failed is None:
                        self._wb_failed = ticket
                self._m_wb_writes.inc()
                ticket._resolve(error=e)
                self._m_wb_depth.set(len(self._wb_queue))
                continue
            with self._lock:
                self._wb_writes += 1
            self._m_wb_writes.inc()
            ticket._resolve(value)
            # The honest remaining depth, the idle case included.
            self._m_wb_depth.set(len(self._wb_queue))

    def drain(self) -> None:
        """Wait for the write-behind queue; re-raise the first queued
        write's failure unless its ticket was already consumed by
        result(). Cleared either way: one failure surfaces once. Every
        seal calls this before it writes a manifest."""
        t0 = time.perf_counter()
        with self._wb_cond:
            while self._wb_queue or self._wb_busy:
                self._wb_cond.wait()
            failed, self._wb_failed = self._wb_failed, None
        waited = time.perf_counter() - t0
        if waited > 1e-6:
            self._note_wait(waited)
        if failed is not None and not failed.consumed:
            failed.consumed = True
            raise failed._error

    # -------------------------------------------------------------- misc

    def _note_wait(self, secs: float) -> None:
        with self._lock:
            self._io_wait_secs += secs
        self._m_io_wait.inc(max(0.0, secs))

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
                "writebehind_writes": self._wb_writes,
                "writebehind_queue_depth": (
                    len(self._wb_queue) + (1 if self._wb_busy else 0)
                ),
                "writebehind_queue_depth_peak": self._wb_depth_peak,
            }

    def close(self) -> None:
        """Drain writes, stop accepting background work, release the
        cache. Late ``write`` calls run inline and late ``hint`` calls
        no-op, so a holder of a stale store stays correct."""
        self.drain()
        with self._wb_cond:
            self._closed = True
            self._wb_cond.notify_all()
            self._pf_cond.notify_all()
        self.cache.clear()


#: Process-wide store, keyed on the env knobs it was built from: a change
#: of GAMESMAN_STORE_* gets a fresh store at the next default_store().
_DEFAULT_LOCK = threading.Lock()
_DEFAULT: tuple | None = None  # guarded-by: _DEFAULT_LOCK


def default_store() -> BlockStore:
    """The shared store (one byte budget, one prefetch pool, one
    write-behind queue per process), configured by
    GAMESMAN_STORE_CACHE_MB, GAMESMAN_STORE_PREFETCH_THREADS and
    GAMESMAN_STORE_WRITEBEHIND."""
    global _DEFAULT
    knobs = (
        env_int("GAMESMAN_STORE_CACHE_MB", _DEFAULT_CACHE_MB),
        env_int("GAMESMAN_STORE_PREFETCH_THREADS", _DEFAULT_PREFETCH_THREADS),
        env_bool("GAMESMAN_STORE_WRITEBEHIND", True),
    )
    with _DEFAULT_LOCK:
        if _DEFAULT is not None and _DEFAULT[0] == knobs:
            return _DEFAULT[1]
        old = _DEFAULT[1] if _DEFAULT is not None else None
        store = BlockStore(
            cache=TieredCache(max(1, knobs[0]) << 20,
                              registry=default_registry()),
            prefetch_threads=knobs[1],
            writebehind=knobs[2],
            registry=default_registry(),
        )
        _DEFAULT = (knobs, store)
    if old is not None:
        old.close()
    return store
