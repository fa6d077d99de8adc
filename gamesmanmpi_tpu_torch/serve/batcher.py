"""Coalescing micro-batcher + LRU hot-position cache for query serving
(port of gamesmanmpi_tpu/serve/batcher.py).

The DbReader's probe is vectorized: one searchsorted over a whole batch
costs barely more than over one key, and the canonicalize kernel is a
fixed-capacity program either way. So the server never probes per
request — concurrent requests park in a queue for a short coalescing
window (default 2 ms) and flush as ONE `DbReader.lookup_best` call. The
same shape as ML inference micro-batching, and the serving twin of the
engine's own design rule (bulk kernels, never per-position work).

In front of the batch sits an LRU cache keyed on the raw queried
position: real traffic is Zipf-ish (openings and famous positions
repeat), and a cache hit answers without touching the batcher at all.
Raw — not canonical — keys mean symmetric duplicates occupy separate
entries; that costs cache capacity, never correctness, and avoids paying
a canonicalize kernel call before the cache.

Degradation model (the resilience layer, docs/CONFIG.md): the batcher
never hangs a client and never dies with the reader. Every ``submit``
carries a deadline (``request_timeout``; expiry raises
:class:`BatcherTimeout` → HTTP 503 + Retry-After); a queue deeper than
``max_queue`` sheds new requests (:class:`BatcherOverloaded`); and
consecutive reader faults trip a circuit breaker
(:class:`BatcherTripped`) that fails misses fast — cache hits still
answer — while the worker re-probes the reader in the background
(half-open) and closes the circuit on the first success, no restart
needed. ``state`` reports ok/open/half_open; ``/healthz`` maps any
non-ok state to "degraded".

Counters are plain ints mutated under the one lock and snapshotted by
`metrics()` (the `/metrics.json` dict); per-batch records go to the
shared utils/metrics JSONL logger so serving latency lands in the same
stream as solve phases, and the obs registry carries the Prometheus
series (`gamesman_batch_queue_depth`, `gamesman_batch_size`,
`gamesman_batch_seconds`, cache hit/miss counters, shed/timeout/breaker
counters) that `/metrics` exposes.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

import numpy as np

from gamesmanmpi_tpu_torch.obs import default_registry
from gamesmanmpi_tpu_torch.obs.qtrace import activate as _activate_traces
from gamesmanmpi_tpu_torch.obs.registry import DEFAULT_SIZE_BUCKETS
from gamesmanmpi_tpu_torch.resilience import faults
from gamesmanmpi_tpu_torch.utils.env import env_float as _env_float


class BatcherUnavailable(RuntimeError):
    """Base of the *transient* submit failures (the HTTP layer answers
    503 + Retry-After for every subclass, 500 only for real reader
    faults — torch's runtime errors subclass RuntimeError, so matching
    on RuntimeError would misclassify a broken DB as a recovering
    server). ``retry_after`` is the advisory client backoff in seconds.
    """

    retry_after = 1

    def __init__(self, msg: str, retry_after: int | None = None):
        super().__init__(msg)
        if retry_after is not None:
            self.retry_after = max(1, int(retry_after))


class BatcherClosed(BatcherUnavailable):
    """submit() after (or parked across) close(): server shutdown."""


class BatcherTimeout(BatcherUnavailable):
    """The per-request deadline expired before the batch flushed."""


class BatcherOverloaded(BatcherUnavailable):
    """Queue-depth load shedding: more parked requests than max_queue."""


class BatcherTripped(BatcherUnavailable):
    """Circuit breaker open after consecutive reader faults; misses
    fail fast until the background half-open re-probe succeeds."""


class _Request:
    """One submitter's slice of a coalesced batch."""

    __slots__ = ("states", "event", "out", "error", "trace", "enq")

    def __init__(self, states: np.ndarray, trace=None):
        self.states = states
        self.event = threading.Event()
        self.out = None
        self.error = None
        #: obs.qtrace.QueryTrace of the submitting request (or None).
        #: The flush attributes its queue wait and the coalesced probe's
        #: spans to every member trace.
        self.trace = trace
        self.enq = time.perf_counter()


class Batcher:
    """Thread-safe coalescing front-end over one DbReader.

    submit() blocks its calling thread until the worker flushes the
    window's batch (or its deadline expires); results come back per
    position as (value, remoteness, found, best) tuples of Python
    scalars.
    """

    def __init__(self, reader, *, window: float = 0.002,
                 cache_size: int = 65536, max_batch: int = 1 << 16,
                 max_queue: int = 1024, request_timeout: float | None = None,
                 breaker_threshold: int = 3, breaker_cooldown: float = 5.0,
                 logger=None, registry=None):
        self.reader = reader
        self.window = float(window)
        #: Flush threshold: a burst larger than this splits into several
        #: probes instead of one giant one — an unbounded coalesce would
        #: pad to a huge (possibly freshly-compiled) kernel capacity and
        #: stall every parked request behind a single oversized batch.
        self.max_batch = int(max_batch)
        #: Load-shed threshold: requests (not positions) parked at once.
        self.max_queue = max(1, int(max_queue))
        #: Per-request deadline in seconds (0 = wait forever). None reads
        #: GAMESMAN_REQUEST_TIMEOUT (default 30 — matches the handler's
        #: socket timeout, so the batcher always answers first).
        if request_timeout is None:
            request_timeout = _env_float("GAMESMAN_REQUEST_TIMEOUT", 30.0)
        self.request_timeout = float(request_timeout)
        #: Consecutive reader faults that open the circuit breaker, and
        #: how long it stays open before a half-open re-probe.
        self.breaker_threshold = max(1, int(breaker_threshold))
        self.breaker_cooldown = float(breaker_cooldown)
        self.logger = logger
        self._cache: OrderedDict = OrderedDict()  # guarded-by: _lock
        # Clamp: a negative size (the conventional "unlimited" spelling
        # elsewhere) would make the eviction loop pop an empty dict.
        self._cache_size = max(0, int(cache_size))
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: list[_Request] = []  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        #: breaker: "ok" | "open" | "half_open" (+ the fault streak and
        #: when the circuit opened), all mutated under the one lock.
        self._breaker = "ok"  # guarded-by: _lock
        self._consecutive_faults = 0  # guarded-by: _lock
        self._opened_at = 0.0  # guarded-by: _lock
        # guarded-by: _lock
        self.counters = {
            "requests": 0,
            "queries": 0,
            "cache_hits": 0,
            "cache_misses": 0,
            "batches": 0,
            "batched_queries": 0,
            "max_batch_size": 0,
            "batch_secs_total": 0.0,
            "timeouts": 0,
            "shed": 0,
            "dup_hits": 0,
            "reader_faults": 0,
            "breaker_opens": 0,
        }
        reg = registry or default_registry()
        self._m_queue_depth = reg.gauge(
            "gamesman_batch_queue_depth",
            "requests parked in the coalescing window right now",
        )
        self._m_batch_size = reg.histogram(
            "gamesman_batch_size", "positions per flushed probe batch",
            buckets=DEFAULT_SIZE_BUCKETS,
        )
        self._m_batch_secs = reg.histogram(
            "gamesman_batch_seconds", "wall seconds per flushed probe batch"
        )
        self._m_cache_hits = reg.counter(
            "gamesman_cache_hits_total", "positions answered from the LRU"
        )
        self._m_cache_misses = reg.counter(
            "gamesman_cache_misses_total", "positions that went to a probe"
        )
        self._m_timeouts = reg.counter(
            "gamesman_request_timeouts_total",
            "submits whose per-request deadline expired",
        )
        self._m_shed = reg.counter(
            "gamesman_requests_shed_total",
            "submits refused by load shedding or an open breaker",
        )
        self._m_dup_hits = reg.counter(
            "gamesman_batch_dup_hits_total",
            "positions coalesced away by in-flight dedup before the probe",
        )
        self._m_reader_faults = reg.counter(
            "gamesman_reader_faults_total",
            "probe batches that failed with a reader error",
        )
        self._m_breaker_state = reg.gauge(
            "gamesman_breaker_state",
            "reader circuit breaker: 0=ok, 1=half_open, 2=open",
        )
        self._m_breaker_state.set(0)
        self._worker = threading.Thread(
            target=self._loop, name="gamesman-batcher", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------ client API

    @property
    def state(self) -> str:
        """Breaker state: "ok" | "open" | "half_open"."""
        with self._lock:
            return self._breaker

    def submit(self, positions,
               timeout: float | None = None, trace=None,
               ) -> list[tuple[int, int, bool, int | None]]:
        """Resolve a request's positions; blocks until the batch flushes
        or the deadline (``timeout``, default the batcher's
        ``request_timeout``; 0 = forever) expires.

        positions: iterable of ints (already range-validated by the
        caller). Returns one (value, remoteness, found, best_or_None)
        tuple per position, in order. Raises a
        :class:`BatcherUnavailable` subclass on shutdown, deadline,
        shedding, or an open breaker — cache hits are still served in
        every state, so a degraded server keeps answering its hot set.
        """
        positions = [int(p) for p in positions]
        results: list = [None] * len(positions)
        miss_idx: list[int] = []
        miss_pos: list[int] = []
        with self._lock:
            if self._closed:
                raise BatcherClosed("batcher is closed")
            self.counters["requests"] += 1
            self.counters["queries"] += len(positions)
            for i, p in enumerate(positions):
                hit = self._cache.get(p)
                if hit is not None:
                    self._cache.move_to_end(p)
                    self.counters["cache_hits"] += 1
                    results[i] = hit
                else:
                    self.counters["cache_misses"] += 1
                    miss_idx.append(i)
                    miss_pos.append(p)
        if len(positions) > len(miss_idx):
            self._m_cache_hits.inc(len(positions) - len(miss_idx))
        if miss_idx:
            self._m_cache_misses.inc(len(miss_idx))
        if not miss_idx:
            return results
        req = _Request(
            np.asarray(miss_pos, dtype=self.reader.game.state_dtype),
            trace=trace,
        )
        with self._cond:
            if self._closed:  # close() may have landed since the cache pass
                raise BatcherClosed("batcher is closed")
            if self._breaker != "ok":
                self.counters["shed"] += 1
                self._m_shed.inc()
                remaining = self._opened_at + self.breaker_cooldown \
                    - time.monotonic()
                raise BatcherTripped(
                    "reader circuit breaker is open",
                    retry_after=max(1, int(remaining) + 1),
                )
            if len(self._pending) >= self.max_queue:
                self.counters["shed"] += 1
                self._m_shed.inc()
                raise BatcherOverloaded(
                    f"query queue is full ({self.max_queue} requests parked)"
                )
            self._pending.append(req)
            self._m_queue_depth.set(len(self._pending))
            self._cond.notify_all()
        deadline = self.request_timeout if timeout is None else float(timeout)
        ok = req.event.wait(deadline if deadline > 0 else None)
        if not ok:
            with self._cond:
                if req in self._pending:
                    self._pending.remove(req)
                    self._m_queue_depth.set(len(self._pending))
                if req.event.is_set():
                    ok = True  # flushed while we raced the removal
                else:
                    self.counters["timeouts"] += 1
            if not ok:
                self._m_timeouts.inc()
                raise BatcherTimeout(
                    f"request deadline ({deadline:g}s) exceeded"
                )
        if req.error is not None:
            raise req.error
        with self._lock:
            for j, i in enumerate(miss_idx):
                results[i] = req.out[j]
                self._cache[miss_pos[j]] = req.out[j]
                self._cache.move_to_end(miss_pos[j])
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)
        return results

    def close(self, drain: bool = False) -> None:
        """Stop the batcher. Default: requests still parked in the
        coalescing window fail with BatcherClosed (→ 503; a client
        retries another replica) — they must never hang on an event
        nobody will set. ``drain=True`` (graceful shutdown, SIGTERM)
        flushes the parked requests through one last probe first."""
        with self._cond:
            self._closed = True
            if not drain:
                for r in self._pending:
                    r.error = BatcherClosed("batcher is closed")
                    r.event.set()
                self._pending.clear()
                self._m_queue_depth.set(0)
            self._cond.notify_all()
        self._worker.join(timeout=5)

    def metrics(self) -> dict:
        """Snapshot of the coalescing/cache counters (+ derived means)."""
        with self._lock:
            c = dict(self.counters)
            state = self._breaker
        batches = max(c["batches"], 1)
        lookups = c["cache_hits"] + c["cache_misses"]
        return {
            **c,
            "breaker_state": state,
            "mean_batch_size": c["batched_queries"] / batches,
            "mean_batch_secs": c["batch_secs_total"] / batches,
            "cache_hit_rate": c["cache_hits"] / max(lookups, 1),
        }

    # ------------------------------------------------------- circuit breaker

    def _note_reader_fault(self) -> None:
        with self._lock:
            self.counters["reader_faults"] += 1
            self._consecutive_faults += 1
            streak = self._consecutive_faults
            opened = (
                self._breaker == "ok"
                and streak >= self.breaker_threshold
            )
            if opened or self._breaker == "half_open":
                self._breaker = "open"
                self._opened_at = time.monotonic()
                if opened:
                    self.counters["breaker_opens"] += 1
        self._m_reader_faults.inc()
        if opened:
            self._m_breaker_state.set(2)
            if self.logger is not None:
                self.logger.log({
                    "phase": "breaker_open",
                    "consecutive_faults": streak,
                })
        elif self.state == "open":
            self._m_breaker_state.set(2)

    def _note_reader_ok(self) -> None:
        recovered = False
        with self._lock:
            self._consecutive_faults = 0
            if self._breaker != "ok":
                self._breaker = "ok"
                recovered = True
        if recovered:
            self._m_breaker_state.set(0)
            if self.logger is not None:
                self.logger.log({"phase": "breaker_closed"})

    # requires-lock: _lock
    def _breaker_wait(self) -> float | None:
        """Seconds the idle worker may sleep before it owes a half-open
        re-probe; None when the breaker is closed (sleep until work).
        Called with the lock held (from the worker's _cond wait loop)."""
        if self._breaker == "ok":
            return None
        return max(
            0.01, self._opened_at + self.breaker_cooldown - time.monotonic()
        )

    def _breaker_tick(self) -> None:
        """Half-open re-probe: after the cooldown, probe the reader with
        one real lookup (through the same faultable probe path) in the
        worker thread — no client request is spent on the experiment —
        and close the circuit on success."""
        with self._lock:
            if self._breaker == "ok":
                return
            if time.monotonic() < self._opened_at + self.breaker_cooldown:
                return
            self._breaker = "half_open"
        self._m_breaker_state.set(1)
        try:
            probe = np.asarray(
                [int(self.reader.game.initial_state())],
                dtype=self.reader.game.state_dtype,
            )
            self.reader.lookup_best(probe)
        except Exception:  # noqa: BLE001 - still broken: stay open
            self._note_reader_fault()
        else:
            self._note_reader_ok()

    # ---------------------------------------------------------------- worker

    def _drain_window(self) -> list[_Request]:
        """Wait for work, then collect what arrives in the window — up to
        max_batch queries; the remainder stays queued and the worker loops
        straight back into the next flush without waiting. With the
        breaker open the wait is bounded so the worker wakes for its
        half-open re-probe even with zero traffic."""
        with self._cond:
            while not self._pending and not self._closed:
                t = self._breaker_wait()
                self._cond.wait(t)
                if t is not None:
                    return []  # let _loop run the breaker tick
            if not self._pending:
                return []
            deadline = time.monotonic() + self.window
            while not self._closed:
                if (
                    sum(r.states.shape[0] for r in self._pending)
                    >= self.max_batch
                ):
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            batch: list[_Request] = []
            total = 0
            while self._pending:
                n = self._pending[0].states.shape[0]
                if batch and total + n > self.max_batch:
                    break
                batch.append(self._pending.pop(0))
                total += n
            self._m_queue_depth.set(len(self._pending))
            return batch

    def _loop(self) -> None:
        while True:
            self._breaker_tick()
            batch = self._drain_window()
            if not batch:
                with self._lock:
                    if self._closed and not self._pending:
                        return
                continue
            t0 = time.perf_counter()
            # Queue-wait span per member request: enqueue to flush start
            # (explicit timing — the wait already happened). Then the
            # coalesced probe runs with ALL member traces active, so the
            # reader/store spans below attribute one shared decode to
            # every request it served.
            traces = [r.trace for r in batch if r.trace is not None]
            for r in batch:
                if r.trace is not None:
                    r.trace.add_span(
                        "queue_wait", r.enq - r.trace._t0, t0 - r.enq,
                        batch=len(batch),
                    )
            try:
                # Everything that can fail lives inside this try: an escape
                # would kill the worker and leave every parked submitter
                # (and all future ones) blocked on events nobody will set.
                faults.fire("serve.flush", batch=len(batch))
                states = np.concatenate([r.states for r in batch])
                # In-flight dedup: a hot (zipf) workload coalesces many
                # requests for the SAME position into one window — probe
                # each distinct state once and fan the answer back out.
                uniq, inverse = np.unique(states, return_inverse=True)
                dup_hits = int(states.shape[0] - uniq.shape[0])
                with _activate_traces(traces):
                    values, rem, found, best = self.reader.lookup_best(
                        uniq
                    )
                values = values[inverse]
                rem = rem[inverse]
                found = found[inverse]
                best = best[inverse]
            except Exception as e:  # noqa: BLE001 - must unblock submitters
                for r in batch:
                    r.error = e
                    r.event.set()
                self._note_reader_fault()
                continue
            self._note_reader_ok()
            secs = time.perf_counter() - t0
            sentinel = int(self.reader.game.sentinel)
            with self._lock:
                self.counters["batches"] += 1
                self.counters["batched_queries"] += int(states.shape[0])
                self.counters["max_batch_size"] = max(
                    self.counters["max_batch_size"], int(states.shape[0])
                )
                self.counters["batch_secs_total"] += secs
                self.counters["dup_hits"] += dup_hits
            if dup_hits:
                self._m_dup_hits.inc(dup_hits)
            self._m_batch_size.observe(int(states.shape[0]))
            self._m_batch_secs.observe(secs)
            if self.logger is not None:
                record = {
                    "phase": "serve_batch",
                    "batch_size": int(states.shape[0]),
                    "requests": len(batch),
                    "dup_hits": dup_hits,
                    "secs": secs,
                }
                # getattr: chaos/unit tests drive the batcher with stub
                # readers that expose only lookup_best.
                stats_fn = getattr(self.reader, "cache_stats", None)
                db_cache = stats_fn() if stats_fn is not None else None
                if db_cache is not None:
                    # Compressed-DB route: cumulative hot-block cache
                    # counters ride every flush record, so the
                    # per-worker JSONL stream carries the hit-rate
                    # trajectory (tools/obs_report.py folds the final
                    # figures into its serve lines). The db name keeps
                    # routes separable in a multi-DB worker's one
                    # stream — without it the report could only keep
                    # the busiest route's counters.
                    record["db_cache_hits"] = db_cache["hits"]
                    record["db_cache_misses"] = db_cache["misses"]
                    # Resident decoded bytes in the backing store tier
                    # (shared across readers — the same figure
                    # every route reports, by design): lets obs_report
                    # square per-route hit rates against one budget.
                    if "bytes" in db_cache:
                        record["db_cache_bytes"] = db_cache["bytes"]
                    db_dir = getattr(self.reader, "dir", None)
                    if db_dir is not None:
                        record["db"] = db_dir.name
                self.logger.log(record)
            off = 0
            for r in batch:
                n = r.states.shape[0]
                r.out = [
                    (
                        int(values[off + j]),
                        int(rem[off + j]),
                        bool(found[off + j]),
                        None
                        if int(best[off + j]) == sentinel
                        else int(best[off + j]),
                    )
                    for j in range(n)
                ]
                off += n
                r.event.set()
