"""DbReader: mmap-backed vectorized lookup into a solved-position DB
(port of gamesmanmpi_tpu/db/reader.py).

The read side of db/format.py: open the manifest, reconstruct the game
from its registry spec, memory-map each level's (keys, cells) pair
lazily, and answer batches of raw positions with (value, remoteness).
Queries are canonicalized through the game's symmetry before probing —
exactly the contract of SolveResult.lookup — so a sym=1 database answers
for every member of a stored class. The per-level search is
db/format.probe_sorted_np: on host, against a memory-mapped level, a
binary search touches O(log n) pages, which is what makes a multi-GB
level servable from disk without loading it.

Canonicalize, level_of and the best-move expansion run as plain torch on
the reader's device (``device=``, the card by default; the reference
pins them to its host CPU backend to dodge accelerator compiles, which
eager torch does not have). Batches run at their exact sizes. States
cross the boundary once each way: queries in the game's reference dtype
go up as the int64 carrier, canonical states come back in the reference
dtype for the probe (core/bitops.to_reference).

``device=None`` opens a reader with no device at all: it validates the
DB and holds its manifest, and refuses to answer. The serving
supervisor opens its parent-side readers so, which keeps the parent
from touching the CUDA driver before it forks its workers; each worker
opens its own reader on its device after the fork.

Serving rides the reader as in the reference: the DB ``epoch`` (the
manifest's sha256), the probe/page-touch/cache/decode series on the
registry it is given, query spans (obs/qtrace.qspan), the cross-worker
shared-memory tier (``shm=``, store/shm.py) under the block store, and
the private per-reader store that ``GAMESMAN_DB_CACHE_MB`` carves.

A GameSpec database (``game_spec`` in the manifest) rebuilds its game
from the embedded canonical spec (gamedsl), as the reference's does.
"""

from __future__ import annotations

import math
import pathlib
import time

import numpy as np
import torch

from gamesmanmpi_tpu_torch.compress import BlockCorruptError
from gamesmanmpi_tpu_torch.core.bitops import SENTINEL, to_reference
from gamesmanmpi_tpu_torch.core.codec import unpack_cells_np
from gamesmanmpi_tpu_torch.core.values import LOSE, TIE, UNDECIDED, WIN
from gamesmanmpi_tpu_torch.db.format import (
    MANIFEST_NAME,
    DbFormatError,
    file_sha256,
    level_is_blocked,
    probe_sorted_np,
    read_manifest,
)
from gamesmanmpi_tpu_torch.obs import default_registry
from gamesmanmpi_tpu_torch.obs.qtrace import qspan
from gamesmanmpi_tpu_torch.resilience import faults
from gamesmanmpi_tpu_torch.solve.engine import undecided_mask
from gamesmanmpi_tpu_torch.store import (
    BlockStore,
    SealedBlockStream,
    TieredCache,
    default_store,
    open_npy_mmap,
)
from gamesmanmpi_tpu_torch.utils.device import resolve_device
from gamesmanmpi_tpu_torch.utils.env import env_bool, env_int, env_opt


class DbReader:
    """Read-only handle on a finalized solved-position database."""

    def __init__(self, directory, game=None, *, verify: bool = False,
                 device="cuda", registry=None, shm=None):
        self.dir = pathlib.Path(directory)
        self.device = None if device is None else resolve_device(device)
        self.manifest = read_manifest(self.dir)
        #: DB epoch — the manifest sha. The invalidation token of every
        #: fast path layered over this reader: shared-memory block slots
        #: are stamped with it, the server's ETag embeds it, and the
        #: opening book implicitly carries it (building a book rewrites
        #: the manifest). A reload that changes the DB changes the
        #: epoch, and everything stale becomes a miss.
        self.epoch = file_sha256(self.dir / MANIFEST_NAME)
        reg = registry or default_registry()
        self._m_probe_secs = reg.histogram(
            "gamesman_db_probe_seconds",
            "wall seconds per batched level probe (searchsorted + "
            "cell gather)",
        )
        self._m_probe_queries = reg.counter(
            "gamesman_db_probe_queries_total", "positions probed"
        )
        self._m_page_touches = reg.counter(
            "gamesman_db_mmap_page_touches_total",
            "estimated mmap pages touched: ceil(log2(level keys)) per "
            "binary-search query plus one cells page per hit — the "
            "working-set denominator that says whether a level is being "
            "served from page cache or disk",
        )
        if game is None and self.manifest.get("game_spec") is not None:
            # gamedsl DB: the manifest embeds the canonical spec document,
            # so the game reconstructs even when the original .json file
            # moved or changed — the DB answers for the rules it was
            # solved under, never for whatever the path now holds.
            from gamesmanmpi_tpu_torch.gamedsl import GameSpec, SpecError
            from gamesmanmpi_tpu_torch.gamedsl.compiler import compile_spec

            try:
                game = compile_spec(
                    GameSpec.from_dict(self.manifest["game_spec"])
                )
            except SpecError as e:
                raise DbFormatError(
                    f"{self.dir}: embedded game_spec is not "
                    f"compilable: {e}"
                ) from e
        if game is None:
            from gamesmanmpi_tpu_torch.games import get_game

            try:
                game = get_game(self.manifest["spec"])
            except (KeyError, ValueError) as e:
                raise DbFormatError(
                    f"{self.dir}: manifest spec "
                    f"{self.manifest['spec']!r} is not constructible: {e}"
                ) from e
        if game.name != self.manifest["game"]:
            raise DbFormatError(
                f"{self.dir} belongs to game {self.manifest['game']!r}, "
                f"not {game.name!r}"
            )
        if np.dtype(game.state_dtype).name != self.manifest["state_dtype"]:
            raise DbFormatError(
                f"{self.dir}: state dtype {self.manifest['state_dtype']} "
                f"!= game's {np.dtype(game.state_dtype).name}"
            )
        self.game = game
        self._levels = {
            int(k): rec for k, rec in self.manifest["levels"].items()
        }
        self._arrays: dict = {}
        self._blocked: dict = {}
        self._shm = shm  # cross-worker decoded-block tier (store/shm.py)
        self._store = None
        self._private_store = False
        self._m_decode_secs = None
        self._m_cache_hits = self._m_cache_misses = None
        self._hits = 0  # guarded-by: _stats_lock
        self._misses = 0  # guarded-by: _stats_lock
        self._stats_lock = None
        if any(level_is_blocked(rec) for rec in self._levels.values()):
            import threading

            # Decompress-on-probe (format v2): decoded blocks live in the
            # shared block-store cache (one byte budget per process).
            # GAMESMAN_DB_CACHE_MB, when set explicitly, carves a private
            # store for this reader, labeled so two private caches on one
            # registry keep separable series.
            if env_opt("GAMESMAN_DB_CACHE_MB"):
                self._store = BlockStore(
                    cache=TieredCache(
                        max(1, env_int("GAMESMAN_DB_CACHE_MB", 64)) << 20,
                        registry=reg, labels={"db": self.dir.name},
                    ),
                    prefetch_threads=0, writebehind=False, registry=reg,
                    labels={"db": self.dir.name},
                )
                self._private_store = True
            else:
                self._store = default_store()
            self._stats_lock = threading.Lock()
            # Per-reader hit/miss series: the db label separates routes
            # within one worker, the worker label separates workers
            # (docs/OBSERVABILITY.md).
            self._m_cache_hits = reg.counter(
                "gamesman_db_cache_hits_total",
                "probes answered from an already-decoded hot block",
                db=self.dir.name,
            )
            self._m_cache_misses = reg.counter(
                "gamesman_db_cache_misses_total",
                "probes that had to decode a cold block",
                db=self.dir.name,
            )
            self._m_decode_secs = reg.histogram(
                "gamesman_db_block_decode_seconds",
                "wall seconds decoding one cold (keys, cells) block pair "
                "on the probe path (cache misses only)",
                db=self.dir.name,
            )
        # The resident opening book (db/book.py) rides the reader, so
        # every consumer gets the short path when the manifest seals one.
        # Loading re-hashes the seal; a corrupt book refuses the reader
        # (never a wrong fast answer). GAMESMAN_SERVE_BOOK=0 opts out.
        self.book = None
        if self.manifest.get("book") and env_bool("GAMESMAN_SERVE_BOOK",
                                                  True):
            from gamesmanmpi_tpu_torch.db.book import OpeningBook

            self.book = OpeningBook.load(self.dir, self.manifest)
        if verify:
            from gamesmanmpi_tpu_torch.db.check import check_db

            problems = check_db(self.dir)
            if problems:
                raise DbFormatError(
                    f"{self.dir}: integrity check failed: {problems[0]}"
                    + (f" (+{len(problems) - 1} more)"
                       if len(problems) > 1 else "")
                )

    # ------------------------------------------------------------- plumbing

    @property
    def num_positions(self) -> int:
        return int(self.manifest.get(
            "num_positions",
            sum(rec["count"] for rec in self._levels.values()),
        ))

    @property
    def levels(self) -> list[int]:
        return sorted(self._levels)

    def _level_arrays(self, level: int):
        """(keys, cells) of one level, memory-mapped on first touch
        (store/sealed.open_npy_mmap — the v1 door)."""
        pair = self._arrays.get(level)
        if pair is None:
            rec = self._levels[level]
            keys = open_npy_mmap(self.dir / rec["keys"])
            cells = open_npy_mmap(self.dir / rec["cells"])
            pair = self._arrays[level] = (keys, cells)
        return pair

    def _blocked_level(self, level: int) -> SealedBlockStream:
        """The v2 probe handle of one level, opened on first touch.
        Lock-free under concurrent probes: a race opens two handles and
        the setdefault loser closes its fds."""
        bl = self._blocked.get(level)
        if bl is None:
            try:
                fresh = SealedBlockStream(
                    self.dir, level, self._levels[level]
                )
            except (BlockCorruptError, OSError) as e:
                raise DbFormatError(
                    f"{self.dir}: level {level} block stream unreadable: "
                    f"{e}"
                ) from e
            bl = self._blocked.setdefault(level, fresh)
            if bl is not fresh:
                fresh.close()
        return bl

    def cache_stats(self):
        """Hot-block cache counters (dict), or None for a v1 DB (the
        serving batcher rides these on its serve_batch records). hits and
        misses are THIS reader's probes; bytes/blocks/evictions are the
        backing store cache's (shared across readers unless
        GAMESMAN_DB_CACHE_MB carved a private one)."""
        if self._store is None:
            return None
        backing = self._store.cache.stats()
        with self._stats_lock:
            hits, misses = self._hits, self._misses
        return {
            "hits": hits,
            "misses": misses,
            "evictions": backing["evictions"],
            "bytes": backing["bytes"],
            "blocks": backing["blocks"],
        }

    def close(self) -> None:
        """Drop the mmaps, close block-stream fds. A private store's cache
        is cleared; the shared store keeps its decoded blocks — they are
        keyed by stream inode, so they can never leak into another DB."""
        self._arrays.clear()
        for bl in self._blocked.values():
            bl.close()
        self._blocked.clear()
        if self._private_store and self._store is not None:
            self._store.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _states(self, queries) -> np.ndarray:
        return np.ascontiguousarray(
            np.asarray(queries, dtype=self.game.state_dtype)
        )

    def _on_device(self, states: np.ndarray) -> torch.Tensor:
        """int64 carrier of `states` on the reader's device."""
        if self.device is None:
            raise ValueError(f"{self.dir}: this reader was opened without "
                             "a device (device=None) and cannot answer")
        return torch.from_numpy(states.astype(np.int64)).to(self.device)

    def _canon_levels(self, q: np.ndarray):
        """Batched canonicalize + level_of on the reader's device:
        [K] reference-dtype states -> (canon [K] in the reference dtype,
        levels [K] int32). A 64-bit query with the top bit set is outside
        every game's 63-bit state space and does not fit the carrier: it
        canonicalizes as 0 and its lane becomes the sentinel, which is
        never probed."""
        ok = (q < np.uint64(SENTINEL) if q.dtype == np.uint64
              else np.ones(q.shape, dtype=bool))
        with qspan("canonicalize", queries=int(q.shape[0])):
            states = self._on_device(np.where(ok, q, 0))
            canon = self.game.canonicalize(states)
            levels = self.game.level_of(canon).cpu().numpy()
            canon = to_reference(canon, self.game)
        canon[~ok] = self.game.sentinel
        return canon, levels

    def _expand(self, q: np.ndarray):
        """Children of raw states on the reader's device -> (raw [K, M],
        canon [K, M], mask [K, M], child levels [K*M]), numpy. The raw
        children are the legal moves of the position the client holds (a
        sym=1 best move must be playable from it, not from its class
        representative); the canonical twins are what gets probed —
        value and remoteness are sym-invariant. Terminal positions have
        no children; unused lanes hold the sentinel and level 0. `q`
        must hold real states only (the callers pass found positions)."""
        g = self.game
        states = self._on_device(q)
        children, mask = g.expand(states)
        mask = mask & undecided_mask(g, states).unsqueeze(-1)
        sent = torch.tensor(SENTINEL, dtype=torch.int64, device=self.device)
        raw = torch.where(mask, children, sent)
        canon = torch.where(mask, g.canonicalize(children), sent)
        # level_of sees real states only: unused lanes ask for the
        # parent's own level and are masked out of every probe.
        filler = states.unsqueeze(-1).expand_as(canon)
        levels = g.level_of(torch.where(mask, canon, filler).reshape(-1))
        return (to_reference(raw, g), to_reference(canon, g),
                mask.cpu().numpy(), levels.cpu().numpy())

    # -------------------------------------------------------------- queries

    def lookup(self, queries) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched probe: raw positions -> (values, remoteness, found).

        queries: array-like of packed positions (any symmetry-class
        member), in or convertible to the game's reference dtype.
        Returns (values [K] uint8 — UNDECIDED on miss, remoteness [K]
        int32 — 0 on miss, found [K] bool). One searchsorted per
        distinct level present in the batch.
        """
        q = self._states(queries)
        if q.shape[0] == 0:
            return (
                np.zeros(0, dtype=np.uint8),
                np.zeros(0, dtype=np.int32),
                np.zeros(0, dtype=bool),
            )
        return self._probe(*self._canon_levels(q))

    def _probe(self, canon: np.ndarray, levels: np.ndarray):
        """Probe ALREADY-CANONICAL states with known levels (the second
        half of lookup; split out so lookup_best canonicalizes a batch
        once and reuses it for both the probe and the expansion)."""
        k = canon.shape[0]
        faults.fire("db.probe", queries=k)
        t0 = time.perf_counter()
        values = np.full(k, UNDECIDED, dtype=np.uint8)
        remoteness = np.zeros(k, dtype=np.int32)
        found = np.zeros(k, dtype=bool)
        real = canon != self.game.sentinel
        pages = 0
        for lv in np.unique(levels[real]):
            rec = self._levels.get(int(lv))
            if rec is None:
                continue
            sel = np.nonzero(real & (levels == lv))[0]
            if level_is_blocked(rec):
                self._probe_blocked_level(
                    int(lv), canon, sel, values, remoteness, found
                )
                continue
            keys, cells = self._level_arrays(int(lv))
            with qspan("searchsorted", level=int(lv),
                       queries=int(sel.size)):
                idx, hit = probe_sorted_np(keys, canon[sel])
            hsel = sel[hit]
            if hsel.size:
                v, r = unpack_cells_np(np.asarray(cells[idx[hit]]))
                values[hsel] = v
                remoteness[hsel] = r
                found[hsel] = True
            # Page-touch model, not a kernel counter: each binary search
            # descends ~log2(n) key pages (upper levels share pages and
            # stay cached, so this is a ceiling), each hit reads one
            # cells page.
            pages += sel.size * max(
                1, math.ceil(math.log2(max(int(keys.shape[0]), 2)))
            ) + int(hsel.size)
        self._m_probe_queries.inc(k)
        self._m_page_touches.inc(pages)
        self._m_probe_secs.observe(time.perf_counter() - t0)
        return values, remoteness, found

    def _probe_blocked_level(self, lv: int, canon, sel, values,
                             remoteness, found) -> None:
        """Decompress-on-probe for one v2 level: route each query to its
        block by first_keys, decode only the touched blocks (hot-block
        cache first), then the same searchsorted-confirm as v1 inside the
        decoded block. Corruption discovered mid-probe (torn block, crc
        mismatch) raises DbFormatError, never a wrong answer."""
        bl = self._blocked_level(lv)
        if bl.num_blocks == 0 or sel.size == 0:
            return
        q = canon[sel]
        # side="right" - 1: the block whose first key is <= q. Queries
        # below the level's first key clip to block 0, where the
        # equality confirm rejects them.
        with qspan("searchsorted", level=int(lv), queries=int(sel.size)):
            bids = np.searchsorted(
                bl.first_keys, q.astype(np.uint64, copy=False),
                side="right",
            ) - 1
            np.clip(bids, 0, bl.num_blocks - 1, out=bids)
        for b in np.unique(bids):
            # Shared-store read keyed by the stream's inode identity
            # (SealedBlockStream.ident): every reader of one DB shares one
            # decoded copy, and an overwrite-swapped DB can never serve
            # the old directory's blocks.
            def _decode(bl=bl, b=int(b), lv=lv):
                t0 = time.perf_counter()
                try:
                    with qspan("block_decode", level=int(lv),
                               block=int(b)):
                        # The fault fires inside the span: an injected
                        # delay here is the slow-decode shape, and the
                        # trace must attribute it to decode.
                        faults.fire("serve.block_decode",
                                    level=int(lv), block=int(b))
                        pair = bl.read_block(b)
                except (BlockCorruptError, OSError) as e:
                    raise DbFormatError(
                        f"{self.dir}: level {lv} block {b} "
                        f"unreadable: {e}"
                    ) from e
                self._m_decode_secs.observe(time.perf_counter() - t0)
                return pair

            loader = _decode
            if self._shm is not None:
                # The cross-worker tier sits under the private store:
                # private miss -> shm probe (a sibling worker's decode,
                # one memcpy) -> real read+decode, which is then
                # published for the rest of the fleet. Epoch-stamped: a
                # reloaded DB's slots read as misses, never as wrong
                # blocks (store/shm.py).
                def loader(bl=bl, b=int(b), decode=_decode):
                    key = (bl.ident[0], bl.ident[1], int(b))
                    pair = self._shm.get(key, self.epoch)
                    if pair is None:
                        pair = decode()
                        self._shm.put(key, self.epoch, pair[0], pair[1])
                    return pair

            pair, hit = self._store.read_ex((bl.ident, int(b)), loader)
            with self._stats_lock:
                if hit:
                    self._hits += 1
                else:
                    self._misses += 1
            (self._m_cache_hits if hit else self._m_cache_misses).inc()
            bkeys, bcells = pair
            bsel = sel[bids == b]
            idx, hit = probe_sorted_np(
                bkeys, canon[bsel].astype(bkeys.dtype, copy=False)
            )
            hsel = bsel[hit]
            if hsel.size:
                v, r = unpack_cells_np(bcells[idx[hit]])
                values[hsel] = v
                remoteness[hsel] = r
                found[hsel] = True

    def lookup_best(self, queries):
        """lookup + the optimal child of each decided, non-terminal query.

        Returns (values, remoteness, found, best [K] state_dtype) where
        best is a packed child of the QUERIED position — a legal move the
        client can actually play, even against a sym=1 database —
        realizing the parent's value (WIN -> a LOSE child of minimum
        remoteness; LOSE -> a WIN child of maximum remoteness, delaying;
        TIE -> a TIE child of maximum remoteness), or the reference's
        sentinel when there is no move (terminal positions, misses).
        Children are scored through their canonical twins in the same
        probe path.
        """
        q = self._states(queries)
        k = q.shape[0]
        best = np.full(k, self.game.sentinel, dtype=self.game.state_dtype)
        if k == 0:
            return (
                np.zeros(0, dtype=np.uint8),
                np.zeros(0, dtype=np.int32),
                np.zeros(0, dtype=bool),
                best,
            )
        values, remoteness, found = self._probe(*self._canon_levels(q))
        rows_found = np.nonzero(found)[0]
        if rows_found.size == 0:
            return values, remoteness, found, best
        # Only found rows are expanded: a found query is a real state
        # (a member of a stored class), and best is defined for it alone.
        raw, canon, mask, clevels = self._expand(q[rows_found])
        n, m = raw.shape
        cv, cr, cfound = self._probe(canon.reshape(-1), clevels)
        cv = cv.reshape(n, m)
        cr = cr.reshape(n, m)
        cand_ok = mask & cfound.reshape(n, m)
        fvalues = values[rows_found]
        fbest = best[rows_found]
        big = np.int64(1) << 40  # past any packable remoteness
        for want, prefer_min in ((WIN, True), (LOSE, False), (TIE, False)):
            rows = (fvalues == want) & cand_ok.any(axis=1)
            if not rows.any():
                continue
            # WIN wants a LOSE child; LOSE has only WIN children; TIE wants
            # a TIE child (combine_host, solve/oracle.py).
            child_want = {WIN: LOSE, LOSE: WIN, TIE: TIE}[want]
            cand = cand_ok & (cv == child_want)
            rows &= cand.any(axis=1)
            if not rows.any():
                continue
            score = np.where(
                cand, cr.astype(np.int64), big if prefer_min else -big
            )
            pick = (
                score.argmin(axis=1) if prefer_min else score.argmax(axis=1)
            )
            fbest[rows] = raw[np.arange(n), pick][rows]
        best[rows_found] = fbest
        return values, remoteness, found, best
