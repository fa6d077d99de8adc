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

Not ported (ROADMAP): the metrics-registry series and query spans, the
cross-worker shared-memory tier and the DB epoch (serving), the private
per-reader cache (``GAMESMAN_DB_CACHE_MB``), and GameSpec databases
(``game_spec`` in the manifest: the game compiler is not ported).
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from gamesmanmpi_tpu_torch.compress import BlockCorruptError
from gamesmanmpi_tpu_torch.core.bitops import SENTINEL, to_reference
from gamesmanmpi_tpu_torch.core.codec import unpack_cells_np
from gamesmanmpi_tpu_torch.core.values import LOSE, TIE, UNDECIDED, WIN
from gamesmanmpi_tpu_torch.db.format import (
    DbFormatError,
    level_is_blocked,
    probe_sorted_np,
    read_manifest,
)
from gamesmanmpi_tpu_torch.resilience import faults
from gamesmanmpi_tpu_torch.solve.engine import undecided_mask
from gamesmanmpi_tpu_torch.store import (
    SealedBlockStream,
    default_store,
    open_npy_mmap,
)
from gamesmanmpi_tpu_torch.utils.device import resolve_device
from gamesmanmpi_tpu_torch.utils.env import env_bool


class DbReader:
    """Read-only handle on a finalized solved-position database."""

    def __init__(self, directory, game=None, *, verify: bool = False,
                 device="cuda"):
        self.dir = pathlib.Path(directory)
        self.device = resolve_device(device)
        self.manifest = read_manifest(self.dir)
        if game is None and self.manifest.get("game_spec") is not None:
            raise DbFormatError(
                f"{self.dir}: a GameSpec database (manifest game_spec) — "
                "the game compiler is not yet ported to the torch port"
            )
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
        self._store = None
        self._hits = 0  # guarded-by: _stats_lock
        self._misses = 0  # guarded-by: _stats_lock
        self._stats_lock = None
        if any(level_is_blocked(rec) for rec in self._levels.values()):
            import threading

            # Decompress-on-probe (format v2): decoded blocks live in the
            # shared block-store cache (one byte budget per process).
            self._store = default_store()
            self._stats_lock = threading.Lock()
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
        """Hot-block cache counters (dict), or None for a v1 DB. hits and
        misses are THIS reader's probes; bytes/blocks/evictions are the
        shared store cache's."""
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
        """Drop the mmaps, close block-stream fds. The shared store keeps
        its decoded blocks — they are keyed by stream inode, so they can
        never leak into another DB."""
        self._arrays.clear()
        for bl in self._blocked.values():
            bl.close()
        self._blocked.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _states(self, queries) -> np.ndarray:
        return np.ascontiguousarray(
            np.asarray(queries, dtype=self.game.state_dtype)
        )

    def _canon_levels(self, q: np.ndarray):
        """Batched canonicalize + level_of on the reader's device:
        [K] reference-dtype states -> (canon [K] in the reference dtype,
        levels [K] int32). A 64-bit query with the top bit set is outside
        every game's 63-bit state space and does not fit the carrier: it
        canonicalizes as 0 and its lane becomes the sentinel, which is
        never probed."""
        ok = (q < np.uint64(SENTINEL) if q.dtype == np.uint64
              else np.ones(q.shape, dtype=bool))
        states = torch.from_numpy(np.where(ok, q, 0).astype(np.int64))
        canon = self.game.canonicalize(states.to(self.device))
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
        states = torch.from_numpy(q.astype(np.int64)).to(self.device)
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
        values = np.full(k, UNDECIDED, dtype=np.uint8)
        remoteness = np.zeros(k, dtype=np.int32)
        found = np.zeros(k, dtype=bool)
        real = canon != self.game.sentinel
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
            idx, hit = probe_sorted_np(keys, canon[sel])
            hsel = sel[hit]
            if hsel.size:
                v, r = unpack_cells_np(np.asarray(cells[idx[hit]]))
                values[hsel] = v
                remoteness[hsel] = r
                found[hsel] = True
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
        bids = np.searchsorted(
            bl.first_keys, q.astype(np.uint64, copy=False), side="right",
        ) - 1
        np.clip(bids, 0, bl.num_blocks - 1, out=bids)
        for b in np.unique(bids):
            # Shared-store read keyed by the stream's inode identity
            # (SealedBlockStream.ident): every reader of one DB shares one
            # decoded copy, and an overwrite-swapped DB can never serve
            # the old directory's blocks.
            def _decode(bl=bl, b=int(b), lv=lv):
                try:
                    faults.fire("serve.block_decode", level=int(lv),
                                block=int(b))
                    return bl.read_block(b)
                except (BlockCorruptError, OSError) as e:
                    raise DbFormatError(
                        f"{self.dir}: level {lv} block {b} "
                        f"unreadable: {e}"
                    ) from e

            pair, hit = self._store.read_ex((bl.ident, int(b)), _decode)
            with self._stats_lock:
                if hit:
                    self._hits += 1
                else:
                    self._misses += 1
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
