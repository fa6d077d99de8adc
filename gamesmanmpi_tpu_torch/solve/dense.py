"""Dense class-partitioned retrograde engine for the Connect-4 family
(port of gamesmanmpi_tpu/solve/dense.py), on one device or a mesh.

Positions are indexed perfectly instead of discovered:

- A **class** is a column-height profile (h_0..h_{w-1}); at level L every
  class holds the C(L, n1) ways to place player 1's n1 = ceil(L/2) stones
  on the L filled cells, so a level is one [P, C(L, n1)] array of packed
  uint8 cells (2-bit value | 6-bit remoteness << 2).
- Within a class a position's index is the colex **combinadic rank** of
  its player-1 cell set; rank/unrank are short loops over the board's
  cells.
- The solve is one backward sweep over levels. Per level: unrank ->
  win folds -> per-move child rank -> gather of the child's packed cell
  -> negamax combine (ops/combine.py's rules), one kernel launch per
  level on the card (per shard on a mesh), one plain step per rank
  block elsewhere.
- Reachable positions (Tromp's counts) come from a separate forward
  **reachability sweep** with "unmove" tables, cached per board per
  process and across processes in the counts file (below).

Each level step is one hand-written CUDA kernel on the card
(ops/dense_level.py, kernels/csrc/dense_level.cu), one thread per lane,
launched once per level over all its rank blocks and writing straight
into the level's [P, C] array: ``dense_step`` unranks and ranks every
child in one descending walk over the level's class indices, folds,
gathers each child's packed cell and combines, in the reference's
narrowed words (uint32 at 5x5; 64-bit where a board needs them);
``reach_step`` ranks every parent in the same walk, does the reach
sweep's OR over columns and counts. Each level's kernel constants go up
as one packed array from pinned memory. On the CPU each step is its
plain version, rank block by rank block: eager int64 torch ops, the
reference's fori_loop walks written out. With
``gather_mode="window"`` (the default) invalid rows and pad lanes get a
monotone fill so each move's flat child index vector is non-decreasing,
and the backward step counts the window gather's misses over exactly the
partition of ops/window_gather.monotone_window_gather (the standalone
kernel of that gather stays the port's counterpart of the reference's
Pallas kernel). ``sorted`` takes the same fill into a clamped torch index
and ``plain`` the clamped unfilled index: both run the plain step on any
device, explicitly chosen, and count no misses; the three give identical
cells. ``GAMESMAN_DENSE_GATHER`` picks the mode when the caller does not:
unset or ``pallas`` is window, ``plain`` and ``sorted`` themselves.

The plain steps hold bitboards, ranks and flat indices in int64 and
cells in uint8 (core/bitops.py); the kernels the reference's words. The
reference's one-walk child ranking ``_rank_all_moves_fused`` is the
kernels' walk, taken downward (so every partial sum is part of the final
rank); its TPU-only machinery is not carried over: the one-hot binomial
select tree (both routes index the binomial table directly), the relay
run-ahead drain, background compiles.

**The counts file** (``GAMESMAN_DENSE_COUNTS_FILE``; default
``.dense_counts.json`` at the repository root, ``0`` turns it off), the
reference's format, so either package reads the other's: one JSON object
keyed by board (``WxHxC``), each entry stamped with the schema version
and the board and checked for the sweep's invariants before it is
trusted (a stale or hand-edited entry means one sweep again). A process
that sweeps merges its counts in under ``<file>.lock``. The sweep then
costs a board once across processes; ``stats["reach_counts_source"]``
says where a solve's counts came from: ``sweep``, ``file`` or
``process`` (the in-process cache).

**The mesh** (``devices=N``, parallel/mesh.Mesh in one process): every
level step's [P, cblock] lanes are split over the N shards, each shard
computing its slice on its device, and each level's cells are copied to
every shard's device for the next level's gathers (the reference's
``_replicate``). A slice is a whole number of the window gather's miss
blocks (2,048 lanes, one CTA of the step kernel), cut from the
one-device layout: every block stays inside one profile row and sees
exactly the lanes it sees at ``devices=1``, so the cells and the summed
``nmiss`` equal the one-device run's. (The reference instead rounds
cblock up to ``lcm(devices, PALLAS_BLOCK)`` and lets SPMD partition it;
its Pallas gather falls back to the plain one there, unproven under
auto-SPMD. Here each shard launches the kernel itself, once per level
over its slices of every rank block, into the level's array on its
device, so there is nothing to fall back from.)
Single-controller, as in the reference: the mesh spans one process.

Checkpoint/resume (``checkpointer=``), as in the reference: the directory
is bound to ``<game>:dense``, each level's flat cells are sealed as they
complete (``dense_NNNN.npz``), and a rerun rechains from the contiguous
sealed run that ends at the top level, through the same path as
``solve(resume_cells=...)``.

Records (``logger=``), the reference's: one ``dense_backward`` record per
level (``classes``, ``class_size``), ``dense_backward_resume`` when a
directory is resumed, and ``done``. Beside them each level runs under a
``backward`` span that writes no record (the registry's
``gamesman_span_seconds`` and the Chrome trace sink) and ends at the
level's host copy when one is taken, and each seal under a
``checkpoint`` span. A traced solve (``solve``) adds the spans that
tile it and its count of blocking device reads in ``stats["trace"]``.
``progress`` is replaced per level for the heartbeat (``heartbeat_secs``
/ ``GAMESMAN_HEARTBEAT_SECS``), the watchdog (``GAMESMAN_WATCHDOG_SECS``)
and the ``/status`` server (``GAMESMAN_STATUS_PORT``), whose level
schedule counts encodable cells.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from gamesmanmpi_tpu_torch import kernels
from gamesmanmpi_tpu_torch.games.connect4 import Connect4
from gamesmanmpi_tpu_torch.obs import (
    SolveStatusTracker,
    Span,
    flightrec,
    trace_span,
)
from gamesmanmpi_tpu_torch.obs.tracing import SpanTree, tracing_on
from gamesmanmpi_tpu_torch.ops import dense_level
from gamesmanmpi_tpu_torch.ops.dense_level import (  # noqa: F401 (re-export)
    _connected_fold,
    _rank_bits,
    _unrank_bits,
)
from gamesmanmpi_tpu_torch.solve.engine import record_solve, watched
from gamesmanmpi_tpu_torch.utils.device import resolve_device
from gamesmanmpi_tpu_torch.utils.env import env_float, env_opt


def _profiles_for_level(width: int, height: int, level: int) -> np.ndarray:
    """All column-height profiles summing to `level`, lexicographic.

    Returns [P, width] int8. Lexicographic order is the class-row order
    everywhere (tables, move maps).
    """
    out = []

    def rec(prefix, remaining, cols_left):
        if cols_left == 0:
            if remaining == 0:
                out.append(prefix)
            return
        # Feasibility pruning keeps this linear in the output size.
        if remaining > cols_left * height:
            return
        for v in range(min(height, remaining) + 1):
            rec(prefix + [v], remaining - v, cols_left - 1)

    rec([], level, width)
    return np.array(out, dtype=np.int8).reshape(len(out), width)


def n1_of_level(level: int) -> int:
    """Player-1 stones after `level` plies (player 1 moves first)."""
    return (level + 1) // 2


class DenseTables:
    """Host-side class machinery for one board: profiles, cell indexing,
    move maps, binomials. All numpy (the port's own copy of the
    reference's class, field for field)."""

    def __init__(self, width: int, height: int, connect: int = 4):
        self.width, self.height, self.connect = width, height, connect
        self.ncells = width * height
        self.h1 = height + 1
        # Bitboard layout of games/connect4.py: cell (c, r) at bit
        # c*(h+1)+r; the spare bit per column stops cross-column wraps.
        if self.h1 * width > 63:
            raise ValueError("board too large for uint64 bitboards")
        self.bits_dtype = np.uint64 if self.h1 * width > 31 else np.uint32

        # Global cell slots: j = c*height + r, (c asc, r asc).
        self.bitpos = np.array(
            [c * self.h1 + r for c in range(width) for r in range(height)],
            dtype=np.int32,
        )

        # binom[k][i] = C(k, i); k = within-class cell index, i = stone
        # ordinal (0..n1max+1). uint64 covers C(42, 21).
        n1max = n1_of_level(self.ncells)
        self.n1_width = n1max + 2
        self.binom = np.zeros((self.ncells + 1, self.n1_width), np.uint64)
        for k in range(self.ncells + 1):
            for i in range(self.n1_width):
                self.binom[k, i] = math.comb(k, i) if i <= k else 0

        self.profiles: list[np.ndarray] = []
        self.row_of: list[dict] = []
        self.class_size: list[int] = []
        for L in range(self.ncells + 1):
            p = _profiles_for_level(width, height, L)
            self.profiles.append(p)
            self.row_of.append(
                {tuple(int(v) for v in row): i for i, row in enumerate(p)}
            )
            self.class_size.append(math.comb(L, n1_of_level(L)))

        self._level_consts: dict[int, dict] = {}
        self._cellidx: dict[int, np.ndarray] = {}

    # -- per-level constants ------------------------------------------------

    def col_base(self, level: int) -> np.ndarray:
        """[P, w] int32: within-class index of each column's FIRST cell."""
        prof = self.profiles[level].astype(np.int32)
        return np.concatenate(
            [np.zeros((prof.shape[0], 1), np.int32),
             np.cumsum(prof, axis=1)[:, :-1]], axis=1
        )

    def cellidx_rows(self, level: int) -> np.ndarray:
        """[P, ncells] int16: within-class index of global slot j, -1 if the
        cell is above the column height (absent)."""
        if level in self._cellidx:
            return self._cellidx[level]
        prof = self.profiles[level].astype(np.int32)  # [P, w]
        w, h = self.width, self.height
        base = self.col_base(level)
        r = np.tile(np.arange(h, dtype=np.int32), w)  # [ncells]
        c = np.repeat(np.arange(w, dtype=np.int32), h)
        idx = base[:, c] + r[None, :]  # [P, ncells]
        absent = r[None, :] >= prof[:, c]
        out = np.where(absent, np.int16(-1), idx.astype(np.int16))
        self._cellidx[level] = out
        return out

    def level_consts(self, level: int) -> dict:
        """All constant arrays for one level's steps (host numpy)."""
        if level in self._level_consts:
            return self._level_consts[level]
        w, h, h1 = self.width, self.height, self.h1
        prof = self.profiles[level].astype(np.int64)  # [P, w]
        P = prof.shape[0]
        dt = self.bits_dtype

        filled = np.zeros(P, np.uint64)
        # Guard bits of the game's packed encoding (one 1 per column at
        # its height).
        guards = np.zeros(P, np.uint64)
        for c in range(w):
            col = (np.uint64(1) << prof[:, c].astype(np.uint64)) - np.uint64(1)
            filled |= col << np.uint64(c * h1)
            guards |= np.uint64(1) << (prof[:, c] + c * h1).astype(np.uint64)

        newbit = np.zeros((P, w), np.uint64)   # cell (c, h_c): the drop target
        topstone = np.zeros((P, w), np.uint64)  # cell (c, h_c - 1): last drop
        valid = prof < h
        for c in range(w):
            hc = prof[:, c]
            newbit[:, c] = np.where(
                valid[:, c], np.uint64(1) << (hc + c * h1).astype(np.uint64), 0
            )
            topstone[:, c] = np.where(
                hc > 0,
                np.uint64(1) << np.maximum(hc - 1 + c * h1, 0).astype(np.uint64),
                0,
            )

        move_row = np.full((P, w), -1, np.int32)
        if level < self.ncells:
            nxt = self.row_of[level + 1]
            for c in range(w):
                for p in range(P):
                    if valid[p, c]:
                        key = list(prof[p])
                        key[c] += 1
                        move_row[p, c] = nxt[tuple(int(v) for v in key)]
        # move_row[:, c] is strictly increasing over valid rows (adding e_c
        # preserves lexicographic order), so filling invalid rows with the
        # previous valid row's LAST slot keeps the flat child index vector
        # globally non-decreasing — what the window gather streams.
        move_fill = np.maximum.accumulate(
            np.where(valid, move_row, -1), axis=0
        ).astype(np.int32)

        # Unmove: the parent one ply earlier, per column (reach sweep).
        parent_row = np.full((P, w), -1, np.int32)
        if level > 0:
            prv = self.row_of[level - 1]
            for c in range(w):
                for p in range(P):
                    if prof[p, c] > 0:
                        key = list(prof[p])
                        key[c] -= 1
                        parent_row[p, c] = prv[tuple(int(v) for v in key)]

        # Fused-rank snapshot slots (the reference's _rank_all_moves_fused;
        # kept so the constants match the reference field for field).
        base = self.col_base(level).astype(np.int64)
        snapk = np.full((P, self.ncells), -1, np.int32)
        for c in range(w):
            hc = prof[:, c]
            rows = np.arange(P)
            ok = hc < h
            snapk[rows[ok], (c * h + hc[ok]).astype(np.int64)] = (
                base[ok, c] + hc[ok]
            )

        cellidx = self.cellidx_rows(level)
        child_cellidx = np.full((P, w, self.ncells), -1, np.int16)
        if level < self.ncells:
            rows = self.cellidx_rows(level + 1)  # [P', ncells]
            for c in range(w):
                ok = move_row[:, c] >= 0
                child_cellidx[ok, c, :] = rows[move_row[ok, c]]
        parent_cellidx = np.full((P, w, self.ncells), -1, np.int16)
        if level > 0:
            rows = self.cellidx_rows(level - 1)
            for c in range(w):
                ok = parent_row[:, c] >= 0
                parent_cellidx[ok, c, :] = rows[parent_row[ok, c]]

        consts = {
            "filled": filled.astype(dt),
            "guards": guards.astype(dt),
            "newbit": newbit.astype(dt),
            "topstone": topstone.astype(dt),
            "valid": valid,
            "move_row": move_row,
            "move_fill": move_fill,
            "parent_row": parent_row,
            "cellidx": cellidx,
            "child_cellidx": child_cellidx,
            "parent_cellidx": parent_cellidx,
            "snapk": snapk,
        }
        self._level_consts[level] = consts
        return consts

    # -- host (python-int) rank machinery -----------------------------------

    def rank_np(self, level: int, row: int, p1_bits: int) -> int:
        """Combinadic rank of a position's player-1 cell set (host scalar)."""
        cellidx = self.cellidx_rows(level)[row]
        rank, seen = 0, 0
        for j in range(self.ncells):
            k = int(cellidx[j])
            if k < 0:
                continue
            if (p1_bits >> int(self.bitpos[j])) & 1:
                seen += 1
                rank += math.comb(k, seen)
        return rank

    def unrank_np(self, level: int, row: int, rank: int) -> int:
        """Inverse of rank_np: player-1 bitboard (host scalar)."""
        cellidx = self.cellidx_rows(level)[row]
        order = [(int(cellidx[j]), int(self.bitpos[j]))
                 for j in range(self.ncells) if cellidx[j] >= 0]
        order.sort(reverse=True)  # descending within-class index
        bits, i = 0, n1_of_level(level)
        for k, bp in order:
            if i > 0 and math.comb(k, i) <= rank:
                rank -= math.comb(k, i)
                bits |= 1 << bp
                i -= 1
        return bits

    def locate(self, state: int) -> tuple[int, int, int]:
        """Guard-encoded state (games/connect4.py) -> (level, row, rank)."""
        w, h1 = self.width, self.h1
        heights = []
        current = 0
        for c in range(w):
            col = (state >> (c * h1)) & ((1 << h1) - 1)
            hc = col.bit_length() - 1
            if hc < 0:
                raise ValueError(f"column {c} has no guard bit: {state:#x}")
            heights.append(hc)
            current |= (col ^ (1 << hc)) << (c * h1)
        level = sum(heights)
        row = self.row_of[level].get(tuple(heights))
        if row is None:
            raise ValueError(f"impossible height profile {heights}")
        filled = 0
        for c in range(w):
            filled |= ((1 << heights[c]) - 1) << (c * h1)
        # The guard encoding stores the CURRENT player's stones; player 1
        # is the current player at even levels.
        p1 = current if level % 2 == 0 else (filled ^ current)
        return level, row, self.rank_np(level, row, p1)

    def _connected_np(self, stones: int) -> bool:
        """Host twin of the device win fold, on a python-int bitboard."""
        h = self.height
        for d in (1, h, h + 1, h + 2):
            x = stones
            for i in range(1, self.connect):
                x &= stones >> (i * d)
            if x:
                return True
        return False

    def current_player_has_line(self, level: int, row: int,
                                rank: int) -> bool:
        """True for the garbage class: the player to move already won."""
        p1 = self.unrank_np(level, row, rank)
        prof = self.profiles[level][row]
        filled = 0
        for c in range(self.width):
            filled |= ((1 << int(prof[c])) - 1) << (c * self.h1)
        current = p1 if level % 2 == 0 else (filled ^ p1)
        return self._connected_np(current)


# ---------------------------------------------------------------------------
# Level steps (the kernels of ops/dense_level.py, or their plain versions)


# The window gather's block and window, whose miss partition the backward
# step counts against. block=2048 divides every cblock >= 2048 (_cblock
# rounds to a multiple), so no kernel block straddles a profile row;
# window=4*block covers child-rank spans up to a ~4x per-level expansion
# ratio.
WINDOW_BLOCK = dense_level.RUN
WINDOW_ELEMS = dense_level.WINDOW


# ---------------------------------------------------------------------------


class DenseSolveResult:
    """Solve result (CLI compatible): root value/remoteness, cells, stats."""

    def __init__(self, game: Connect4, tables: DenseTables, value: int,
                 remoteness: int, cells: Optional[Dict[int, np.ndarray]],
                 stats: dict):
        self.game = game
        self._tables = tables
        self.value = int(value)
        self.remoteness = int(remoteness)
        self.cells = cells  # level -> [P, C] uint8 numpy, or None
        self.stats = stats

    @property
    def num_positions(self) -> int:
        return self.stats["positions"]

    def lookup(self, state) -> tuple[int, int]:
        """(value, remoteness) of any guard-encoded position.

        Dense tables answer for every valid board configuration (the
        encodable superset). Positions where the player to move already
        completed a line have placeholder cells and raise KeyError.
        """
        if self.cells is None:
            raise KeyError("solved in no-tables mode; re-run with tables")
        level, row, rank = self._tables.locate(int(state))
        if self._tables.current_player_has_line(level, row, rank):
            raise KeyError(
                f"state {int(state):#x} is not a position (the player to "
                "move already has a line); its table cell is a placeholder"
            )
        cell = int(self.cells[level][row, rank])
        return cell & 3, cell >> 2


# Reachable-position counts are a property of the board, not the solve:
# one sweep per board per process, reused by every later solve, and the
# counts file carries them across processes.
_REACH_COUNTS: Dict[tuple, Dict[int, int]] = {}


def _counts_file() -> Optional[str]:
    """The counts file's path (GAMESMAN_DENSE_COUNTS_FILE; "0" = off;
    default .dense_counts.json at the repository root, the reference's
    place, so both packages share it)."""
    path = env_opt("GAMESMAN_DENSE_COUNTS_FILE")
    if path == "0":
        return None
    if path:
        return path
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, ".dense_counts.json")


#: Bumped when what a reachable count means changes; stamped into every
#: entry, so an older engine's file cannot feed a solve's positions.
_COUNTS_SCHEMA_VERSION = 2


def _counts_tag(board_key: tuple) -> str:
    return "x".join(str(k) for k in board_key)


def _load_cached_counts(board_key: tuple) -> Optional[Dict[int, int]]:
    """The board's counts from the counts file, or None when the file is
    off, missing or unreadable, or its entry is unstamped, stale or fails
    the invariants of any sweep (one empty board at level 0, no negative
    count, no level past the cell count)."""
    path = _counts_file()
    if path is None or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            data = json.load(f)
        rec = data.get(_counts_tag(board_key))
        if (not isinstance(rec, dict)
                or rec.get("version") != _COUNTS_SCHEMA_VERSION
                or rec.get("board") != _counts_tag(board_key)
                or not isinstance(rec.get("counts"), dict)):
            return None
        counts = {int(k): int(v) for k, v in rec["counts"].items()}
        w, h = board_key[0], board_key[1]
        if counts.get(0) != 1 or any(v < 0 or k < 0 or k > w * h
                                     for k, v in counts.items()):
            return None
        return counts
    except (OSError, ValueError, AttributeError):
        return None


def _store_cached_counts(board_key: tuple, counts: Dict[int, int]) -> None:
    """Merge the board's counts into the counts file: load, merge and
    replace under an exclusive lock on ``<file>.lock``, through a private
    temporary file, so two processes never drop each other's entry.
    Best effort: an I/O failure leaves the file as it was."""
    path = _counts_file()
    if path is None:
        return
    try:
        import fcntl
    except ImportError:  # pragma: no cover - non-POSIX: lockless
        fcntl = None
    try:
        with contextlib.ExitStack() as stack:
            if fcntl is not None:
                lockf = stack.enter_context(open(f"{path}.lock", "w"))
                fcntl.flock(lockf, fcntl.LOCK_EX)
            data = {}
            if os.path.exists(path):
                try:
                    with open(path) as f:
                        data = json.load(f)
                except ValueError:
                    data = {}  # a torn or edited file: replace it
            if not isinstance(data, dict):
                data = {}
            data[_counts_tag(board_key)] = {
                "version": _COUNTS_SCHEMA_VERSION,
                "board": _counts_tag(board_key),
                "counts": {str(k): v for k, v in counts.items()},
            }
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(data, f)
            os.replace(tmp, path)
    except OSError:
        pass

_TABLES: Dict[tuple, DenseTables] = {}


def kernel_launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """Each kernel's launches since the kernels.LAUNCHES snapshot
    `before`."""
    return {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()}


def gather_mode_from_env() -> str:
    """GAMESMAN_DENSE_GATHER, parsed strictly: unset or ``pallas`` (the
    reference's name for its window kernel) -> "window", ``plain`` ->
    "plain", ``sorted`` -> "sorted"; anything else raises ValueError. The
    port's default stays the window mode (the level kernels on the card),
    where the reference defaults to plain."""
    raw = env_opt("GAMESMAN_DENSE_GATHER")
    if raw is None or raw == "pallas":
        return "window"
    if raw in ("plain", "sorted"):
        return raw
    raise ValueError(f"GAMESMAN_DENSE_GATHER={raw!r}: expected 'pallas', "
                     "'plain' or 'sorted'")


def tables_for(width: int, height: int, connect: int = 4) -> DenseTables:
    """One shared DenseTables per board (its per-level constants memoize)."""
    key = (width, height, connect)
    if key not in _TABLES:
        _TABLES[key] = DenseTables(width, height, connect)
    return _TABLES[key]


def cells_from_reference(cells: Dict[int, np.ndarray],
                         device) -> Dict[int, torch.Tensor]:
    """A reference solve's cells (level -> [P, C] uint8 numpy) as the
    port's tensors on `device`, e.g. to seed DenseSolver.solve's
    resume_cells."""
    dev = torch.device(device)
    # np.array copies: the reference's arrays may be read-only views.
    return {int(L): torch.from_numpy(np.array(a, dtype=np.uint8)).to(dev)
            for L, a in cells.items()}


#: Default lanes per level step ([P, cblock] work arrays). The eager int64
#: temporaries of the unrank and rank walks cost a few hundred bytes per
#: lane, so 16M lanes keep a step's peak at a few GB.
DEFAULT_BLOCK_ELEMS = 16 * 1024 * 1024


class DenseSolver:
    """Dense solver for Connect-4 games (sym=False), one device.

    DenseSolver(game).solve() -> DenseSolveResult with
    .value/.remoteness/.num_positions/.stats/.lookup.

    device: "cuda" (default) or "cpu"; a missing card raises
    DeviceUnavailable. gather_mode: "window" (the level kernels on the
    card), "plain" or "sorted" (the plain steps, explicitly chosen); None
    reads GAMESMAN_DENSE_GATHER. The reach sweep runs the reach kernel on
    the card in every mode. The
    reachability sweep that counts positions runs once per board per
    process. checkpointer: a utils/checkpoint.LevelCheckpointer to seal
    levels into and resume from. devices: shards of the mesh (module
    docstring); more than the visible devices raises ValueError. logger:
    a utils/metrics logger for the per-level records; heartbeat_secs:
    the heartbeat period (0 = off; None reads GAMESMAN_HEARTBEAT_SECS).
    """

    def __init__(self, game: Connect4, store_tables: bool = True,
                 block_elems: Optional[int] = None, device="cuda",
                 gather_mode: Optional[str] = None, checkpointer=None,
                 devices: int = 1, logger=None,
                 heartbeat_secs: Optional[float] = None):
        if not isinstance(game, Connect4):
            raise TypeError("DenseSolver requires a Connect4-family game")
        if game.sym:
            raise ValueError(
                "DenseSolver solves the full space; use sym=False "
                "(symmetry only reduces memory, which dense tables "
                "already cut to 1 byte/position)"
            )
        if gather_mode is None:
            gather_mode = gather_mode_from_env()
        if gather_mode not in ("window", "plain", "sorted"):
            raise ValueError(f"gather_mode must be 'window', 'plain' or "
                             f"'sorted', got {gather_mode!r}")
        self.game = game
        self.store_tables = store_tables
        self.checkpointer = checkpointer
        self.logger = logger
        if heartbeat_secs is None:
            heartbeat_secs = env_float("GAMESMAN_HEARTBEAT_SECS", 0.0)
        self.heartbeat_secs = float(heartbeat_secs)
        #: replaced (never mutated) per level; read by the heartbeat,
        #: watchdog and status threads
        self.progress: dict = {"phase": "init"}
        self.status_tracker = SolveStatusTracker()
        self.device = resolve_device(device)
        self.gather_mode = gather_mode
        self.devices = int(devices)
        if self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        if self.devices > 1:
            from gamesmanmpi_tpu_torch.parallel.mesh import make_mesh

            self._mesh = make_mesh(self.devices, self.device)
            if self._mesh.world > 1:
                raise ValueError(
                    "the meshed dense engine is single-controller: its "
                    "mesh spans one process, not a world")
            self._shard_devices = list(self._mesh.devices)
        else:
            self._mesh = None
            self._shard_devices = [self.device]
        if self.device.type == "cuda":
            torch.cuda.init()  # the allocator, for its peak statistics
        self.tables = tables_for(game.width, game.height, game.connect)
        self.block_elems = int(block_elems or DEFAULT_BLOCK_ELEMS)
        self._consts: dict = {}
        self._binoms: dict = {}
        #: where reachable_counts took the counts from: "sweep", "file"
        #: or "process" (None before it ran)
        self.reach_counts_source: Optional[str] = None
        #: the solve's blocking reads of device values (each level's
        #: download, each per-level miss count, each reach count of a
        #: sweep, the root; the same sites count on the CPU), reset at
        #: each solve's entry
        self.host_syncs = 0
        #: the solve's span tree (None unless traced)
        self._tree: Optional[SpanTree] = None

    @property
    def _board_key(self):
        g = self.game
        return (g.width, g.height, g.connect)

    def _cblock(self, level: int) -> tuple[int, int]:
        """(cblock, nblk): the level's C ranks in nblk equal blocks of at
        most ~block_elems lanes ([P, cblock] each).

        The split is balanced and rounds UP, unlike the reference's
        min(C, cap) rounded down: that one computes a mostly-padding last
        block on most levels, and more so with its kernel-block rounding.
        Here the padding is under one lane (plain) or one kernel block
        (window) per block of ranks.
        """
        P = len(self.tables.profiles[level])
        C = self.tables.class_size[level]
        cap = max(self.block_elems // max(P, 1), 1)
        nblk = -(-C // cap)
        cblock = -(-C // nblk)
        if self.gather_mode == "window" and cblock >= WINDOW_BLOCK:
            # A WINDOW_BLOCK multiple keeps kernel blocks from straddling
            # profile rows (a straddling block's index span is ~the child
            # class size: a guaranteed window miss).
            cblock = -(-cblock // WINDOW_BLOCK) * WINDOW_BLOCK
        return cblock, -(-C // cblock)

    def _binom_on(self, device) -> torch.Tensor:
        """The [ncells+1, K] int64 binomial table on `device` (cached):
        the plain steps' (the kernels carry theirs in each level's
        pack)."""
        key = str(device)
        if key not in self._binoms:
            self._binoms[key] = torch.as_tensor(
                self.tables.binom.astype(np.int64), device=device)
        return self._binoms[key]

    @property
    def _binom(self) -> torch.Tensor:
        return self._binom_on(self.device)

    def _lane_slices(self, cblock: int, window: bool) -> list:
        """Each shard's [lo, hi) lanes of a cblock-wide rank block: whole
        kernel blocks of the one-device layout (WINDOW_BLOCK lanes when
        cblock is a multiple of it, else the whole block) for the window
        gather, single lanes otherwise, dealt out contiguously. A shard
        may get none (a level narrower than the mesh)."""
        N = self.devices
        if window and cblock >= WINDOW_BLOCK:
            unit = WINDOW_BLOCK
        elif window:
            unit = cblock
        else:
            unit = 1
        ncol = cblock // unit
        return [(i * ncol // N * unit, (i + 1) * ncol // N * unit)
                for i in range(N)]

    def _replicate(self, flat: torch.Tensor) -> list:
        """A level's flat cells (or reach) on every shard's device: the
        one communication of the meshed design (one copy per distinct
        device; shards sharing a card share the tensor)."""
        out, by_dev = [], {}
        for dev in self._shard_devices:
            key = str(dev)
            if key not in by_dev:
                by_dev[key] = flat.to(dev)
            out.append(by_dev[key])
        return out

    def _level_tensors(self, level: int, for_reach: bool,
                       device=None) -> dict:
        """Per-level constants in the plain steps' layout (steps first,
        int64; ops/dense_level.eager_consts) on `device` (default the
        solver's), cached on the solver."""
        device = self.device if device is None else torch.device(device)
        key = (level, for_reach, str(device))
        if key not in self._consts:
            self._consts[key] = dense_level.eager_consts(
                self.tables, level, for_reach, device)
        return self._consts[key]

    def _kernel_consts(self, level: int, for_reach: bool, device) -> dict:
        """A level's kernel pack (ops/dense_level.kernel_pack) on the CUDA
        `device`, cached on the solver: one host-to-device copy from
        pinned memory."""
        device = torch.device(device)
        key = ("pack", level, for_reach, str(device))
        if key not in self._consts:
            host = torch.from_numpy(dense_level.kernel_pack(
                self.tables, level, for_reach)).pin_memory()
            self._consts[key] = {"pack": host.to(device, non_blocking=True)}
        return self._consts[key]

    def _step_consts(self, L: int, for_reach: bool, mode: str,
                     device) -> tuple:
        """(consts, binom) of one launch at level L on `device`: the
        kernel pack where the kernels run (window mode on the card), else
        the plain steps' layout and binomial table."""
        if mode == "window" and device.type == "cuda":
            return self._kernel_consts(L, for_reach, device), None
        return (self._level_tensors(L, for_reach, device),
                self._binom_on(device))

    # -- the level steps ----------------------------------------------------

    def _launch_maps(self, L: int, for_reach: bool) -> list:
        """[(shard, ops/dense_level.LaunchMap)]: the lanes each shard's
        step takes at level L, one launch each on the card: every rank
        block whole on one device, writing the level's array in place;
        on a mesh each shard's lane slice of every block, into a compact
        output of its own (shards whose slice is empty take none)."""
        t = self.tables
        P, C = len(t.profiles[L]), t.class_size[L]
        cblock, nblk = self._cblock(L)
        window = not for_reach and self.gather_mode == "window"
        slices = ([(0, cblock)] if self._mesh is None
                  else self._lane_slices(cblock, window))
        return [(i, dense_level.LaunchMap(P, C, cblock, nblk, lo, hi,
                                          compact=self._mesh is not None))
                for i, (lo, hi) in enumerate(slices) if hi > lo]

    def _run_level(self, L: int, for_reach: bool, other):
        """One level's step over its rank blocks and, on a mesh, each
        block's lane slices shard by shard: on the card one kernel launch
        per shard over its slices of every block (the backward's plain
        modes: a plain step per block). One device writes the level's
        [P, C] array in place; a mesh shard writes its lanes compact on
        its device, and only those cross to the home device. `other`: the
        adjacent level's flat array on every shard's device (the step's
        gather source). -> ([P, C] level array on the home device, the
        steps' second outputs summed on it: the reach count or the gather
        misses, or None)."""
        t = self.tables
        P, C = len(t.profiles[L]), t.class_size[L]
        mode = "window" if for_reach else self.gather_mode
        # A traced solve's backward level: its constants under
        # dense_pack, the rest up to the last launch under dense_launch.
        tree = None if for_reach else self._tree
        maps = self._launch_maps(L, for_reach)
        sp = (None if tree is None
              else Span("dense_pack", tree=tree, detail=True, level=L))
        consts = [self._step_consts(L, for_reach, mode, other[i].device)
                  for i, _ in maps]
        if sp is not None:
            sp.end()
            sp = Span("dense_launch", tree=tree, detail=True, level=L)
        geom = dense_level.level_geom(t, L)
        out = torch.empty((P, C), dtype=torch.uint8, device=self.device)
        total, shards = None, []
        for (i, lmap), (cst, binom) in zip(maps, consts):
            src = other[i]
            target = out if not lmap.compact else torch.empty(
                (P, lmap.out_cols), dtype=torch.uint8, device=src.device)
            if mode != "window":
                extra = dense_level.dense_level_ref(
                    geom, lmap, src, cst, binom, target, mode)
            else:
                step = (dense_level.reach_step if for_reach
                        else dense_level.dense_step)
                extra = step(geom, lmap, src, cst, binom, target)
            if target is not out:
                shards.append((lmap, target))
            if extra is not None:
                extra = extra.to(self.device)
                total = extra if total is None else total + extra
        for lmap, target in shards:
            dense_level.merge_shard(lmap, target, out)
        if sp is not None:
            sp.end()
        return out, total

    def _sweep_levels(self, last_level: int):
        """The reach sweep 1..last_level -> (counts {0..last_level},
        level last_level's flat reach [P*C] uint8 on the home device).
        Shared by reachable_counts (the full sweep) and the hybrid (the
        sweep to its boundary)."""
        reach = torch.ones((1,), dtype=torch.uint8, device=self.device)
        counts_dev: Dict[int, torch.Tensor] = {}
        for L in range(1, last_level + 1):
            level_reach, cnt = self._run_level(L, True,
                                               self._replicate(reach))
            reach = level_reach.reshape(-1)
            counts_dev[L] = cnt
        counts = {0: 1}
        counts.update({L: int(v) for L, v in counts_dev.items()})
        self.host_syncs += len(counts_dev)
        return counts, reach

    def reachable_counts(self) -> Dict[int, int]:
        """Exact per-level reachable-position counts: the process's cache,
        else the counts file, else a full sweep (recorded in both).
        ``reach_counts_source`` says which."""
        cached = _REACH_COUNTS.get(self._board_key)
        if cached is not None:
            self.reach_counts_source = "process"
            return cached
        cached = _load_cached_counts(self._board_key)
        if cached is not None:
            _REACH_COUNTS[self._board_key] = cached
            self.reach_counts_source = "file"
            return cached
        counts, _ = self._sweep_levels(self.tables.ncells)
        _REACH_COUNTS[self._board_key] = counts
        _store_cached_counts(self._board_key, counts)
        self.reach_counts_source = "sweep"
        return counts

    def _backward_level(self, L: int, child_flat):
        """One backward level: the deeper level's flat cells -> this
        level's [P, C] cells, plus the gather misses summed over the
        shards (a tensor or None)."""
        return self._run_level(L, False, self._replicate(child_flat))

    # -- the solve ----------------------------------------------------------

    def _checkpoint_resume(self) -> Optional[Dict[int, Optional[torch.Tensor]]]:
        """Bind the checkpoint directory and read its contiguous sealed run
        K..top as resume cells, or None when level top is not sealed.

        Only K's file is read unless tables are kept (the rechain needs
        K's cells alone); the others map to None. The save-then-manifest
        order guarantees a listed level's file is complete. A level whose
        cell count differs from the board's refuses a stale directory.
        """
        t, ckpt = self.tables, self.checkpointer
        # ":dense" namespaces the binding: these are flat cell arrays, not
        # the classic engine's tables; one directory never serves both.
        ckpt.bind_game(self.game.name + ":dense")
        completed = set(ckpt.dense_levels())
        K = t.ncells + 1
        while K - 1 in completed:
            K -= 1
        if K > t.ncells:
            return None
        out: Dict[int, Optional[torch.Tensor]] = {}
        for L in range(K, t.ncells + 1):
            if not self.store_tables and L != K:
                out[L] = None
                continue
            P, C = len(t.profiles[L]), t.class_size[L]
            cells = ckpt.load_dense_level(L)
            if cells.shape[0] != P * C:
                raise ValueError(
                    f"checkpointed dense level {L} has {cells.shape[0]} "
                    f"cells, expected {P * C} — stale checkpoint directory?")
            out[L] = torch.from_numpy(
                np.array(cells, dtype=np.uint8).reshape(P, C)).to(self.device)
        return out

    def solve(self, resume_cells: Optional[Dict[int, torch.Tensor]] = None
              ) -> DenseSolveResult:
        """Run the backward sweep (then the reach count, once per board)
        under the optional heartbeat, the env-gated watchdog and the live
        status server.

        resume_cells: level -> [P, C] uint8 cells of already solved levels
        (e.g. cells_from_reference of a reference solve). The sweep
        rechains from the lowest level of the contiguous run that ends at
        the top level, as a resumed reference checkpoint does; those
        levels are taken as given, not recomputed. With a checkpointer the
        resume cells come from its directory (a level mapped to None is
        sealed but not read), and each computed level is sealed.

        Traced (obs/tracing.tracing_on(), read here once): the solve's
        spans tile it under ``dense_solve`` (``dense_enter``, per level
        ``backward`` with its ``dense_pack``, ``dense_launch`` and
        ``dense_download`` and a ``dense_record`` after it, then
        ``dense_exit``), and ``stats["trace"]`` holds their counts and
        seconds and the solve's ``host_syncs``.
        """
        self.host_syncs = 0
        tree = SpanTree() if tracing_on() else None
        root = enter = None
        if tree is not None:
            root = Span("dense_solve", tree=tree, detail=True)
            enter = Span("dense_enter", tree=tree, detail=True)
        self._tree = tree
        try:
            self.status_tracker.begin(game=self.game.name, engine="dense",
                                      world=1, rank=0)
            with watched(lambda: self.progress, self.logger,
                         self.heartbeat_secs,
                         lambda: self.status_tracker.snapshot(
                             progress=self.progress)):
                result = self._solve_impl(resume_cells, enter)
            if tree is not None:
                root.end()
                result.stats["trace"] = {**tree.finish(),
                                         "host_syncs": self.host_syncs}
        finally:
            self._tree = None
        return result

    def _solve_impl(self, resume_cells,
                    between: Optional[Span] = None) -> DenseSolveResult:
        """The solve; `between`: a traced solve's open span between
        levels (dense_enter, then each level's dense_record, then
        dense_exit), ended here."""
        g, t, ckpt = self.game, self.tables, self.checkpointer
        nc = t.ncells
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        launches0 = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        if ckpt is not None:
            if resume_cells is not None:
                raise ValueError("pass resume_cells or a checkpointer, "
                                 "not both")
            ckpt.begin_solve()
            resume_cells = self._checkpoint_resume()
        encodable_total = 0
        saved: Optional[Dict[int, np.ndarray]] = (
            {} if self.store_tables else None
        )
        child_flat = torch.zeros((1,), dtype=torch.uint8, device=self.device)
        start_L = nc
        if resume_cells:
            K = nc + 1
            while K - 1 in resume_cells:
                K -= 1
            if K > nc:
                raise ValueError(
                    f"resume_cells must include the top level {nc}; "
                    f"got levels {sorted(resume_cells)}")
            for L in range(K, nc + 1):
                P, C = len(t.profiles[L]), t.class_size[L]
                encodable_total += P * C
                cells = resume_cells[L]
                if cells is None:
                    continue  # sealed, not read (no tables kept)
                if tuple(cells.shape) != (P, C) or cells.dtype != torch.uint8:
                    raise ValueError(
                        f"resume level {L}: expected uint8 [{P}, {C}], got "
                        f"{cells.dtype} {tuple(cells.shape)}")
                if saved is not None:
                    saved[L] = cells.cpu().numpy()
                    self.host_syncs += 1
            child_flat = resume_cells[K].to(self.device).reshape(-1)
            start_L = K - 1
            if self.logger is not None:
                self.logger.log({"phase": "dense_backward_resume",
                                 "levels_resumed": nc - K + 1,
                                 "from_level": K})
        levels_resumed = nc - start_L
        self.status_tracker.set_schedule(
            {L: len(t.profiles[L]) * t.class_size[L]
             for L in range(start_L + 1)})
        computed_encodable = 0
        nmiss: Dict[int, torch.Tensor] = {}
        tree = self._tree
        for L in range(start_L, -1, -1):
            P, C = len(t.profiles[L]), t.class_size[L]
            self.progress = {"phase": "backward", "level": L, "classes": P}
            if between is not None:
                between.end()
            sp = Span("backward", log=False, level=L, tree=tree)
            encodable_total += P * C
            computed_encodable += P * C
            level_cells, nm = self._backward_level(L, child_flat)
            if nm is not None:
                nmiss[L] = nm
            child_flat = level_cells.reshape(-1)
            if saved is not None or ckpt is not None:
                dl = (None if tree is None else Span(
                    "dense_download", tree=tree, detail=True, level=L))
                host = level_cells.cpu().numpy()  # one download per level
                if dl is not None:
                    dl.end()
                self.host_syncs += 1
                if saved is not None:
                    saved[L] = host
                if ckpt is not None:
                    with trace_span("checkpoint", level=L, kind="level",
                                    tree=tree):
                        ckpt.save_dense_level(L, host)
            sp.stop()
            if tree is not None:
                between = Span("dense_record", tree=tree, detail=True,
                               level=L)
            sp.end()
            if self.logger is not None:
                self.logger.log({"phase": "dense_backward", "level": L,
                                 "classes": P, "class_size": C})
            self.status_tracker.backward_level(L, P * C, sp.secs)
            flightrec.boundary("backward", L)
        if between is not None:
            between.end()
            between = Span("dense_exit", tree=tree, detail=True)

        root_cell = int(child_flat[0])  # synchronises with the device
        self.host_syncs += 1
        value, remoteness = root_cell & 3, root_cell >> 2
        solve_secs = time.perf_counter() - t0

        tc = time.perf_counter()
        counted = self.reachable_counts()
        count_secs = (time.perf_counter() - tc
                      if self.reach_counts_source != "process" else 0.0)
        positions = sum(counted.values())

        stats = {
            "game": g.name,
            "engine": "dense",
            "gather_mode": self.gather_mode,
            "device": str(self.device),
            "devices": self.devices,
            "positions": positions,
            "encodable_positions": encodable_total,
            "levels": nc + 1,
            "secs_forward": 0.0,  # there is no forward pass
            "secs_backward": solve_secs,
            "secs_total": solve_secs,
            # Excluded from secs_total: a per-board constant, computed
            # once per board (the counts file) or per process, not part
            # of the solve.
            "secs_count_reachable": count_secs,
            "reach_counts_source": self.reach_counts_source,
            # A resumed run computed only some levels: report 0 rather
            # than credit it with the whole board.
            "positions_per_sec": (
                positions / max(solve_secs, 1e-9)
                if levels_resumed == 0 else 0.0
            ),
            "levels_resumed": levels_resumed,
            "bytes_sorted": 0,
            # Operand bytes of the gathers this run issued (u8 cells).
            "bytes_gathered": computed_encodable * g.max_moves,
            # Window-gather elements outside their block's 2-window view
            # (each still exact; a miss costs a global read, not a retry).
            "gather_nmiss_per_level": {L: int(v) for L, v in nmiss.items()},
        }
        self.host_syncs += len(nmiss)
        stats["gather_nmiss"] = sum(stats["gather_nmiss_per_level"].values())
        # Each kernel's launches in this solve, by name (the wrappers'
        # counts; 0 on the CPU, which takes the plain versions): how a
        # solve in another process, a campaign attempt, shows it ran the
        # kernels. gather_launches: those of the kernel that gathers the
        # child cells, the backward step's.
        stats["kernel_launches"] = kernel_launches_since(launches0)
        stats["gather_launches"] = stats["kernel_launches"]["dense_step"]
        if cuda:
            stats["peak_mem_bytes"] = torch.cuda.max_memory_allocated(
                self.device)
        if ckpt is not None:
            stats.update(ckpt.solve_stats())
        stats["reachable_per_level"] = counted
        self.progress = {"phase": "done"}
        if self.logger is not None:
            self.logger.log({"phase": "done", **stats})
        record_solve(g.name, positions, solve_secs)
        if between is not None:
            between.end()
        return DenseSolveResult(g, t, value, remoteness, saved, stats)
