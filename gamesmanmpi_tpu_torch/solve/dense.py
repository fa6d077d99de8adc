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
  -> negamax combine (ops/combine.py).
- Reachable positions (Tromp's counts) come from a separate forward
  **reachability sweep** with "unmove" tables, cached per board per
  process.

The child-cell gather is the one hand-written kernel on this path
(``gather_mode="window"``, the default): invalid rows and pad lanes get a
monotone fill so the flat child index vector is non-decreasing, and
ops/window_gather.monotone_window_gather serves it — the CUDA kernel on
the card, its plain version on the CPU. The kernel is exact, so the
reference's per-call fallback gather is gone. ``gather_mode="plain"`` is
the clipped torch index, kept as the yardstick. ``GAMESMAN_DENSE_GATHER``
picks it when the caller does not: unset or ``pallas`` is the window
kernel, ``plain`` the plain gather; ``sorted`` is not ported.

All tensors are int64 (bitboards, ranks, flat indices) or uint8 (cells);
see core/bitops.py. The reference's TPU-only machinery is not carried
over: the one-hot binomial select tree (the card indexes the [ncells+1, K]
table directly), the relay run-ahead drain, background compiles. Not yet
ported (ROADMAP): the counts file, _rank_all_moves_fused and the sorted
gather mode.

**The mesh** (``devices=N``, parallel/mesh.Mesh in one process): every
level step's [P, cblock] lanes are split over the N shards, each shard
computing its slice on its device, and each level's cells are copied to
every shard's device for the next level's gathers (the reference's
``_replicate``). A slice is a whole number of window-gather kernel
blocks, cut from the one-device layout: every kernel block stays inside
one profile row and sees exactly the lanes it sees at ``devices=1``, so
the cells and the summed ``nmiss`` equal the one-device run's. (The
reference instead rounds cblock up to ``lcm(devices, PALLAS_BLOCK)`` and
lets SPMD partition it; its Pallas gather falls back to the plain one
there, unproven under auto-SPMD. Here each shard launches the kernel
itself on its own slice, so there is nothing to fall back from.)
Single-controller, as in the reference: the mesh spans one process.

Checkpoint/resume (``checkpointer=``), as in the reference: the directory
is bound to ``<game>:dense``, each level's flat cells are sealed as they
complete (``dense_NNNN.npz``), and a rerun rechains from the contiguous
sealed run that ends at the top level, through the same path as
``solve(resume_cells=...)``.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from gamesmanmpi_tpu_torch.core.values import LOSE, TIE
from gamesmanmpi_tpu_torch.games.connect4 import Connect4
from gamesmanmpi_tpu_torch.ops.combine import combine_children
from gamesmanmpi_tpu_torch.ops.window_gather import monotone_window_gather
from gamesmanmpi_tpu_torch.utils.device import resolve_device
from gamesmanmpi_tpu_torch.utils.env import env_opt


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
# Level steps (plain torch around the window-gather kernel)


def _connected_fold(stones, h: int, connect: int):
    """Any `connect`-in-a-row in a guard-layout int64 bitboard.

    Same four directions as games/connect4.py: vertical 1, diag-down h,
    horizontal h+1, diag-up h+2.
    """
    won = torch.zeros(stones.shape, dtype=torch.bool, device=stones.device)
    for d in (1, h, h + 1, h + 2):
        x = stones
        for i in range(1, connect):
            x = x & (stones >> (i * d))
        won |= x != 0
    return won


def _unrank_bits(ranks, n1: int, binom, cellidx, bitpos):
    """[P or 1, cb] combinadic ranks -> [P, cb] player-1 bitboards.

    A descending walk over the global cells. binom is the [ncells+1, K]
    int64 table, indexed directly; cellidx[j] is each class's within-class
    index of global cell j ([ncells, P] int64, -1 for an absent cell).
    """
    ncells, P = cellidx.shape
    cb = ranks.shape[1]
    kmax = binom.shape[0] - 1
    bits = torch.zeros((P, cb), dtype=torch.int64, device=ranks.device)
    rem = torch.full((P, cb), n1, dtype=torch.int64, device=ranks.device)
    r = ranks.expand(P, cb).clone()
    for j in range(ncells - 1, -1, -1):
        kj = cellidx[j]
        exists = (kj >= 0)[:, None]
        cki = binom[kj.clamp(0, kmax)[:, None], rem]  # C(k_j, rem)
        # C(k, rem) == 0 (k < rem) means every remaining cell must be a
        # stone; 0 <= r always holds, so `take` fires as required.
        take = exists & (rem > 0) & (cki <= r)
        r -= cki * take
        rem -= take.to(torch.int64)
        bits |= take.to(torch.int64) * (1 << int(bitpos[j]))
    return bits


def _rank_bits(bits, binom, cellidx_c, bitpos):
    """[P, cb] stone bitboards -> combinadic ranks under the cell indexing
    cellidx_c ([ncells, P] int64, the TARGET class per row)."""
    ncells, P = cellidx_c.shape
    kmax = binom.shape[0] - 1
    acc = torch.zeros(bits.shape, dtype=torch.int64, device=bits.device)
    seen = torch.zeros(bits.shape, dtype=torch.int64, device=bits.device)
    for j in range(ncells):
        kj = cellidx_c[j]
        take = (kj >= 0)[:, None] & ((bits & (1 << int(bitpos[j]))) != 0)
        seen += take
        ck = binom[kj.clamp(0, kmax)[:, None], seen]
        acc += ck * take
    return acc


# Kernel block / window of the child gather. block=2048 divides every
# cblock >= 2048 (_cblock rounds to a multiple), so no kernel block
# straddles a profile row; window=4*block covers child-rank spans up to a
# ~4x per-level expansion ratio.
WINDOW_BLOCK = 2048
WINDOW_ELEMS = 8192


def build_dense_step(tables: DenseTables, level: int, cblock: int,
                     gather_mode: str = "window"):
    """The backward step for one level at one block width.

    Returned fn: (rank0 int, child_flat [flat] uint8 (dummy at the top
    level), consts dict of level tensors, binom [ncells+1, K] int64)
      -> (cells [P, cblock] uint8, nmiss int32 tensor or None)

    gather_mode "window" feeds the monotone-filled flat index to the
    window-gather kernel; "plain" indexes with the clipped flat index.
    Both give identical cells.
    """
    w, h, connect = tables.width, tables.height, tables.connect
    ncells = tables.ncells
    n1 = n1_of_level(level)
    C = tables.class_size[level]
    Cc = tables.class_size[level + 1] if level < ncells else 1
    is_top = level == ncells
    p1_moves = level % 2 == 0   # the player moving OUT of this level
    mover_is_p1 = level % 2 == 1  # the player who made the ply INTO it
    bitpos = [int(b) for b in tables.bitpos]

    def step(rank0, child_flat, consts, binom):
        dev = child_flat.device
        filled = consts["filled"]
        P = filled.shape[0]
        ranks = rank0 + torch.arange(cblock, dtype=torch.int64,
                                     device=dev)[None, :]  # [1, cb]
        p1 = _unrank_bits(ranks, n1, binom, consts["cellidx"], bitpos)
        p2 = filled[:, None] ^ p1
        mover = p1 if mover_is_p1 else p2
        current = p2 if mover_is_p1 else p1
        # mover_line: the player to move already lost. current_line
        # without mover_line: unreachable garbage, made terminal so it
        # never fans out gathers.
        prim = (_connected_fold(mover, h, connect)
                | _connected_fold(current, h, connect))
        del p2, mover, current
        if is_top:
            top = torch.full(prim.shape, TIE, dtype=torch.uint8, device=dev)
            return top.masked_fill_(prim, LOSE), None

        m = child_flat.shape[0]
        in_range = ranks < C
        nmiss = None
        vals, rems, masks = [], [], []
        for c in range(w):
            valid_c = consts["valid"][:, c:c + 1]
            row_c = consts["move_row"][:, c:c + 1]
            cbits = (p1 | consts["newbit"][:, c:c + 1]) if p1_moves else p1
            crank = _rank_bits(cbits, binom, consts["child_cellidx"][:, :, c],
                               bitpos)
            flat = row_c * Cc + crank
            del cbits, crank
            if gather_mode == "window":
                # Invalid rows take the previous valid row's last slot (0
                # before any), pad lanes (rank >= C) their own row's last
                # slot: the flat vector stays globally non-decreasing.
                fillr = torch.where(valid_c, row_c,
                                    consts["move_fill"][:, c:c + 1])
                fill = torch.where(fillr < 0, torch.zeros_like(fillr),
                                   fillr * Cc + (Cc - 1))
                flat = torch.where(valid_c & in_range, flat, fill)
                cell, nm = monotone_window_gather(
                    child_flat, flat.reshape(-1), WINDOW_BLOCK, WINDOW_ELEMS)
                cell = cell.reshape(P, cblock)
                nmiss = nm if nmiss is None else nmiss + nm
            else:
                cell = child_flat[flat.clamp(0, m - 1)]
            del flat
            vals.append(cell & 3)
            rems.append((cell >> 2).to(torch.int32))
            masks.append(valid_c.expand(P, cblock))

        cv = torch.stack(vals, dim=-1).reshape(P * cblock, w)
        cr = torch.stack(rems, dim=-1).reshape(P * cblock, w)
        mk = (torch.stack(masks, dim=-1)
              & ~prim[..., None]).reshape(P * cblock, w)
        del vals, rems, masks
        values, rem_out = combine_children(cv, cr, mk)
        del cv, cr, mk
        values = values.reshape(P, cblock).masked_fill_(prim, LOSE)
        rem_out = rem_out.reshape(P, cblock).masked_fill_(prim, 0)
        return values | (rem_out.clamp(0, 63).to(torch.uint8) << 2), nmiss

    return step


def build_reach_step(tables: DenseTables, level: int, cblock: int):
    """The reachability-sweep step for one level (level >= 1).

    reach(y) = OR over columns c of y's class: the top stone of column c
    belongs to the player who made ply `level` AND the position with that
    stone removed is reachable AND was not terminal (its own last mover had
    no line).

    Returned fn: (rank0 int, parent_reach [flat] uint8, consts, binom)
      -> (reach [P, cblock] uint8, count int64 tensor)
    """
    w, h, connect = tables.width, tables.height, tables.connect
    n1 = n1_of_level(level)
    C = tables.class_size[level]
    Cp = tables.class_size[level - 1]
    mover_is_p1 = level % 2 == 1           # who made ply `level`
    parent_mover_is_p1 = (level - 1) % 2 == 1  # who made the ply before
    bitpos = [int(b) for b in tables.bitpos]

    def step(rank0, parent_reach, consts, binom):
        dev = parent_reach.device
        filled = consts["filled"]
        P = filled.shape[0]
        ranks = rank0 + torch.arange(cblock, dtype=torch.int64,
                                     device=dev)[None, :]
        in_range = ranks < C
        p1 = _unrank_bits(ranks, n1, binom, consts["cellidx"], bitpos)
        n = parent_reach.shape[0]

        reach = torch.zeros((P, cblock), dtype=torch.bool, device=dev)
        for c in range(w):
            ts = consts["topstone"][:, c:c + 1]  # [P, 1]; 0 for empty columns
            prow = consts["parent_row"][:, c:c + 1]
            stone_is_p1 = (p1 & ts) != 0
            color_ok = (ts != 0) & (stone_is_p1 if mover_is_p1
                                    else ~stone_is_p1)
            parent_p1 = (p1 ^ ts) if mover_is_p1 else p1
            parent_filled = filled[:, None] ^ ts
            parent_mover = (parent_p1 if parent_mover_is_p1
                            else parent_filled ^ parent_p1)
            parent_live = ~_connected_fold(parent_mover, h, connect)
            prank = _rank_bits(parent_p1, binom,
                               consts["parent_cellidx"][:, :, c], bitpos)
            flat = prow * Cp + prank
            pr = parent_reach[flat.clamp(0, n - 1)] != 0
            reach |= color_ok & parent_live & pr & (prow >= 0)
        count = (reach & in_range).sum()
        return reach.to(torch.uint8), count

    return step


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
# one sweep per board per process, reused by every later solve.
_REACH_COUNTS: Dict[tuple, Dict[int, int]] = {}

_TABLES: Dict[tuple, DenseTables] = {}


def gather_mode_from_env() -> str:
    """GAMESMAN_DENSE_GATHER, parsed strictly: unset or ``pallas`` (the
    reference's name for its window kernel) -> "window", ``plain`` ->
    "plain"; ``sorted`` (not ported) and anything else raise ValueError.
    The port's default stays the window kernel, where the reference
    defaults to plain."""
    raw = env_opt("GAMESMAN_DENSE_GATHER")
    if raw is None or raw == "pallas":
        return "window"
    if raw == "plain":
        return "plain"
    if raw == "sorted":
        raise ValueError("GAMESMAN_DENSE_GATHER=sorted: the sorted gather "
                         "mode is not ported; use 'pallas' (the window "
                         "kernel) or 'plain'")
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
    DeviceUnavailable. gather_mode: "window" (the CUDA window-gather
    kernel on the card) or "plain"; None reads GAMESMAN_DENSE_GATHER. The
    reachability sweep that counts positions runs once per board per
    process. checkpointer: a utils/checkpoint.LevelCheckpointer to seal
    levels into and resume from. devices: shards of the mesh (module
    docstring); more than the visible devices raises ValueError.
    """

    def __init__(self, game: Connect4, store_tables: bool = True,
                 block_elems: Optional[int] = None, device="cuda",
                 gather_mode: Optional[str] = None, checkpointer=None,
                 devices: int = 1):
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
        if gather_mode not in ("window", "plain"):
            raise ValueError(f"gather_mode must be 'window' or 'plain', "
                             f"got {gather_mode!r}")
        self.game = game
        self.store_tables = store_tables
        self.checkpointer = checkpointer
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
        self.tables = tables_for(game.width, game.height, game.connect)
        self.block_elems = int(block_elems or DEFAULT_BLOCK_ELEMS)
        self._consts: dict = {}
        self._binoms: dict = {}
        self._binom = self._binom_on(self.device)

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
        """The [ncells+1, K] int64 binomial table on `device` (cached)."""
        key = str(device)
        if key not in self._binoms:
            self._binoms[key] = torch.as_tensor(
                self.tables.binom.astype(np.int64), device=device)
        return self._binoms[key]

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
        """Per-level constants on `device` (default the solver's), cached
        on the solver."""
        device = self.device if device is None else torch.device(device)
        key = (level, for_reach, str(device))
        if key in self._consts:
            return self._consts[key]
        c = self.tables.level_consts(level)

        def dev(a, dtype=torch.int64):
            return torch.as_tensor(
                np.ascontiguousarray(a.astype(np.int64)), device=device
            ).to(dtype)

        def steps_first(a):  # [P, ..., ncells] -> [ncells, P, ...]
            return dev(np.moveaxis(a, -1, 0))

        out = dict(cellidx=steps_first(c["cellidx"]), filled=dev(c["filled"]))
        if for_reach:
            out.update(
                topstone=dev(c["topstone"]),
                parent_row=dev(c["parent_row"]),
                parent_cellidx=steps_first(c["parent_cellidx"]),
            )
        else:
            out.update(
                newbit=dev(c["newbit"]),
                valid=dev(c["valid"], torch.bool),
                move_row=dev(c["move_row"]),
                move_fill=dev(c["move_fill"]),
                child_cellidx=steps_first(c["child_cellidx"]),
            )
        self._consts[key] = out
        return out

    # -- reachability sweep -------------------------------------------------

    def _run_level(self, L: int, builder, for_reach: bool, window: bool,
                   other):
        """One level's steps over its rank blocks and, on a mesh, each
        block's lane slices shard by shard. `other`: the adjacent level's
        flat array on every shard's device (the step's gather source).
        -> ([P, C] level array on the home device, the per-step second
        outputs summed on it: the reach count or the gather misses)."""
        t = self.tables
        C = t.class_size[L]
        cblock, nblk = self._cblock(L)
        slices = ([(0, cblock)] if self._mesh is None
                  else self._lane_slices(cblock, window))
        steps: dict = {}
        blocks, total = [], None
        for b in range(nblk):
            parts = []
            for (lo, hi), dev, src in zip(slices, self._shard_devices, other):
                if hi == lo:
                    continue
                step = steps.get(hi - lo)
                if step is None:
                    step = steps[hi - lo] = builder(t, L, hi - lo)
                out, extra = step(b * cblock + lo, src,
                                  self._level_tensors(L, for_reach, dev),
                                  self._binom_on(dev))
                parts.append(out.to(self.device))
                if extra is not None:
                    extra = extra.to(self.device)
                    total = extra if total is None else total + extra
            blocks.append(parts[0] if len(parts) == 1
                          else torch.cat(parts, dim=1))
        cells = blocks[0] if nblk == 1 else torch.cat(blocks, dim=1)
        return cells[:, :C].contiguous(), total

    def _sweep_levels(self, last_level: int):
        """The reach sweep 1..last_level -> (counts {0..last_level},
        level last_level's flat reach [P*C] uint8 on the home device).
        Shared by reachable_counts (the full sweep) and the hybrid (the
        sweep to its boundary)."""
        reach = torch.ones((1,), dtype=torch.uint8, device=self.device)
        counts_dev: Dict[int, torch.Tensor] = {}
        for L in range(1, last_level + 1):
            level_reach, cnt = self._run_level(
                L, build_reach_step, True, False, self._replicate(reach))
            reach = level_reach.reshape(-1)
            counts_dev[L] = cnt
        counts = {0: 1}
        counts.update({L: int(v) for L, v in counts_dev.items()})
        return counts, reach

    def reachable_counts(self) -> Dict[int, int]:
        """Exact per-level reachable-position counts (cached per process)."""
        cached = _REACH_COUNTS.get(self._board_key)
        if cached is not None:
            return cached
        counts, _ = self._sweep_levels(self.tables.ncells)
        _REACH_COUNTS[self._board_key] = counts
        return counts

    def _backward_level(self, L: int, child_flat):
        """One backward level: the deeper level's flat cells -> this
        level's [P, C] cells, plus the gather misses summed over the
        shards (a tensor or None)."""
        mode = self.gather_mode

        def builder(t, level, width):
            return build_dense_step(t, level, width, mode)

        return self._run_level(L, builder, False, mode == "window",
                               self._replicate(child_flat))

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
        """Run the backward sweep (then the reach count, once per board).

        resume_cells: level -> [P, C] uint8 cells of already solved levels
        (e.g. cells_from_reference of a reference solve). The sweep
        rechains from the lowest level of the contiguous run that ends at
        the top level, as a resumed reference checkpoint does; those
        levels are taken as given, not recomputed. With a checkpointer the
        resume cells come from its directory (a level mapped to None is
        sealed but not read), and each computed level is sealed.
        """
        g, t, ckpt = self.game, self.tables, self.checkpointer
        nc = t.ncells
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
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
            child_flat = resume_cells[K].to(self.device).reshape(-1)
            start_L = K - 1
        levels_resumed = nc - start_L
        computed_encodable = 0
        nmiss: Dict[int, torch.Tensor] = {}
        for L in range(start_L, -1, -1):
            P, C = len(t.profiles[L]), t.class_size[L]
            encodable_total += P * C
            computed_encodable += P * C
            level_cells, nm = self._backward_level(L, child_flat)
            if nm is not None:
                nmiss[L] = nm
            child_flat = level_cells.reshape(-1)
            if saved is not None or ckpt is not None:
                host = level_cells.cpu().numpy()  # one download per level
                if saved is not None:
                    saved[L] = host
                if ckpt is not None:
                    ckpt.save_dense_level(L, host)

        root_cell = int(child_flat[0])  # synchronises with the device
        value, remoteness = root_cell & 3, root_cell >> 2
        solve_secs = time.perf_counter() - t0

        counted = _REACH_COUNTS.get(self._board_key)
        count_secs = 0.0
        if counted is None:
            tc = time.perf_counter()
            counted = self.reachable_counts()
            count_secs = time.perf_counter() - tc
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
            # once per process, not part of the solve.
            "secs_count_reachable": count_secs,
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
        stats["gather_nmiss"] = sum(stats["gather_nmiss_per_level"].values())
        if cuda:
            stats["peak_mem_bytes"] = torch.cuda.max_memory_allocated(
                self.device)
        if ckpt is not None:
            stats.update(ckpt.solve_stats())
        stats["reachable_per_level"] = counted
        return DenseSolveResult(g, t, value, remoteness, saved, stats)
