"""Plain reference: a strong retrograde solve of a Connect-4 board, written
from the rules alone in eager PyTorch (CPU or GPU), with its own rank and
unrank.

It imports torch and the standard library only: nothing of the program
under test, and nothing of the JAX package it was ported from. It reads
the program's outputs only to judge them (``check_*``).

Layout of its tables (the one the dense engine's cells use, so the two can
be held against each other cell for cell):

- a level L is the positions with L stones; its rows are the column-height
  profiles (h_0..h_{w-1}), sum L, each <= height, in lexicographic order;
- within a row the L filled cells are numbered column by column from the
  bottom (k = h_0 + .. + h_{c-1} + r for cell (c, r)), and a position is
  the set of player 1's n1 = ceil(L/2) stones among them, at its colex
  rank: sum over its stones, taken by ascending k, of C(k, j), j = 1..n1;
- a cell is one byte, value | remoteness << 2 (WIN 1, LOSE 2, TIE 3;
  remoteness saturating at 63).

Every encodable position gets a cell. A position in which either player
has a line is terminal: LOSE, remoteness 0 (for a reachable position it is
the player to move who has lost). A full board without a line is TIE,
remoteness 0. Otherwise the value is WIN if some move reaches a LOSE
position (remoteness 1 + the least such), else TIE if some move reaches a
TIE (1 + the largest such), else LOSE (1 + the largest of all children).

A position is reachable when a game from the empty board gets there, no
move being made from a terminal position (Tromp's counts).

Bitboards: cell (c, r) is bit c*(height+1) + r; the spare bit per column
keeps line tests from wrapping. A packed state (the form the program's
classic tables and its query server use) is, per column, the stones of
the player to move below a single guard bit at the column's height.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import torch

WIN, LOSE, TIE = 1, 2, 3
VALUE_NAMES = {WIN: "WIN", LOSE: "LOSE", TIE: "TIE"}


def parse_connect4(spec: str) -> tuple[int, int, int]:
    """'connect4:w=5,h=5' -> (width, height, connect)."""
    name, _, args = spec.partition(":")
    if name != "connect4":
        raise ValueError(f"not a Connect-4 board: {spec!r}")
    kv = dict(a.split("=", 1) for a in args.split(",") if a)
    unknown = set(kv) - {"w", "h", "connect"}
    if unknown:
        raise ValueError(f"{spec!r}: the reference has no {sorted(unknown)}")
    return int(kv.get("w", 7)), int(kv.get("h", 6)), int(kv.get("connect", 4))


@dataclass
class Solution:
    """The reference's answer for a whole board."""

    cells: dict            # level -> uint8 [P, C]
    reach: dict            # level -> bool [P, C]
    reachable: dict        # level -> reachable positions
    moves: dict            # level -> (reachable live position, move) pairs
    value: int = 0
    remoteness: int = 0
    positions: int = 0


class Board:
    """The layout and rules of one w x h Connect-`connect` board."""

    def __init__(self, width: int, height: int, connect: int = 4,
                 device="cpu"):
        if (height + 1) * width > 63:
            raise ValueError("board too large for 63-bit bitboards")
        self.width, self.height, self.connect = width, height, connect
        self.h1 = height + 1
        self.ncells = width * height
        self.device = torch.device(device)
        dev = self.device
        n = self.ncells
        self.binom = torch.tensor(
            [[math.comb(k, i) for i in range(n + 2)] for k in range(n + 1)],
            dtype=torch.int64, device=dev)
        by_level: list[list] = [[] for _ in range(n + 1)]
        for prof in itertools.product(range(height + 1), repeat=width):
            by_level[sum(prof)].append(prof)
        self.profiles = [torch.tensor(sorted(p), dtype=torch.int64,
                                      device=dev).reshape(-1, width)
                         for p in by_level]
        self.size = [math.comb(L, (L + 1) // 2) for L in range(n + 1)]
        # row_of[code] = the row of the profile whose mixed-radix code
        # (base height+1, column 0 lowest) is `code`, within its level.
        radix = torch.tensor([self.h1 ** c for c in range(width)],
                             dtype=torch.int64, device=dev)
        self.row_of = torch.full((self.h1 ** width,), -1, dtype=torch.int64,
                                 device=dev)
        pmax = max(p.shape[0] for p in self.profiles)
        # kbit[L, row, k] = bit of the k-th filled cell of that row.
        self.kbit = torch.zeros((n + 1, pmax, max(n, 1)), dtype=torch.int64,
                                device=dev)
        self.filled = []
        self.child_row = []
        for L, prof in enumerate(self.profiles):
            P = prof.shape[0]
            self.row_of[(prof * radix).sum(1)] = torch.arange(P, device=dev)
            filled = torch.zeros(P, dtype=torch.int64, device=dev)
            for p in range(P):
                k = 0
                for c in range(width):
                    for r in range(int(prof[p, c])):
                        self.kbit[L, p, k] = c * self.h1 + r
                        filled[p] |= 1 << (c * self.h1 + r)
                        k += 1
            self.filled.append(filled)
        for L, prof in enumerate(self.profiles):
            rows = torch.full((prof.shape[0], width), -1, dtype=torch.int64,
                              device=dev)
            if L < n:
                for c in range(width):
                    ok = prof[:, c] < height
                    code = (prof * radix).sum(1) + radix[c]
                    rows[ok, c] = self.row_of[code[ok]]
            self.child_row.append(rows)

    # -- rules ---------------------------------------------------------------

    def has_line(self, x: torch.Tensor) -> torch.Tensor:
        """`connect` in a row anywhere in bitboard(s) x."""
        out = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        for d in (1, self.height, self.h1, self.h1 + 1):
            y = x
            for i in range(1, self.connect):
                y = y & (x >> (i * d))
            out |= y != 0
        return out

    # -- rank and unrank -------------------------------------------------------

    def unrank(self, L: int, row: torch.Tensor, rank: torch.Tensor
               ) -> torch.Tensor:
        """Player 1's bitboard of the position at `rank` in `row` of level L."""
        i = torch.full_like(rank, (L + 1) // 2)
        r = rank.clone()
        bits = torch.zeros_like(rank)
        kb = self.kbit[L]
        for k in range(L - 1, -1, -1):
            ck = self.binom[k][i]
            take = (i > 0) & (ck <= r)
            r -= ck * take
            i -= take.to(torch.int64)
            bits |= take.to(torch.int64) << kb[row, k]
        return bits

    def rank(self, level, row: torch.Tensor, p1: torch.Tensor
             ) -> torch.Tensor:
        """Colex rank of player 1's stones p1 within `row` of `level` (an
        int, or a tensor of levels for positions of mixed levels)."""
        acc = torch.zeros_like(p1)
        seen = torch.zeros_like(p1)
        if isinstance(level, int):
            kb, top = self.kbit[level], level
        else:
            kb, top = None, self.ncells
        for k in range(top):
            if kb is None:
                bit = self.kbit[level, row, k]
                stone = ((p1 >> bit) & 1) * (level > k)
            else:
                stone = (p1 >> kb[row, k]) & 1
            seen += stone
            acc += stone * self.binom[k][seen]
        return acc

    def locate(self, states: torch.Tensor):
        """Packed states -> (level, row, rank, p1, ok): ok is False where a
        state is no packed position of this board."""
        s = states.to(torch.int64)
        colmask = (1 << self.h1) - 1
        level = torch.zeros_like(s)
        code = torch.zeros_like(s)
        current = torch.zeros_like(s)
        filled = torch.zeros_like(s)
        ok = s >= 0
        for c in range(self.width):
            col = (s >> (c * self.h1)) & colmask
            hc = torch.full_like(s, -1)
            for r in range(self.h1):
                hc = torch.where(((col >> r) & 1) == 1, r, hc)
            ok &= (hc >= 0) & (hc <= self.height)
            hc = hc.clamp(0, self.height)
            level += hc
            code += hc * self.h1 ** c
            current |= (col ^ (1 << hc)) << (c * self.h1)
            filled |= ((1 << hc) - 1) << (c * self.h1)
        ok &= (s >> (self.width * self.h1)) == 0
        row = self.row_of[code]
        p1 = torch.where(level % 2 == 0, current, filled ^ current)
        rank = self.rank(level, row, p1)
        return level, row, rank, p1, ok

    def pack(self, heights: torch.Tensor, to_move: torch.Tensor
             ) -> torch.Tensor:
        """Packed states of positions given as column heights [..., w] and
        the stones of the player to move."""
        guards = torch.zeros_like(to_move)
        for c in range(self.width):
            guards |= 1 << (heights[..., c] + c * self.h1)
        return to_move | guards

    def children(self, states: torch.Tensor):
        """Packed children of packed states: ([B, w] states, [B, w] legal);
        a terminal position (a line, or a full board) has none."""
        s = states.to(torch.int64)
        level, row, _, p1, _ = self.locate(s)
        heights = self.profiles_of(level, row)
        filled = torch.zeros_like(s)
        for c in range(self.width):
            filled |= ((1 << heights[:, c]) - 1) << (c * self.h1)
        p2 = filled ^ p1
        to_move = torch.where(level % 2 == 0, p1, p2)
        other = to_move ^ filled
        terminal = self.has_line(p1) | self.has_line(p2)
        kids, legal = [], []
        for c in range(self.width):
            h = heights.clone()
            h[:, c] += 1
            legal.append((heights[:, c] < self.height) & ~terminal)
            kids.append(self.pack(h.clamp(max=self.height), other))
        return torch.stack(kids, 1), torch.stack(legal, 1)

    def profiles_of(self, level: torch.Tensor, row: torch.Tensor
                    ) -> torch.Tensor:
        """[B, w] column heights of (level, row) pairs."""
        out = torch.zeros((level.shape[0], self.width), dtype=torch.int64,
                          device=level.device)
        for L in torch.unique(level).tolist():
            sel = level == L
            out[sel] = self.profiles[L][row[sel]]
        return out

    # -- the solve -----------------------------------------------------------

    def _lanes(self, L: int, block: int):
        """(row, rank) of every encodable position of level L, in blocks
        of lanes in flat order (row * C + rank)."""
        C = self.size[L]
        n = self.profiles[L].shape[0] * C
        for a in range(0, n, block):
            flat = torch.arange(a, min(a + block, n), dtype=torch.int64,
                                device=self.device)
            yield flat, flat // C, flat % C

    def _position(self, L: int, row, rank):
        """-> (p1, terminal) of lanes of level L."""
        p1 = self.unrank(L, row, rank)
        p2 = self.filled[L][row] ^ p1
        return p1, self.has_line(p1) | self.has_line(p2)

    def _child_flat(self, L: int, c: int, row, p1):
        """(legal, flat index into level L+1) of the move in column c."""
        crow = self.child_row[L][row, c]
        legal = crow >= 0
        crow = crow.clamp(min=0)
        hc = self.profiles[L][row, c].clamp(max=self.height - 1)
        newbit = 1 << (c * self.h1 + hc)
        cp1 = p1 | newbit if L % 2 == 0 else p1
        crank = self.rank(L + 1, crow, cp1)
        return legal, crow * self.size[L + 1] + crank

    def solve(self, remoteness_bits: int = 6, block: int = 1 << 23
              ) -> Solution:
        """Reachability forward, then the retrograde sweep backward.

        remoteness_bits below 6 stores remoteness saturating at
        2**bits - 1, the precision a cheaper table would keep: the
        benchmark's control, which the comparison has to reject."""
        n, dev = self.ncells, self.device
        rmax = (1 << remoteness_bits) - 1
        reach = {0: torch.ones((1, 1), dtype=torch.bool, device=dev)}
        moves = {}
        for L in range(n):
            nxt = torch.zeros((self.profiles[L + 1].shape[0],
                               self.size[L + 1]), dtype=torch.bool,
                              device=dev).reshape(-1)
            live_ids = reach[L].reshape(-1).nonzero().reshape(-1)
            C = self.size[L]
            pairs = 0
            for a in range(0, live_ids.numel(), block):
                flat = live_ids[a:a + block]
                row, rank = flat // C, flat % C
                p1, term = self._position(L, row, rank)
                for c in range(self.width):
                    legal, cflat = self._child_flat(L, c, row, p1)
                    legal &= ~term
                    pairs += int(legal.sum())
                    nxt[cflat[legal]] = True
            moves[L] = pairs
            reach[L + 1] = nxt.reshape(self.profiles[L + 1].shape[0], -1)
        moves[n] = 0

        cells = {}
        top = torch.empty((self.profiles[n].shape[0], self.size[n]),
                          dtype=torch.uint8, device=dev).reshape(-1)
        for flat, row, rank in self._lanes(n, block):
            _, term = self._position(n, row, rank)
            top[flat] = torch.where(term, LOSE, TIE).to(torch.uint8)
        cells[n] = top.reshape(self.profiles[n].shape[0], -1)
        for L in range(n - 1, -1, -1):
            child = cells[L + 1].reshape(-1)
            out = torch.empty(self.profiles[L].shape[0] * self.size[L],
                              dtype=torch.uint8, device=dev)
            for flat, row, rank in self._lanes(L, block):
                p1, term = self._position(L, row, rank)
                any_lose = torch.zeros_like(term)
                any_tie = torch.zeros_like(term)
                min_lose = torch.full_like(row, 1 << 30)
                max_tie = torch.full_like(row, -1)
                max_all = torch.full_like(row, -1)
                for c in range(self.width):
                    legal, cflat = self._child_flat(L, c, row, p1)
                    cell = child[torch.where(legal, cflat, 0)].to(torch.int64)
                    v, r = cell & 3, cell >> 2
                    lose, tie = legal & (v == LOSE), legal & (v == TIE)
                    any_lose |= lose
                    any_tie |= tie
                    min_lose = torch.where(lose, torch.minimum(min_lose, r),
                                           min_lose)
                    max_tie = torch.where(tie, torch.maximum(max_tie, r),
                                          max_tie)
                    max_all = torch.where(legal, torch.maximum(max_all, r),
                                          max_all)
                value = torch.where(any_lose, WIN,
                                    torch.where(any_tie, TIE, LOSE))
                rem = 1 + torch.where(any_lose, min_lose,
                                      torch.where(any_tie, max_tie, max_all))
                value = torch.where(term, LOSE, value)
                rem = torch.where(term, 0, rem).clamp(0, rmax)
                out[flat] = (value | (rem << 2)).to(torch.uint8)
            cells[L] = out.reshape(self.profiles[L].shape[0], -1)
        root = int(cells[0][0, 0])
        reachable = {L: int(r.sum()) for L, r in reach.items()}
        return Solution(cells=cells, reach=reach, reachable=reachable,
                        moves=moves, value=root & 3, remoteness=root >> 2,
                        positions=sum(reachable.values()))


# -- judging the program's outputs ---------------------------------------------


def check_solve(board: Board, sol: Solution, cells, levels, device
                ) -> int:
    """Reachable positions that a solve's output gets wrong, every level:
    judged from its dense cells (level -> [P, C] uint8, the reference's
    layout) where it has a level's, else from its table (level -> states
    sorted ascending, values, remoteness). A level that has neither counts
    every reachable position of it. Only reachable positions are judged:
    what an engine writes for an unreachable one (a placeholder) is not
    part of the solve."""
    bad = 0
    for L in sol.reach:
        if cells and L in cells:
            bad += check_dense_level(sol, L, cells[L], device)
        elif levels and L in levels:
            bad += check_table_level(board, sol, L, levels[L])
        else:
            bad += sol.reachable[L]
    return bad


def check_dense_level(sol: Solution, L: int, got, device) -> int:
    """Reachable cells of level L that differ from the reference's; a
    misshapen level counts all of them."""
    want, reach = sol.cells[L], sol.reach[L]
    if tuple(got.shape) != tuple(want.shape):
        return sol.reachable[L]
    got = torch.as_tensor(got).to(device)
    return int(((got != want.to(device)) & reach.to(device)).sum())


def check_table_level(board: Board, sol: Solution, L: int, t,
                      block: int = 1 << 23) -> int:
    """Entries of the classic engine's table of level L (states sorted
    ascending, values, remoteness) that are wrong: a state that is not a
    reachable position of the level, a repeated state, a value or
    remoteness that differs from the reference; plus the reachable
    positions the table lacks. A reachable position counts once, as its
    cell does in check_dense_level."""
    reach = sol.reach[L]
    states = torch.as_tensor(t.states)
    values = torch.as_tensor(t.values)
    rems = torch.as_tensor(t.remoteness)
    found = bad = 0
    for a in range(0, states.shape[0], block):
        s = states[a:a + block].to(board.device)
        lvl, row, rank, _, ok = board.locate(s)
        ok &= lvl == L
        row, rank = row.clamp(min=0), rank.clamp(0, board.size[L] - 1)
        ok &= reach[row, rank]
        if s.numel() > 1:
            ok[1:] &= s[1:] > s[:-1]
        if a > 0:
            ok[0] &= bool(s[0] > states[a - 1])
        cell = sol.cells[L][row, rank].to(torch.int64)
        good = (ok & (values[a:a + block].to(board.device) == (cell & 3))
                & (rems[a:a + block].to(board.device).to(torch.int64)
                   == (cell >> 2)))
        found += int(ok.sum())
        bad += int((~good).sum())
    return bad + sol.reachable[L] - found


def lookup(board: Board, sol: Solution, states: torch.Tensor):
    """(cells, reachable) of packed states: each state's byte in the
    reference's tables, and whether it is a reachable position."""
    lvl, row, rank, _, ok = board.locate(states)
    cell = torch.zeros_like(states)
    for L in torch.unique(lvl[ok]).tolist():
        sel = ok & (lvl == L)
        r, k = row[sel], rank[sel]
        ok[sel] &= sol.reach[L][r, k]
        cell[sel] = sol.cells[L][r, k].to(torch.int64)
    return cell, ok


def check_answers(board: Board, sol: Solution, states, values, rems, bests
                  ) -> int:
    """Query answers that are wrong. states: packed positions asked;
    values: value names; rems: remoteness; bests: the packed best child or
    None. A reachable position must come back with the reference's value
    and remoteness, and a best move iff it has moves: a legal child whose
    value is what the position's value needs (LOSE for a WIN, WIN for a
    LOSE, TIE for a TIE) at one less remoteness."""
    dev = board.device
    s = torch.as_tensor(states, dtype=torch.int64).to(dev)
    want, ok = lookup(board, sol, s)
    names = {v: k for k, v in VALUE_NAMES.items()}
    got_v = torch.tensor([names.get(v, 0) for v in values], device=dev)
    got_r = torch.tensor([-1 if r is None else int(r) for r in rems],
                         dtype=torch.int64, device=dev)
    good = ok & (got_v == (want & 3)) & (got_r == (want >> 2))
    kids, legal = board.children(s)
    has_best = torch.tensor([b is not None for b in bests], device=dev)
    good &= has_best == legal.any(1)
    best = torch.tensor([0 if b is None else int(b) for b in bests],
                        dtype=torch.int64, device=dev)
    need = torch.tensor([0, LOSE, WIN, TIE], device=dev)[want & 3]
    bcell, bok = lookup(board, sol, best)
    best_ok = (bok & ((kids == best[:, None]) & legal).any(1)
               & ((bcell & 3) == need) & ((bcell >> 2) == (want >> 2) - 1))
    good &= ~has_best | best_ok
    return int((~good).sum())
