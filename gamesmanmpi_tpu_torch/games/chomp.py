"""Chomp, the poisoned-cookie game (port of gamesmanmpi_tpu/games/chomp.py).

A width x height bar; a move picks a remaining cookie and eats it with
every cookie above and to the right; the player left with only the
poisoned bottom-left cookie loses (primitive LOSE there).

State encoding, as in the reference: the remaining cookies form a
staircase, so the position is the vector of column heights
h_0 >= ... >= h_{w-1}, packed little-endian at bit_length(height) bits per
column. A move at (col c, row r) clamps every column >= c to height r.
The port applies all w*h-1 moves at once as one [B, moves, w] clamp.
Moves jump levels arbitrarily: a generic-path game. With ``sym=1``
(square boards) the transposed staircase canonicalizes.
"""

from __future__ import annotations

import torch

from gamesmanmpi_tpu_torch.core.bitops import SENTINEL
from gamesmanmpi_tpu_torch.core.values import LOSE, UNDECIDED
from gamesmanmpi_tpu_torch.games.base import TensorGame


class Chomp(TensorGame):
    def __init__(self, width: int = 4, height: int = 3, sym: bool = False):
        if width < 1 or height < 1:
            raise ValueError("board must be at least 1x1")
        self.w = int(width)
        self.h = int(height)
        self.sym = bool(sym)
        if self.sym and self.w != self.h:
            raise ValueError("sym=1 (transpose symmetry) needs a square board")
        self.bits = max(int(self.h).bit_length(), 1)  # heights 0..h
        self.state_bits = self.bits * self.w
        if self.state_bits > 63:
            raise ValueError(f"board too large to pack: {width}x{height}")
        suffix = "_sym" if self.sym else ""
        self.name = f"chomp_{width}x{height}{suffix}"
        # Static move list: every cell but the poisoned (0, 0).
        self._moves = [
            (c, r)
            for c in range(self.w)
            for r in range(self.h)
            if (c, r) != (0, 0)
        ]
        self.max_moves = max(len(self._moves), 1)
        self.num_levels = self.w * self.h
        self.max_level_jump = max(self.w * self.h - 1, 1)
        self.uniform_level_jump = False

    def _shifts(self, device):
        return torch.arange(self.w, dtype=torch.int64, device=device) * self.bits

    def _heights(self, states):
        """[...] packed -> [..., w] int64 column heights."""
        mask = (1 << self.bits) - 1
        return (states.unsqueeze(-1) >> self._shifts(states.device)) & mask

    def _pack(self, heights):
        """[..., w] heights -> [...] packed (fields never overlap, so the
        sum is the OR)."""
        return (heights << self._shifts(heights.device)).sum(dim=-1)

    def canonicalize(self, states):
        """min(state, transpose) for square boards with sym=1; the
        transposed height vector is h'_r = #{c : h_c > r}."""
        if not self.sym:
            return states
        hs = self._heights(states).unsqueeze(-2)  # [..., 1, w]
        rows = torch.arange(self.h, dtype=torch.int64, device=states.device)
        flipped = self._pack((hs > rows.unsqueeze(-1)).sum(dim=-1))
        return torch.minimum(states, flipped)

    def initial_state(self) -> int:
        packed = 0
        for c in range(self.w):
            packed |= self.h << (c * self.bits)
        return packed

    def expand(self, states):
        dev = states.device
        if not self._moves:  # 1x1 board: poison only, no legal moves ever
            shape = states.shape + (1,)
            return (torch.full(shape, SENTINEL, dtype=torch.int64, device=dev),
                    torch.zeros(shape, dtype=torch.bool, device=dev))
        cs = torch.tensor([c for c, _ in self._moves], device=dev)
        rs = torch.tensor([r for _, r in self._moves], dtype=torch.int64,
                          device=dev)
        hs = self._heights(states)                       # [B, w]
        cols = torch.arange(self.w, device=dev)
        eaten = cols.unsqueeze(0) >= cs.unsqueeze(-1)   # [moves, w]
        h3 = hs.unsqueeze(-2)                            # [B, 1, w]
        clamped = torch.where(eaten, torch.minimum(h3, rs.unsqueeze(-1)), h3)
        return self._pack(clamped), hs[..., cs] > rs

    def primitive(self, states):
        # Poison-only board: h = (1, 0, ..., 0), packed == 1.
        out = torch.full(states.shape, UNDECIDED, dtype=torch.uint8,
                         device=states.device)
        return out.masked_fill(states == 1, LOSE)

    def level_of(self, states):
        return (self.w * self.h - self._heights(states).sum(dim=-1)).to(
            torch.int32)

    def describe(self, state) -> str:
        hs = [(int(state) >> (c * self.bits)) & ((1 << self.bits) - 1)
              for c in range(self.w)]
        return f"{self.name} heights={hs}"
