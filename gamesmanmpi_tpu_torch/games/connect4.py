"""Connect-N on a w x h board, column-drop rules (port of
gamesmanmpi_tpu/games/connect4.py).

State encoding, as in the reference: column c occupies bits
[c*(h+1), c*(h+1)+h] — h cell bits plus one guard. The guard is a single
1 at bit `height` (stones in the column); below it the set bits are the
stones of the player to move. An empty column is 0b1. The encoding fits
(h+1)*w <= 63 bits, so the port's int64 carrier holds it exactly.

A move in column c is branch-free: with g the column's guard bit,
    child = opponent_stones | (guards + g).
The win test is the 4-direction bitboard fold {1, h, h+1, h+2} on the
last mover's stones. Guards are found with the reference's masked
down-smear (its default "bitboard" decompose). With ``sym=1`` the
left-right mirror canonicalizes (min of the state and its mirror).
"""

from __future__ import annotations

import torch

from gamesmanmpi_tpu_torch.core.bitops import popcount
from gamesmanmpi_tpu_torch.core.values import LOSE, TIE, UNDECIDED
from gamesmanmpi_tpu_torch.games.base import TensorGame


class Connect4(TensorGame):
    uniform_level_jump = True  # every move drops exactly one stone

    def __init__(self, width: int = 7, height: int = 6, connect: int = 4,
                 sym: bool = False):
        if (height + 1) * width > 63:
            raise ValueError("board too large for 63-bit packing")
        self.width, self.height, self.connect = width, height, connect
        self.sym = bool(sym)
        suffix = "_sym" if self.sym else ""
        self.name = f"connect{connect}_{width}x{height}{suffix}"
        self.max_moves = width
        self.num_levels = width * height + 1
        self.max_level_jump = 1
        self.state_bits = (height + 1) * width
        h1 = height + 1
        self._col_masks = [((1 << h1) - 1) << (c * h1) for c in range(width)]
        self._top_bits = [1 << (c * h1 + height) for c in range(width)]
        self._full_mask = sum(((1 << height) - 1) << (c * h1)
                              for c in range(width))
        self._bottom_mask = sum(1 << (c * h1) for c in range(width))
        # {vertical, diag down, horizontal, diag up} strides.
        self._dirs = (1, height, h1, height + 2)
        # Down-smear masks: shifting the word right by i moves a column's
        # bottom bits into the column below, always to in-column offset
        # >= h1-i, while every legitimate smear stays below h1-i.
        self._smear_keep = {}
        i = 1
        while i <= max(height, 1):
            self._smear_keep[i] = sum(((1 << (h1 - i)) - 1) << (c * h1)
                                      for c in range(width))
            i <<= 1

    def initial_state(self) -> int:
        return self._bottom_mask

    def _mirror(self, states):
        """Reflect the board left-right: column c <-> column w-1-c."""
        h1 = self.height + 1
        out = torch.zeros_like(states)
        for c in range(self.width):
            col = (states >> (c * h1)) & self._col_masks[0]
            out = out | (col << ((self.width - 1 - c) * h1))
        return out

    def canonicalize(self, states):
        """min(state, mirror) with sym=1: mirroring commutes with drops
        and preserves wins, so this picks one representative per class."""
        if not self.sym:
            return states
        return torch.minimum(states, self._mirror(states))

    def _decompose(self, states):
        """-> (guards, filled, current, opponent) int64 bitboards."""
        smear = states
        i = 1
        while i <= self.height:
            smear = smear | ((smear >> i) & self._smear_keep[i])
            i <<= 1
        guards = smear ^ ((smear >> 1) & self._smear_keep[1])
        filled = smear ^ guards
        current = states ^ guards
        opponent = filled ^ current
        return guards, filled, current, opponent

    def expand(self, states):
        guards, _, _, opponent = self._decompose(states)
        children = []
        masks = []
        for c in range(self.width):
            g = guards & self._col_masks[c]
            children.append(opponent | (guards + g))
            masks.append((guards & self._top_bits[c]) == 0)
        return torch.stack(children, dim=-1), torch.stack(masks, dim=-1)

    def _connected(self, stones):
        won = torch.zeros(stones.shape, dtype=torch.bool, device=stones.device)
        for d in self._dirs:
            x = stones
            for i in range(1, self.connect):
                x = x & (stones >> (d * i))
            won = won | (x != 0)
        return won

    def primitive(self, states):
        _, filled, _, opponent = self._decompose(states)
        lost = self._connected(opponent)
        full = filled == self._full_mask
        out = torch.full(states.shape, UNDECIDED, dtype=torch.uint8,
                         device=states.device)
        out = torch.where(full, torch.full_like(out, TIE), out)
        return torch.where(lost, torch.full_like(out, LOSE), out)

    def level_of(self, states):
        _, filled, _, _ = self._decompose(states)
        return popcount(filled)

    def describe(self, state) -> str:
        s = int(state)
        h1 = self.height + 1
        cols = [(s >> (c * h1)) & ((1 << h1) - 1) for c in range(self.width)]
        heights = [cv.bit_length() - 1 for cv in cols]
        cur_char, opp_char = ("X", "O") if sum(heights) % 2 == 0 else ("O", "X")
        rows = []
        for r in range(self.height - 1, -1, -1):
            row = ""
            for c in range(self.width):
                if r >= heights[c]:
                    row += "."
                elif (cols[c] >> r) & 1:
                    row += cur_char
                else:
                    row += opp_char
            rows.append(row)
        return "\n".join(rows)
