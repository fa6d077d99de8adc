"""Generalized m,n,k tic-tac-toe (port of gamesmanmpi_tpu/games/tictactoe.py).

State layout, as in the reference: bits [0, m*n) are X's stones, bits
[m*n, 2*m*n) are O's stones, cell index = row * n + col. Player to move:
X iff popcount(X plane) == popcount(O plane). Primitive (perspective of
the player to move): the last mover has k in a row -> LOSE; else a full
board -> TIE; else UNDECIDED.

With ``sym=1`` the board's symmetry group (dihedral for square boards,
the Klein group for rectangular ones) canonicalizes to the minimum packed
image. A cell permutation moves each bit by a fixed distance, so each
transform is applied as one masked shift per distinct distance rather
than one per cell.
"""

from __future__ import annotations

import torch

from gamesmanmpi_tpu_torch.core.bitops import popcount
from gamesmanmpi_tpu_torch.core.values import LOSE, TIE, UNDECIDED
from gamesmanmpi_tpu_torch.games.base import TensorGame


def _win_lines(m: int, n: int, k: int) -> list:
    """All k-in-a-row masks on the X bit-plane (bits 0..m*n), sorted."""
    lines = set()
    for r in range(m):
        for c in range(n):
            for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
                rr, cc = r + dr * (k - 1), c + dc * (k - 1)
                if 0 <= rr < m and 0 <= cc < n:
                    mask = 0
                    for i in range(k):
                        mask |= 1 << ((r + dr * i) * n + c + dc * i)
                    lines.add(mask)
    return sorted(lines)


class TicTacToe(TensorGame):
    uniform_level_jump = True  # every move places exactly one stone

    def __init__(self, m: int = 3, n: int = 3, k: int = 3, sym: bool = False):
        if 2 * m * n > 63:
            raise ValueError("board too large for 63-bit packing")
        self.m, self.n, self.k = m, n, k
        self.cells = m * n
        self.sym = bool(sym)
        suffix = "_sym" if self.sym else ""
        self.name = f"tictactoe_{m}x{n}x{k}{suffix}"
        self.max_moves = self.cells
        self.num_levels = self.cells + 1
        self.max_level_jump = 1
        self.state_bits = 2 * self.cells
        self._lines = _win_lines(m, n, k)
        self._plane_mask = (1 << self.cells) - 1
        self._sym_shifts = (
            [self._shift_masks(p) for p in self._board_symmetries()]
            if self.sym else []
        )

    def initial_state(self) -> int:
        return 0

    def _board_symmetries(self):
        """Cell permutations of the board's symmetry group, identity
        excluded; perm[dst] = src cell index."""
        m, n = self.m, self.n
        coord_maps = [
            lambda r, c: (r, n - 1 - c),          # horizontal flip
            lambda r, c: (m - 1 - r, c),          # vertical flip
            lambda r, c: (m - 1 - r, n - 1 - c),  # 180 rotation
        ]
        if m == n:
            coord_maps += [
                lambda r, c: (c, r),                      # main transpose
                lambda r, c: (n - 1 - c, m - 1 - r),      # anti transpose
                lambda r, c: (c, m - 1 - r),              # rot 90
                lambda r, c: (n - 1 - c, r),              # rot 270
            ]
        perms = []
        for f in coord_maps:
            perm = [0] * self.cells
            for r in range(m):
                for c in range(n):
                    sr, sc = f(r, c)
                    perm[r * n + c] = sr * n + sc
            perms.append(tuple(perm))
        return sorted(set(perms))

    def _shift_masks(self, perm):
        """[(distance dst-src, source-bit mask over both planes)]."""
        by_shift: dict = {}
        for dst, src in enumerate(perm):
            bits = (1 << src) | (1 << (self.cells + src))
            by_shift[dst - src] = by_shift.get(dst - src, 0) | bits
        return sorted(by_shift.items())

    def canonicalize(self, states):
        """Min over the board symmetry group applied to both planes."""
        if not self.sym:
            return states
        best = states
        for shifts in self._sym_shifts:
            out = torch.zeros_like(states)
            for d, mask in shifts:
                part = states & mask
                out = out | (part << d if d >= 0 else part >> -d)
            best = torch.minimum(best, out)
        return best

    def _planes(self, states):
        return states & self._plane_mask, (states >> self.cells) & self._plane_mask

    def expand(self, states):
        x, o = self._planes(states)
        occupied = (x | o).unsqueeze(-1)
        bits = 1 << torch.arange(self.cells, dtype=torch.int64,
                                 device=states.device)
        # The mover's stone lands at cell i on their own plane.
        shift = torch.where(popcount(x) == popcount(o), 0,
                            self.cells).to(torch.int64).unsqueeze(-1)
        children = states.unsqueeze(-1) | (bits << shift)
        return children, (occupied & bits) == 0

    def primitive(self, states):
        x, o = self._planes(states)
        # Last mover is the player NOT to move.
        last = torch.where(popcount(x) == popcount(o), o, x).unsqueeze(-1)
        lines = torch.tensor(self._lines, dtype=torch.int64,
                             device=states.device)
        won = ((last & lines) == lines).any(dim=-1)
        full = (x | o) == self._plane_mask
        out = torch.full(states.shape, UNDECIDED, dtype=torch.uint8,
                         device=states.device)
        out = out.masked_fill(full, TIE)
        return out.masked_fill(won, LOSE)

    def level_of(self, states):
        return popcount(states)

    def describe(self, state) -> str:
        s = int(state)
        rows = []
        for r in range(self.m):
            row = ""
            for c in range(self.n):
                i = r * self.n + c
                if (s >> i) & 1:
                    row += "X"
                elif (s >> (self.cells + i)) & 1:
                    row += "O"
                else:
                    row += "."
            rows.append(row)
        return "\n".join(rows)
