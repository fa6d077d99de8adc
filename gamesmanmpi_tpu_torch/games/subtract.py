"""Subtraction games (port of gamesmanmpi_tpu/games/subtract.py).

Start from `total` objects; a move removes any amount in `moves`. In
normal play the player who cannot move (0 left) has lost (primitive
LOSE); in misère play they have won (primitive WIN). State = objects
remaining. Removing s objects advances the level by s, so this is a
generic-path game with a multi-level lookup window.
"""

from __future__ import annotations

import torch

from gamesmanmpi_tpu_torch.core.values import LOSE, UNDECIDED, WIN
from gamesmanmpi_tpu_torch.games.base import TensorGame


class Subtract(TensorGame):
    def __init__(self, total: int = 10, moves=(1, 2), misere: bool = False):
        self.total = int(total)
        self.moves = tuple(sorted(int(m) for m in moves))
        if not self.moves or self.moves[0] < 1:
            raise ValueError("moves must be positive")
        self.misere = misere
        suffix = "m" if misere else ""
        self.name = f"subtract_{total}_{'-'.join(map(str, self.moves))}{suffix}"
        self.max_moves = len(self.moves)
        self.num_levels = self.total + 1
        self.max_level_jump = self.moves[-1]
        self.state_bits = max(int(self.total).bit_length(), 1)

    def initial_state(self) -> int:
        return self.total

    def expand(self, states):
        moves = torch.tensor(self.moves, dtype=torch.int64,
                             device=states.device)
        s = states.unsqueeze(-1)
        return s - moves, s >= moves

    def primitive(self, states):
        out = torch.full(states.shape, UNDECIDED, dtype=torch.uint8,
                         device=states.device)
        return out.masked_fill(states == 0, WIN if self.misere else LOSE)

    def level_of(self, states):
        return (self.total - states).to(torch.int32)
