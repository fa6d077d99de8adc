"""Nim, multi-heap, normal and misère (port of gamesmanmpi_tpu/games/nim.py).

State layout, as in the reference: heap i occupies `bits` bits starting at
i*bits, `bits` sized to hold the largest initial heap. A move removes
1..heap[i] objects from one heap: a subtraction at the heap's offset.
Terminal: all heaps empty — LOSE for the player to move in normal play,
WIN in misère. Moves jump levels by up to the largest heap, so this is a
generic-path game.
"""

from __future__ import annotations

import torch

from gamesmanmpi_tpu_torch.core.values import LOSE, UNDECIDED, WIN
from gamesmanmpi_tpu_torch.games.base import TensorGame


class Nim(TensorGame):
    def __init__(self, heaps=(3, 4, 5), misere: bool = False):
        self.heaps = tuple(int(h) for h in heaps)
        if not self.heaps or min(self.heaps) < 0:
            raise ValueError("heaps must be non-negative")
        self.misere = misere
        self.bits = max(max(self.heaps), 1).bit_length()
        if self.bits * len(self.heaps) > 63:
            raise ValueError("heaps too large for 63-bit packing")
        suffix = "m" if misere else ""
        self.name = f"nim_{'-'.join(map(str, self.heaps))}{suffix}"
        # Moves are (heap, amount) pairs, amount in 1..initial[heap].
        self._move_list = [
            (i, t) for i, h in enumerate(self.heaps) for t in range(1, h + 1)
        ]
        self.max_moves = max(len(self._move_list), 1)
        self.num_levels = sum(self.heaps) + 1
        self.max_level_jump = max(max(self.heaps), 1)
        self.state_bits = self.bits * len(self.heaps)
        self._heap_mask = (1 << self.bits) - 1

    def initial_state(self) -> int:
        s = 0
        for i, h in enumerate(self.heaps):
            s |= h << (i * self.bits)
        return s

    def _heaps(self, states):
        """[...] packed -> [..., H] int64 heap sizes."""
        shifts = torch.arange(len(self.heaps), dtype=torch.int64,
                              device=states.device) * self.bits
        return (states.unsqueeze(-1) >> shifts) & self._heap_mask

    def expand(self, states):
        dev = states.device
        # All heaps empty from the start: one move that is never legal.
        heap_of = torch.tensor([i for i, _ in self._move_list] or [0],
                               dtype=torch.int64, device=dev)
        take = torch.tensor([t for _, t in self._move_list] or [1],
                            dtype=torch.int64, device=dev)
        children = states.unsqueeze(-1) - (take << (heap_of * self.bits))
        return children, self._heaps(states)[..., heap_of] >= take

    def primitive(self, states):
        out = torch.full(states.shape, UNDECIDED, dtype=torch.uint8,
                         device=states.device)
        return out.masked_fill(states == 0, WIN if self.misere else LOSE)

    def level_of(self, states):
        total = self._heaps(states).sum(dim=-1)
        return (sum(self.heaps) - total).to(torch.int32)
