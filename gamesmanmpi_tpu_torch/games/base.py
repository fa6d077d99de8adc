"""The tensorized game-plugin boundary (port of gamesmanmpi_tpu/games/base.py).

A game is expressed over batches of bit-packed positions: ``expand`` fuses
gen_moves+do_move over a batch, ``primitive`` is vectorized, and
``level_of`` is a topological level (every move strictly raises it, by at
most ``max_level_jump``). In the port the packed positions are int64
tensors (core/bitops.py says why), on whatever device the caller's batch
lives.

Contracts kept from the reference so game kernels stay branch-free:
  - expand returns (children [B, max_moves] int64, mask [B, max_moves]
    bool); lanes with mask False are ignored by the engine.
  - primitive returns uint8 values from the perspective of the player to
    move (WIN/LOSE/TIE/UNDECIDED), UNDECIDED meaning non-terminal.
  - canonicalize maps a state to its symmetry-class representative
    (identity unless the game opts in with ``sym=1``); it is a game
    automorphism projection, so values are invariant within a class.

The engine calls the kernels on real states only: levels run at their
exact sizes, so no padding lane reaches a game.
"""

from __future__ import annotations

import abc

from gamesmanmpi_tpu_torch.core.bitops import sentinel_for, state_dtype_for


class TensorGame(abc.ABC):
    """A two-player abstract game over batches of packed int64 states."""

    #: short name used by the registry / CLI
    name: str = "game"
    #: static maximum number of moves from any position
    max_moves: int
    #: upper bound (exclusive) on level_of over reachable states; the
    #: engine enforces it during forward discovery
    num_levels: int
    #: max of level_of(child) - level_of(parent) over all moves
    max_level_jump: int = 1
    #: bits a packed state occupies; at most 63 so int64 holds it exactly
    state_bits: int = 63
    #: True when every move advances level_of by exactly 1 (the engine's
    #: device-resident fast path)
    uniform_level_jump: bool = False

    @property
    def state_dtype(self):
        """The reference's numpy dtype for a packed state (uint32/uint64):
        the dtype of tables exchanged with it (core/bitops.to_reference)."""
        return state_dtype_for(self.state_bits)

    @property
    def sentinel(self):
        """The reference's padding sentinel in this game's state dtype."""
        return sentinel_for(self.state_dtype)

    def canonicalize(self, states):
        """Symmetry-class representative of each state (identity here)."""
        return states

    @abc.abstractmethod
    def initial_state(self) -> int:
        """The packed initial position."""

    @abc.abstractmethod
    def expand(self, states):
        """Batched gen_moves+do_move: [B] -> (children [B, M], mask [B, M])."""

    @abc.abstractmethod
    def primitive(self, states):
        """Batched primitive value: [B] -> uint8 [B]."""

    @abc.abstractmethod
    def level_of(self, states):
        """Topological level of each state: [B] -> int32 [B]."""

    def describe(self, state) -> str:
        """Human-readable rendering of one packed state (debugging)."""
        return f"{self.name} state {int(state):#x}"
