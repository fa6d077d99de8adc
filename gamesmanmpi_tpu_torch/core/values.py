"""Game-theoretic value algebra (port of gamesmanmpi_tpu/core/values.py).

Values are uint8 from the perspective of the player to move:
WIN iff some child is LOSE; else TIE iff some child is TIE; else LOSE
(vacuously with no children). Remoteness: WIN -> 1 + min over LOSE
children, LOSE -> 1 + max over all children, TIE -> 1 + max over TIE
children; primitives have remoteness 0.
"""

import numpy as np

# uint8 encodings. UNDECIDED doubles as "not yet resolved" in tables.
UNDECIDED = 0
WIN = 1
LOSE = 2
TIE = 3

VALUE_NAMES = {UNDECIDED: "UNDECIDED", WIN: "WIN", LOSE: "LOSE", TIE: "TIE"}

# negate: WIN <-> LOSE, TIE -> TIE, UNDECIDED -> UNDECIDED.
_NEGATE_TABLE = np.array([UNDECIDED, LOSE, WIN, TIE], dtype=np.uint8)

# The +inf pad of masked min-reductions (ops/combine.py); the reference
# packs remoteness into 30 bits with the same bound.
MAX_REMOTENESS = (1 << 30) - 1


def negate(values):
    """Negate a uint8 value tensor (child value -> parent's view)."""
    import torch

    table = torch.as_tensor(_NEGATE_TABLE, device=values.device)
    return table[values.long()]


def negate_np(values):
    """NumPy twin of `negate` for host-side code."""
    return _NEGATE_TABLE[values]


def value_name(v) -> str:
    """Human-readable name of a value constant (rank-0 output formatting)."""
    return VALUE_NAMES[int(v)]
