"""Parent value/remoteness combine (port of gamesmanmpi_tpu/ops/combine.py).

Children are regenerated aligned per parent, so the frontier's negamax
reduce is two masked row-reductions over a [B, M] block.
"""

import torch

from gamesmanmpi_tpu_torch.core.values import (
    LOSE,
    MAX_REMOTENESS,
    REMOTENESS_DTYPE,
    TIE,
    VALUE_DTYPE,
    WIN,
)


def combine_children(child_values, child_remoteness, mask):
    """Combine child results into parent (value, remoteness).

    child_values: [B, M] uint8 (child-perspective values).
    child_remoteness: [B, M] integer.
    mask: [B, M] bool — True where a real child exists.

    Rules: value WIN if any child LOSE; else TIE if any child TIE; else
    LOSE (vacuously, remoteness 0, with no children). Remoteness:
    WIN -> 1 + min over LOSE children, LOSE -> 1 + max over all children,
    TIE -> 1 + max over TIE children.
    Returns (values [B] uint8, remoteness [B] int32).
    """
    cv = child_values
    cr = child_remoteness.to(REMOTENESS_DTYPE)

    lose = mask & (cv == LOSE)
    tie = mask & (cv == TIE)
    any_lose = lose.any(dim=-1)
    any_tie = tie.any(dim=-1)

    def const(v):
        return torch.full(any_lose.shape, v, dtype=VALUE_DTYPE,
                          device=cv.device)

    values = torch.where(any_lose, const(WIN),
                         torch.where(any_tie, const(TIE), const(LOSE)))

    big = torch.full_like(cr, MAX_REMOTENESS)
    neg = torch.full_like(cr, -1)
    win_rem = 1 + torch.where(lose, cr, big).amin(dim=-1)
    lose_rem = 1 + torch.where(mask, cr, neg).amax(dim=-1)
    tie_rem = 1 + torch.where(tie, cr, neg).amax(dim=-1)

    remoteness = torch.where(any_lose, win_rem,
                             torch.where(any_tie, tie_rem, lose_rem))
    return values, remoteness.to(REMOTENESS_DTYPE)
