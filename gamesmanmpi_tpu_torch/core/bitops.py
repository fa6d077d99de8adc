"""Bit primitives on int64 bitboards (port of gamesmanmpi_tpu/core/bitops.py).

The reference carries states in uint32/uint64; torch implements neither
``>>`` nor ``searchsorted`` for its unsigned 32/64-bit types, so the port
carries them in signed int64. That is exact because every state fits 63
bits (games/base.py), so the sign bit is never set and arithmetic right
shifts behave as logical ones.
"""

import torch

_M1 = 0x5555_5555_5555_5555
_M2 = 0x3333_3333_3333_3333
_M4 = 0x0F0F_0F0F_0F0F_0F0F


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Population count of non-negative int64 values, as int32.

    SWAR bit counting; the byte sums are folded with shifts instead of the
    usual multiply so nothing overflows the signed carrier.
    """
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return (x & 0x7F).to(torch.int32)


def msb_index(x: torch.Tensor) -> torch.Tensor:
    """Index of the most-significant set bit of positive int64 values.

    A six-step binary search over shift widths (torch has no clz).
    """
    out = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for s in (32, 16, 8, 4, 2, 1):
        hi = (x >> s) != 0
        x = torch.where(hi, x >> s, x)
        out = out + hi.to(torch.int32) * s
    return out
