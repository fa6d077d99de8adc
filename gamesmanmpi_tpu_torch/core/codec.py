"""Packed table-cell codec (port of gamesmanmpi_tpu/core/codec.py).

A solved position's record is one uint32 cell: the value in the low 2
bits, the remoteness (clipped to MAX_REMOTENESS) in the other 30.

torch has no ``<<``/``>>``/``+`` for uint32, so the arithmetic runs on an
int64 widening and the result is narrowed back through an int32 view
(same bits): :func:`pack_cells` returns uint32, :func:`unpack_cells`
takes it. The numpy twins live in core/host.py (no torch) and serve
host-side writers (``--table-out``, the DB).
"""

import torch

from gamesmanmpi_tpu_torch.core.host import (  # noqa: F401
    VALUE_BITS as _VALUE_BITS,
    VALUE_MASK as _VALUE_MASK,
    pack_cells_np,
    unpack_cells_np,
)
from gamesmanmpi_tpu_torch.core.values import MAX_REMOTENESS

_U32 = 0xFFFF_FFFF


def u32_to_i64(x: torch.Tensor) -> torch.Tensor:
    """Zero-extend a uint32 tensor into int64 (through an int32 view)."""
    return x.view(torch.int32).to(torch.int64) & _U32


def i64_to_u32(w: torch.Tensor) -> torch.Tensor:
    """Narrow int64 values to uint32 bits, mod 2^32, with no signed
    overflow: shift into the int32 range, convert, then view."""
    signed = ((w + (1 << 31)) & _U32) - (1 << 31)
    return signed.to(torch.int32).view(torch.uint32)


def pack_cells(values: torch.Tensor, remoteness: torch.Tensor) -> torch.Tensor:
    """uint8 values + integer remoteness -> uint32 cells."""
    v = values.to(torch.int64) & _VALUE_MASK
    r = remoteness.to(torch.int64).clamp(0, MAX_REMOTENESS)
    return i64_to_u32(v | (r << _VALUE_BITS))


def unpack_cells(cells: torch.Tensor):
    """Inverse of pack_cells -> (values uint8, remoteness int32)."""
    w = u32_to_i64(cells)
    return ((w & _VALUE_MASK).to(torch.uint8),
            (w >> _VALUE_BITS).to(torch.int32))

