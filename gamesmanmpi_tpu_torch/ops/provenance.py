"""Dedup provenance (port of gamesmanmpi_tpu/ops/provenance.py).

The forward pass's dedup already determines where every child lands in
the next level's sorted table. Keeping that index (`uidx`) turns the
backward pass into gathers and a combine: no search, no re-expansion.

The reference gets `uidx` from two pair sorts (sort (child, origin), number
the runs, sort the run index back by origin), a shape XLA compiles well.
``torch.unique(sorted=True, return_inverse=True)`` returns exactly that
inverse in one call.
"""

from __future__ import annotations

import torch

from gamesmanmpi_tpu_torch.core.bitops import SENTINEL
from gamesmanmpi_tpu_torch.core.codec import pack_cells
from gamesmanmpi_tpu_torch.ops.dedup import unique_tailed, with_sentinel_slot


def uidx_from_inverse(inverse: torch.Tensor, count: int) -> torch.Tensor:
    """unique_tailed's inverse -> int32 uidx, -1 on SENTINEL slots."""
    return torch.where(inverse == count, -1, inverse).to(torch.int32)


def dedup_provenance(flat: torch.Tensor):
    """Sort-unique [N] int64 states AND report where each slot landed.

    Returns (uniq [N] sorted uniques first + SENTINEL tail, count as a host
    int, uidx [N] int32): uidx[j] is the index of flat[j] within the uniq
    prefix, -1 for sentinel slots.
    """
    uniq, count, inv = unique_tailed(with_sentinel_slot(flat))
    out = torch.full((flat.numel(),), SENTINEL, dtype=torch.int64,
                     device=flat.device)
    out[:count] = uniq
    return out, count, uidx_from_inverse(inv, count)


def gather_cells(uidx: torch.Tensor, wvals: torch.Tensor,
                 wrem: torch.Tensor) -> torch.Tensor:
    """Packed uint32 cells for stored unique-indices.

    uidx: [...] int32 indices into the deeper level's prefix (-1 = no
    child, which yields the UNDECIDED cell 0). wvals/wrem: the deeper
    level's solved values [W] uint8 / remoteness [W] int32. The gather
    runs on the cells' int32 view (same bits): torch's index kernels do
    not take uint32 on every device.
    """
    cells = pack_cells(wvals, wrem).view(torch.int32)
    got = cells[uidx.to(torch.int64).clamp(0, cells.numel() - 1)]
    return torch.where(uidx >= 0, got, 0).view(torch.uint32)
