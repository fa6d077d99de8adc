"""Frontier deduplication (port of gamesmanmpi_tpu/ops/dedup.py).

Contract kept from the reference: the uniques in ascending order, then a
sentinel tail (the port's sentinel is INT64_MAX, so it sorts last on the
int64 carrier), plus the count. The reference builds this from a sort, a
neighbour compare and a re-sort or scatter, shapes XLA keeps static. Eager
torch has ``torch.unique(sorted=True)``, which does the sort and the run
detection in one call, and sizes its output on the host.

:func:`unique_tailed` is the shared core: the caller's buffer ends in one
SENTINEL slot, so the last unique is always the sentinel and the count of
real uniques is known on the host from the output's length. The only
host synchronisation is the one inside ``torch.unique``.
"""

from __future__ import annotations

import torch

from gamesmanmpi_tpu_torch.core.bitops import SENTINEL


def with_sentinel_slot(flat: torch.Tensor) -> torch.Tensor:
    """[N] int64 -> [N+1] copy whose last slot is SENTINEL."""
    buf = torch.empty(flat.numel() + 1, dtype=torch.int64, device=flat.device)
    buf[:-1] = flat.reshape(-1)
    buf[-1] = SENTINEL
    return buf


def unique_tailed(buf: torch.Tensor):
    """Sorted uniques of a buffer whose last slot is SENTINEL.

    buf: [N+1] int64, buf[-1] == SENTINEL (other SENTINEL slots allowed).
    Returns (uniq [count] ascending, without the sentinel; count, a host
    int; inverse [N] int64: index of buf[j] in the sorted uniques, equal
    to `count` on SENTINEL slots).
    """
    u, inv = torch.unique(buf, sorted=True, return_inverse=True)
    return u[:-1], u.numel() - 1, inv[:-1]


def compact_sorted(s: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Kept entries of a SORTED [N] array to the front, order preserved,
    SENTINEL tail. keep must be False on sentinel entries.

    A cumsum gives each kept entry its slot; dropped entries are written
    to one spare slot past the end, so nothing syncs with the host.
    """
    n = s.numel()
    pos = torch.where(keep, torch.cumsum(keep.to(torch.int64), 0) - 1, n)
    out = torch.full((n + 1,), SENTINEL, dtype=s.dtype, device=s.device)
    out.scatter_(0, pos, s)
    out[n] = SENTINEL
    return out[:n]


def sort_unique(states: torch.Tensor):
    """Sort [N] int64 states, drop duplicates and sentinels, compact.

    Returns (sorted_unique [N] with all uniques first then a SENTINEL
    tail, count of unique non-sentinel entries as a host int).
    """
    uniq, count, _ = unique_tailed(with_sentinel_slot(states))
    out = torch.full((states.numel(),), SENTINEL, dtype=torch.int64,
                     device=states.device)
    out[:count] = uniq
    return out, count
