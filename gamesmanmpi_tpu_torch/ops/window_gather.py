"""Monotone-window gather (port of gamesmanmpi_tpu/ops/pallas_gather.py).

The dense engine's backward step is, per move, one byte gather with a
globally non-decreasing flat index vector (solve/dense.py builds exactly
that with its monotone fill). A run of consecutive indices then touches a
bounded stretch of the table, which a kernel reads from on-chip memory
(L1, or a span staged in shared memory) instead of issuing one scattered
read per element. The reference's `block`/`window` tiling survives only
in the miss count; the CUDA kernel's work split is its own.

* :func:`monotone_window_gather` — the hand-written CUDA kernel
  (kernels/csrc/window_gather.cu) for a CUDA tensor; for a CPU tensor it
  returns the plain version, and for any other device it raises.
* :func:`monotone_window_gather_ref` — the plain PyTorch version with the
  same contract.
* :func:`cells_table_gather` — the reference's direct-address gather
  (plain torch: it was never a Pallas kernel).
* :func:`gather_plan`, :func:`run_bounds`, :func:`tile_is_vector`,
  :func:`staged_span` — the kernel's launch arithmetic, here in Python so
  that the CPU tests reach it; the CUDA source follows it.

Contract (stronger than the TPU kernel's): ``out == table[clamp(idx, 0,
M-1)]`` at every position, and ``nmiss`` counts the elements outside
their block's 2-window view exactly as the reference wrapper does —
replicas of ``idx[-1]`` that pad the last block to `block` included — so
``nmiss == 0`` exactly when every real element hit. Misses cost speed, not
correctness: callers need no fallback.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from gamesmanmpi_tpu_torch import kernels

#: The CUDA source's constants: threads per CTA, outputs a lane stores per
#: tile, and the tile (indices per CTA step).
THREADS = 256
LANE_ELEMS = 16
TILE = THREADS * LANE_ELEMS
#: Indices per CTA: two tiles, the fastest run on an H100 (PERF.md).
RUN = 2 * TILE
#: Staged span: two table entries per index of the run, at most 32 KiB
#: (two u8 entries or one u32 entry per index; the dense child gather
#: drifts ~1.3 u8 entries per index, section 7b's sorted index 0.25 u32
#: entries).
SPAN_BUDGET_MAX = 32 * 1024


@dataclass(frozen=True)
class GatherPlan:
    """One launch: `grid` CTAs, CTA c taking indices run_bounds(plan, c);
    `vector` when idx and out are 16-byte aligned; `budget` bytes of
    staged span; `smem` dynamic shared bytes per CTA."""

    n: int
    run: int
    grid: int
    vector: bool
    budget: int
    smem: int


def gather_plan(n: int, table_bytes: int, idx_ptr: int,
                out_ptr: int) -> GatherPlan:
    """The launch arithmetic for n indices into a table of `table_bytes`
    elements. The split is the kernel's own: `block` and `window` only
    define the miss count."""
    budget = min(2 * RUN * table_bytes, SPAN_BUDGET_MAX)
    return GatherPlan(n=n, run=RUN, grid=-(-n // RUN),
                      vector=((idx_ptr | out_ptr) & 15) == 0, budget=budget,
                      # the span, then the per-warp output buffers
                      smem=budget + TILE * table_bytes)


def run_bounds(plan: GatherPlan, cta: int) -> Tuple[int, int]:
    """[start, stop) of the indices CTA `cta` gathers."""
    start = cta * plan.run
    return start, min(start + plan.run, plan.n)


def tile_is_vector(plan: GatherPlan, t0: int) -> bool:
    """Whether the tile at t0 takes the vector path (16-byte index loads
    and stores): a whole tile, with idx and out aligned."""
    return plan.vector and t0 + TILE <= plan.n


def staged_span(plan: GatherPlan, first: int, last: int, m: int,
                table_ptr: int, table_bytes: int) -> Tuple[int, int]:
    """(span_lo, span_len) in table entries: what a CTA whose run
    starts at index value `first` and ends at `last` copies into shared
    memory. 16-byte aligned at both ends, never past the table, at most
    plan.budget bytes; (0, 0) when nothing is staged."""
    tb = table_bytes
    lo, hi = min(max(first, 0), m - 1), min(max(last, 0), m - 1)
    if table_ptr % 16 or hi < lo:
        return 0, 0
    b_lo = lo * tb // 16 * 16
    b_hi = min(-(-(hi + 1) * tb // 16) * 16, m * tb // 16 * 16,
               b_lo + plan.budget)
    if b_hi <= b_lo:
        return 0, 0
    return b_lo // tb, (b_hi - b_lo) // tb


def padded_table_len(m: int, window: int) -> int:
    """A whole number of windows, at least two, covering m elements: the
    table length the reference pads to, which fixes the number of windows
    a block's base is clipped to."""
    return max(-(-m // window), 2) * window


def _check(table, idx, block, window):
    if table.dim() != 1 or idx.dim() != 1:
        raise ValueError("table and idx must be 1-D")
    if table.shape[0] == 0:
        raise ValueError("table must not be empty")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    if table.element_size() not in (1, 2, 4):
        raise TypeError(f"table elements must be 1, 2 or 4 bytes, "
                        f"got {table.dtype}")
    if table.device != idx.device:
        raise ValueError(f"table on {table.device}, idx on {idx.device}")
    if block <= 0 or window <= 0:
        raise ValueError(f"block and window must be positive, got "
                         f"{block}, {window}")


def monotone_window_gather_ref(table, idx, block: int = 2048,
                               window: int = 8192):
    """Plain PyTorch version: (table[clamp(idx)], nmiss int32 scalar)."""
    _check(table, idx, block, window)
    m, n = table.shape[0], idx.shape[0]
    if n == 0:
        return table[:0].clone(), torch.zeros((), dtype=torch.int32,
                                              device=table.device)
    wide = idx.to(torch.int64)
    # Index through a same-size signed view: torch's index kernels do not
    # cover every unsigned dtype on every device, and the gather only
    # copies bits.
    signed = {1: torch.int8, 2: torch.int16, 4: torch.int32}[
        table.element_size()]
    out = table.view(signed)[wide.clamp(0, m - 1)].view(table.dtype)
    npad = -n % block
    if npad:
        wide = torch.cat([wide, wide[-1:].expand(npad)])
    nwin = padded_table_len(m, window) // window
    starts = wide[::block]
    base = torch.div(starts, window, rounding_mode="floor").clamp(
        0, nwin - 2) * window
    off = wide - base.repeat_interleave(block)
    nmiss = ((off < 0) | (off >= 2 * window)).sum().to(torch.int32)
    return out, nmiss


def monotone_window_gather(table, idx, block: int = 2048,
                           window: int = 8192):
    """table [M], idx [N] int32/int64 non-decreasing ->
    (out [N] table.dtype, nmiss int32 scalar tensor on the same device).

    On a CUDA tensor this launches the CUDA kernel (and counts the launch
    in kernels.LAUNCHES); on a CPU tensor it is the plain version.
    """
    _check(table, idx, block, window)
    if table.device.type == "cpu":
        return monotone_window_gather_ref(table, idx, block, window)
    if table.device.type != "cuda":
        raise RuntimeError(f"no window-gather kernel for {table.device}")
    from gamesmanmpi_tpu_torch.kernels import build

    table = table.contiguous()
    idx = idx.contiguous()
    m, n = table.shape[0], idx.shape[0]
    out = torch.empty(n, dtype=table.dtype, device=table.device)
    nmiss = torch.zeros((), dtype=torch.int32, device=table.device)
    if n == 0:
        return out, nmiss
    p = gather_plan(n, table.element_size(), idx.data_ptr(), out.data_ptr())
    lib = build.load("window_gather")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    code = lib.window_gather_launch(
        table.element_size(), idx.element_size(), table.data_ptr(), m,
        idx.data_ptr(), n, out.data_ptr(), nmiss.data_ptr(), block, window,
        padded_table_len(m, window) // window, p.run, p.grid, int(p.vector),
        p.budget, p.smem, stream)
    build.check("monotone_window_gather", code)
    kernels.LAUNCHES["monotone_window_gather"] += 1
    return out, nmiss


def cells_table_gather(cells, idx, valid):
    """Direct-address packed-cell gather: cells[idx] where valid, else 0.

    idx may hold garbage on invalid lanes; it is clamped in bounds before
    the gather and the lane is zeroed by the select (cell 0 is UNDECIDED,
    which doubles as the miss flag downstream).
    """
    t = cells.shape[0]
    safe = idx.to(torch.int64).clamp(0, t - 1)
    return torch.where(valid, cells[safe], torch.zeros((), dtype=cells.dtype,
                                                       device=cells.device))
