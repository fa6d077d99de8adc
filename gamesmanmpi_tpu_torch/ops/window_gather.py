"""Monotone-window gather (port of gamesmanmpi_tpu/ops/pallas_gather.py).

The dense engine's backward step is, per move, one byte gather with a
globally non-decreasing flat index vector (solve/dense.py builds exactly
that with its monotone fill). Each block of `block` indices then touches a
bounded stretch of the table, so a kernel can stage two window-aligned
tiles on chip and select locally instead of issuing one scattered read
per element.

* :func:`monotone_window_gather` — the hand-written CUDA kernel
  (kernels/csrc/window_gather.cu) for a CUDA tensor; for a CPU tensor it
  returns the plain version, and for any other device it raises.
* :func:`monotone_window_gather_ref` — the plain PyTorch version with the
  same contract.
* :func:`cells_table_gather` — the reference's direct-address gather
  (plain torch: it was never a Pallas kernel).

Contract (stronger than the TPU kernel's): ``out == table[clamp(idx, 0,
M-1)]`` at every position, and ``nmiss`` counts the elements outside
their block's 2-window view exactly as the reference wrapper does —
replicas of ``idx[-1]`` that pad the last block to `block` included — so
``nmiss == 0`` exactly when every real element hit. Misses cost speed, not
correctness: callers need no fallback.
"""

from __future__ import annotations

import torch

from gamesmanmpi_tpu_torch import kernels


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
    smem = 2 * window * table.element_size()
    if smem > 227 * 1024:
        raise ValueError(f"two windows of {window} elements need {smem} B "
                         "of shared memory; a CTA has 227 KB")
    lib = build.load("window_gather")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    code = lib.window_gather_launch(
        table.element_size(), idx.element_size(), table.data_ptr(), m,
        idx.data_ptr(), n, out.data_ptr(), nmiss.data_ptr(), block, window,
        padded_table_len(m, window) // window, stream)
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
