"""Elementwise u32 doubling (port of `pallas_double` in tools/microbench2.py).

The op-level microbenchmark's Pallas probe computes ``x * 2`` on uint32.
Contract here: ``out[i] == (2 * x[i]) mod 2^32`` for every i, the tail
included (the TPU kernel writes only whole 1,048,576-element blocks; at
the benchmark's default N, a multiple of that, the two agree).

* :func:`double_u32` — the hand-written CUDA kernel
  (kernels/csrc/double_u32.cu) for a CUDA tensor; for a CPU tensor it
  returns the plain version, and for any other device it raises.
* :func:`double_u32_ref` — the plain PyTorch version. torch has no ``<<``
  or ``+`` for uint32, so it widens to int64, doubles, and narrows the low
  32 bits back (core/codec.i64_to_u32).
* :func:`double_plan` — every launch's arithmetic (which elements the
  vector kernel takes, its grid, the scalar kernel's share), here in
  Python so that the CPU tests reach it; the CUDA source follows it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gamesmanmpi_tpu_torch import kernels
from gamesmanmpi_tpu_torch.core.codec import i64_to_u32, u32_to_i64

#: The CUDA source's constants (kThreads, kVecs): threads per CTA and
#: 16-byte vectors per thread of the vector kernel.
THREADS = 256
VECS = 2
#: Scalar-kernel CTAs at most: about one fill of an H100 (132 SMs of 2,048
#: threads); the kernel's grid-stride loop takes the rest.
SCALAR_GRID_MAX = 1024


@dataclass(frozen=True)
class DoublePlan:
    """One call's launches: the vector kernel over elements [0, 4 * nvec)
    on `grid` CTAs, then the scalar kernel over [start, n) on
    `scalar_grid` CTAs."""

    n: int
    nvec: int
    grid: int
    start: int
    scalar_grid: int


def double_plan(n: int, x_ptr: int, out_ptr: int) -> DoublePlan:
    """The launch arithmetic of one call on n elements.

    The vector kernel needs x and out 16-byte aligned; it then takes the
    whole 16-byte vectors, one CTA per THREADS * VECS of them. The scalar
    kernel takes the rest: the n % 4 tail, or everything when a pointer is
    off alignment.
    """
    aligned = ((x_ptr | out_ptr) & 15) == 0
    nvec = n // 4 if aligned else 0
    start = 4 * nvec
    return DoublePlan(n=n, nvec=nvec, grid=-(-nvec // (THREADS * VECS)),
                      start=start,
                      scalar_grid=min(-(-(n - start) // THREADS),
                                      SCALAR_GRID_MAX))


def _check(x):
    if x.dtype != torch.uint32:
        raise TypeError(f"x must be uint32, got {x.dtype}")


def double_u32_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (2 * x) mod 2^32, uint32, same shape."""
    _check(x)
    return i64_to_u32(u32_to_i64(x) * 2)


def double_u32(x: torch.Tensor) -> torch.Tensor:
    """x uint32 [...] -> (2 * x) mod 2^32, uint32, same shape.

    On a CUDA tensor this launches the CUDA kernel (and counts the launch
    in kernels.LAUNCHES); on a CPU tensor it is the plain version.
    """
    _check(x)
    if x.device.type == "cpu":
        return double_u32_ref(x)
    if x.device.type != "cuda":
        raise RuntimeError(f"no double_u32 kernel for {x.device}")
    from gamesmanmpi_tpu_torch.kernels import build

    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    p = double_plan(x.numel(), x.data_ptr(), out.data_ptr())
    lib = build.load("double_u32")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.double_u32_launch(x.data_ptr(), out.data_ptr(), p.nvec,
                                 p.grid, p.start, p.n, p.scalar_grid, stream)
    build.check("double_u32", code)
    kernels.LAUNCHES["double_u32"] += 1
    return out
