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
"""

from __future__ import annotations

import torch

from gamesmanmpi_tpu_torch import kernels
from gamesmanmpi_tpu_torch.core.codec import i64_to_u32, u32_to_i64


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
    lib = build.load("double_u32")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.double_u32_launch(x.data_ptr(), out.data_ptr(), x.numel(),
                                 stream)
    build.check("double_u32", code)
    kernels.LAUNCHES["double_u32"] += 1
    return out
