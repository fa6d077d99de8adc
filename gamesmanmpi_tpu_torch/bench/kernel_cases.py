"""Shapes, byte bounds and in-turn timing for the port's CUDA kernels.

Shared by chip_smoke.py and tools/torch_kernel_ab.py, so that both
time the same inputs the same way:

* :func:`time_turns` — each function timed with CUDA events over `iters`
  calls, in turns (A, B, ..., B, A) for `rounds` rounds; medians and
  spread per function. Comparing two versions only means something inside
  one such call, on one card.
* :func:`gather_shapes` — the gather's inputs at the shapes the port
  runs it, made on the card from a seed.
* :func:`gather_bound_bytes`, :func:`double_bound_bytes` — the bytes each
  function must move: every input read once, every output written once.
* :func:`nvidia_smi_line`, :func:`hbm_bytes_per_sec` — the card's name and
  power limit, and its published memory rate.
* :func:`int32_ops_per_sec` — the card's peak integer issue rate, the
  bound of the integer-bound level kernels.
"""

from __future__ import annotations

import statistics
import subprocess
from typing import Callable, Dict, Iterator, Tuple

import torch

#: Rows of `gather_shapes`: (label, n indices, m table entries, index
#: dtype, table dtype, how idx is drawn).
GATHER_SHAPES = (
    # The dense 5x5 backward's largest launch (level 18: 14,991,360 lanes
    # into an 18,937,490-entry u8 table), idx drifting forward like the
    # child ranks, ~1.27 entries per index.
    ("dense 5x5 level 18", 14_991_360, 18_937_490, torch.int64, torch.uint8,
     "drift"),
    # Microbench section 7b: a sorted int32 index into a u32 table.
    ("microbench 7b", 32 << 20, 8 << 20, torch.int32, torch.uint32,
     "sorted"),
    # The smoke shape of earlier runs: 64M int64 into a 32M u8 table.
    ("smoke 64M", 64 << 20, 32 << 20, torch.int64, torch.uint8, "half"),
)


def nvidia_smi_line() -> str:
    """The card's name and power limit, as `nvidia-smi` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def hbm_bytes_per_sec(name: str) -> float:
    """Published device-memory rate of the card (NVIDIA data sheets)."""
    if "H200" in name:
        return 4.8e12
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM


#: Integer lanes per SM per clock at most on Hopper: four schedulers, one
#: warp instruction (32 lanes) each. Each pipe alone gives half of it (the
#: ALU's shifts, logic and compares; the FMA pipe's IMAD forms of adds,
#: moves and multiply-adds), but a mix can issue to both at once, so no
#: integer work takes less than its operations over this rate.
#: tools/torch_int_rate.py measures each pipe and the mix on the card.
INT32_LANES_PER_SM = 128


def int32_ops_per_sec() -> float:
    """Peak integer issue rate of card 0: its SMs x INT32_LANES_PER_SM x
    its maximum SM clock as `nvidia-smi` reports it (clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * float(out[0]) * 1e6


def gather_bound_bytes(n: int, m: int, idx_bytes: int,
                       table_bytes: int) -> int:
    """idx and out once each, and the table once."""
    return n * (idx_bytes + table_bytes) + m * table_bytes


def double_bound_bytes(n: int) -> int:
    """4 B read and 4 B written per element."""
    return 8 * n


def gather_shapes(dev, seed: int = 1) -> Iterator[Tuple[str, torch.Tensor,
                                                          torch.Tensor]]:
    """(label, table, idx) for each row of GATHER_SHAPES, made on `dev`,
    one at a time (drop each before the next)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    for label, n, m, idtype, tdtype, kind in GATHER_SHAPES:
        hi = 256 if tdtype == torch.uint8 else 1 << 32
        table = torch.randint(0, hi, (m,), generator=g, device=dev,
                              dtype=torch.int64)
        table = (table.to(torch.uint8) if tdtype == torch.uint8
                 else table.to(torch.int32).view(torch.uint32))
        if kind == "sorted":
            idx = torch.sort(torch.randint(0, m, (n,), generator=g,
                                           device=dev)).values
        else:
            step_hi = 3 if kind == "drift" else 2
            idx = torch.cumsum(torch.randint(0, step_hi, (n,), generator=g,
                                             device=dev), 0)
            if kind == "drift":
                idx = idx * (m - 1) // idx[-1].clamp(min=1)
            idx = idx.clamp_(max=m - 1)
        yield label, table, idx.to(idtype)
        del table, idx


#: GPU cycles of busy wait queued before each sample, per call timed: the
#: host enqueues the calls while the card waits, so the sample measures
#: the card running them back to back, not the host's launch overhead.
SLEEP_CYCLES_PER_CALL = 200_000


def _time_once(fn: Callable[[], object], iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_turns(fns: Dict[str, Callable[[], object]], rounds: int = 5,
               iters: int = 10, warmup: int = 2) -> Dict[str, dict]:
    """name -> {median_ms, min_ms, max_ms, samples}: each round times every
    function once in order and once in reverse order, each sample the mean
    of `iters` calls between two CUDA events, queued behind a busy wait so
    that the card runs them back to back."""
    names = list(fns)
    for f in fns.values():
        for _ in range(warmup):
            f()
    torch.cuda.synchronize()
    runs: Dict[str, list] = {k: [] for k in names}
    for _ in range(rounds):
        for k in names + names[::-1]:
            runs[k].append(_time_once(fns[k], iters))
    return {k: {"median_ms": statistics.median(v), "min_ms": min(v),
                "max_ms": max(v), "samples": len(v)}
            for k, v in runs.items()}
