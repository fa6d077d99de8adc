"""Op-level microbenchmarks of the torch port (twin of tools/microbench2.py).

    python -m gamesmanmpi_tpu_torch.bench.microbench2 [--quick]
                                                      [--device cuda|cpu]

It times the primitives the classic engine is built from — elementwise
passes, sorts by size, row sorts, a u8-key pair sort, gathers against
table size, permutation inversion by scatter and by pair sort, a bitonic
merge, searchsorted — and the port's two kernels: section 7 the
``double_u32`` CUDA kernel (the reference's ``pallas_double`` probe) and
section 7b the monotone-window gather kernel against ``table[idx]``.
Sections and labels follow the reference, with these differences:

* u32 keys are below 2^30 and ride an int32 carrier (same bytes, same
  order; torch has no uint32 ``+``/``>>``/``max``); each record names its
  carrier dtype. Section 7 runs on a real uint32 tensor.
* section 6b: the reference timed its merge ladder, a measured no-go that
  is not ported; here it is the pair sort the port's dedup uses, a
  ``torch.sort`` of u32 keys carrying an int32 payload.
* section 6c: one binary search on the int64 carrier (torch has no
  sort-merge searchsorted and no unsigned one).

N comes from GAMESMAN_MB_N (default 32M). Inputs are made on the device
from seeded generators. Times are the best of 3 after 2 warm-up calls,
from CUDA events on the card and perf_counter on the CPU. It prints one
JSON line per section on stdout and exits 2 without a card unless
--device cpu is given. ``run(n, quick, device)`` returns the records.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, List, Optional

import torch

from gamesmanmpi_tpu_torch.ops.elementwise import double_u32
from gamesmanmpi_tpu_torch.ops.window_gather import monotone_window_gather
from gamesmanmpi_tpu_torch.utils.device import DeviceUnavailable, resolve_device
from gamesmanmpi_tpu_torch.utils.env import env_int

DEFAULT_N = 32 * 1024 * 1024


def _sz(n: int) -> str:
    """An element count as the labels print it: 32M, 64K, 100."""
    if n >= 1 << 20 and n % (1 << 20) == 0:
        return f"{n >> 20}M"
    if n >= 1 << 10 and n % (1 << 10) == 0:
        return f"{n >> 10}K"
    return str(n)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best_ms(fn: Callable, dev: torch.device, iters: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    _sync(dev)
    times = []
    for _ in range(iters):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def bitonic_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two sorted [N] tensors (N a power of two) into one sorted
    [2N]: cat(a, reverse(b)) is bitonic; log2(2N) compare-exchange stages
    of min/max sort it."""
    x = torch.cat([a, b.flip(0)])
    n = x.numel()
    s = n // 2
    while s >= 1:
        y = x.view(-1, 2, s)
        lo = torch.minimum(y[:, 0, :], y[:, 1, :])
        hi = torch.maximum(y[:, 0, :], y[:, 1, :])
        x = torch.stack([lo, hi], dim=1).view(n)
        s //= 2
    return x


def run(n: Optional[int] = None, quick: bool = False,
        device="cuda") -> List[dict]:
    """Run every section; -> one record per timed line."""
    dev = resolve_device(device)
    N = int(n or env_int("GAMESMAN_MB_N", DEFAULT_N))
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    records: List[dict] = []

    def timeit(section, label, fn, bytes_moved=None, iters=3, warmup=2,
               carrier=None):
        best = _best_ms(fn, dev, iters, warmup)
        rec = {"section": section, "label": label, "best_ms": best,
               "gbps": (bytes_moved / (best * 1e-3) / 1e9
                        if bytes_moved and best > 0 else None),
               "carrier": carrier, "device": kind}
        records.append(rec)
        return rec

    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(hi, size, dtype=torch.int32):
        return torch.randint(0, hi, (size,), generator=gen, device=dev,
                             dtype=torch.int64).to(dtype)

    keys = rand(1 << 30, N)  # u32 keys < 2^30 on the int32 carrier
    i32 = "int32"

    # 0. sync floor + elementwise bandwidth
    tiny = torch.arange(256, dtype=torch.int32, device=dev)
    timeit("0", "sync floor", lambda: tiny + 1, iters=10, carrier=i32)
    timeit("0", f"elementwise x+1 u32 [{_sz(N)}]", lambda: keys + 1,
           2 * 4 * N, carrier=i32)
    timeit("0", f"elementwise 5-op u32 [{_sz(N)}]",
           lambda: ((keys * 3) ^ (keys >> 7)) + (keys << 2), 2 * 4 * N,
           carrier=i32)

    # 1. sort cost against size
    for m in (1, 4, 32):
        sz = min(m * 1024 * 1024, N)
        part = keys[:sz]
        timeit("1", f"sort u32 [{_sz(sz)}]", lambda p=part: torch.sort(p),
               2 * 4 * sz, carrier=i32)

    # 2. batched row sorts, constant total N
    for rows in (32, 256, 2048):
        cols = N // rows
        x = keys[:rows * cols].view(rows, cols)
        timeit("2", f"row sort [{rows} x {_sz(cols)}]",
               lambda v=x: torch.sort(v, dim=-1), 2 * 4 * rows * cols,
               carrier=i32)

    # 3. partition pass: u8-key pair sort (bucket id = top 8 bits)
    def bucket_sort(k):
        bid = (k >> 22).to(torch.uint8)
        return k[torch.sort(bid).indices]

    timeit("3", f"u8-key pair sort (partition) [{_sz(N)}]",
           lambda: bucket_sort(keys), 2 * 5 * N, carrier=i32)

    # 4. gather bandwidth against table size, then monotone indices
    for m, label in ((64 * 1024, "64K"), (1024 * 1024, "1M"),
                     (8 * 1024 * 1024, "8M")):
        table = rand(1 << 30, m)
        idx = rand(m, N)
        timeit("4", f"gather u32 [{_sz(N)} from {label}]",
               lambda t=table, i=idx: t[i], 4 * N, carrier=i32)
    table8 = rand(1 << 30, 8 * 1024 * 1024)
    sidx = torch.sort(rand(8 * 1024 * 1024, N)).values
    timeit("4", f"gather u32 sorted idx [{_sz(N)} from 8M]",
           lambda: table8[sidx], 4 * N, carrier=i32)

    # 5. permutation inversion: scatter against pair sort
    perm = torch.randperm(N, generator=gen, device=dev).to(torch.int32)
    vals = rand(1 << 30, N)

    def inv_scatter(p, v):
        return torch.zeros_like(v).scatter_(0, p.to(torch.int64), v)

    def inv_sort(p, v):
        return v[torch.sort(p).indices]

    timeit("5", f"perm inversion scatter [{_sz(N)}]",
           lambda: inv_scatter(perm, vals), 3 * 4 * N, carrier=i32)
    timeit("5", f"perm inversion pair sort [{_sz(N)}]",
           lambda: inv_sort(perm, vals), 3 * 4 * N, carrier=i32)
    del perm, vals

    # 6. bitonic merge of two sorted halves against sorting the whole
    h = N // 2
    a = torch.sort(keys[:h]).values
    b = torch.sort(keys[h:2 * h]).values
    timeit("6", f"bitonic merge [{_sz(h)} + {_sz(h)}]",
           lambda: bitonic_merge(a, b),
           2 * 4 * N * max(N.bit_length() - 1, 1), carrier=i32)
    timeit("6", f"torch.sort same total [{_sz(N)}]",
           lambda: torch.sort(keys), 2 * 4 * N, carrier=i32)
    del a, b

    # 6b. the pair sort the port's dedup relies on (u32 keys, i32 payload)
    origin = torch.arange(N, dtype=torch.int32, device=dev)

    def pair_sort(k, o):
        s = torch.sort(k)
        return s.values, o[s.indices]

    timeit("6b", f"torch.sort u32 keys + i32 payload (pair sort) [{_sz(N)}]",
           lambda: pair_sort(keys, origin), 2 * 8 * N, carrier=i32)
    del origin

    # 6c. searchsorted on the int64 carrier (queries half-hit)
    m8 = 8 * 1024 * 1024
    tbl64 = torch.sort(rand(1 << 60, m8, torch.int64)).values
    pick = tbl64[rand(m8, N, torch.int64)]
    q64 = torch.where(rand(2, N, torch.bool), pick, rand(1 << 60, N, torch.int64))
    del pick
    timeit("6c", f"searchsorted i64 [{_sz(N)} in 8M]",
           lambda: torch.searchsorted(tbl64, q64), 8 * N, carrier="int64")
    del tbl64, q64

    if not quick:
        # 7. the double_u32 kernel (the reference's pallas_double probe)
        ku = keys.view(torch.uint32)
        impl = "cuda kernel" if dev.type == "cuda" else "plain (CPU tensor)"
        timeit("7", f"{impl} elementwise 2x [{_sz(N)}]",
               lambda: double_u32(ku), 2 * 4 * N, carrier="uint32")

        # 7b. the monotone-window gather kernel against table[idx]
        tb = rand(1 << 30, m8).view(torch.uint32)
        mono = torch.sort(rand(m8, N)).values
        impl = "cuda" if dev.type == "cuda" else "plain (CPU tensor)"
        timeit("7b", f"{impl} monotone gather [{_sz(N)} from 8M]",
               lambda: monotone_window_gather(tb, mono)[0], 4 * N,
               carrier="uint32")
        tbi = tb.view(torch.int32)
        timeit("7b", f"torch gather same monotone idx [{_sz(N)} from 8M]",
               lambda: tbi[mono], 4 * N, carrier=i32)
        del tb, tbi, mono

    # 8. u64 sort (the wide-board state dtype) on the int64 carrier
    keys64 = keys.to(torch.int64)
    timeit("8", f"sort u64 [{_sz(N)}]", lambda: torch.sort(keys64),
           2 * 8 * N, carrier="int64")
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m gamesmanmpi_tpu_torch.bench.microbench2",
        description="op-level microbenchmarks of the torch port")
    p.add_argument("--quick", action="store_true",
                   help="skip the kernel sections 7 and 7b")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except DeviceUnavailable as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"device: {dev}", file=sys.stderr)
    for rec in run(quick=args.quick, device=dev):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
