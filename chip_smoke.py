"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. env     — torch/CUDA versions, the card's name and power limit.
2. build   — nvcc builds every kernel from kernels/csrc (timed, with the
             ptxas register/shared-memory report).
3. kernel monotone_window_gather — the CUDA kernel against its plain
             PyTorch version on the card: u8/u32 tables, int32/int64
             indices, all-hit and missing index vectors, ragged lengths;
             `out` bit-identical and `nmiss` equal. Then timed on a
             64M-index u8 gather from a 32M table beside the plain version,
             `table[idx]`, and the byte bound.
4. dense 4x4 — window-kernel and plain-gather solves on the card give
             byte-identical cells and 161,029 positions; 5x4 gives
             3,945,711 positions, TIE, remoteness 20; 3x4 connect-3 on the
             card equals the same solve on the CPU.
5. dense 5x5 — the CLI entry point (`solve connect4:w=5,h=5`, device
             cuda) with the launch counts reset just before and read just
             after: 69,763,700 positions, TIE, remoteness 25, kernel
             launches > 0.

Then the kernels line, the `nvidia-smi` name/power-limit line, and last
`{"ok": true, "device": {...}}`. It imports nothing of JAX or of the JAX
package, and exits non-zero without printing a result when there is no
card (or when run without the rest of the repository beside it).
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time

import torch


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
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


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def as_signed(t: torch.Tensor) -> torch.Tensor:
    """Same-size signed view, for comparing unsigned tensors."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
        t.element_size()]).to(torch.int64)


def kernel_phase(dev, rate):
    from gamesmanmpi_tpu_torch.ops.window_gather import (
        monotone_window_gather,
        monotone_window_gather_ref,
    )

    gen = torch.Generator(device="cpu").manual_seed(0)
    cases, worst = 0, 0
    for tdtype in (torch.uint8, torch.uint32):
        for idtype in (torch.int32, torch.int64):
            for kind in ("hits", "misses"):
                for n in (1, 255, 2049, 5000):
                    for block, window in ((2048, 8192), (256, 1024)):
                        m = 1 << 18
                        hi = 256 if tdtype == torch.uint8 else 1 << 32
                        table = torch.randint(0, hi, (m,), generator=gen)
                        table = table.to(tdtype).to(dev)
                        if kind == "hits":
                            steps = torch.randint(0, 3, (n,), generator=gen)
                            idx = torch.cumsum(steps, 0).clamp(max=m - 1)
                        else:
                            idx = torch.sort(torch.randint(
                                0, m, (n,), generator=gen)).values
                        idx = idx.to(idtype).to(dev)
                        out, nm = monotone_window_gather(table, idx, block,
                                                         window)
                        ref, nm_ref = monotone_window_gather_ref(
                            table, idx, block, window)
                        torch.cuda.synchronize()
                        err = int((as_signed(out) - as_signed(ref)).abs()
                                  .max()) if n else 0
                        if err != 0 or int(nm) != int(nm_ref):
                            raise AssertionError(
                                f"window gather mismatch: {tdtype} {idtype} "
                                f"{kind} n={n} block={block}: max err {err}, "
                                f"nmiss {int(nm)} vs {int(nm_ref)}")
                        if kind == "hits" and block == 2048 and int(nm):
                            raise AssertionError(
                                f"near-monotone idx missed: nmiss={int(nm)}")
                        worst = max(worst, err)
                        cases += 1

    # Timing at the dense path's scale: 64M monotone indices (expansion
    # ratio ~0.5) into a 32M-cell u8 table, block 2048, window 8192.
    n, m = 64 << 20, 32 << 20
    g = torch.Generator(device=dev).manual_seed(1)
    table = torch.randint(0, 256, (m,), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    idx = torch.cumsum(torch.randint(0, 2, (n,), generator=g, device=dev),
                       0).clamp_(max=m - 1)
    out, nm = monotone_window_gather(table, idx)
    ref, nm_ref = monotone_window_gather_ref(table, idx)
    big_err = int((out.to(torch.int64) - ref.to(torch.int64)).abs().max())
    if big_err != 0 or int(nm) != int(nm_ref):
        raise AssertionError(f"64M gather mismatch: err {big_err}, nmiss "
                             f"{int(nm)} vs {int(nm_ref)}")
    del out, ref
    ms = time_ms(lambda: monotone_window_gather(table, idx))
    plain_ms = time_ms(lambda: monotone_window_gather_ref(table, idx))
    library_ms = time_ms(lambda: table[idx])
    nbytes = n * idx.element_size() + n * 1 + m * 1
    bound_ms = nbytes / rate * 1e3
    emit("kernel monotone_window_gather", cases=cases, max_abs_err=worst,
         n=n, m=m, nmiss=int(nm), ms=ms, plain_ms=plain_ms,
         library_ms=library_ms, bound_ms=bound_ms, bound_bytes=nbytes,
         hbm_bytes_per_sec=rate)
    return dict(max_abs_err=max(worst, big_err), ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms)


def dense_small_phase(dev):
    from gamesmanmpi_tpu_torch.games import get_game
    from gamesmanmpi_tpu_torch.solve.dense import DenseSolver

    t0 = time.perf_counter()
    g = get_game("connect4:w=4,h=4")
    win = DenseSolver(g, device=dev, gather_mode="window").solve()
    plain = DenseSolver(g, device=dev, gather_mode="plain").solve()
    for L in win.cells:
        if not (win.cells[L] == plain.cells[L]).all():
            raise AssertionError(f"4x4 level {L}: window != plain cells")
    if win.num_positions != 161029:
        raise AssertionError(f"4x4 positions {win.num_positions} != 161029")
    r54 = DenseSolver(get_game("connect4:w=5,h=4"), device=dev,
                      store_tables=False).solve()
    got54 = (r54.num_positions, r54.value, r54.remoteness)
    if got54 != (3945711, 3, 20):
        raise AssertionError(f"5x4 (positions, value, rem) {got54} != "
                             "(3945711, TIE=3, 20)")
    g34 = get_game("connect4:w=3,h=4,connect=3")
    card = DenseSolver(g34, device=dev).solve()
    cpu = DenseSolver(g34, device="cpu").solve()
    for L in cpu.cells:
        if not (card.cells[L] == cpu.cells[L]).all():
            raise AssertionError(f"3x4c3 level {L}: card != CPU cells")
    emit("dense 4x4", positions_4x4=win.num_positions,
         root_4x4=[win.value, win.remoteness],
         nmiss_4x4=win.stats["gather_nmiss"], positions_5x4=got54[0],
         root_5x4=list(got54[1:]), secs_backward_5x4=r54.stats["secs_backward"],
         cpu_parity_3x4c3=True, secs=time.perf_counter() - t0)


def dense_5x5_phase():
    from gamesmanmpi_tpu_torch import kernels
    from gamesmanmpi_tpu_torch.cli import solve_main

    buf = io.StringIO()
    kernels.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc, result = solve_main(["solve", "connect4:w=5,h=5"])
    launches = dict(kernels.LAUNCHES)
    report = buf.getvalue().splitlines()
    if rc != 0 or result is None:
        raise AssertionError(f"CLI solve exited {rc}: {report}")
    got = (result.num_positions, result.value, result.remoteness)
    if got != (69763700, 3, 25):
        raise AssertionError(f"5x5 (positions, value, rem) {got} != "
                             "(69763700, TIE=3, 25)")
    if launches["monotone_window_gather"] <= 0:
        raise AssertionError(f"5x5 solve launched no kernel: {launches}")
    s = result.stats
    emit("dense 5x5", report=report, positions=got[0], value="TIE",
         remoteness=got[2], secs_backward=s["secs_backward"],
         secs_count_reachable=s["secs_count_reachable"],
         positions_per_sec=s["positions_per_sec"],
         encodable_positions=s["encodable_positions"],
         launches=launches, gather_nmiss=s["gather_nmiss"],
         peak_mem_bytes=s["peak_mem_bytes"])
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from gamesmanmpi_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    rate = hbm_bytes_per_sec(name)
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=name, nvidia_smi=smi,
         device_count=torch.cuda.device_count())

    t0 = time.perf_counter()
    libs = build.build_all()
    emit("build", secs=time.perf_counter() - t0,
         libraries={k: str(v.name) for k, v in libs.items()},
         ptxas={k: v[-2000:] for k, v in build.PTXAS_REPORT.items()})

    k = kernel_phase(dev, rate)
    dense_small_phase(dev)
    launches = dense_5x5_phase()

    print(json.dumps({"kernels": [{
        "name": "monotone_window_gather",
        "route": "cuda",
        "source": "gamesmanmpi_tpu_torch/kernels/csrc/window_gather.cu",
        "replaces": "gamesmanmpi_tpu/ops/pallas_gather.py:116",
        "launches": launches["monotone_window_gather"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k["library_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
