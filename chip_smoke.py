"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. env     — torch/CUDA versions, the card's name and power limit.
2. build   — nvcc builds every kernel from kernels/csrc, one nvcc per
             source, all started together (timed, with each kernel's
             ptxas register/shared-memory/spill report).
3. kernel monotone_window_gather — the CUDA kernel against its plain
             PyTorch version on the card: u8/u32 tables, int32/int64
             indices, all-hit and missing index vectors, ragged lengths;
             `out` bit-identical and `nmiss` equal. Then timed on a
             64M-index u8 gather from a 32M table beside the plain version,
             `table[idx]`, and the byte bound.
4. kernel double_u32 — the CUDA kernel bit-identical to its plain version
             at N in {1, 3, 1023, 1M, 1M+1, 32M} (seeded values with 0,
             2^31, 2^31+5 and 2^32-1 at both ends), on aligned tensors and
             on views one element in (the scalar path). Then timed at 32M
             beside the plain version, the library call and the byte bound.
5. dense 4x4 — window-kernel and plain-gather solves on the card give
             byte-identical cells and 161,029 positions; 5x4 gives
             3,945,711 positions, TIE, remoteness 20; 3x4 connect-3 on the
             card equals the same solve on the CPU.
6. dense 5x5 — the CLI entry point (`solve connect4:w=5,h=5`, device
             cuda) with the launch counts reset just before and read just
             after: 69,763,700 positions, TIE, remoteness 25, kernel
             launches > 0.
7. microbench — first the window gather bit-identical to its plain
             version (and `nmiss` equal) at section 7b's shape, a uint32
             [8M] table and a sorted int32 [32M] index; then the op-level
             bench entry point (`bench/microbench2.run`, N = 32M) with the
             launch counts reset just before and read just after: both
             kernels launched; one line per section.
8. classic small — the CLI's classic engine on the card: tictactoe
             TIE/9/5478, nim 3-4-5 WIN/11/120, subtract 10/{1,2} WIN/7/11;
             tictactoe sym=1, chomp 4x3, chomp 4x4 sym=1 and connect4 4x4
             sym=1 give every level's (states, values, remoteness)
             identical on the card and on the CPU (4x4 sym=1 also through
             the lookup-join backward).
9. classic 5x5 — `solve connect4:w=5,h=5 --engine classic` on the card:
             69,763,700 positions, TIE, remoteness 25, no lookup misses,
             and the same (value, remoteness) as the dense solve for 2,000
             sampled positions.

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


def double_phase(dev, rate):
    from gamesmanmpi_tpu_torch.core.codec import i64_to_u32
    from gamesmanmpi_tpu_torch.ops.elementwise import double_u32, double_u32_ref

    gen = torch.Generator(device="cpu").manual_seed(2)
    special = torch.tensor([0, 1 << 31, (1 << 31) + 5, (1 << 32) - 1])
    cases, worst = 0, 0
    for n in (1, 3, 1023, 1 << 20, (1 << 20) + 1, 32 << 20):
        vals = torch.randint(0, 1 << 32, (n,), generator=gen)
        k = min(n, 4)
        vals[:k] = special[:k]
        vals[n - k:] = special[4 - k:]
        x = i64_to_u32(vals).to(dev)
        # A view one element in is 4 B off 16-byte alignment: the scalar
        # path of the kernel.
        for view in ((x, x[1:]) if n > 1 else (x,)):
            out = double_u32(view)
            ref = double_u32_ref(view)
            torch.cuda.synchronize()
            err = int((as_signed(out) - as_signed(ref)).abs().max())
            if err != 0 or out.shape != view.shape:
                raise AssertionError(f"double_u32 mismatch at n={n} "
                                     f"offset={view.storage_offset()}: "
                                     f"max err {err}")
            worst = max(worst, err)
            cases += 1

    n = 32 << 20
    x = torch.randint(0, 1 << 32, (n,), generator=gen)
    x = i64_to_u32(x).to(dev)
    ms = time_ms(lambda: double_u32(x))
    plain_ms = time_ms(lambda: double_u32_ref(x))
    # The int32 view gives the same bits as a uint32 multiply, on every
    # torch (some lack uint32 `*` on CUDA).
    library = "x.view(torch.int32) * 2"
    if not torch.equal(x.view(torch.int32) * 2,
                       double_u32(x).view(torch.int32)):
        raise AssertionError(f"library call {library} disagrees with the "
                             "kernel at 32M")
    library_ms = time_ms(lambda: x.view(torch.int32) * 2)
    nbytes = 2 * 4 * n
    bound_ms = nbytes / rate * 1e3
    emit("kernel double_u32", cases=cases, max_abs_err=worst, n=n, ms=ms,
         plain_ms=plain_ms, library_ms=library_ms, library_call=library,
         bound_ms=bound_ms, bound_bytes=nbytes, hbm_bytes_per_sec=rate)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms)


def cli_solve(argv):
    """Run the CLI in-process: -> (result, report lines); raises unless
    it exits 0."""
    from gamesmanmpi_tpu_torch.cli import solve_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, result = solve_main(argv)
    report = buf.getvalue().splitlines()
    if rc != 0 or result is None:
        raise AssertionError(f"CLI {argv} exited {rc}: {report}")
    return result, report


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

    kernels.reset_launches()
    result, report = cli_solve(["solve", "connect4:w=5,h=5"])
    launches = dict(kernels.LAUNCHES)
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
    return launches, result


def microbench_phase(dev):
    from gamesmanmpi_tpu_torch import kernels
    from gamesmanmpi_tpu_torch.bench.microbench2 import run
    from gamesmanmpi_tpu_torch.ops.window_gather import (
        monotone_window_gather,
        monotone_window_gather_ref,
    )

    t0 = time.perf_counter()
    # Section 7b's gather at its own shape, before the counted run: a
    # uint32 [8M] table and a sorted int32 [32M] index, default block and
    # window; `out` bit-identical and `nmiss` equal.
    n, m = 32 << 20, 8 << 20
    g = torch.Generator(device=dev).manual_seed(3)
    table = torch.randint(0, 1 << 32, (m,), generator=g, device=dev,
                          dtype=torch.int64).to(torch.int32)
    table = table.view(torch.uint32)
    idx = torch.sort(torch.randint(0, m, (n,), generator=g, device=dev,
                                   dtype=torch.int64).to(torch.int32)).values
    out, nm = monotone_window_gather(table, idx)
    ref, nm_ref = monotone_window_gather_ref(table, idx)
    if not torch.equal(out.view(torch.int32), ref.view(torch.int32)) \
            or int(nm) != int(nm_ref):
        err = int((as_signed(out) - as_signed(ref)).abs().max())
        raise AssertionError(f"7b gather mismatch at [32M from 8M]: max err "
                             f"{err}, nmiss {int(nm)} vs {int(nm_ref)}")
    emit("microbench 7b check", n=n, m=m, idx_dtype="int32",
         table_dtype="uint32", max_abs_err=0, nmiss=int(nm))
    del table, idx, out, ref

    kernels.reset_launches()
    records = run(n=32 << 20, quick=False, device=dev)
    launches = dict(kernels.LAUNCHES)
    for rec in records:
        emit("microbench", **rec)
    if launches["double_u32"] <= 0 or launches["monotone_window_gather"] <= 0:
        raise AssertionError(f"microbench launched a kernel no time: "
                             f"{launches}")
    sections = sorted({r["section"] for r in records})
    emit("microbench done", sections=sections, lines=len(records),
         launches=launches, secs=time.perf_counter() - t0)
    return launches


def _same_tables(a, b, what):
    if sorted(a.levels) != sorted(b.levels):
        raise AssertionError(f"{what}: levels {sorted(a.levels)} != "
                             f"{sorted(b.levels)}")
    for k, t in a.levels.items():
        u = b.levels[k]
        for field in ("states", "values", "remoteness"):
            x, y = getattr(t, field), getattr(u, field)
            if x.dtype != y.dtype or not (x == y).all():
                raise AssertionError(f"{what}: level {k} {field} differ")


def classic_small_phase():
    from gamesmanmpi_tpu_torch.games import get_game
    from gamesmanmpi_tpu_torch.solve.engine import Solver

    t0 = time.perf_counter()
    known = {}
    for spec, want in (("tictactoe", (3, 9, 5478)),
                       ("nim:heaps=3-4-5", (1, 11, 120)),
                       ("subtract:total=10,moves=1-2", (1, 7, 11))):
        r, _ = cli_solve(["solve", spec])
        got = (r.value, r.remoteness, r.num_positions)
        if got != want or r.stats["engine"] != "classic" or r.stats["misses"]:
            raise AssertionError(f"{spec}: (value, rem, positions) {got} != "
                                 f"{want}, stats {r.stats}")
        known[spec] = list(got)
    parity = []
    for spec in ("tictactoe:sym=1", "chomp:w=4,h=3", "chomp:w=4,h=4,sym=1",
                 "connect4:w=4,h=4,sym=1"):
        card, _ = cli_solve(["solve", spec, "--engine", "classic"])
        cpu, _ = cli_solve(["solve", spec, "--engine", "classic",
                            "--device", "cpu"])
        if card.stats["device"] == cpu.stats["device"]:
            raise AssertionError(f"{spec}: both solves ran on "
                                 f"{card.stats['device']}")
        _same_tables(card, cpu, f"{spec} card vs CPU")
        parity.append(spec)
    join = Solver(get_game("connect4:w=4,h=4,sym=1"), device="cuda",
                  use_provenance=False).solve()
    _same_tables(join, cpu, "connect4 4x4 sym=1 join on card vs CPU")
    emit("classic small", known=known, card_cpu_identical=parity,
         join_route_identical=True, secs=time.perf_counter() - t0)


def classic_5x5_phase(dense_result):
    import numpy as np

    result, report = cli_solve(["solve", "connect4:w=5,h=5",
                                "--engine", "classic"])
    s = result.stats
    got = (result.num_positions, result.value, result.remoteness)
    if got != (69763700, 3, 25) or s["engine"] != "classic":
        raise AssertionError(f"classic 5x5 (positions, value, rem) {got} != "
                             "(69763700, TIE=3, 25)")
    if s["misses"] != 0:
        raise AssertionError(f"classic 5x5: {s['misses']} lookup misses")
    # The same answers as the dense engine, on sampled positions.
    rng = np.random.default_rng(5)
    checked = 0
    for k, t in sorted(result.levels.items()):
        for i in rng.integers(0, t.states.shape[0], size=80):
            want = dense_result.lookup(int(t.states[i]))
            if want != (int(t.values[i]), int(t.remoteness[i])):
                raise AssertionError(
                    f"level {k} state {int(t.states[i]):#x}: classic "
                    f"{(int(t.values[i]), int(t.remoteness[i]))} != dense "
                    f"{want}")
            checked += 1
    emit("classic 5x5", report=report, positions=got[0], value="TIE",
         remoteness=got[2], secs_forward=s["secs_forward"],
         secs_backward=s["secs_backward"],
         positions_per_sec=s["positions_per_sec"],
         peak_mem_bytes=s["peak_mem_bytes"], levels=s["levels"],
         provenance_levels=s["provenance_levels"], misses=s["misses"],
         dense_agreement_checked=checked)


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
    d = double_phase(dev, rate)
    dense_small_phase(dev)
    dense_launches, dense_result = dense_5x5_phase()
    bench_launches = microbench_phase(dev)
    classic_small_phase()
    classic_5x5_phase(dense_result)

    def row(name, source, replaces, launches, m):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": "bytes", "library_ms": m["library_ms"]}

    print(json.dumps({"kernels": [
        # Launches on the path that runs each kernel: the dense solve for
        # the gather, the microbench for the doubling.
        row("monotone_window_gather",
            "gamesmanmpi_tpu_torch/kernels/csrc/window_gather.cu",
            "gamesmanmpi_tpu/ops/pallas_gather.py:116",
            dense_launches["monotone_window_gather"], k),
        row("double_u32",
            "gamesmanmpi_tpu_torch/kernels/csrc/double_u32.cu",
            "tools/microbench2.py:210",
            bench_launches["double_u32"], d),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
