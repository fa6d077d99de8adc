"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. env     — torch/CUDA versions, the card's name and power limit.
2. build   — nvcc builds every kernel from kernels/csrc, one nvcc per
             source, all started together (timed, with each kernel's
             ptxas register/shared-memory/spill report).
3. kernel monotone_window_gather — the CUDA kernel against the plain
             PyTorch version on the card: u8/u32 tables, int32/int64
             indices, all-hit and missing index vectors, ragged lengths;
             `out` bit-identical and `nmiss` equal. Then at each shape of
             bench/kernel_cases.GATHER_SHAPES (the dense 5x5 backward's
             largest launch, microbench section 7b, 64M into 32M u8):
             bit-identical, and the kernel, `table[idx]` and the plain
             version timed in turns (medians of 10 samples over 5 rounds),
             beside the byte bound.
4. kernel double_u32 — the CUDA kernel bit-identical to the plain
             version at N in {1, 3, 1023, 1M, 1M+1, 32M} (seeded values
             with 0, 2^31, 2^31+5 and 2^32-1 at both ends), on aligned
             tensors and on views one element in (the scalar path). Then
             at 32M the kernel, the library call and the plain version
             timed in turns, beside the byte bound.
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
10. checkpoint classic 5x5 — `solve connect4:w=5,h=5 --checkpoint-dir D`
             (auto routes a checkpointed solve to the classic engine):
             in-process, uninterrupted; then in a child process killed by
             GAMESMAN_FAULTS=engine.backward:kill:13 (exit 77), rerun on D
             (69,763,700 / TIE / 25; every level sealed before the kill
             keeps its mtime and crc, so it was loaded, not recomputed),
             every level file equal member for member to phase 9's tables,
             and `--no-tables --checkpoint-dir D --query` on 312 sampled
             positions answering as phase 9's `lookup`.
11. checkpoint dense 5x5 — `solve connect4:w=5,h=5 --engine dense
             --checkpoint-dir D2` in-process, uninterrupted, both ways (the
             gather's launches counted); then in a child process, SIGKILLed once the
             manifest lists 5 dense levels; the rerun on D2 resumes
             (`levels_resumed` > 0), launches the window gather on the
             levels it recomputes (`nmiss` counted there), and every
             dense_NNNN.npz holds phase 6's cells byte for byte.

Then the kernels line, the `nvidia-smi` name/power-limit line, and last
`{"ok": true, "device": {...}}`. It imports nothing of JAX or of the JAX
package, and exits non-zero without printing a result when there is no
card (or when run without the rest of the repository beside it).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import torch


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def ptxas_summary(report: str) -> dict:
    """Kernel entry function (mangled) -> its registers and spills, from
    nvcc's -Xptxas=-v report."""
    out, fn, spill = {}, None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn, spill = m.group(1), ""
        elif "spill stores" in line:
            spill = line.strip()
        elif fn and "Used" in line and "registers" in line:
            out[fn] = f"{line.split('ptxas info    : ')[-1].strip()}; {spill}"
    return out


def signed_view(t: torch.Tensor) -> torch.Tensor:
    """Same-size signed view: torch's CUDA index and compare kernels do
    not cover every unsigned dtype."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def as_signed(t: torch.Tensor) -> torch.Tensor:
    """Widened signed view, for differences of unsigned tensors."""
    return signed_view(t).to(torch.int64)


def timed(times: dict, kernel: str, plain: str, library: str,
          bound_ms: float) -> dict:
    """A kernel's numbers from one time_turns call: medians, spread."""
    k = times[kernel]
    return dict(ms=k["median_ms"], ms_min=k["min_ms"], ms_max=k["max_ms"],
                samples=k["samples"], plain_ms=times[plain]["median_ms"],
                library_ms=times[library]["median_ms"], bound_ms=bound_ms,
                bound_share=bound_ms / k["median_ms"])


def kernel_phase(dev, rate):
    from gamesmanmpi_tpu_torch.bench.kernel_cases import (
        gather_bound_bytes,
        gather_shapes,
        time_turns,
    )
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
                        ref, nm_ref = monotone_window_gather_ref(
                            table, idx, block, window)
                        out, nm = monotone_window_gather(table, idx, block,
                                                         window)
                        torch.cuda.synchronize()
                        err = int((as_signed(out) - as_signed(ref)).abs()
                                  .max()) if n else 0
                        if err != 0 or int(nm) != int(nm_ref):
                            raise AssertionError(
                                f"window gather mismatch: {tdtype} {idtype} "
                                f"{kind} n={n} block={block}: max err {err}, "
                                f"nmiss {int(nm)} vs {int(nm_ref)}")
                        worst = max(worst, err)
                        cases += 1
                        if kind == "hits" and block == 2048 and int(nm_ref):
                            raise AssertionError(
                                f"near-monotone idx missed: nmiss="
                                f"{int(nm_ref)}")

    # The shapes the port runs it at (bench/kernel_cases.GATHER_SHAPES),
    # first the dense 5x5 backward's largest launch: bit-identical, then
    # the kernel, table[idx] and the plain version timed in turns.
    shapes = []
    for label, table, idx in gather_shapes(dev):
        n, m = idx.shape[0], table.shape[0]
        ref, nm_ref = monotone_window_gather_ref(table, idx)
        out, nm = monotone_window_gather(table, idx)
        if not torch.equal(signed_view(out), signed_view(ref)) \
                or int(nm) != int(nm_ref):
            err = int((as_signed(out) - as_signed(ref)).abs().max())
            raise AssertionError(f"{label} gather mismatch: err {err}, "
                                 f"nmiss {int(nm)} vs {int(nm_ref)}")
        del out, ref
        signed = signed_view(table)
        times = time_turns({
            "kernel": lambda: monotone_window_gather(table, idx),
            "library": lambda: signed[idx],
            "plain": lambda: monotone_window_gather_ref(table, idx)})
        nbytes = gather_bound_bytes(n, m, idx.element_size(),
                                    table.element_size())
        row = dict(shape=label, n=n, m=m, idx_dtype=str(idx.dtype),
                   table_dtype=str(table.dtype), nmiss=int(nm_ref),
                   bound_bytes=nbytes,
                   **timed(times, "kernel", "plain", "library",
                           nbytes / rate * 1e3))
        emit("kernel monotone_window_gather", **row)
        shapes.append(row)
    emit("kernel monotone_window_gather cases", cases=cases,
         max_abs_err=worst, library_call="table[idx]",
         hbm_bytes_per_sec=rate)
    return dict(shapes[0], max_abs_err=worst, shapes=shapes)


def double_phase(dev, rate):
    from gamesmanmpi_tpu_torch.bench.kernel_cases import (
        double_bound_bytes,
        time_turns,
    )
    from gamesmanmpi_tpu_torch.core.codec import i64_to_u32
    from gamesmanmpi_tpu_torch.ops.elementwise import (
        double_u32,
        double_u32_ref,
    )

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
            ref = double_u32_ref(view)
            out = double_u32(view)
            torch.cuda.synchronize()
            err = int((as_signed(out) - as_signed(ref)).abs().max())
            if err != 0 or out.shape != view.shape:
                raise AssertionError(
                    f"double_u32 mismatch at n={n} offset="
                    f"{view.storage_offset()}: max err {err}")
            worst = max(worst, err)
            cases += 1

    n = 32 << 20
    x = torch.randint(0, 1 << 32, (n,), generator=gen)
    x = i64_to_u32(x).to(dev)
    # The int32 view gives the same bits as a uint32 multiply, on every
    # torch (some lack uint32 `*` on CUDA).
    library = "x.view(torch.int32) * 2"
    if not torch.equal(x.view(torch.int32) * 2,
                       double_u32(x).view(torch.int32)):
        raise AssertionError(f"library call {library} disagrees with the "
                             "kernel at 32M")
    times = time_turns({"kernel": lambda: double_u32(x),
                        "library": lambda: x.view(torch.int32) * 2,
                        "plain": lambda: double_u32_ref(x)})
    nbytes = double_bound_bytes(n)
    row = dict(n=n, bound_bytes=nbytes,
               **timed(times, "kernel", "plain", "library",
                       nbytes / rate * 1e3))
    emit("kernel double_u32", cases=cases, max_abs_err=worst,
         library_call=library, hbm_bytes_per_sec=rate, **row)
    return dict(row, max_abs_err=worst)


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
    return result


#: The CLI in a child process: its report, then as the last line the
#: solve's stats and the kernels' launch counts (reset just before).
CHILD = """
import json, sys
from gamesmanmpi_tpu_torch import kernels
from gamesmanmpi_tpu_torch.cli import solve_main
kernels.reset_launches()
rc, result = solve_main(sys.argv[1:])
print(json.dumps({"rc": rc, "launches": dict(kernels.LAUNCHES),
                  "stats": None if result is None else result.stats},
                 default=str), flush=True)
sys.exit(rc)
"""

REPO = pathlib.Path(__file__).resolve().parent
C55 = "connect4:w=5,h=5"


def child(argv, env=None):
    """Popen of the CLI child, from the repository root."""
    return subprocess.Popen(
        [sys.executable, "-c", CHILD, *argv], cwd=REPO,
        env=dict(os.environ, **(env or {})), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def stop(proc) -> None:
    """Kill a child still running (on an error or a timeout)."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def run_child(argv, want_rc, env=None):
    """Run the CLI child to its end: -> (report lines, last-line record,
    seconds); raises unless it exits want_rc."""
    t0 = time.perf_counter()
    proc = child(argv, env)
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        stop(proc)
    secs = time.perf_counter() - t0
    if proc.returncode != want_rc:
        raise AssertionError(f"child {argv} exited {proc.returncode}, not "
                             f"{want_rc}:\n{out[-2000:]}\n{err[-4000:]}")
    lines = out.splitlines()
    rec = json.loads(lines[-1]) if want_rc == 0 else None
    return lines, rec, secs


def report_answer(lines):
    got = {ln.split(":")[0]: ln.split(": ", 1)[1] for ln in lines
           if ln.startswith(("positions:", "value:", "remoteness:"))}
    return int(got["positions"]), got["value"], int(got["remoteness"])


def disk_bytes(d):
    return sum(p.stat().st_size for p in pathlib.Path(d).iterdir())


def manifest(d):
    return json.loads((pathlib.Path(d) / "manifest.json").read_text())


def uninterrupted(argv, d, answer):
    """An uninterrupted checkpointed CLI solve in-process, then its
    directory's bytes on disk (the directory is removed): -> (stats,
    disk bytes)."""
    result, report = cli_solve([*argv, "--checkpoint-dir", str(d)])
    if report_answer(report) != answer:
        raise AssertionError(f"checkpointed {argv}: {report}")
    disk = disk_bytes(d)
    shutil.rmtree(d)
    return result.stats, disk


def seal_fields(s, disk):
    return dict(secs_forward=s["secs_forward"],
                secs_backward=s["secs_backward"],
                ckpt_bytes_raw=s["ckpt_bytes_raw"],
                ckpt_bytes_stored=s["ckpt_bytes_stored"],
                ckpt_save_secs=s["ckpt_save_secs"], disk_bytes=disk,
                io_wait_secs=s["io_wait_secs"],
                peak_mem_bytes=s.get("peak_mem_bytes"))


def checkpoint_classic_phase(result, tmp, spec=C55,
                             answer=(69763700, "TIE", 25), extra=()):
    """Phase 10: the classic engine's checkpoint on the card. `result` is
    the uninterrupted solve of `spec` (phase 9's); `extra` CLI arguments
    (`--device cpu`) rehearse the phase on the CPU at a small board."""
    import numpy as np

    from gamesmanmpi_tpu_torch.core.bitops import to_reference
    from gamesmanmpi_tpu_torch.core.codec import pack_cells_np
    from gamesmanmpi_tpu_torch.core.values import value_name
    from gamesmanmpi_tpu_torch.store import file_crc32, read_npz_members

    t0 = time.perf_counter()
    # Uninterrupted, in-process: what sealing costs the solve.
    s0, full_disk = uninterrupted(["solve", spec, *extra],
                                  tmp / "classic_full", answer)
    if s0["engine"] != "classic":
        raise AssertionError(f"checkpointed {spec} ran {s0['engine']}")

    d = tmp / "classic"
    argv = ["solve", spec, "--checkpoint-dir", str(d), *extra]
    nlev = len(result.levels)
    kill = nlev // 2  # the backward's 13th level of 26: level 13
    _, _, secs_killed = run_child(
        argv, 77, {"GAMESMAN_FAULTS": f"engine.backward:kill:{kill}"})
    m = manifest(d)
    sealed = sorted(m["levels"])
    if sealed != list(range(nlev - kill + 1, nlev)) \
            or not m.get("frontiers_complete"):
        raise AssertionError(f"killed run sealed levels {sealed}, frontiers "
                             f"complete {m.get('frontiers_complete')}")
    before = {k: ((d / f"level_{k:04d}.npz").stat().st_mtime_ns,
                  m["crc"][f"level_{k:04d}.npz"]) for k in sealed}
    lines, rec, secs_resumed = run_child(argv, 0)
    if report_answer(lines) != answer:
        raise AssertionError(f"resumed classic {spec}: {lines}")
    m = manifest(d)
    for k, (mtime, crc) in before.items():
        name = f"level_{k:04d}.npz"
        now = ((d / name).stat().st_mtime_ns, m["crc"][name])
        if now != (mtime, crc) or file_crc32(d / name) != crc:
            raise AssertionError(f"{name} was rewritten by the resume")
    if sorted(m["levels"]) != list(range(nlev)):
        raise AssertionError(f"resume sealed {sorted(m['levels'])}")
    # Every sealed level, member for member, against phase 9's tables.
    g = result.game
    for k, t in sorted(result.levels.items()):
        states, cells = read_npz_members(d / f"level_{k:04d}.npz",
                                         ("states", "cells"))
        want_s = to_reference(t.states, g)
        want_c = pack_cells_np(t.values, t.remoteness)
        if states.dtype != want_s.dtype or cells.dtype != np.uint32 \
                or not np.array_equal(states, want_s) \
                or not np.array_equal(cells, want_c):
            raise AssertionError(f"level {k} file differs from the "
                                 "uninterrupted tables")
    # Point queries answered from the directory (--no-tables), in level
    # order so each level's file is read once.
    rng = np.random.default_rng(7)
    queries, want = [], []
    for k, t in sorted(result.levels.items()):
        for i in rng.integers(0, t.states.shape[0], size=12):
            s = int(t.states[i])
            queries.append(hex(s))
            v, r = result.lookup(s)
            want.append(f"query {hex(s)}: value={value_name(v)} "
                        f"remoteness={r}")
    qargs = [a for q in queries for a in ("--query", q)]
    lines, qrec, secs_query = run_child(argv + ["--no-tables", *qargs], 0)
    got = [ln for ln in lines if ln.startswith("query ")]
    if got != want:
        bad = [(a, b) for a, b in zip(got, want) if a != b][:3]
        raise AssertionError(f"checkpoint queries differ: {bad}")
    disk = disk_bytes(d)
    s1, s2 = rec["stats"], qrec["stats"]
    emit(f"checkpoint classic {spec}", positions=answer[0], value=answer[1],
         remoteness=answer[2],
         no_checkpoint=dict(secs_forward=result.stats["secs_forward"],
                            secs_backward=result.stats["secs_backward"]),
         uninterrupted=seal_fields(s0, full_disk),
         killed=dict(exit=77, levels_sealed=len(sealed), secs=secs_killed),
         resumed=dict(secs=secs_resumed, secs_forward=s1["secs_forward"],
                      secs_backward=s1["secs_backward"],
                      ckpt_bytes_raw=s1["ckpt_bytes_raw"],
                      ckpt_bytes_stored=s1["ckpt_bytes_stored"],
                      ckpt_save_secs=s1["ckpt_save_secs"],
                      io_wait_secs=s1["io_wait_secs"],
                      sealed_levels_untouched=len(before)),
         query=dict(positions=len(queries), secs=secs_query,
                    secs_forward=s2["secs_forward"],
                    secs_backward=s2["secs_backward"],
                    io_wait_secs=s2["io_wait_secs"],
                    ckpt_bytes_raw=s2["ckpt_bytes_raw"]),
         disk_bytes=disk, levels_equal_tables=len(result.levels),
         secs=time.perf_counter() - t0)


def checkpoint_dense_phase(dense_result, tmp, spec=C55,
                           answer=(69763700, "TIE", 25), extra=()):
    """Phase 11: the dense engine's checkpoint on the card; the slice's
    kernel path (the window gather on the recomputed levels).
    `dense_result` is the uninterrupted solve of `spec` (phase 6's)."""
    import numpy as np

    from gamesmanmpi_tpu_torch.store import read_npz_members

    from gamesmanmpi_tpu_torch import kernels

    t0 = time.perf_counter()
    nlev = len(dense_result.cells)
    on_card = "cpu" not in extra  # a CPU rehearsal takes the plain version
    # Uninterrupted, in-process, launches counted: what sealing costs.
    kernels.reset_launches()
    s0, full_disk = uninterrupted(["solve", spec, "--engine", "dense",
                                   *extra], tmp / "dense_full", answer)
    full_launches = kernels.LAUNCHES["monotone_window_gather"]
    if (full_launches > 0) != on_card:
        raise AssertionError(f"checkpointed dense {spec}: {full_launches} "
                             "gather launches")

    d = tmp / "dense"
    argv = ["solve", spec, "--engine", "dense", "--checkpoint-dir", str(d),
            *extra]
    t_kill = time.perf_counter()
    proc = child(argv)
    try:
        deadline = time.monotonic() + 600
        listed = []
        while proc.poll() is None and time.monotonic() < deadline:
            try:
                listed = manifest(d).get("dense_levels", [])
            except FileNotFoundError:
                listed = []
            if len(listed) >= 5:
                proc.send_signal(signal.SIGKILL)
                break
            time.sleep(0.002)
        _, err = proc.communicate(timeout=60)
    finally:
        stop(proc)
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"dense child was not killed mid-solve: exit "
                             f"{proc.returncode}, listed {listed}\n"
                             f"{err[-4000:]}")
    secs_killed = time.perf_counter() - t_kill
    sealed = manifest(d)["dense_levels"]
    if len(sealed) >= nlev:
        raise AssertionError("the dense child sealed every level first")
    lines, rec, secs_resumed = run_child(argv, 0)
    s = rec["stats"]
    if report_answer(lines) != answer:
        raise AssertionError(f"resumed dense {spec}: {lines}")
    # Levels K..25 were loaded; K-1..0 recomputed, each through the gather.
    K = nlev - s["levels_resumed"]
    if s["levels_resumed"] != len(sealed) or K <= 0:
        raise AssertionError(f"levels_resumed {s['levels_resumed']} for "
                             f"sealed {sorted(sealed)}")
    launches = rec["launches"]["monotone_window_gather"]
    nmiss = {int(L): v for L, v in s["gather_nmiss_per_level"].items()}
    if (launches <= 0) == on_card or sorted(nmiss) != list(range(K)):
        raise AssertionError(f"gather launches {launches}, nmiss counted on "
                             f"levels {sorted(nmiss)}, recomputed 0..{K - 1}")
    for L, cells in sorted(dense_result.cells.items()):
        (got,) = read_npz_members(d / f"dense_{L:04d}.npz", ("cells",))
        if got.dtype != np.uint8 or got.tobytes() != cells.tobytes():
            raise AssertionError(f"dense_{L:04d}.npz differs from the "
                                 "uninterrupted cells")
    emit(f"checkpoint dense {spec}", positions=answer[0], value=answer[1],
         remoteness=answer[2],
         killed=dict(signal="SIGKILL", levels_sealed=len(sealed),
                     secs=secs_killed),
         resumed=dict(secs=secs_resumed, levels_resumed=s["levels_resumed"],
                      secs_forward=s["secs_forward"],
                      secs_backward=s["secs_backward"],
                      secs_count_reachable=s["secs_count_reachable"],
                      ckpt_bytes_raw=s["ckpt_bytes_raw"],
                      ckpt_bytes_stored=s["ckpt_bytes_stored"],
                      ckpt_save_secs=s["ckpt_save_secs"],
                      io_wait_secs=s["io_wait_secs"],
                      gather_launches=launches,
                      gather_nmiss=s["gather_nmiss"]),
         uninterrupted=dict(seal_fields(s0, full_disk),
                            gather_launches=full_launches,
                            gather_nmiss=s0["gather_nmiss"]),
         no_checkpoint=dict(
             secs_backward=dense_result.stats["secs_backward"],
             encodable_positions=dense_result.stats["encodable_positions"]),
         disk_bytes=disk_bytes(d), cells_identical_levels=nlev,
         secs=time.perf_counter() - t0)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from gamesmanmpi_tpu_torch.bench.kernel_cases import (
        hbm_bytes_per_sec,
        nvidia_smi_line,
    )
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
         ptxas={k: ptxas_summary(v) for k, v in build.PTXAS_REPORT.items()})

    k = kernel_phase(dev, rate)
    d = double_phase(dev, rate)
    dense_small_phase(dev)
    dense_launches, dense_result = dense_5x5_phase()
    bench_launches = microbench_phase(dev)
    classic_small_phase()
    classic_result = classic_5x5_phase(dense_result)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        checkpoint_classic_phase(classic_result, tmp)
        del classic_result
        checkpoint_dense_phase(dense_result, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def row(name, source, replaces, launches, m):
        r = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": m["max_abs_err"], "ms": m["ms"],
             "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
             "bound_by": "bytes", "library_ms": m["library_ms"],
             "bound_share": m["bound_share"]}
        if "shapes" in m:
            r["shapes"] = [{k: s[k] for k in (
                "shape", "n", "m", "ms", "plain_ms", "library_ms",
                "bound_ms", "bound_share")} for s in m["shapes"]]
        return r

    print(json.dumps({"kernels": [
        # Launches on the path that runs each kernel: the dense solve for
        # the gather (times at its largest launch's shape, then every
        # shape), the microbench for the doubling.
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
