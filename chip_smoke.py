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
12. db 5x5 — the solved-position DB, in CLI children: `export-db` from
             a fresh classic solve streamed into the writer (69,763,700
             positions, 26 levels), from phase 10's uninterrupted
             checkpoint (every file the same sha256, `db_equal` clean),
             and as format v2 with an 8-ply opening book (`check_db`,
             `db_equal` against v1 and `verify_book` clean); each
             export's seconds and peak RSS. Then 2^20 positions (2^19
             sampled from phase 9's tables, 2^19 random 30-bit states)
             through `DbReader` on the card over v1 and v2: `lookup`
             equal to the classic tables (found iff reachable),
             `lookup_best` equal to a CPU reader's on every lane, each
             best move a legal child realizing the value; and a `query`
             child printing the in-process reader's lines.
13. serve 5x5 — serving over phase 12's databases, in CLI children
             (`python -m gamesmanmpi_tpu_torch serve`): a 2-worker fleet
             on the card over v1 (spawn mode, each worker's seconds to
             ready, peak RSS and device memory), a fixed 256-position
             set and a 10 s tools/load_gen.py load (concurrency 8, 8
             positions per request, zipf 1.1 over 4,096 sampled
             reachable states plus the reachable ones among 2^16 random
             states) held to the classic tables; a second load with one
             worker SIGKILLed (dropped at most the 8 in flight, one
             restart, the replacement ready); a third under POST /reload
             with no failed request; SIGTERM exits 0. The same fleet
             with --device cpu for the device comparison. Then v2 +
             book: a single process under 5 s of conditional GETs (304s,
             book hits) and a 2-worker fleet's shm counters.
14. sharded 5x5 — the hash-partitioned sharded engine: (a) `solve
             connect4:w=5,h=5 --devices 4` in-process with
             GAMESMAN_FAKE_DEVICES=4 (4 shards share the card): 69,763,700
             / TIE / 25 and every level's (states, values, remoteness)
             identical to phase 9's; forward/backward seconds, positions/s,
             peak memory, exchange bytes and seconds per direction, syncs
             per level, backend. (b) connect4 5x4 with --devices 2 and 8,
             with GAMESMAN_BACKWARD=lookup, and nim 3-4-5 and chomp 4x3 on
             the generic path, each identical to the classic engine on the
             card. (c) a 2-process world on the one card through
             parallel/launch.py (`solve connect4:w=5,h=4 --devices 4
             --table-out`, gloo moving CUDA tensors): both ranks exit 0,
             their tables identical to each other and to (b)'s
             one-process `--devices 4` table. (d) in that world, a
             transient on rank 1 only is a retry on both ranks, with equal
             counts and the same tables; rank 1 SIGKILLed in its third
             backward step ends rank 0 with exit 124 (the coordinated
             abort) within the barrier deadline.
15. sharded checkpoint, meshed dense, hybrid 5x5 — (a) `solve
             connect4:w=5,h=5 --devices 4 --checkpoint-dir D` in-process
             (GAMESMAN_FAKE_DEVICES=4, default compression): 69,763,700 /
             TIE / 25, every level identical to phase 9's, every level
             sealed per shard with the edges and the frontier snapshot;
             the seal seconds and the bytes raw, stored and on disk. (b)
             A child killed by GAMESMAN_FAULTS=sharded.backward:kill:10
             exits 77; the rerun on a (hard-linked) copy resumes to phase
             9's tables, every level shard sealed before the kill keeping
             its mtime and crc. (c) Copies of the killed tree resumed at
             --devices 2 and 8 report resharded_from 4, tables identical.
             (b) and (c) set GAMESMAN_CKPT_COMPRESS=0 (raw files) to keep
             the phase short. (d) `export-db --from-checkpoint D` writes
             phase 12's v1 files (sha256). (e) A 2-process world on the
             card (5x4, --devices 4 --checkpoint-dir): rank 1 SIGKILLed in
             the backward, rank 0 exits 124; the world's rerun resumes,
             and a one-process --devices 4 run resumes a copy of the same
             directory; both tables equal phase 14's one-process table.
             (f) `--engine dense --devices 4`: cells byte-identical to
             phase 6's and the same nmiss per level, the gather's launches
             counted. (g) `--engine hybrid --hybrid-cutover 16`, on one
             device and with --devices 4: 69,763,700 / TIE / 25, the BFS
             region's levels 17-25 identical to phase 9's, the answers of
             20,000 sampled reachable states of levels 0-16 equal phase
             9's, the gather's launches counted; then hybrid sym=1 at 5x4
             against the classic engine. (f) and (g)'s one-device hybrid
             each run twice more: once with every window gather of the
             path held against the plain version on its own inputs (`out`
             bit-identical, `nmiss` equal, as many launches as the counted
             run, the plain nmiss summing to the run's), and once with
             GAMESMAN_DENSE_GATHER=plain; both runs' dense cells equal the
             counted run's byte for byte. Each run's seconds and peak
             memory beside the dense and classic numbers of the call.

Then the script's seconds, the kernels line, the `nvidia-smi`
name/power-limit line, and last
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


def uninterrupted(argv, d, answer, keep=False):
    """An uninterrupted checkpointed CLI solve in-process, then its
    directory's bytes on disk (the directory is removed unless `keep`):
    -> (stats, disk bytes)."""
    result, report = cli_solve([*argv, "--checkpoint-dir", str(d)])
    if report_answer(report) != answer:
        raise AssertionError(f"checkpointed {argv}: {report}")
    disk = disk_bytes(d)
    if not keep:
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
    # Kept: phase 12 converts it into a database.
    s0, full_disk = uninterrupted(["solve", spec, *extra],
                                  tmp / "classic_full", answer, keep=True)
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


def rss_bytes(pid="self"):
    """The resident set of process `pid` (this one by default) now
    (/proc/<pid>/statm), or None where the kernel does not report it."""
    try:
        pages = int(pathlib.Path(f"/proc/{pid}/statm").read_text().split()[1])
    except (OSError, IndexError, ValueError):
        return None
    return pages * os.sysconf("SC_PAGE_SIZE")


class PeakRss:
    """The peak of rss_bytes() over a `with` block, sampled every 20 ms
    on a thread (ru_maxrss would carry the forking parent's peak, and
    VmHWM is not reported everywhere). `peak` is None when the resident
    set cannot be read."""

    def __enter__(self):
        import threading

        self.peak = rss_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.02):
            now = rss_bytes()
            if now is not None:
                self.peak = max(self.peak or 0, now)

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        now = rss_bytes()
        if now is not None:
            self.peak = max(self.peak or 0, now)
        return False


#: The CLI in a child process for a command that solves nothing
#: (export-db, query): its output, then as the last line its exit code
#: and its peak resident set.
DB_CHILD = """
import json, sys
import chip_smoke
from gamesmanmpi_tpu_torch.cli import main
with chip_smoke.PeakRss() as rss:
    rc = main(sys.argv[1:])
print(json.dumps({"rc": rc, "peak_rss_bytes": rss.peak}), flush=True)
sys.exit(rc)
"""


def run_db_child(argv):
    """Run DB_CHILD to its end: -> (output lines, peak RSS bytes,
    seconds); raises unless it exits 0."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", DB_CHILD, *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    if proc.returncode != 0:
        raise AssertionError(f"child {argv} exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return lines[:-1], json.loads(lines[-1])["peak_rss_bytes"], secs


def export_child(argv, answer, nlevels):
    """An export-db child: its positions and levels lines checked."""
    lines, rss, secs = run_db_child(["export-db", *argv])
    got = {ln.split(": ")[0]: ln.split(": ", 1)[1] for ln in lines
           if ": " in ln}
    if int(got["positions"]) != answer[0] or int(got["levels"]) != nlevels:
        raise AssertionError(f"export-db {argv}: {lines}")
    return lines, rss, secs


def digests(d):
    import hashlib

    out = {}
    for p in sorted(pathlib.Path(d).iterdir()):
        h = hashlib.sha256()
        with open(p, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 24), b""):
                h.update(chunk)
        out[p.name] = h.hexdigest()
    return out


def sample_states(result, n, seed):
    """n states drawn with replacement from every level's table (a level
    weighted by its size) -> (int64 states, values, remoteness)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    levels = sorted(result.levels)
    sizes = np.array([result.levels[k].states.shape[0] for k in levels])
    ends = np.cumsum(sizes)
    u = np.sort(rng.integers(0, int(ends[-1]), size=n))
    which = np.searchsorted(ends, u, side="right")
    parts = ([], [], [])
    for i, k in enumerate(levels):
        idx = u[which == i] - (ends[i] - sizes[i])
        t = result.levels[k]
        for part, arr in zip(parts, (t.states, t.values, t.remoteness)):
            part.append(arr[idx])
    return tuple(np.concatenate(p) for p in parts)


def table_truth(result, states, device):
    """The solve's answer for arbitrary states: found iff the state is in
    the table of its level (Connect-4 sym=0: canonical = raw), with its
    value and remoteness -> (found, values, remoteness)."""
    import numpy as np

    g = result.game
    lv = g.level_of(torch.from_numpy(states).to(device)).cpu().numpy()
    found = np.zeros(states.shape, dtype=bool)
    values = np.zeros(states.shape, dtype=np.uint8)
    rem = np.zeros(states.shape, dtype=np.int32)
    for k, t in result.levels.items():
        sel = np.nonzero(lv == k)[0]
        i = np.minimum(np.searchsorted(t.states, states[sel]),
                       t.states.shape[0] - 1)
        hit = t.states[i] == states[sel]
        found[sel[hit]] = True
        values[sel[hit]] = t.values[i[hit]]
        rem[sel[hit]] = t.remoteness[i[hit]]
    return found, values, rem


def best_moves_check(reader, q, values, rem, found, best):
    """Each best move is a legal child of the raw query whose stored value
    is the combine's pick (WIN -> a LOSE child, LOSE -> WIN, TIE -> TIE)
    at one less remoteness; terminal positions and misses get the
    reference's sentinel. -> the number of best moves checked."""
    import numpy as np

    from gamesmanmpi_tpu_torch.core.values import UNDECIDED

    g = reader.game
    has = best != g.sentinel
    if has[~found].any():
        raise AssertionError("a best move for a position not found")
    rows = np.nonzero(found)[0]
    states = torch.from_numpy(q[rows].astype(np.int64)).to(reader.device)
    kids, mask = g.expand(states)
    prim = g.primitive(states)
    mask = (mask & (prim == UNDECIDED).unsqueeze(-1)).cpu().numpy()
    kids = np.where(mask, kids.cpu().numpy(), -1)
    if (has[rows] != mask.any(axis=1)).any():
        raise AssertionError("best move present iff the position has moves "
                             "does not hold")
    r = rows[has[rows]]
    legal = (kids[has[rows]] == best[r, None].astype(np.int64)).any(axis=1)
    bv, br, bf = reader.lookup(best[r])
    want = np.array([0, 2, 1, 3], dtype=np.uint8)[values[r]]
    if not (legal.all() and bf.all() and (bv == want).all()
            and (br == rem[r] - 1).all()):
        raise AssertionError("a best move is not a legal child realizing "
                             "the position's value")
    return int(r.size)


def db_phase(result, tmp, spec=C55, answer=(69763700, "TIE", 25),
             extra=(), book_plies=8):
    """Phase 12: the solved-position DB on the card, at the main path's
    width. `result` is phase 9's in-process classic solve of `spec`, and
    tmp / "classic_full" phase 10's uninterrupted checkpoint of it;
    `extra` CLI arguments (`--device cpu`) rehearse the phase on the CPU
    at a small board. -> the v1 and the v2 + book directories (phase
    13 serves them; the caller removes them)."""
    import numpy as np

    from gamesmanmpi_tpu_torch.core.bitops import to_reference
    from gamesmanmpi_tpu_torch.db import DbReader, check_db
    from gamesmanmpi_tpu_torch.db.book import verify_book
    from gamesmanmpi_tpu_torch.db.check import db_equal

    t0 = time.perf_counter()
    on_card = "cpu" not in extra
    device = "cuda" if on_card else "cpu"
    nlev = len(result.levels)
    parent_rss = rss_bytes()  # holding phase 9's tables
    a, b, c = tmp / "db_a", tmp / "db_b", tmp / "db_c"
    ckpt = tmp / "classic_full"
    # 1. A fresh classic solve streamed into the writer (level_sink).
    _, rss_a, secs_a = export_child([spec, "--out", str(a), *extra],
                                    answer, nlev)
    # 2. The same DB converted from phase 10's checkpoint: the same bytes.
    _, rss_b, secs_b = export_child([spec, "--from-checkpoint", str(ckpt),
                                     "--out", str(b), *extra], answer, nlev)
    da = digests(a)
    if da != digests(b) or db_equal(a, b) != []:
        raise AssertionError("streamed and from-checkpoint exports differ")
    # 3. Format v2 with an opening book, from the checkpoint.
    lines_c, rss_c, secs_c = export_child(
        [spec, "--from-checkpoint", str(ckpt), "--compress", "--book-plies",
         str(book_plies), "--out", str(c), *extra], answer, nlev)
    t = time.perf_counter()
    problems = check_db(c) + db_equal(a, c)
    secs_check = time.perf_counter() - t
    t = time.perf_counter()
    problems += verify_book(c, device=device)
    secs_verify_book = time.perf_counter() - t
    if problems:
        raise AssertionError(f"v2 DB: {problems[:3]}")
    mc = manifest(c)
    # 4. 2^20 lookups on the card: 2^19 sampled reachable states, 2^19
    # random states of the 30-bit space (mostly unreachable).
    g = result.game
    half = 1 << 19
    s_states, s_values, s_rem = sample_states(result, half, seed=12)
    rand = np.random.default_rng(13).integers(0, 1 << g.state_bits,
                                              size=half)
    r_found, r_values, r_rem = table_truth(result, rand, device)
    q = to_reference(np.concatenate([s_states, rand]), g)
    want_found = np.concatenate([np.ones(half, dtype=bool), r_found])
    want_values = np.concatenate([s_values, r_values])
    want_rem = np.concatenate([s_rem, r_rem])
    secs = {}
    answers = {}
    for label, d, dev in (("v1_" + device, a, device), ("v2_" + device, c,
                                                         device),
                          ("v1_cpu_reader", a, "cpu")):
        with DbReader(d, device=dev) as reader:
            reader.lookup(q[:1024])  # first touch: mmaps, blocks, kernels
            t = time.perf_counter()
            values, rem, found = reader.lookup(q)
            secs[f"lookup_{label}"] = time.perf_counter() - t
            t = time.perf_counter()
            got = reader.lookup_best(q)
            secs[f"lookup_best_{label}"] = time.perf_counter() - t
            if not (np.array_equal(found, want_found)
                    and np.array_equal(values[found], want_values[found])
                    and np.array_equal(rem[found], want_rem[found])
                    and (values[~found] == 0).all()):
                raise AssertionError(f"{label} lookup differs from the "
                                     "classic tables")
            answers[label] = got
            if label == "v1_" + device:
                checked = best_moves_check(reader, q, *got)
    for label, got in answers.items():
        for x, y in zip(got, answers["v1_cpu_reader"]):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(f"{label} lookup_best differs from "
                                     "the CPU reader")
    # 5. `query` in a child: the in-process reader's lines.
    picks = [hex(int(q[i])) for i in (half // 3, 2 * half // 3, half - 1)]
    qargs = [hex(int(g.initial_state())), *picks]
    lines, rss_q, secs_query = run_db_child(["query", str(a), *qargs,
                                             *extra])
    from gamesmanmpi_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["query", str(a), *qargs, *extra])
    if rc != 0 or lines != buf.getvalue().splitlines() \
            or len(lines) != len(qargs):
        raise AssertionError(f"query child {lines} != in-process "
                             f"{buf.getvalue().splitlines()}")
    comp = mc["compression"]
    emit(f"db {spec}", positions=answer[0], levels=nlev,
         export_streamed=dict(secs=secs_a, peak_rss_bytes=rss_a),
         export_from_checkpoint=dict(secs=secs_b, peak_rss_bytes=rss_b,
                                     files_identical=len(da)),
         export_v2_book=dict(secs=secs_c, peak_rss_bytes=rss_c,
                             stored_bytes=comp["stored_bytes"],
                             raw_bytes=comp["raw_bytes"],
                             book_entries=mc["book"]["count"],
                             book_plies=mc["book"]["plies"],
                             secs_check_db_and_db_equal=secs_check,
                             secs_verify_book=secs_verify_book),
         disk_bytes_v1=disk_bytes(a), disk_bytes_v2=disk_bytes(c),
         parent_rss_bytes=parent_rss,
         batch=dict(positions=int(q.shape[0]),
                    found=int(want_found.sum()), best_moves_checked=checked,
                    **secs),
         query=dict(lines=lines, secs=secs_query, peak_rss_bytes=rss_q),
         secs=time.perf_counter() - t0)
    shutil.rmtree(b)
    return a, c


class PidsRss:
    """Per-pid peak of rss_bytes() over a `with` block, sampled every
    100 ms on a thread; `pids()` names the processes to watch (the
    fleet's workers, re-read each sample, so a replacement is watched
    from its first sample)."""

    def __init__(self, pids):
        self.pids = pids
        self.peak = {}

    def __enter__(self):
        import threading

        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.1):
            for pid in self.pids():
                now = rss_bytes(pid)
                if now is not None:
                    self.peak[pid] = max(self.peak.get(pid, 0), now)

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        return False


def http_json(url, payload=None, timeout=30):
    import urllib.request

    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, method="POST"
                                 if data is not None else "GET")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def http_text(url, timeout=30):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def wait_for(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            out = pred()
        except OSError:  # the control port is not up yet
            out = None
        if out:
            return out
        time.sleep(0.1)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


class Served:
    """`python -m gamesmanmpi_tpu_torch serve ARGS` as a child: its
    banner's ports, stopped (SIGTERM, then SIGKILL) on exit."""

    def __init__(self, argv):
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "gamesmanmpi_tpu_torch", "serve", *argv],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        banner = self.proc.stdout.readline()
        ports = re.findall(r"127\.0\.0\.1:(\d+)", banner)
        if not ports:
            stop(self.proc)
            raise AssertionError(f"serve {argv}: no banner: {banner!r} "
                                 f"{self.proc.stderr.read()[-3000:]}")
        self.base = f"http://127.0.0.1:{ports[0]}"
        self.control = (f"http://127.0.0.1:{ports[1]}" if len(ports) > 1
                        else None)

    def healthz(self):
        return http_json(self.control + "/healthz")

    def worker_pids(self):
        try:
            return [w["pid"] for w in self.healthz()["workers"].values()
                    if w["pid"]]
        except OSError:
            return []

    def terminate(self, timeout=60):
        """SIGTERM, then the exit code (SIGKILL past `timeout`)."""
        self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=timeout)
        finally:
            stop(self.proc)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.terminate(timeout=30)
        return False


def load_gen(base, pos_file, secs, out_json, get=False, conc=8):
    """tools/load_gen.py as a child: concurrency 8, 8 positions per
    request, zipf(1.1) over `pos_file` (or single-position conditional
    GETs with `get`). -> Popen; `load_result` reads its record."""
    argv = [sys.executable, str(REPO / "tools" / "load_gen.py"), base,
            "--positions-file", str(pos_file), "--duration", str(secs),
            "--concurrency", str(conc), "--chunk-size", "8",
            "--dist", "zipf:1.1", "--json", str(out_json)]
    if get:
        argv.append("--get")
    return subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def load_result(proc, out_json, secs):
    try:
        out, err = proc.communicate(timeout=secs + 120)
    finally:
        stop(proc)
    if not pathlib.Path(out_json).exists():
        raise AssertionError(f"load_gen wrote no record (rc "
                             f"{proc.returncode}): {out[-1000:]} "
                             f"{err[-2000:]}")
    return json.loads(pathlib.Path(out_json).read_text())


def load_fields(rec):
    return {k: rec[k] for k in ("requests", "ok", "not_modified", "shed",
                                "shed_retried", "errors", "dropped",
                                "mismatches", "qps", "p50_ms", "p95_ms",
                                "p99_ms")}


def check_answers(rec, truth, what):
    """Every answer the load saw equals the classic tables."""
    bad = [(p, a) for p, a in rec["answers"].items()
           if (a[0], a[1]) != truth[int(p, 0)][1:]]
    if rec["errors"] or rec["mismatches"] or bad:
        raise AssertionError(f"{what}: errors {rec['errors']}, mismatches "
                             f"{rec['mismatches']}, wrong answers "
                             f"{bad[:3]}")
    return len(rec["answers"])


def smi(query):
    """nvidia-smi's csv answer to `query` (e.g. --query-gpu=memory.used),
    without header or units; "" where nvidia-smi is missing."""
    try:
        return subprocess.run(
            ["nvidia-smi", query, "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def smi_apps():
    """{pid: device MiB} of the processes on the card (nvidia-smi
    --query-compute-apps): empty where it lists none (a container's own
    PID namespace)."""
    apps = {}
    for line in smi("--query-compute-apps=pid,used_memory").splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            apps[int(parts[0])] = parts[1]
    return apps


def smi_used_mib():
    """The card's used memory in MiB (nvidia-smi), or None."""
    out = smi("--query-gpu=memory.used").splitlines()
    return int(out[0]) if out and out[0].strip().isdigit() else None


def metric_sum(text, name):
    """Sum of every sample of metric `name` in Prometheus text."""
    total = 0.0
    for m in re.finditer(rf"^{name}(?:{{[^}}]*}})? (\S+)$", text, re.M):
        total += float(m.group(1))
    return total


def batch_costs(base):
    """Per worker (either may answer /metrics.json): the mean coalesced
    batch's positions and its flush milliseconds (canonicalize, probe,
    expand, probe again)."""
    out = {}
    for _ in range(8):
        m = http_json(base + "/metrics.json")
        if m.get("batches"):
            out[str(m.get("worker"))] = dict(
                batches=m["batches"], mean_batch_size=m["mean_batch_size"],
                mean_flush_ms=1e3 * m["batch_secs_total"] / m["batches"])
    return out


def fleet_run(db, device, pos_file, truth, fixed, tmp, secs, chaos):
    """One 2-worker fleet on `device` over `db`: ready, the `fixed`
    256-position set and a zipf load over `pos_file` held to the tables
    (`truth`, `fixed`: {state: (found, value name, remoteness)}); with
    `chaos`, a second load with one worker SIGKILLed and a third, twice
    as long, under POST /reload. -> the phase's record for this fleet."""
    t0 = time.perf_counter()
    rec = {"device": device}
    used_before = smi_used_mib()
    with Served([str(db), "--workers", "2", "--port", "0",
                 "--control-port", "0", "--device", device]) as fleet, \
            PidsRss(fleet.worker_pids) as rss:
        st = wait_for(lambda: (s := fleet.healthz())["ready"] == 2 and s,
                      300, f"{device} fleet ready")
        rec["secs_to_ready"] = time.perf_counter() - fleet.t0
        rec["spawn_mode"] = st["spawn_mode"]
        rec["workers"] = {i: {"pid": w["pid"],
                              "warmup_secs": w["warmup_secs"],
                              "verified": w["verified"]}
                          for i, w in st["workers"].items()}
        body = http_json(fleet.base + "/query",
                         {"positions": [hex(p) for p in fixed]})
        for p, r in zip(fixed, body["results"]):
            want = fixed[p]
            got = ((r["found"], r["value"], r["remoteness"]) if r["found"]
                   else (False,))
            if got != (want if want[0] else (False,)):
                raise AssertionError(f"{device} fleet: {hex(p)} answered "
                                     f"{r}, tables say {want}")
        out = tmp / f"load_{device}.json"
        first = load_result(load_gen(fleet.base, pos_file, secs, out), out,
                            secs)
        rec["answers_checked"] = check_answers(first, truth,
                                               f"{device} load")
        rec["load"] = load_fields(first)
        rec["batches"] = batch_costs(fleet.base)
        # Per worker where nvidia-smi lists the processes; else the
        # card's used memory with the fleet up, over its use before
        # (the supervisor never touches the card).
        apps = smi_apps()
        rec["device_mib"] = {i: apps.get(w["pid"]) for i, w in
                             rec["workers"].items()}
        used = smi_used_mib()
        rec["device_used_mib_fleet"] = (
            used - used_before if None not in (used, used_before) else None)
        if chaos:
            out = tmp / f"load_{device}_kill.json"
            load = load_gen(fleet.base, pos_file, secs, out)
            time.sleep(secs / 3)
            victim = fleet.healthz()["workers"]["0"]["pid"]
            t_kill = time.perf_counter()
            os.kill(victim, signal.SIGKILL)
            killed = load_result(load, out, secs)
            check_answers(killed, truth, f"{device} load under SIGKILL")
            if killed["dropped"] > 8:
                raise AssertionError(f"SIGKILL dropped {killed['dropped']} "
                                     "> 8 requests in flight")
            st = wait_for(lambda: (s := fleet.healthz())["ready"] == 2
                          and s["workers"]["0"]["pid"] != victim and s,
                          300, "replacement ready")
            restarts = sum(w["restarts"] for w in st["workers"].values())
            if restarts != 1:
                raise AssertionError(f"restarts {restarts}, not 1")
            rec["kill"] = dict(load_fields(killed), restarts=restarts,
                               secs_to_replacement_ready=(
                                   time.perf_counter() - t_kill),
                               replacement_warmup_secs=st["workers"]["0"]
                               ["warmup_secs"])
            out = tmp / f"load_{device}_reload.json"
            load = load_gen(fleet.base, pos_file, 2 * secs, out)
            time.sleep(1.0)
            t_reload = time.perf_counter()
            http_json(fleet.control + "/reload", {})
            wait_for(lambda: (s := fleet.healthz())["reloads_done"] == 1
                     and s["ready"] == 2 and s, 300, "rolling reload")
            secs_reload = time.perf_counter() - t_reload
            rolled = load_result(load, out, 2 * secs)
            check_answers(rolled, truth, f"{device} load under reload")
            failed = (rolled["errors"] + rolled["dropped"] + rolled["shed"]
                      + rolled["shed_retried"])
            if failed:
                raise AssertionError(f"reload: {failed} failed requests")
            rec["reload"] = dict(load_fields(rolled), secs=secs_reload)
        rec["rc"] = fleet.terminate()
        if rec["rc"] != 0:
            raise AssertionError(f"fleet exited {rec['rc']} on SIGTERM")
    rec["peak_rss_bytes"] = sorted(rss.peak.values())
    rec["secs"] = time.perf_counter() - t0
    return rec


def serve_phase(result, tmp, v1, v2, extra=(), secs=10.0, get_secs=5.0):
    """Phase 13: serving on the card over phase 12's databases. `v1`
    and `v2` are phase 12's v1 and v2 + book exports of `result`'s
    game; `extra` (`--device cpu`) rehearses the phase on the CPU."""
    import numpy as np

    from gamesmanmpi_tpu_torch.core.bitops import to_reference
    from gamesmanmpi_tpu_torch.core.values import value_name

    t0 = time.perf_counter()
    device = "cpu" if "cpu" in extra else "cuda"
    g = result.game
    s_states, s_values, s_rem = sample_states(result, 4096, seed=14)
    rand = np.random.default_rng(15).integers(0, 1 << g.state_bits,
                                              size=1 << 16)
    r_found, r_values, r_rem = table_truth(result, rand, device)
    states = np.concatenate([s_states, rand[r_found]])
    values = np.concatenate([s_values, r_values[r_found]])
    rem = np.concatenate([s_rem, r_rem[r_found]])
    q = to_reference(states, g)
    truth = {int(p): (True, value_name(v), int(r))
             for p, v, r in zip(q, values, rem)}
    pos_file = tmp / "positions.txt"
    pos_file.write_text("\n".join(hex(int(p)) for p in q))
    # The fixed set: 128 reachable, 128 random states (found or not).
    fq = to_reference(np.concatenate([s_states[:128], rand[:128]]), g)
    fixed = {int(p): (bool(f), value_name(v), int(r)) for p, f, v, r in zip(
        fq, np.concatenate([np.ones(128, dtype=bool), r_found[:128]]),
        np.concatenate([s_values[:128], r_values[:128]]),
        np.concatenate([s_rem[:128], r_rem[:128]]))}
    card = fleet_run(v1, device, pos_file, truth, fixed, tmp, secs,
                     chaos=True)
    cpu = fleet_run(v1, "cpu", pos_file, truth, fixed, tmp, secs,
                    chaos=False)
    # v2 + book: a single process under conditional GETs (book hits,
    # 304s), then a 2-worker fleet whose workers share decoded blocks
    # through the shm segment.
    with Served([str(v2), "--port", "0", "--device", device]) as one:
        wait_for(lambda: http_json(one.base + "/healthz")["status"] == "ok",
                 300, "single-process server")
        out = tmp / "load_get.json"
        got = load_result(load_gen(one.base, pos_file, get_secs, out,
                                   get=True), out, get_secs)
        if got["errors"] or got["mismatches"]:
            raise AssertionError(f"GET load: {load_fields(got)}")
        text = http_text(one.base + "/metrics")
        single = dict(load_fields(got),
                      book_hits=metric_sum(text, "gamesman_book_hits_total"),
                      rc=one.terminate())
    with Served([str(v2), "--workers", "2", "--port", "0",
                 "--control-port", "0", "--device", device]) as fleet:
        wait_for(lambda: fleet.healthz()["ready"] == 2, 300,
                 "v2 fleet ready")
        out = tmp / "load_v2.json"
        got = load_result(load_gen(fleet.base, pos_file, get_secs, out),
                          out, get_secs)
        check_answers(got, truth, "v2 fleet load")
        shm = {}
        for _ in range(8):  # /metrics answers from either worker
            text = http_text(fleet.base + "/metrics")
            for name in ("gamesman_shm_hits_total",
                         "gamesman_shm_misses_total",
                         "gamesman_shm_stores_total"):
                for m in re.finditer(rf'^{name}{{worker="(\d)"}} (\S+)$',
                                     text, re.M):
                    shm[f"{name}[{m.group(1)}]"] = float(m.group(2))
        v2_fleet = dict(load_fields(got), shm=shm, rc=fleet.terminate())
    emit(f"serve {g.name}", positions_file=len(truth), fleet_card=card,
         fleet_cpu=cpu, single_v2_get=single, fleet_v2=v2_fleet,
         secs=time.perf_counter() - t0)


@contextlib.contextmanager
def env_set(**values):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def sharded_fields(s):
    return dict(secs_forward=s["secs_forward"],
                secs_backward=s["secs_backward"],
                positions_per_sec=s["positions_per_sec"],
                peak_mem_bytes=s["peak_mem_bytes"],
                exchange_bytes=s["exchange_bytes"],
                exchange_secs=s["exchange_secs"],
                exchange_calls=s["exchange_calls"], syncs=s["syncs"],
                syncs_per_level=s["syncs_per_level"], levels=s["levels"],
                backend=s["backend"], device=s["device"],
                backward_edges_levels=s["backward_edges_levels"],
                retries=s["retries"], misses=s["misses"])


def world_tables(prefix):
    import numpy as np

    out = []
    for rank in (0, 1):
        with np.load(f"{prefix}.rank{rank}.npz") as z:
            out.append({f: (str(z[f].dtype), z[f].tobytes())
                        for f in z.files})
    return out


def world_run(args, log_dir, env=None, kill_rank1_at=None):
    """A 2-process world of the CLI through parallel/launch.py: -> (rank
    results, wall seconds, seconds from the SIGKILL to rank 0's exit or
    None). With `kill_rank1_at`, rank 1 is SIGKILLed once its stderr shows
    that fault banner."""
    from gamesmanmpi_tpu_torch.parallel.launch import start_world

    t0 = time.perf_counter()
    world = start_world(args, processes=2, log_dir=str(log_dir), env=env)
    t_kill = None
    try:
        if kill_rank1_at is not None:
            deadline = time.monotonic() + 300
            while kill_rank1_at not in world.stderr_of(1):
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"rank 1 never reached {kill_rank1_at!r}:\n"
                        f"{world.stderr_of(1)[-2000:]}")
                time.sleep(0.05)
            os.kill(world.pids()[1], signal.SIGKILL)
            t_kill = time.perf_counter()
        ranks = world.wait(600)
    finally:
        world.wait(0)
    secs = time.perf_counter() - t0
    return ranks, secs, (None if t_kill is None
                         else time.perf_counter() - t_kill)


def sharded_phase(result, tmp, spec=C55, answer=(69763700, "TIE", 25),
                  extra=(), small="connect4:w=5,h=4"):
    """Phase 14: the sharded engine. `result` is phase 9's classic solve
    of `spec`; `extra` (`--device cpu`) and a smaller `spec`/`small`
    rehearse the phase on the CPU."""
    import numpy as np

    t0 = time.perf_counter()
    extra = list(extra)
    # (a) Full width, one process, 4 shards sharing the card.
    with env_set(GAMESMAN_FAKE_DEVICES=4):
        full, report = cli_solve(["solve", spec, "--devices", "4", *extra])
    if report_answer(report) != answer:
        raise AssertionError(f"sharded {spec}: {report}")
    if full.stats["shards"] != 4 or full.stats["misses"]:
        raise AssertionError(f"sharded {spec}: stats {full.stats}")
    _same_tables(full, result, f"sharded {spec} vs classic")
    one = sharded_fields(full.stats)
    del full
    # (b) Shard counts, backward modes and the generic path, each against
    # the classic engine on the same device.
    variants = {}
    table_out = tmp / "sharded_one.npz"
    classic_small, _ = cli_solve(["solve", small, "--engine", "classic",
                                  *extra])
    for label, devices, env, more in (
            ("devices2", 2, {}, []),
            ("devices4", 4, {}, ["--table-out", str(table_out)]),
            ("devices8", 8, {}, []),
            ("lookup4", 4, {"GAMESMAN_BACKWARD": "lookup"}, [])):
        with env_set(GAMESMAN_FAKE_DEVICES=devices, **env):
            r, _ = cli_solve(["solve", small, "--devices", str(devices),
                              *more, *extra])
        _same_tables(r, classic_small, f"{small} {label} vs classic")
        variants[label] = dict(sharded_fields(r.stats),
                               positions=r.num_positions)
    for gspec in ("nim:heaps=3-4-5", "chomp:w=4,h=3"):
        ref, _ = cli_solve(["solve", gspec, "--engine", "classic", *extra])
        with env_set(GAMESMAN_FAKE_DEVICES=4):
            r, _ = cli_solve(["solve", gspec, "--devices", "4", *extra])
        if r.stats["path"] != "generic":
            raise AssertionError(f"{gspec}: path {r.stats['path']}")
        _same_tables(r, ref, f"{gspec} sharded vs classic")
        variants[gspec] = dict(sharded_fields(r.stats),
                               positions=r.num_positions)
    with np.load(table_out) as z:
        one_proc = {f: (str(z[f].dtype), z[f].tobytes()) for f in z.files}

    # (c) A 2-process world on the one card.
    args = ["solve", small, "--devices", "4", *extra]
    prefix = tmp / "world"
    ranks, world_secs, _ = world_run(
        args + ["--table-out", f"{prefix}.npz"], tmp / "world_logs")
    for r in ranks:
        if r.returncode != 0:
            raise AssertionError(f"world rank {r.rank} exited "
                                 f"{r.returncode}:\n{r.stderr[-3000:]}")
    backends = sorted({m.group(1) for r in ranks for m in re.finditer(
        r"world: rank \d+ of 2, backend (\w+)", r.stderr)})
    t0_, t1_ = world_tables(prefix)
    if not t0_ == t1_ == one_proc:
        raise AssertionError("world rank tables differ from each other or "
                             "from the one-process table")
    world = dict(rc=[r.returncode for r in ranks], backend=backends,
                 wall_secs=world_secs,
                 elapsed=[ln for r in ranks for ln in r.stdout.splitlines()
                          if ln.startswith("elapsed:")])

    # (d) Faults in that world: a transient on rank 1 only.
    fprefix = tmp / "fault"
    ranks, fault_secs, _ = world_run(
        args + ["--table-out", f"{fprefix}.npz"], tmp / "fault_logs",
        env={"GAMESMAN_FAULTS_RANK_1": "sharded.forward:transient:3",
             "GAMESMAN_RETRY_BASE_SECS": "0"})
    retries = [len([ln for ln in r.stderr.splitlines()
                    if ln.startswith("[coordination]") and " retries " in ln])
               for r in ranks]
    if [r.returncode for r in ranks] != [0, 0] or retries[0] != retries[1] \
            or retries[0] < 1:
        raise AssertionError(f"transient on rank 1: rc "
                             f"{[r.returncode for r in ranks]}, retries "
                             f"{retries}:\n{ranks[1].stderr[-2000:]}")
    if "injecting transient" in ranks[0].stderr:
        raise AssertionError("the transient fired on rank 0 too")
    if world_tables(fprefix) != [one_proc, one_proc]:
        raise AssertionError("tables changed under the retried transient")
    # Rank 1 SIGKILLed in its third backward step.
    barrier = 10.0
    ranks, kill_secs, after_kill = world_run(
        args, tmp / "kill_logs",
        env={"GAMESMAN_FAULTS_RANK_1": "sharded.backward:delay=120:3",
             "GAMESMAN_BARRIER_SECS": barrier,
             "GAMESMAN_COLLECTIVE_TIMEOUT": 60},
        kill_rank1_at="injecting delay at sharded.backward")
    rcs = [r.returncode for r in ranks]
    if rcs != [124, -signal.SIGKILL] or after_kill > barrier + 30 \
            or "coordinated abort" not in ranks[0].stderr:
        raise AssertionError(f"SIGKILL of rank 1: rc {rcs}, rank 0 exited "
                             f"{after_kill} s after the kill:\n"
                             f"{ranks[0].stderr[-2000:]}")
    emit("sharded 5x5", spec=spec, report=report, one_process=one,
         variants=variants, world=world,
         transient=dict(rc=[0, 0], retries=retries, wall_secs=fault_secs),
         sigkill=dict(rc=rcs, barrier_secs=barrier,
                      rank0_exit_after_kill_secs=after_kill,
                      wall_secs=kill_secs,
                      abort=[ln for ln in ranks[0].stderr.splitlines()
                             if ln.startswith("coordinated abort")]),
         secs=time.perf_counter() - t0)


def hardlink_copy(src, dst):
    """A copy of a checkpoint directory that shares its files: a resume
    never writes a sealed file in place (tmp + os.replace, quarantines
    rename), so the copies cannot disturb each other."""
    shutil.copytree(src, dst, copy_function=os.link)
    return dst


def sealed_level_files(d):
    """{file name: (mtime ns, crc)} of every sealed level shard file."""
    m = manifest(d)
    out = {}
    for k, num in m.get("sharded_levels", {}).items():
        for s in range(int(num)):
            name = f"level_{int(k):04d}.shard_{s:04d}.npz"
            out[name] = ((pathlib.Path(d) / name).stat().st_mtime_ns,
                         m["crc"][name])
    return out


def ckpt_fields(s):
    return dict(secs_forward=s["secs_forward"],
                secs_backward=s["secs_backward"],
                ckpt_save_secs=s["ckpt_save_secs"],
                ckpt_bytes_raw=s["ckpt_bytes_raw"],
                ckpt_bytes_stored=s["ckpt_bytes_stored"],
                io_wait_secs=s["io_wait_secs"],
                peak_mem_bytes=s["peak_mem_bytes"],
                backward_edges_levels=s["backward_edges_levels"],
                resharded_from=s["resharded_from"],
                edges_geometry_fallback_levels=s[
                    "edges_geometry_fallback_levels"])


@contextlib.contextmanager
def checked_gather(tally):
    """Route the dense engine's window gathers (the meshed dense engine's
    and the hybrid's dense region go through solve/dense.py) through a
    wrapper that also runs the plain version on the same inputs: `out`
    bit-identical and `nmiss` equal on every launch, else AssertionError.
    `tally` collects the launches checked, the plain version's summed
    nmiss and the distinct (n, m) shapes."""
    from gamesmanmpi_tpu_torch.ops.window_gather import (
        monotone_window_gather_ref,
    )
    from gamesmanmpi_tpu_torch.solve import dense

    kernel = dense.monotone_window_gather

    def both(table, idx, block, window):
        out, nm = kernel(table, idx, block, window)
        ref, nm_ref = monotone_window_gather_ref(table, idx, block, window)
        if not torch.equal(out, ref) or int(nm) != int(nm_ref):
            raise AssertionError(
                f"window gather on the path differs from its plain version "
                f"at n={idx.shape[0]} m={table.shape[0]}: nmiss {int(nm)} "
                f"vs {int(nm_ref)}")
        tally["launches_checked"] += 1
        tally["plain_nmiss"] += int(nm_ref)
        tally["shapes"].add((int(idx.shape[0]), int(table.shape[0])))
        return out, nm

    dense.monotone_window_gather = both
    try:
        yield
    finally:
        dense.monotone_window_gather = kernel


def gather_cross_checks(argv, what, kernel_cells, kernel_nmiss, launches,
                        cells_of):
    """The path of `argv` again twice: once with every window gather held
    against its plain version on its own inputs (checked_gather), and once
    with GAMESMAN_DENSE_GATHER=plain; both runs' dense cells must equal
    `kernel_cells` (the counted kernel run's) byte for byte, the checked
    run must check `launches` launches (None on the CPU, where the path
    launches no kernel), and the plain version's nmiss must sum to
    `kernel_nmiss`. -> a summary for the phase line."""
    import numpy as np

    def same_cells(r, label):
        cells = cells_of(r)
        if sorted(cells) != sorted(kernel_cells):
            raise AssertionError(f"{what} {label}: levels {sorted(cells)}")
        for L, c in kernel_cells.items():
            if not np.array_equal(cells[L], c):
                raise AssertionError(f"{what} {label}: level {L} cells "
                                     "differ from the kernel run's")

    tally = {"launches_checked": 0, "plain_nmiss": 0, "shapes": set()}
    t0 = time.perf_counter()
    with env_set(GAMESMAN_FAKE_DEVICES=4), checked_gather(tally):
        r, _ = cli_solve(argv)
    checked_secs = time.perf_counter() - t0
    if launches is not None and tally["launches_checked"] != launches \
            or tally["plain_nmiss"] != kernel_nmiss \
            or r.stats["gather_nmiss"] != kernel_nmiss:
        raise AssertionError(f"{what}: checked run {tally}, nmiss "
                             f"{r.stats['gather_nmiss']} vs {kernel_nmiss}, "
                             f"{launches} launches counted")
    same_cells(r, "checked")
    del r
    t0 = time.perf_counter()
    with env_set(GAMESMAN_FAKE_DEVICES=4, GAMESMAN_DENSE_GATHER="plain"):
        r, _ = cli_solve(argv)
    plain_secs = time.perf_counter() - t0
    if r.stats["gather_mode"] != "plain":
        raise AssertionError(f"{what}: gather_mode {r.stats['gather_mode']}")
    same_cells(r, "plain")
    del r
    return dict(launches_checked=tally["launches_checked"],
                plain_nmiss=tally["plain_nmiss"],
                shapes_checked=len(tally["shapes"]),
                checked_secs=checked_secs, plain_run_secs=plain_secs)


def hybrid_check(h, result, n, seed, what):
    """A hybrid result against the classic tables of the same game: every
    BFS-region level identical, and the lookups of `n` sampled states of
    the dense region equal the table's."""
    import numpy as np

    K = h.cutover
    bfs = {k: t for k, t in result.levels.items() if k > K}
    if sorted(h.levels) != sorted(bfs):
        raise AssertionError(f"{what}: BFS levels {sorted(h.levels)}")
    for k, t in bfs.items():
        u = h.levels[k]
        for field in ("states", "values", "remoteness"):
            if not np.array_equal(getattr(u, field), getattr(t, field)):
                raise AssertionError(f"{what}: level {k} {field} differ")
    low = type(result)(result.game, result.value, result.remoteness,
                       {k: t for k, t in result.levels.items() if k <= K},
                       result.stats)
    states, values, rems = sample_states(low, n, seed)
    for s, v, r in zip(states, values, rems):
        if h.lookup(int(s)) != (int(v), int(r)):
            raise AssertionError(f"{what}: {int(s):#x} answers "
                                 f"{h.lookup(int(s))}, not {(v, r)}")
    return len(states)


def hybrid_fields(h, launches):
    s = h.stats
    return dict(positions=h.num_positions, value=h.value,
                remoteness=h.remoteness, cutover=s["cutover"],
                devices=s["devices"], secs_total=s["secs_total"],
                secs_forward=s["secs_forward"], secs_bfs=s["secs_bfs"],
                secs_boundary=s["secs_boundary"],
                positions_dense_region=s["positions_dense_region"],
                positions_bfs_region=s["positions_bfs_region"],
                frontier_at_boundary=s["frontier_at_boundary"],
                gather_nmiss=s["gather_nmiss"],
                peak_mem_bytes=s["peak_mem_bytes"],
                launches=launches["monotone_window_gather"])


def reshard_hybrid_phase(result, dense_result, tmp, v1, spec=C55,
                         answer=(69763700, "TIE", 25), extra=(),
                         small="connect4:w=5,h=4", world_table=None,
                         cutover=16, kill=10, samples=20000):
    """Phase 15: sharded checkpoints with reshard, the meshed dense engine
    and the hybrid. `result` is phase 9's classic solve of `spec`,
    `dense_result` phase 6's dense one, `v1` phase 12's streamed DB and
    `world_table` phase 14's one-process `--devices 4` table of `small`;
    `extra` (`--device cpu`) and smaller boards rehearse the phase on the
    CPU. -> the gather's launches per path."""
    import numpy as np

    from gamesmanmpi_tpu_torch import kernels
    from gamesmanmpi_tpu_torch.store import file_crc32

    t0 = time.perf_counter()
    extra = list(extra)
    base = {"classic": dict(secs_forward=result.stats["secs_forward"],
                            secs_backward=result.stats["secs_backward"],
                            peak_mem_bytes=result.stats["peak_mem_bytes"]),
            "dense": dict(secs_backward=dense_result.stats["secs_backward"],
                          peak_mem_bytes=dense_result.stats.get(
                              "peak_mem_bytes"))}
    # (a) Uninterrupted sharded checkpoint, default compression.
    D = tmp / "sharded_ckpt"
    ta = time.perf_counter()
    with env_set(GAMESMAN_FAKE_DEVICES=4):
        full, report = cli_solve(["solve", spec, "--devices", "4",
                                  "--checkpoint-dir", str(D), *extra])
    secs_a = time.perf_counter() - ta
    if report_answer(report) != answer:
        raise AssertionError(f"sharded checkpoint {spec}: {report}")
    _same_tables(full, result, f"sharded checkpoint {spec} vs classic")
    m = manifest(D)
    nlev = len(result.levels)
    if sorted(int(k) for k in m["sharded_levels"]) != list(range(nlev)) \
            or m["frontier_shards"] != 4 or "forward_level_shards" in m:
        raise AssertionError(f"sharded checkpoint manifest: {sorted(m)}")
    uninterrupted_ = dict(ckpt_fields(full.stats), secs=secs_a,
                          disk_bytes=disk_bytes(D),
                          edge_levels=len(m.get("edge_levels", {})))
    del full

    # (b) Kill and resume, raw files (GAMESMAN_CKPT_COMPRESS=0).
    raw = {"GAMESMAN_CKPT_COMPRESS": "0"}
    K = tmp / "sharded_killed"
    argv = ["solve", spec, "--devices", "4", *extra]
    _, _, secs_killed = run_child(
        argv + ["--checkpoint-dir", str(K)], 77,
        dict(raw, GAMESMAN_FAKE_DEVICES="4",
             GAMESMAN_FAULTS=f"sharded.backward:kill:{kill}"))
    sealed = sorted(int(k) for k in manifest(K).get("sharded_levels", {}))
    if len(sealed) < kill // 2 or sealed[-1] != nlev - 1:
        raise AssertionError(f"killed sharded run sealed {sealed}")
    B = hardlink_copy(K, tmp / "sharded_b")
    before = sealed_level_files(B)
    with env_set(GAMESMAN_FAKE_DEVICES=4, **raw):
        resumed, report = cli_solve(argv + ["--checkpoint-dir", str(B)])
    if report_answer(report) != answer:
        raise AssertionError(f"resumed sharded {spec}: {report}")
    _same_tables(resumed, result, f"resumed sharded {spec} vs classic")
    m = manifest(B)
    for name, (mtime, crc) in before.items():
        now = ((B / name).stat().st_mtime_ns, m["crc"][name])
        if now != (mtime, crc) or file_crc32(B / name) != crc:
            raise AssertionError(f"{name} was rewritten by the resume")
    resumed_ = dict(ckpt_fields(resumed.stats),
                    sealed_untouched=len(before), killed_secs=secs_killed,
                    levels_sealed_at_kill=len(sealed))
    del resumed

    # (c) Reshard: copies of the killed tree at 2 and 8 shards.
    reshard = {}
    for S in (2, 8):
        C = hardlink_copy(K, tmp / f"sharded_c{S}")
        with env_set(GAMESMAN_FAKE_DEVICES=S, **raw):
            r, report = cli_solve(["solve", spec, "--devices", str(S),
                                   "--checkpoint-dir", str(C), *extra])
        if report_answer(report) != answer \
                or r.stats["resharded_from"] != 4:
            raise AssertionError(f"reshard 4 -> {S}: {report}, "
                                 f"{r.stats['resharded_from']}")
        _same_tables(r, result, f"reshard 4 -> {S} vs classic")
        reshard[S] = ckpt_fields(r.stats)
        del r
        shutil.rmtree(C)
    shutil.rmtree(B)

    # (d) The sharded directory exported: phase 12's v1 files.
    lines, rss_d, secs_d = export_child(
        [spec, "--from-checkpoint", str(D), "--out", str(tmp / "db_sharded"),
         *extra], answer, nlev)
    if digests(tmp / "db_sharded") != digests(v1):
        raise AssertionError("sharded export differs from the classic v1 "
                             "export")
    export = dict(secs=secs_d, peak_rss_bytes=rss_d, files=len(digests(v1)))
    shutil.rmtree(tmp / "db_sharded")
    shutil.rmtree(D)
    shutil.rmtree(K)

    # (e) A 2-process world on the one card, checkpointed, rank 1 killed.
    W = tmp / "world_ckpt"
    wargs = ["solve", small, "--devices", "4", "--checkpoint-dir", str(W),
             *extra]
    barrier = 10.0
    ranks, kill_secs, after_kill = world_run(
        wargs, tmp / "wk_logs",
        env={"GAMESMAN_FAULTS_RANK_1": "sharded.backward:delay=120:3",
             "GAMESMAN_BARRIER_SECS": barrier,
             "GAMESMAN_COLLECTIVE_TIMEOUT": 60},
        kill_rank1_at="injecting delay at sharded.backward")
    rcs = [r.returncode for r in ranks]
    if rcs != [124, -signal.SIGKILL]:
        raise AssertionError(f"checkpointed world, rank 1 killed: rc {rcs}:"
                             f"\n{ranks[0].stderr[-2000:]}")
    wsealed = len(manifest(W).get("sharded_levels", {}))
    one_copy = hardlink_copy(W, tmp / "world_one")
    prefix = tmp / "world_resumed"
    ranks, resume_secs, _ = world_run(
        wargs + ["--table-out", f"{prefix}.npz"], tmp / "wr_logs")
    if [r.returncode for r in ranks] != [0, 0]:
        raise AssertionError(f"world resume: rc "
                             f"{[r.returncode for r in ranks]}:\n"
                             f"{ranks[0].stderr[-2000:]}")
    t0_, t1_ = world_tables(prefix)
    with env_set(GAMESMAN_FAKE_DEVICES=4):
        one, _ = cli_solve(["solve", small, "--devices", "4",
                            "--checkpoint-dir", str(one_copy),
                            "--table-out", str(tmp / "world_one.npz"),
                            *extra])
    with np.load(tmp / "world_one.npz") as z:
        one_t = {f: (str(z[f].dtype), z[f].tobytes()) for f in z.files}
    want = one_t
    if world_table is not None:
        with np.load(world_table) as z:
            want = {f: (str(z[f].dtype), z[f].tobytes()) for f in z.files}
    if not t0_ == t1_ == one_t == want:
        raise AssertionError("resumed world / one-process tables differ")
    world = dict(killed_rc=rcs, rank0_exit_after_kill_secs=after_kill,
                 levels_sealed=wsealed, world_resume_secs=resume_secs,
                 epoch=manifest(W)["run"]["epoch"],
                 one_process=dict(secs_backward=one.stats["secs_backward"],
                                  resharded_from=one.stats["resharded_from"]))
    del one
    shutil.rmtree(W)
    shutil.rmtree(one_copy)

    # (f) The meshed dense engine, launches counted.
    kernels.reset_launches()
    with env_set(GAMESMAN_FAKE_DEVICES=4):
        md, report = cli_solve(["solve", spec, "--engine", "dense",
                                "--devices", "4", *extra])
    launches_md = dict(kernels.LAUNCHES)
    if report_answer(report) != answer or md.stats["devices"] != 4:
        raise AssertionError(f"meshed dense {spec}: {report}")
    for L, cells in dense_result.cells.items():
        if not np.array_equal(md.cells[L], cells):
            raise AssertionError(f"meshed dense level {L} differs")
    if md.stats["gather_nmiss_per_level"] != dense_result.stats[
            "gather_nmiss_per_level"]:
        raise AssertionError("meshed dense nmiss differs per level")
    if "cpu" not in extra and launches_md["monotone_window_gather"] <= 0:
        raise AssertionError(f"meshed dense launched no gather: "
                             f"{launches_md}")
    meshed = dict(secs_backward=md.stats["secs_backward"],
                  positions_per_sec=md.stats["positions_per_sec"],
                  gather_nmiss=md.stats["gather_nmiss"],
                  peak_mem_bytes=md.stats.get("peak_mem_bytes"),
                  launches=launches_md["monotone_window_gather"])
    meshed["cross_checks"] = gather_cross_checks(
        ["solve", spec, "--engine", "dense", "--devices", "4", *extra],
        "meshed dense", md.cells, md.stats["gather_nmiss"],
        None if "cpu" in extra else launches_md["monotone_window_gather"],
        lambda r: r.cells)
    del md

    # (g) The hybrid at K, one device then 4, then sym=1 at `small`.
    hybrid = {}
    launches_hy = {}
    for label, more in (("devices1", []), ("devices4", ["--devices", "4"])):
        kernels.reset_launches()
        with env_set(GAMESMAN_FAKE_DEVICES=4):
            h, report = cli_solve(["solve", spec, "--engine", "hybrid",
                                   "--hybrid-cutover", str(cutover), *more,
                                   *extra])
        launches = dict(kernels.LAUNCHES)
        if report_answer(report) != answer:
            raise AssertionError(f"hybrid {label} {spec}: {report}")
        if "cpu" not in extra and launches["monotone_window_gather"] <= 0:
            raise AssertionError(f"hybrid {label} launched no gather")
        checked = hybrid_check(h, result, samples, 15, f"hybrid {label}")
        hybrid[label] = dict(hybrid_fields(h, launches), sampled=checked)
        launches_hy[label] = launches["monotone_window_gather"]
        if label == "devices1":
            hybrid[label]["cross_checks"] = gather_cross_checks(
                ["solve", spec, "--engine", "hybrid", "--hybrid-cutover",
                 str(cutover), *more, *extra], f"hybrid {label}", h.cells,
                h.stats["gather_nmiss"],
                None if "cpu" in extra else launches["monotone_window_gather"],
                lambda r: r.cells)
        del h
    sym = small + ",sym=1"
    ref_sym, _ = cli_solve(["solve", sym, "--engine", "classic", *extra])
    plain_small, _ = cli_solve(["solve", small, "--engine", "classic",
                                *extra])
    small_k = (2 * len(plain_small.levels) - 2) // 3
    kernels.reset_launches()
    h, report = cli_solve(["solve", sym, "--engine", "hybrid",
                           "--hybrid-cutover", str(small_k), *extra])
    launches = dict(kernels.LAUNCHES)
    if (h.value, h.remoteness) != (ref_sym.value, ref_sym.remoteness):
        raise AssertionError(f"hybrid {sym}: {report}")
    for k, t in ref_sym.levels.items():
        if k > small_k:
            u = h.levels[k]
            if not (np.array_equal(u.states, t.states)
                    and np.array_equal(u.values, t.values)
                    and np.array_equal(u.remoteness, t.remoteness)):
                raise AssertionError(f"hybrid {sym} level {k} differs")
    states, values, rems = sample_states(plain_small, samples // 4, 16)
    for s, v, r in zip(states, values, rems):
        if h.lookup(int(s)) != (int(v), int(r)):
            raise AssertionError(f"hybrid {sym}: {int(s):#x}")
    hybrid["sym_" + small] = dict(hybrid_fields(h, launches),
                                  sampled=len(states))
    launches_hy["sym"] = launches["monotone_window_gather"]
    emit("sharded checkpoint, meshed dense, hybrid", spec=spec,
         same_call=base, uninterrupted=uninterrupted_, resumed=resumed_,
         reshard=reshard, export=export, world=world, meshed_dense=meshed,
         hybrid=hybrid, secs=time.perf_counter() - t0)
    return {"meshed_dense": launches_md["monotone_window_gather"],
            "hybrid": launches_hy["devices1"],
            "hybrid_devices4": launches_hy["devices4"],
            "hybrid_sym": launches_hy["sym"]}


def main() -> int:
    t_script = time.perf_counter()
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
        v1, v2 = db_phase(classic_result, tmp)
        serve_phase(classic_result, tmp, v1, v2)
        sharded_phase(classic_result, tmp)
        path_launches = reshard_hybrid_phase(
            classic_result, dense_result, tmp, v1,
            world_table=tmp / "sharded_one.npz")
        del classic_result
        checkpoint_dense_phase(dense_result, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def row(name, source, replaces, launches, m, by_path=None):
        r = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": m["max_abs_err"], "ms": m["ms"],
             "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
             "bound_by": "bytes", "library_ms": m["library_ms"],
             "bound_share": m["bound_share"]}
        if by_path:
            r["launches_by_path"] = by_path
        if "shapes" in m:
            r["shapes"] = [{k: s[k] for k in (
                "shape", "n", "m", "ms", "plain_ms", "library_ms",
                "bound_ms", "bound_share")} for s in m["shapes"]]
        return r

    emit("total", secs=time.perf_counter() - t_script)
    print(json.dumps({"kernels": [
        # Launches on the path that runs each kernel: the dense solve for
        # the gather (times at its largest launch's shape, then every
        # shape; per path: dense, meshed dense, hybrid), the microbench
        # for the doubling.
        row("monotone_window_gather",
            "gamesmanmpi_tpu_torch/kernels/csrc/window_gather.cu",
            "gamesmanmpi_tpu/ops/pallas_gather.py:116",
            dense_launches["monotone_window_gather"], k,
            dict(dense=dense_launches["monotone_window_gather"],
                 **path_launches)),
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
