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
5. dense 4x4 — level-kernel and plain-step solves on the card give
             byte-identical cells and 161,029 positions; 5x4 gives
             3,945,711 positions, TIE, remoteness 20; 3x4 connect-3 on the
             card equals the same solve on the CPU.
6. dense 5x5 — the CLI entry point (`solve connect4:w=5,h=5`, device
             cuda) with the launch counts reset just before and read just
             after: 69,763,700 positions, TIE, remoteness 25, launches
             of both level kernels (dense_step, reach_step) > 0.
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
             level kernels' launches counted); then in a child process, SIGKILLed once the
             manifest lists 5 dense levels; the rerun on D2 resumes
             (`levels_resumed` > 0), launches the backward kernel on the
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
             phase 6's and the same nmiss per level, the kernels' launches
             counted. (g) `--engine hybrid --hybrid-cutover 16`, on one
             device and with --devices 4: 69,763,700 / TIE / 25, the BFS
             region's levels 17-25 identical to phase 9's, the answers of
             20,000 sampled reachable states of levels 0-16 equal phase
             9's, the kernels' launches counted; then hybrid sym=1 at 5x4
             against the classic engine. (f) and (g)'s one-device hybrid
             each run twice more: once with every level kernel launch of the
             path held against its plain version on its own inputs
             (in-range lanes bit-identical, `nmiss` and the reach count
             equal, as many launches of each kernel as the counted run,
             the plain nmiss summing to the run's), and once with
             GAMESMAN_DENSE_GATHER=plain; both runs' dense cells equal the
             counted run's byte for byte. Each run's seconds and peak
             memory beside the dense and classic numbers of the call.
16. spec and instrumentation — (a) a Connect-4 5x5 GameSpec (written to
             the run's temp dir) through `solve --spec`: the classic
             engine (a compiled game is not of the Connect-4 class),
             69,763,700 / TIE / 25, every level identical to phase 9's
             tables; then the compiled and the hand-written classic solve
             in turns (seconds and peak memory). (b) m,n,k 4x4x4 compiled
             against the hand-written game on the card, tables identical;
             examples/specs/gomoku_4x3x3.json and mnk_3x3x3_misere.json on
             the card, identical to the CPU's tables and to the host
             oracle over examples/ref_games/. (c) Two `solve` children
             with --jsonl --trace-events --metrics-out --heartbeat-secs
             0.5 --status-port 0 and GAMESMAN_STATUS_ADDR_FILE, /status
             scraped while each runs: 5x5 (auto's dense pick, the window
             level kernels launched) and (a)'s spec (classic): one record per
             level and phase in the reference's names, positions/s from
             the records equal to the report's, the trace Chrome JSON of
             registered span names, gamesman_span_seconds in the metrics,
             a heartbeat with cuda:0's bytes in use; each backward's
             seconds beside the uninstrumented ones (phase 6, (a)). (d) A
             5x4 classic child with GAMESMAN_FAULTS=engine.backward:
             delay=60:3 and --watchdog-secs 2 exits 124 well inside the
             delay, its flightrec_0.json naming the stalled level 18. (e)
             Two 5x5 classic children, one with the host-memory guard at
             the resident set CUDA's bring-up leaves plus 512 MiB (exits
             1, "out of memory", an oom dump, the trip's RSS), one with
             the guard off (solves); (d) and (e) run together. (f)
             --profile-dir on the dense 4x4 solve: the Chrome trace names
             the backward step's kernel. (g) `export-db --spec
             connect4_4x4.json` on the card writes the CPU export's files
             byte for byte; a card reader rebuilds the game from the
             embedded spec, and it and `query` answer as the solve.

17. campaign and registry 5x5 — self-healing campaigns and the DB
             registry, as CLI children (`python -m
             gamesmanmpi_tpu_torch.resilience.campaign`, `... registry`),
             raw checkpoint files: (a) `--engine dense` killed by
             GAMESMAN_FAULTS=ckpt.save_level:kill:5 after its 5th sealed
             level; attempt 2 resumes 5 levels, launches the level kernels
             on the rest (its `done` record's `kernel_launches`), and every dense
             level equals phase 6's cells; the ledger reads killed, then
             complete. (b) `--devices 2` (GAMESMAN_FAKE_DEVICES=2) with
             `--chaos sharded.backward:oom:2`: a campaign_reshard record
             2 -> 4 shards with the store cache halved, attempt 2 at 4
             shards over the 2-shard tree (its `reshard` record from [2]),
             its --table-out identical to phase 9's tables. (c) The
             campaign SIGTERMed in attempt 1's backward (slowed by an
             engine.backward delay) exits 75, the attempt 75; the same
             command again completes; while the attempt runs, the
             campaign process has no CUDA mapped (and is not in
             `nvidia-smi --query-compute-apps`), the attempt has; one
             scrape of the campaign's --status-port shows `kind:
             campaign` with the attempt's status under `solve`. (d)
             `registry serve --jobs`, `POST /solve connect4:w=5,h=5`,
             `registry run-jobs --once`: the published epoch is sha256 of
             phase 12's v1 manifest.json and every file's sha256 is phase
             12's; the pull client installs it into a fresh directory and
             a rerun is a no-op; 312 sampled positions through `DbReader`
             equal phase 9's tables. Each run's seconds and the peak
             resident set of the campaign and of its largest child.
18. capacity and pipeline 5x5 — raw checkpoint files throughout
             (GAMESMAN_CKPT_COMPRESS=0). (a) `solve connect4:w=5,h=5
             --engine classic` in-process with GAMESMAN_PIPELINE=level
             and =pingpong in turns (level, pingpong, pingpong, level):
             every level identical to phase 9's, `overlap_secs` > 0 under
             pingpong; then one `--checkpoint-dir` run of each mode,
             every level_NNNN.npz with the same sha256 in both. Each
             run's backward seconds, overlap seconds and peak memory. (b)
             The sharded 5x5 on 4 shards of the card
             (GAMESMAN_FAKE_DEVICES=4) with `--window-block 1048576`, so
             the widest levels stream, under `--backward edges` (with
             `--table-out`) and `--backward lookup`:
             `window_stream_blocks` > 0, tables identical to phase 9's,
             peak memory beside phase 14's resident run. (c) (b)'s edges
             run with `--checkpoint-dir`, `--device-store-mb 1` and
             GAMESMAN_STORE_CACHE_MB=64: `edges_bytes_disk` > 0, tables
             identical. (d) Two `solve connect4:w=5,h=5 --engine dense`
             children sharing a GAMESMAN_DENSE_COUNTS_FILE in the phase's
             temp dir: the first sweeps, the second's --jsonl `done`
             record reads `reach_counts_source: file`; both 69,763,700 /
             TIE / 25, their level kernels' launches counted. (e) One `--engine
             hybrid --hybrid-cutover 16 --jsonl` child: `hybrid_sweep`,
             `hybrid_bfs` and `done` records with the reference's keys.
             (f) `python -m gamesmanmpi_tpu_torch.db.check` on phase 12's
             v1 and v2 DBs exits 0, and 1 on a copy of v1 with one byte
             flipped, as tools/check_db.py does.
19. dense level kernels — (a) every launch of both level kernels
             (dense_step, reach_step) held against its plain version on
             the same inputs (in-range lanes bit-identical, nmiss and the
             reach count equal) in dense solves of 4x4 (block 2^14: several
             blocks per level, ragged pad lanes; one device, 2 and 3
             shards) and 5x4 (block 2^18), the reach counts Tromp's, the
             shards' cells and nmiss the one-device run's; and both
             kernels in the 64-bit words of 6x5 and 6x6+ on every rank
             block of every 4x4 level. (b) At 5x5 the widest backward
             block and the widest reach block: kernel and plain version
             in turns, beside the bound (the larger of the bytes over the
             memory rate and the integer operations of
             ops/dense_level.step_work over the INT32 issue rate, SMs x 64
             x `nvidia-smi` clocks.max.sm). (c) The CLI's 5x5 dense solve
             on the kernels against the solve on the plain steps
             (GAMESMAN_DENSE_GATHER=plain, the reach sweep on its plain
             version), in turns, the reach sweep run each time: backward
             and reach seconds and peak memory, every level of every run
             byte-identical to phase 6's, 69,763,700 / TIE / 25.

Then the script's seconds, the kernels line (four rows: the window
gather, the doubling, and the two level kernels with their launches per
dense path), the `nvidia-smi`
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
    if min(step_launches(launches).values()) <= 0:
        raise AssertionError(f"5x5 solve launched no level kernel: "
                             f"{launches}")
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
    full_launches = step_launches(kernels.LAUNCHES)
    if (full_launches["dense_step"] > 0) != on_card:
        raise AssertionError(f"checkpointed dense {spec}: {full_launches} "
                             "level kernel launches")

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
    # Levels K..25 were loaded; K-1..0 recomputed, each through the
    # backward step's kernel.
    K = nlev - s["levels_resumed"]
    if s["levels_resumed"] != len(sealed) or K <= 0:
        raise AssertionError(f"levels_resumed {s['levels_resumed']} for "
                             f"sealed {sorted(sealed)}")
    launches = step_launches(rec["launches"])
    nmiss = {int(L): v for L, v in s["gather_nmiss_per_level"].items()}
    if (launches["dense_step"] <= 0) == on_card \
            or sorted(nmiss) != list(range(K)):
        raise AssertionError(f"level kernel launches {launches}, nmiss "
                             f"counted on levels {sorted(nmiss)}, "
                             f"recomputed 0..{K - 1}")
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
                      launches=launches,
                      gather_nmiss=s["gather_nmiss"]),
         uninterrupted=dict(seal_fields(s0, full_disk),
                            launches=full_launches,
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
    return one


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


#: The level kernels (ops/dense_level.py) and what each replaces.
STEP_KERNELS = {"dense_step": "gamesmanmpi_tpu/solve/dense.py:577",
                "reach_step": "gamesmanmpi_tpu/solve/dense.py:759"}


def in_range(geom, rank0, width, device):
    """[width] bool: the lanes of [rank0, rank0+width) below the class
    size (pad lanes beyond it carry no position)."""
    return (rank0 + torch.arange(width, device=device)) < geom.size


def same_step(name, geom, rank0, width, out, ref, extra, extra_ref):
    """A level kernel's launch against its plain version on the same
    inputs: in-range lanes bit-identical and nmiss (or the reach count)
    equal, else AssertionError."""
    ok = in_range(geom, rank0, width, out.device)
    if not torch.equal(signed_view(out[:, ok]), signed_view(ref[:, ok])) \
            or (extra is None) != (extra_ref is None) \
            or (extra is not None and int(extra) != int(extra_ref)):
        raise AssertionError(
            f"{name} differs from its plain version at level {geom.level}, "
            f"ranks [{rank0}, {rank0 + width}) x {out.shape[0]} rows: "
            f"{None if extra is None else int(extra)} vs "
            f"{None if extra_ref is None else int(extra_ref)}")


@contextlib.contextmanager
def checked_step(tally):
    """Route the dense engine's level steps (the meshed dense engine's and
    the hybrid's dense region go through solve/dense.py) through wrappers
    that also run the plain version on the same inputs: in-range lanes
    bit-identical, nmiss and the reach count equal on every launch, else
    AssertionError. `tally` collects each kernel's launches checked, the
    plain version's summed nmiss and reach count, and the distinct
    (level, rows, width) shapes."""
    from gamesmanmpi_tpu_torch.ops import dense_level

    kernel = {"dense_step": dense_level.dense_step,
              "reach_step": dense_level.reach_step}

    def wrap(name):
        def both(geom, rank0, width, src, consts, binom):
            out, extra = kernel[name](geom, rank0, width, src, consts, binom)
            if name == "dense_step":
                ref, extra_ref = dense_level.dense_step_ref(
                    geom, rank0, width, src, consts, binom, "window")
            else:
                ref, extra_ref = dense_level.reach_step_ref(
                    geom, rank0, width, src, consts, binom)
            same_step(name, geom, rank0, width, out, ref, extra, extra_ref)
            tally["launches_checked"][name] += 1
            tally["plain_" + ("nmiss" if name == "dense_step"
                              else "reach")] += int(extra_ref or 0)
            tally["shapes"].add((name, geom.level, out.shape[0], width))
            return out, extra
        return both

    dense_level.dense_step = wrap("dense_step")
    dense_level.reach_step = wrap("reach_step")
    try:
        yield
    finally:
        dense_level.dense_step = kernel["dense_step"]
        dense_level.reach_step = kernel["reach_step"]


def new_tally():
    return {"launches_checked": {k: 0 for k in STEP_KERNELS},
            "plain_nmiss": 0, "plain_reach": 0, "shapes": set()}


def step_cross_checks(argv, what, kernel_cells, kernel_nmiss, launches,
                      cells_of):
    """The path of `argv` again twice: once with every level kernel held
    against its plain version on its own inputs (checked_step), and once
    with GAMESMAN_DENSE_GATHER=plain; both runs' dense cells must equal
    `kernel_cells` (the counted kernel run's) byte for byte, the checked
    run must check as many launches of each kernel as `launches` (the
    counted run's; None on the CPU, where the path launches no kernel),
    and the plain version's nmiss must sum to `kernel_nmiss`. -> a
    summary for the phase line."""
    import numpy as np

    def same_cells(r, label):
        cells = cells_of(r)
        if sorted(cells) != sorted(kernel_cells):
            raise AssertionError(f"{what} {label}: levels {sorted(cells)}")
        for L, c in kernel_cells.items():
            if not np.array_equal(cells[L], c):
                raise AssertionError(f"{what} {label}: level {L} cells "
                                     "differ from the kernel run's")

    tally = new_tally()
    t0 = time.perf_counter()
    with env_set(GAMESMAN_FAKE_DEVICES=4), checked_step(tally):
        r, _ = cli_solve(argv)
    checked_secs = time.perf_counter() - t0
    counted = None if launches is None else {k: launches[k]
                                             for k in STEP_KERNELS}
    if counted is not None and tally["launches_checked"] != counted \
            or tally["plain_nmiss"] != kernel_nmiss \
            or r.stats["gather_nmiss"] != kernel_nmiss:
        raise AssertionError(f"{what}: checked run {tally}, nmiss "
                             f"{r.stats['gather_nmiss']} vs {kernel_nmiss}, "
                             f"{counted} launches counted")
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
                plain_reach=tally["plain_reach"],
                shapes_checked=len(tally["shapes"]),
                checked_secs=checked_secs, plain_run_secs=plain_secs)


def step_launches(launches):
    """The level kernels' entries of a kernels.LAUNCHES snapshot."""
    return {k: launches[k] for k in STEP_KERNELS}


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
                launches=step_launches(launches))


def reshard_hybrid_phase(result, dense_result, tmp, v1, spec=C55,
                         answer=(69763700, "TIE", 25), extra=(),
                         small="connect4:w=5,h=4", world_table=None,
                         cutover=16, kill=10, samples=20000):
    """Phase 15: sharded checkpoints with reshard, the meshed dense engine
    and the hybrid. `result` is phase 9's classic solve of `spec`,
    `dense_result` phase 6's dense one, `v1` phase 12's streamed DB and
    `world_table` phase 14's one-process `--devices 4` table of `small`;
    `extra` (`--device cpu`) and smaller boards rehearse the phase on the
    CPU. -> the level kernels' launches per path."""
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
    if "cpu" not in extra and launches_md["dense_step"] <= 0:
        raise AssertionError(f"meshed dense launched no dense_step: "
                             f"{launches_md}")
    meshed = dict(secs_backward=md.stats["secs_backward"],
                  positions_per_sec=md.stats["positions_per_sec"],
                  gather_nmiss=md.stats["gather_nmiss"],
                  peak_mem_bytes=md.stats.get("peak_mem_bytes"),
                  launches=step_launches(launches_md))
    meshed["cross_checks"] = step_cross_checks(
        ["solve", spec, "--engine", "dense", "--devices", "4", *extra],
        "meshed dense", md.cells, md.stats["gather_nmiss"],
        None if "cpu" in extra else launches_md, lambda r: r.cells)
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
        if "cpu" not in extra and min(step_launches(launches).values()) <= 0:
            raise AssertionError(f"hybrid {label} launched no level kernel: "
                                 f"{launches}")
        checked = hybrid_check(h, result, samples, 15, f"hybrid {label}")
        hybrid[label] = dict(hybrid_fields(h, launches), sampled=checked)
        launches_hy[label] = step_launches(launches)
        if label == "devices1":
            hybrid[label]["cross_checks"] = step_cross_checks(
                ["solve", spec, "--engine", "hybrid", "--hybrid-cutover",
                 str(cutover), *more, *extra], f"hybrid {label}", h.cells,
                h.stats["gather_nmiss"],
                None if "cpu" in extra else launches, lambda r: r.cells)
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
    launches_hy["sym"] = step_launches(launches)
    emit("sharded checkpoint, meshed dense, hybrid", spec=spec,
         same_call=base, uninterrupted=uninterrupted_, resumed=resumed_,
         reshard=reshard, export=export, world=world, meshed_dense=meshed,
         hybrid=hybrid, secs=time.perf_counter() - t0)
    return {"meshed_dense": step_launches(launches_md),
            "hybrid": launches_hy["devices1"],
            "hybrid_devices4": launches_hy["devices4"],
            "hybrid_sym": launches_hy["sym"]}


#: Phase 16's specs: Connect-4 5x5 and 4x4 m,n,k as GameSpec documents.
SPEC_C55 = {"gamedsl": 1, "name": "connect4_5x5",
            "board": {"width": 5, "height": 5}, "moves": {"family": "drop"},
            "win": {"kind": "k_in_line", "k": 4}}
SPEC_TTT444 = {"gamedsl": 1, "name": "tictactoe_4x4x4",
               "board": {"width": 4, "height": 4},
               "moves": {"family": "place"},
               "win": {"kind": "k_in_line", "k": 4}}
#: The span names docs/OBSERVABILITY.md registers for the solve.
SOLVE_SPANS = {"forward", "dedup", "backward", "backward_edges",
               "checkpoint", "db_export"}

#: The CLI child of phase 16(e): the resident set once CUDA is up, then
#: the host-memory guard armed at that plus the margin (argv[1] MiB, or
#: "off"), then the solve.
MEMGUARD_CHILD = """
import json, os, sys
import torch
from gamesmanmpi_tpu_torch.cli import main
from gamesmanmpi_tpu_torch.obs.heartbeat import rss_bytes
if "cpu" not in sys.argv:
    torch.zeros(1, device="cuda")
rss = rss_bytes()
if sys.argv[1] != "off":
    os.environ["GAMESMAN_HOST_MEM_LIMIT_MB"] = str(
        rss / 2**20 + float(sys.argv[1]))
print(json.dumps({"rss_after_bringup": rss}), flush=True)
sys.exit(main(sys.argv[2:]))
"""


def write_spec(tmp, doc):
    path = tmp / f"{doc['name']}.json"
    path.write_text(json.dumps(doc))
    return str(path)


def jsonl(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def solve_fields(r):
    s = r.stats
    return dict(secs_forward=s["secs_forward"],
                secs_backward=s["secs_backward"],
                peak_mem_bytes=s["peak_mem_bytes"],
                positions_per_sec=s["positions_per_sec"])


def spec_5x5(classic_result, tmp, doc=SPEC_C55, spec=C55,
             answer=(69763700, "TIE", 25), extra=()):
    """(a) The Connect-4 5x5 GameSpec on the classic engine (auto's pick
    for a compiled game): phase 9's answer and tables, then the compiled
    and the hand-written solve in turns."""
    path = write_spec(tmp, doc)
    runs = []
    for turn, argv in enumerate((["solve", "--spec", path],
                                 ["solve", spec, "--engine", "classic"],
                                 ["solve", "--spec", path],
                                 ["solve", spec, "--engine", "classic"])):
        r, report = cli_solve([*argv, *extra])
        if report_answer(report) != answer or r.stats[
                "engine"] != "classic" or r.stats["misses"]:
            raise AssertionError(f"{argv}: {report}")
        if turn == 0:
            if getattr(r.game, "spec_hash", None) is None:
                raise AssertionError("--spec did not compile a GameSpec")
            _same_tables(r, classic_result, "compiled 5x5 vs phase 9")
        runs.append(dict(game="compiled" if turn % 2 == 0 else "hand",
                         **solve_fields(r)))
        del r
    return path, runs


def place_family(tmp, doc=SPEC_TTT444, spec="tictactoe:m=4,n=4,k=4",
                 extra=()):
    """(b) m,n,k 4x4x4 compiled against the hand-written game on the
    card; gomoku and misere m,n,k on the card against the CPU and the
    host oracle over the reference-style modules."""
    from gamesmanmpi_tpu_torch.compat import load_game_module
    from gamesmanmpi_tpu_torch.solve.oracle import oracle_solve

    out = {}
    compiled, _ = cli_solve(["solve", write_spec(tmp, doc), *extra])
    hand, _ = cli_solve(["solve", spec, *extra])
    _same_tables(compiled, hand, "tictactoe 4x4x4 compiled vs hand")
    out["ttt444"] = dict(positions=compiled.num_positions,
                         root=[compiled.value, compiled.remoteness],
                         compiled=solve_fields(compiled),
                         hand=solve_fields(hand))
    del compiled, hand
    for spec, module in (("gomoku_4x3x3.json", "gomoku_4x3x3.py"),
                         ("mnk_3x3x3_misere.json", "mnk_333_misere.py")):
        path = str(REPO / "examples" / "specs" / spec)
        card, _ = cli_solve(["solve", "--spec", path, *extra])
        cpu, _ = cli_solve(["solve", "--spec", path, "--device", "cpu"])
        _same_tables(card, cpu, f"{spec} card vs CPU")
        value, rem, table = oracle_solve(load_game_module(
            str(REPO / "examples" / "ref_games" / module)))
        if (card.value, card.remoteness) != (value, rem):
            raise AssertionError(f"{spec}: root {(card.value, card.remoteness)}"
                                 f" != oracle {(value, rem)}")
        n = 0
        for t in card.levels.values():
            for st, v, r in zip(t.states.tolist(), t.values.tolist(),
                                t.remoteness.tolist()):
                if table[st] != (v, r):
                    raise AssertionError(f"{spec} state {st:#x}: card "
                                         f"{(v, r)} != oracle {table[st]}")
                n += 1
        out[spec] = dict(positions=card.num_positions, oracle_checked=n,
                         root=[card.value, card.remoteness])
    return out


def instrumented_child(argv, tmp, tag):
    """(c) One solve child with every instrumentation flag; /status is
    scraped while it runs. -> (report lines, last-line record, records,
    trace events, metrics text, /status snapshots, seconds)."""
    from gamesmanmpi_tpu_torch.obs.status import fetch_status

    d = tmp / tag
    d.mkdir()
    addr = d / "addr"
    paths = {k: d / f"run.{k}" for k in ("jsonl", "trace", "metrics")}
    t0 = time.perf_counter()
    proc = child([*argv, "--jsonl", str(paths["jsonl"]), "--trace-events",
                  str(paths["trace"]), "--metrics-out", str(paths["metrics"]),
                  "--heartbeat-secs", "0.5", "--status-port", "0"],
                 env={"GAMESMAN_STATUS_ADDR_FILE": str(addr)})
    snaps = []
    try:
        while proc.poll() is None:
            if addr.exists():
                got = fetch_status(addr.read_text(), timeout=2)
                if got is not None:
                    snaps.append(got)
            # 5 Hz: a 20 Hz scraper costs the dense backward 12-15%
            # (tools/torch_instrumentation_ab.py).
            time.sleep(0.2)
        out, err = proc.communicate(timeout=600)
    finally:
        stop(proc)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"child {argv} exited {proc.returncode}:\n"
                             f"{out[-2000:]}\n{err[-4000:]}")
    lines = out.splitlines()
    trace = json.loads(paths["trace"].read_text())["traceEvents"]
    return (lines, json.loads(lines[-1]), jsonl(paths["jsonl"]), trace,
            paths["metrics"].read_text(), snaps, secs)


def check_instrumented(tag, lines, records, trace, metrics, snaps, want,
                       spans, card):
    """The records follow `want` ((phase, level) in order, heartbeats
    aside); positions/s from the done record is the report's; the trace
    is Chrome JSON of registered span names; the metrics hold the span
    histogram; /status answered mid-solve. The heartbeats that carry
    cuda:0's bytes in use are counted (the caller requires them where
    the solve outlasts the interval)."""
    got = [(r["phase"], r.get("level")) for r in records
           if r["phase"] != "heartbeat"]
    if got != want:
        raise AssertionError(f"{tag}: records {got} != {want}")
    # The heartbeat thread stops after the engine logs `done`, so a last
    # beat may follow it in the stream (the reference's order too).
    done = next(r for r in reversed(records) if r["phase"] == "done")
    rate =done["positions"] / done["secs_total"]
    line = next(ln for ln in lines if ln.startswith("throughput:"))
    if line != f"throughput: {rate:.0f} positions/sec":
        raise AssertionError(f"{tag}: {line} != records' {rate:.0f}")
    names = {e["name"] for e in trace}
    if names != spans or any(e["ph"] != "X" for e in trace):
        raise AssertionError(f"{tag}: trace events {names} != {spans}")
    if "gamesman_span_seconds" not in metrics:
        raise AssertionError(f"{tag}: no span histogram in --metrics-out")
    beats = [r for r in records if r["phase"] == "heartbeat"]
    on_card = [b for b in beats
               if b.get("devices", {}).get("cuda:0", {}).get(
                   "bytes_in_use", 0) > 0]
    mid = [s for s in snaps if s.get("phase") in ("forward", "backward")]
    if card and not mid:
        raise AssertionError(f"{tag}: /status never answered mid-solve "
                             f"({len(snaps)} snapshots)")
    mid = mid or [{}]
    return dict(records=len(records), heartbeats=len(beats),
                heartbeats_on_card=len(on_card),
                heartbeat_bytes_in_use=(on_card[-1]["devices"]["cuda:0"]
                                        if on_card else None),
                status_snapshots=len(snaps),
                status_mid_solve={k: mid[-1].get(k) for k in (
                    "engine", "phase", "level", "positions_solved",
                    "levels_total", "levels_solved", "throughput_pps",
                    "eta_secs")},
                trace_events=len(trace), span_names=sorted(names),
                secs_backward=done["secs_backward"],
                positions_per_sec=done["positions_per_sec"])


def watchdog_and_memguard(tmp, stalled=("connect4:w=5,h=4", 18), spec=C55,
                          answer=(69763700, "TIE", 25), margin="512",
                          extra=()):
    """(d) A 5x4 classic child stalled at its third backward level under
    --watchdog-secs 2, and (e) two 5x5 classic children, the host-memory
    guard armed 512 MiB above the resident set CUDA's bring-up leaves,
    and off: run together. -> their fields."""
    wd_dir, mg_dir = tmp / "watchdog", tmp / "memguard"
    wd_dir.mkdir()
    mg_dir.mkdir()
    mg_jsonl = mg_dir / "run.jsonl"
    t0 = time.perf_counter()
    wd = child(["solve", stalled[0], "--engine", "classic",
                "--watchdog-secs", "2", *extra],
               env={"GAMESMAN_FAULTS": "engine.backward:delay=60:3",
                    "GAMESMAN_FLIGHTREC_DIR": str(wd_dir)})
    procs = {"watchdog": wd}
    for tag, limit, flags, env in (
            ("guarded", margin, ["--jsonl", str(mg_jsonl)],
             {"GAMESMAN_FLIGHTREC_DIR": str(mg_dir)}),
            ("unguarded", "off", [], {})):
        procs[tag] = subprocess.Popen(
            [sys.executable, "-c", MEMGUARD_CHILD, limit, "solve", spec,
             "--engine", "classic", *flags, *extra], cwd=REPO,
            env=dict(os.environ, **env), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    res = {}
    try:
        for tag, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            res[tag] = (proc.returncode, out, err,
                        time.perf_counter() - t0)
    finally:
        for proc in procs.values():
            stop(proc)
    rc, out, err, wd_secs = res["watchdog"]
    if rc != 124 or wd_secs > 45 or "[watchdog] stall detected" not in err:
        raise AssertionError(f"watchdog child rc {rc} after {wd_secs:.1f} s:"
                             f"\n{err[-3000:]}")
    dump = json.loads((wd_dir / "flightrec_0.json").read_text())
    level = stalled[1]
    spans = [s for s in dump["inflight_spans"] if s["span"] == "backward"]
    if dump["reason"] != "watchdog_abort" or [
            s["level"] for s in spans] != [level] or dump[
            "last_completed"].get("backward") != level + 1:
        raise AssertionError(f"watchdog dump: {dump['reason']}, "
                             f"{spans}, {dump['last_completed']}")
    stall = re.search(r"'stalled_secs': ([0-9.]+), 'deadline_secs': "
                      r"([0-9.]+)", err)
    wd_fields = dict(rc=rc, secs_to_exit=wd_secs,
                     stalled_secs=float(stall.group(1)),
                     deadline_secs=float(stall.group(2)),
                     stalled_level=level, age_secs=spans[0]["age_secs"])
    rc, out, err, g_secs = res["guarded"]
    first = json.loads(out.splitlines()[0])
    trips = [r for r in jsonl(mg_jsonl) if r["phase"] == "oom_guard"]
    dump = json.loads((mg_dir / "flightrec_0.json").read_text())
    if (rc != 1 or "out of memory: host RSS" not in err or not trips
            or dump["reason"] != "oom" or "positions:" in out):
        raise AssertionError(f"guarded child rc {rc}: {out[-1000:]}\n"
                             f"{err[-3000:]}")
    rc2, out2, err2, u_secs = res["unguarded"]
    if rc2 != 0 or report_answer(out2.splitlines()) != answer:
        raise AssertionError(f"unguarded child rc {rc2}: {out2[-1000:]}\n"
                             f"{err2[-3000:]}")
    mg_fields = dict(rss_after_bringup=first["rss_after_bringup"],
                     trip=trips[0], secs=g_secs,
                     unguarded_rss_after_bringup=json.loads(
                         out2.splitlines()[0])["rss_after_bringup"],
                     unguarded_secs=u_secs)
    return wd_fields, mg_fields


def profile_dense(tmp, extra=()):
    """(f) --profile-dir on the dense 4x4 solve: the Chrome trace names
    the backward step's kernel."""
    from gamesmanmpi_tpu_torch import kernels

    d = tmp / "profile"
    kernels.reset_launches()
    r, report = cli_solve(["solve", "connect4:w=4,h=4", "--engine", "dense",
                           "--profile-dir", str(d), *extra])
    launches = dict(kernels.LAUNCHES)["dense_step"]
    if report_answer(report) != (161029, "TIE", 16) or (
            launches <= 0 and not extra):
        raise AssertionError(f"profiled 4x4: {report}, {launches} launches")
    (trace,) = d.iterdir()
    events = json.loads(trace.read_text())["traceEvents"]
    gathers = [e for e in events if "dense_step_kernel" in e.get(
        "name", "") and e.get("cat") == "kernel"]
    if not gathers and not extra:
        raise AssertionError("profiler trace names no dense_step_kernel")
    return dict(trace_bytes=trace.stat().st_size, events=len(events),
                gather_kernel_events=len(gathers), launches=launches,
                kernel_name=gathers[0]["name"] if gathers else None,
                kernel_us=sum(e.get("dur", 0) for e in gathers))


def spec_export(tmp, extra=()):
    """(g) export-db --spec connect4_4x4.json on the card: the CPU
    export's files; a card reader rebuilds the game from the embedded
    spec and answers, and `query` prints, the solve's table."""
    import numpy as np

    from gamesmanmpi_tpu_torch.cli import main
    from gamesmanmpi_tpu_torch.db import DbReader
    from gamesmanmpi_tpu_torch.gamedsl import load_spec

    spec = str(REPO / "examples" / "specs" / "connect4_4x4.json")
    card_db, cpu_db = tmp / "spec_card.db", tmp / "spec_cpu.db"
    t0 = time.perf_counter()
    for d, flags in ((card_db, list(extra)), (cpu_db, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["export-db", "--spec", spec, "--out", str(d), *flags])
        if rc != 0 or "positions: 161029" not in buf.getvalue():
            raise AssertionError(f"export-db --spec {flags}: rc {rc}")
    export_secs = time.perf_counter() - t0
    if digests(card_db) != digests(cpu_db):
        raise AssertionError("card and CPU --spec exports differ")
    truth, _ = cli_solve(["solve", "--spec", spec, *extra])
    rng = np.random.default_rng(16)
    states = np.concatenate([t.states[rng.integers(0, t.states.shape[0],
                                                   size=64)]
                             for t in truth.levels.values()])
    want = {int(s): truth.lookup(int(s)) for s in states}
    device = "cpu" if extra else "cuda"
    with DbReader(card_db, device=device) as reader:
        if reader.game.spec_hash != load_spec(spec).spec_hash:
            raise AssertionError("reader's game is not the embedded spec")
        values, rem, found = reader.lookup(states.astype(np.uint32))
    for s, v, r, f in zip(states.tolist(), values.tolist(), rem.tolist(),
                          found.tolist()):
        if not f or want[s] != (v, r):
            raise AssertionError(f"reader {s:#x}: {(f, v, r)} != {want[s]}")
    asked = [hex(int(s)) for s in states[:32]]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["query", str(card_db), *asked, *extra])
    lines = buf.getvalue().splitlines()
    for q, ln in zip(asked, lines):
        v, r = want[int(q, 16)]
        head = f"query {q}: value={('UNDECIDED', 'WIN', 'LOSE', 'TIE')[v]} "
        if rc != 0 or not ln.startswith(head + f"remoteness={r}"):
            raise AssertionError(f"query {q}: {ln!r}, want {(v, r)}")
    return dict(files=len(digests(card_db)), export_secs=export_secs,
                reader_checked=int(states.shape[0]), query_checked=len(asked))


def spec_instrumentation_phase(classic_result, dense_result, tmp, spec=C55,
                               doc=SPEC_C55, answer=(69763700, "TIE", 25),
                               extra=(), stalled=("connect4:w=5,h=4", 18),
                               place=(SPEC_TTT444, "tictactoe:m=4,n=4,k=4"),
                               margin="512"):
    """Phase 16: GameSpec games and the solve's instrumentation. The
    keyword arguments shrink it for a rehearsal on the CPU (extra =
    ("--device", "cpu"), where the card-only checks are skipped)."""
    t0 = time.perf_counter()
    tmp = tmp / "phase16"  # the earlier phases' names stay theirs
    tmp.mkdir()
    cells = doc["board"]["width"] * doc["board"]["height"]
    fields = {}
    tp = time.perf_counter()
    path, runs = spec_5x5(classic_result, tmp, doc, spec, answer, extra)
    fields["a_spec_5x5"] = dict(runs=runs, tables_equal_phase9=True,
                                secs=time.perf_counter() - tp)
    tp = time.perf_counter()
    fields["b_place"] = dict(place_family(tmp, *place, extra=extra),
                             secs=time.perf_counter() - tp)
    tp = time.perf_counter()
    engine = ["--engine", "dense"] if extra else []
    dense = instrumented_child(["solve", spec, *engine, *extra], tmp,
                               "dense")
    lines, rec, records, trace, metrics, snaps, secs = dense
    if rec["stats"]["engine"] != "dense" or (
            rec["launches"]["dense_step"] <= 0 and not extra):
        raise AssertionError(f"instrumented 5x5 did not run the kernels: "
                             f"{rec['launches']}")
    got_d = check_instrumented(
        "dense", lines[:-1], records, trace, metrics, snaps,
        [("dense_backward", L) for L in range(cells, -1, -1)]
        + [("done", None)], {"backward"}, card=not extra)
    if not extra and not got_d["heartbeats_on_card"]:
        raise AssertionError("the instrumented dense 5x5 child left no "
                             "heartbeat with cuda:0 memory")
    got_d.update(child_secs=secs, launches=rec["launches"],
                 uninstrumented_secs_backward=dense_result.stats[
                     "secs_backward"])
    got_d["backward_ratio"] = (got_d["secs_backward"]
                               / got_d["uninstrumented_secs_backward"])
    lines, rec, records, trace, metrics, snaps, secs = instrumented_child(
        ["solve", "--spec", path, *extra], tmp, "classic")
    got_c = check_instrumented(
        "classic", lines[:-1], records, trace, metrics, snaps,
        [("forward", k) for k in range(cells)]
        + [("backward", k) for k in range(cells, -1, -1)]
        + [("done", None)], {"forward", "dedup", "backward"},
        card=not extra)
    compiled = [r["secs_backward"] for r in runs if r["game"] == "compiled"]
    got_c.update(child_secs=secs, uninstrumented_secs_backward=compiled)
    got_c["backward_ratio"] = got_c["secs_backward"] / min(compiled)
    fields["c_instrumented"] = dict(dense=got_d, classic=got_c,
                                    secs=time.perf_counter() - tp)
    tp = time.perf_counter()
    wd, mg = watchdog_and_memguard(tmp, stalled, spec, answer, margin,
                                   extra)
    fields["d_watchdog"] = wd
    fields["e_memguard"] = dict(mg, secs=time.perf_counter() - tp)
    tp = time.perf_counter()
    fields["f_profile"] = dict(profile_dense(tmp, extra),
                               secs=time.perf_counter() - tp)
    tp = time.perf_counter()
    fields["g_export"] = dict(spec_export(tmp, extra),
                              secs=time.perf_counter() - tp)
    emit("spec and instrumentation", **fields,
         secs=time.perf_counter() - t0)


#: The campaign runner and the CLI, each as its users run it.
CAMPAIGN = [sys.executable, "-m", "gamesmanmpi_tpu_torch.resilience.campaign"]
PORT_CLI = [sys.executable, "-m", "gamesmanmpi_tpu_torch"]


def children_of(pid):
    """Pids whose parent is `pid` (a scan of /proc)."""
    out = []
    for d in pathlib.Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            stat = (d / "stat").read_text()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(d.name))
    return out


def maps_cuda(pid):
    """Does process `pid` have libcuda (CUDA's user-mode library) mapped
    (None where /proc/<pid>/maps cannot be read)?"""
    try:
        return "libcuda.so" in pathlib.Path(f"/proc/{pid}/maps").read_text()
    except OSError:
        return None


class TreeRun:
    """A child process and its children, sampled every 0.1 s until it
    exits: the peak resident set of the child itself and of the largest
    grandchild, and every grandchild pid seen. `tick(run)` runs at each
    sample (the phase's probes)."""

    def __init__(self, argv, env, tick=None, timeout=900):
        self.argv, self.tick, self.timeout = argv, tick, timeout
        self.env = dict(os.environ, **env)
        self.env.pop("GAMESMAN_HOST_MEM_LIMIT_MB", None)
        self.peak = self.child_peak = 0
        self.seen = set()

    def run(self):
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(self.argv, cwd=REPO, env=self.env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
        import threading

        out = {}
        reader = threading.Thread(target=lambda: out.update(zip(
            ("out", "err"), self.proc.communicate())), daemon=True)
        reader.start()
        try:
            deadline = time.monotonic() + self.timeout
            while self.proc.poll() is None:
                if time.monotonic() > deadline:
                    raise AssertionError(f"{self.argv} ran past "
                                         f"{self.timeout} s")
                self.peak = max(self.peak, rss_bytes(self.proc.pid) or 0)
                kids = children_of(self.proc.pid)
                self.seen.update(kids)
                for k in kids:
                    self.child_peak = max(self.child_peak, rss_bytes(k) or 0)
                if self.tick is not None:
                    self.tick(self)
                time.sleep(0.1)
        finally:
            stop(self.proc)
            reader.join(timeout=60)
        self.t_end = time.perf_counter()
        self.secs = self.t_end - t0
        self.out, self.err = out.get("out", ""), out.get("err", "")
        return self

    def fields(self):
        return dict(rc=self.proc.returncode, secs=self.secs,
                    parent_peak_rss_bytes=self.peak,
                    child_peak_rss_bytes=self.child_peak)


def ledger_of(ck):
    return [json.loads(line) for line in
            (pathlib.Path(ck) / "campaign.jsonl").read_text().splitlines()]


def attempt_causes(ck):
    return [r["cause"] for r in ledger_of(ck)
            if r["phase"] == "campaign_attempt"]


def attempt_report(ck, attempt):
    out = pathlib.Path(ck) / "logs" / f"attempt_{attempt:03d}.out"
    return report_answer(out.read_text().splitlines())


def table_out_equal(path, result):
    """A --table-out file against a solve's tables, level by level."""
    import numpy as np

    from gamesmanmpi_tpu_torch.core.bitops import to_reference
    from gamesmanmpi_tpu_torch.core.codec import pack_cells_np

    with np.load(path) as z:
        if sorted(z.files) != sorted(
                f"{w}_{k:04d}" for k in result.levels
                for w in ("states", "cells")):
            raise AssertionError(f"{path}: members {sorted(z.files)[:4]}...")
        for k, t in result.levels.items():
            want_s = to_reference(t.states, result.game)
            want_c = pack_cells_np(t.values, t.remoteness)
            got_s, got_c = z[f"states_{k:04d}"], z[f"cells_{k:04d}"]
            if got_s.dtype != want_s.dtype or got_s.tobytes() != \
                    want_s.tobytes() or got_c.tobytes() != want_c.tobytes():
                raise AssertionError(f"{path}: level {k} differs")


def campaign_registry_phase(result, dense_result, tmp, v1, spec=C55,
                            answer=(69763700, "TIE", 25), extra=(),
                            kill=5, delay="0.3", samples=312):
    """Phase 17: self-healing campaigns and the DB registry, as CLI
    children. `result` is phase 9's classic solve of `spec`,
    `dense_result` phase 6's dense one and `v1` phase 12's streamed DB;
    `extra` (`--device cpu`) and a smaller `spec` rehearse the phase on
    the CPU. -> the level kernels' launches in the dense campaign's
    resumed attempt."""
    import numpy as np

    from gamesmanmpi_tpu_torch.db import DbReader
    from gamesmanmpi_tpu_torch.obs.status import fetch_status
    from gamesmanmpi_tpu_torch.registry.pull import fetch_catalog, pull_db
    from gamesmanmpi_tpu_torch.resilience.campaign import checkpoint_progress
    from gamesmanmpi_tpu_torch.store import read_npz_members

    t0 = time.perf_counter()
    tmp = tmp / "phase17"
    tmp.mkdir()
    extra = list(extra)
    on_card = "cpu" not in extra
    raw = {"GAMESMAN_CKPT_COMPRESS": "0",
           "GAMESMAN_CAMPAIGN_BACKOFF_BASE_SECS": "0.5"}
    fields = {}

    # (a) Dense: killed after its `kill`-th sealed level, resumed.
    D, J = tmp / "dense", tmp / "dense.jsonl"
    run = TreeRun(CAMPAIGN + [spec, "--checkpoint-dir", str(D), "--chaos",
                              f"ckpt.save_level:kill:{kill}",
                              "--attempt-timeout", "600", "--", "--engine",
                              "dense", "--jsonl", str(J), *extra], raw).run()
    if run.proc.returncode != 0 or attempt_causes(D) != ["killed",
                                                         "complete"]:
        raise AssertionError(f"dense campaign: rc {run.proc.returncode}, "
                             f"causes {attempt_causes(D)}\n{run.err[-3000:]}")
    done = [r for r in jsonl(J) if r["phase"] == "done"][-1]
    launches = step_launches(done["kernel_launches"])
    if (attempt_report(D, 2) != answer or done["levels_resumed"] != kill
            or (launches["dense_step"] > 0) != on_card):
        raise AssertionError(f"dense campaign: {attempt_report(D, 2)}, "
                             f"resumed {done['levels_resumed']}, "
                             f"{launches} launches")
    for L, cells in sorted(dense_result.cells.items()):
        (got,) = read_npz_members(D / f"dense_{L:04d}.npz", ("cells",))
        if got.tobytes() != cells.tobytes():
            raise AssertionError(f"dense campaign: level {L} differs from "
                                 "phase 6's cells")
    fields["a_dense"] = dict(
        run.fields(), causes=attempt_causes(D), launches=launches,
        levels_resumed=done["levels_resumed"],
        resumed_secs_backward=done["secs_backward"],
        attempt_secs=[r["wall_secs"] for r in ledger_of(D)
                      if r["phase"] == "campaign_attempt"],
        cells_identical_levels=len(dense_result.cells))
    emit("campaign dense (a)", **fields["a_dense"])
    shutil.rmtree(D)

    # (b) Sharded at 2 shards, oom at the 2nd backward step: escalated to
    # 4 shards (GAMESMAN_FAKE_DEVICES pinned) with the cache halved.
    S, J, T = tmp / "sharded", tmp / "sharded.jsonl", tmp / "sharded.npz"
    run = TreeRun(CAMPAIGN + [spec, "--checkpoint-dir", str(S), "--chaos",
                              "sharded.backward:oom:2", "--attempt-timeout",
                              "600", "--", "--devices", "2", "--jsonl",
                              str(J), "--table-out", str(T), *extra],
                  dict(raw, GAMESMAN_FAKE_DEVICES="2")).run()
    records = ledger_of(S)
    resh = [r for r in records if r["phase"] == "campaign_reshard"]
    attempts = [r for r in records if r["phase"] == "campaign_attempt"]
    reshard = [r for r in jsonl(J) if r["phase"] == "reshard"]
    if (run.proc.returncode != 0 or len(resh) != 1
            or (resh[0]["from_shards"], resh[0]["to_shards"]) != (2, 4)
            or resh[0]["to_cache_mb"] != resh[0]["from_cache_mb"] // 2
            or [r["cause"] for r in attempts] != ["oom", "complete"]
            or (attempts[1]["shards"], attempts[1]["sealed_shards"]) != (4, 2)
            or not reshard or reshard[-1]["from_shards"] != [2]):
        raise AssertionError(f"oom campaign: rc {run.proc.returncode}, "
                             f"{resh}, {attempts}, {reshard}\n"
                             f"{run.err[-3000:]}")
    table_out_equal(T, result)
    done = [r for r in jsonl(J) if r["phase"] == "done"][-1]
    fields["b_oom"] = dict(
        run.fields(), reshard=resh[0], resharded_from=reshard[-1][
            "from_shards"], resumed_secs_backward=done.get("secs_backward"),
        attempt_secs=[r["wall_secs"] for r in attempts],
        tables_equal_phase9=True)
    emit("campaign oom (b)", **fields["b_oom"])
    shutil.rmtree(S)
    T.unlink()

    # (c) Preemption: SIGTERM to the campaign in attempt 1's backward
    # (slowed by a delay), exit 75; the same command again completes.
    P, addr = tmp / "preempt", tmp / "campaign_addr"
    argv = CAMPAIGN + [spec, "--checkpoint-dir", str(P), "--chaos",
                       f"engine.backward:delay={delay}:always",
                       "--status-port", "0", "--", *extra]
    env = dict(raw, GAMESMAN_STATUS_ADDR_FILE=str(addr))
    probe = {}

    def preempt(run):
        if "signalled" in probe or not addr.exists():
            return
        if "scrape" not in probe:
            got = fetch_status(addr.read_text().strip(), timeout=5)
            if got and got.get("solve"):
                probe["scrape"] = got
        if len(checkpoint_progress(P)["solved_levels"]) < 2:
            return
        kids = children_of(run.proc.pid)
        probe["attempt_pids"] = kids
        probe["smi_pids"] = sorted(smi_apps())
        probe["maps_cuda"] = {"campaign": maps_cuda(run.proc.pid),
                              "attempt": [maps_cuda(k) for k in kids]}
        if "scrape" in probe:
            probe["signalled"] = time.perf_counter()
            run.proc.send_signal(signal.SIGTERM)

    run = TreeRun(argv, env, tick=preempt).run()
    causes = attempt_causes(P)
    if run.proc.returncode != 75 or causes[-1:] != ["preempted"] \
            or ledger_of(P)[-1]["phase"] != "campaign_preempted":
        raise AssertionError(f"preempted campaign: rc {run.proc.returncode},"
                             f" causes {causes}\n{run.err[-3000:]}")
    scrape = probe["scrape"]
    if scrape["kind"] != "campaign" or scrape["attempt"] != 1 \
            or not scrape["solve"]:
        raise AssertionError(f"campaign /status: {scrape}")
    # nvidia-smi reports pids of its own PID namespace (a container's CUDA
    # processes may all read as one pid there), so the check that holds
    # is /proc/<pid>/maps: libcuda mapped in the attempt, never in the
    # campaign; nvidia-smi's list is recorded beside it.
    if probe["maps_cuda"]["campaign"] or run.proc.pid in probe["smi_pids"]:
        raise AssertionError(f"CUDA in the campaign process: {probe}")
    if on_card and not any(probe["maps_cuda"]["attempt"]):
        raise AssertionError(f"the attempt holds no CUDA: {probe}")
    sealed = len(checkpoint_progress(P)["solved_levels"])
    first = dict(run.fields(),
                 secs_sigterm_to_exit=run.t_end - probe["signalled"])
    campaign_pid = run.proc.pid
    run = TreeRun(argv, env).run()
    rerun = [r for r in ledger_of(P) if r["phase"] == "campaign_attempt"][-1]
    if run.proc.returncode != 0 or rerun["cause"] != "complete" \
            or rerun["solved_before"] != sealed \
            or attempt_report(P, rerun["attempt"]) != answer:
        raise AssertionError(f"rerun after preemption: rc "
                             f"{run.proc.returncode}, {rerun}\n"
                             f"{run.err[-3000:]}")
    fields["c_preempt"] = dict(
        first=first, rerun=run.fields(), levels_sealed_at_sigterm=sealed,
        nvidia_smi_pids=probe["smi_pids"], attempt_pids=probe["attempt_pids"],
        campaign_pid=campaign_pid, maps_cuda=probe["maps_cuda"],
        status=dict(kind=scrape["kind"], attempt=scrape["attempt"],
                    breaker=scrape["breaker"],
                    solve_phase=scrape["solve"].get("phase")))
    emit("campaign preempt (c)", **fields["c_preempt"])
    shutil.rmtree(P)

    # (d) The registry: serve --jobs, POST /solve, run-jobs --once; the
    # published epoch and files are phase 12's v1 DB; pulled twice.
    R, name = tmp / "registry", "connect4_" + spec.split(":")[1].replace(
        ",", "_").replace("=", "")
    serve = subprocess.Popen(PORT_CLI + ["registry", "serve", "--root",
                                         str(R), "--jobs", *extra],
                             cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        banner = serve.stdout.readline()
        if " on http://" not in banner:
            raise AssertionError(f"registry banner {banner!r}: "
                                 f"{serve.stderr.read()[-2000:]}")
        url = banner.split(" on ")[1].split()[0]
        job = http_json(f"{url}/solve", {"spec": spec, "name": name})
        if not job.get("ok") or job["state"] != "pending":
            raise AssertionError(f"POST /solve: {job}")
        run = TreeRun(PORT_CLI + ["registry", "run-jobs", "--root", str(R),
                                  "--once", *extra], raw).run()
        if run.proc.returncode != 0:
            raise AssertionError(f"run-jobs: {run.out[-2000:]}\n"
                                 f"{run.err[-3000:]}")
        (res,) = json.loads(run.out.splitlines()[-1])["results"]
        want = digests(v1)
        cat = fetch_catalog(url)
        rec = cat["dbs"][name]
        if rec["epoch"] != want["manifest.json"] or res["epoch"] != \
                rec["epoch"] or {f["name"]: f["sha256"]
                                  for f in rec["files"]} != want:
            raise AssertionError(f"published {rec['epoch']} != phase 12's "
                                 f"v1 {want['manifest.json']}")
        tp = time.perf_counter()
        pulled = pull_db(url, name, tmp / "replica")
        pull_secs = time.perf_counter() - tp
        again = pull_db(url, name, tmp / "replica")
        if not pulled["installed"] or again["installed"] or \
                digests(pulled["db"]) != want:
            raise AssertionError(f"pull: {pulled}, rerun {again}")
        states, values, rem = sample_states(result, samples, seed=1717)
        dev = torch.device("cuda" if on_card else "cpu")
        with DbReader(pulled["db"], device=dev) as reader:
            got_v, got_r, found = reader.lookup(states)
        if not found.all() or not np.array_equal(got_v, values) \
                or not np.array_equal(got_r, rem):
            raise AssertionError("the pulled DB answers differently from "
                                 "phase 9's tables")
        serve.send_signal(signal.SIGTERM)
        if serve.wait(timeout=60) != 0:
            raise AssertionError(f"registry serve exited {serve.returncode}")
    finally:
        stop(serve)
    fields["d_registry"] = dict(
        run_jobs=run.fields(), epoch=rec["epoch"], files=len(rec["files"]),
        files_equal_phase12_v1=True, pull=dict(
            secs=pull_secs, installed=True, rerun_installed=False),
        positions_checked=int(samples))
    emit("registry (d)", **fields["d_registry"])
    shutil.rmtree(tmp)
    emit("campaign and registry", parts=sorted(fields),
         secs=time.perf_counter() - t0)
    return launches


#: The keys of the reference's hybrid records (gamesmanmpi_tpu/solve/
#: hybrid.py): hybrid_sweep and hybrid_bfs exactly, done's but the
#: analytic byte counts the port leaves out. "t" is the logger's stamp.
HYBRID_KEYS = {
    "hybrid_sweep": {"phase", "t", "boundary", "frontier", "reachable",
                     "secs"},
    "hybrid_bfs": {"phase", "t", "levels", "positions", "secs"},
    "done": {"phase", "t", "engine", "cutover", "positions",
             "positions_dense_region", "positions_bfs_region",
             "positions_per_sec", "secs_forward", "secs_backward",
             "secs_total", "secs_bfs", "frontier_at_boundary",
             "reachable_at_boundary"},
}


def file_sha(path):
    import hashlib

    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


def pipeline_runs(result, tmp, spec, answer, extra):
    """(a) GAMESMAN_PIPELINE level and pingpong in turns, then one
    checkpointed run of each: -> the phase line's fields."""
    runs = []
    for mode in ("level", "pingpong", "pingpong", "level"):
        with env_set(GAMESMAN_PIPELINE=mode):
            r, report = cli_solve(["solve", spec, "--engine", "classic",
                                   *extra])
        if report_answer(report) != answer or r.stats["pipeline"] != mode:
            raise AssertionError(f"{mode}: {report} {r.stats['pipeline']}")
        _same_tables(r, result, f"pipeline {mode} vs phase 9")
        s = r.stats
        # On the card every level's tail waits on its copies; a CPU
        # rehearsal's tails of zero-copy views round to 0.000 s.
        if mode == "pingpong" and not s["overlap_secs"] > 0 \
                and "cpu" not in extra:
            raise AssertionError(f"pingpong overlap_secs {s['overlap_secs']}")
        runs.append(dict(mode=mode, secs_forward=s["secs_forward"],
                         secs_backward=s["secs_backward"],
                         overlap_secs=s["overlap_secs"],
                         bytes_host=s["bytes_host"],
                         peak_mem_bytes=s["peak_mem_bytes"]))
        del r
    digests, ckpt = {}, {}
    for mode in ("level", "pingpong"):
        d = tmp / f"pipeline_{mode}"
        with env_set(GAMESMAN_PIPELINE=mode, GAMESMAN_CKPT_COMPRESS=0):
            r, report = cli_solve(["solve", spec, "--engine", "classic",
                                   "--checkpoint-dir", str(d), *extra])
        if report_answer(report) != answer:
            raise AssertionError(f"checkpointed {mode}: {report}")
        digests[mode] = {p.name: file_sha(p) for p in sorted(d.iterdir())
                         if p.name.startswith("level_")}
        s = r.stats
        ckpt[mode] = dict(secs_backward=s["secs_backward"],
                          overlap_secs=s["overlap_secs"],
                          ckpt_save_secs=s.get("ckpt_save_secs"),
                          peak_mem_bytes=s["peak_mem_bytes"])
        del r
        shutil.rmtree(d)
    if len(digests["level"]) != len(result.levels) \
            or digests["level"] != digests["pingpong"]:
        raise AssertionError("checkpoint level files differ between level "
                             "and pingpong")
    if not ckpt["pingpong"]["overlap_secs"] > 0:
        raise AssertionError(f"checkpointed pingpong: {ckpt['pingpong']}")
    return dict(runs=runs, checkpointed=ckpt,
                level_files_identical=len(digests["level"]))


def streaming_runs(result, tmp, spec, answer, extra, window_block,
                   store_mb):
    """(b) and (c): window streaming under both backwards, then the
    edges' disk tier: -> the phase line's fields."""
    out = {}
    wb = ["--window-block", str(window_block)]
    for mode in ("edges", "lookup"):
        more = (["--table-out", str(tmp / "streamed.npz")]
                if mode == "edges" else [])
        with env_set(GAMESMAN_FAKE_DEVICES=4):
            r, report = cli_solve(["solve", spec, "--devices", "4", *wb,
                                   "--backward", mode, *more, *extra])
        s = r.stats
        if report_answer(report) != answer or s["window_stream_blocks"] <= 0 \
                or s["backward"] != mode or s["misses"]:
            raise AssertionError(f"streamed {mode}: {report} {s}")
        _same_tables(r, result, f"streamed {mode} vs phase 9")
        if more:
            table_out_equal(more[1], result)
            pathlib.Path(more[1]).unlink()
        out[mode] = dict(sharded_fields(s),
                         window_stream_blocks=s["window_stream_blocks"])
        del r
    d = tmp / "disk_tier"
    with env_set(GAMESMAN_FAKE_DEVICES=4, GAMESMAN_CKPT_COMPRESS=0,
                 GAMESMAN_STORE_CACHE_MB=store_mb):
        r, report = cli_solve(["solve", spec, "--devices", "4", *wb,
                               "--backward", "edges", "--device-store-mb",
                               "1", "--checkpoint-dir", str(d), *extra])
    s = r.stats
    if report_answer(report) != answer or s["edges_bytes_disk"] <= 0 \
            or s["backward_edges_levels"] != s["levels"] - 1:
        raise AssertionError(f"disk tier: {report} {s}")
    _same_tables(r, result, "disk tier vs phase 9")
    out["disk_tier"] = dict(
        ckpt_fields(s), edges_bytes_disk=s["edges_bytes_disk"],
        edges_bytes_spilled=s["edges_bytes_spilled"],
        states_bytes_spilled=s["states_bytes_spilled"],
        window_stream_blocks=s["window_stream_blocks"],
        prefetch_hits=s["prefetch_hits"],
        prefetch_misses=s["prefetch_misses"], store_cache_mb=store_mb,
        disk_bytes=disk_bytes(d))
    del r
    shutil.rmtree(d)
    return out


def counts_file_children(tmp, spec, answer, extra):
    """(d): two dense children sharing one counts file -> (fields,
    their level kernels' launches)."""
    path = tmp / "dense_counts.json"
    env = {"GAMESMAN_DENSE_COUNTS_FILE": str(path)}
    out, launches = [], dict.fromkeys(STEP_KERNELS, 0)
    for i, want in enumerate(("sweep", "file")):
        log = tmp / f"counts_{i}.jsonl"
        lines, rec, secs = run_child(["solve", spec, "--engine", "dense",
                                      "--jsonl", str(log), *extra], 0, env)
        done = [r for r in jsonl(log) if r["phase"] == "done"][-1]
        if report_answer(lines) != answer \
                or done["reach_counts_source"] != want:
            raise AssertionError(f"counts child {i}: {lines[-3:]} "
                                 f"{done.get('reach_counts_source')}")
        for k in STEP_KERNELS:
            launches[k] += rec["launches"][k]
        out.append(dict(reach_counts_source=done["reach_counts_source"],
                        secs_count_reachable=done["secs_count_reachable"],
                        secs_backward=done["secs_backward"],
                        launches=step_launches(done["kernel_launches"]),
                        wall_secs=secs))
    if not path.exists():
        raise AssertionError("the first child wrote no counts file")
    return out, launches


def hybrid_records_child(tmp, spec, answer, extra, cutover):
    """(e): the hybrid's records from a child's --jsonl -> (fields, its
    level kernels' launches)."""
    log = tmp / "hybrid.jsonl"
    lines, rec, secs = run_child(["solve", spec, "--engine", "hybrid",
                                  "--hybrid-cutover", str(cutover),
                                  "--jsonl", str(log), *extra], 0)
    recs = [r for r in jsonl(log) if r["phase"] != "heartbeat"]
    phases = [r["phase"] for r in recs]
    if report_answer(lines) != answer or phases != [
            "hybrid_sweep", "hybrid_bfs", "done"]:
        raise AssertionError(f"hybrid records {phases}: {lines[-3:]}")
    for r in recs:
        want = HYBRID_KEYS[r["phase"]]
        if r["phase"] == "done" and not want <= set(r) \
                or r["phase"] != "done" and set(r) != want:
            raise AssertionError(f"{r['phase']} keys {sorted(r)}")
    return dict(records={r["phase"]: {k: v for k, v in r.items()
                                      if k in ("boundary", "frontier",
                                               "reachable", "levels",
                                               "positions", "secs",
                                               "secs_total")}
                         for r in recs}, wall_secs=secs), \
        step_launches(rec["launches"])


def check_twin(tmp, v1, v2, extra):
    """(f): the check_db twin on phase 12's DBs and on a copy of v1 with
    one byte flipped -> its exit codes."""
    def run(db):
        proc = subprocess.run(
            [sys.executable, "-m", "gamesmanmpi_tpu_torch.db.check",
             str(db), "--quiet", *extra], cwd=REPO, capture_output=True,
            text=True, timeout=600)
        return proc.returncode, proc.stderr
    rcs = {}
    for name, db in (("v1", v1), ("v2", v2)):
        rcs[name], err = run(db)
        if rcs[name] != 0:
            raise AssertionError(f"check twin on {name}: {err[-2000:]}")
    bad = hardlink_copy(v1, tmp / "flipped.db")
    victim = max((p for p in bad.iterdir() if p.name.startswith("level")),
                 key=lambda p: p.stat().st_size)
    data = bytearray(victim.read_bytes())
    data[len(data) // 2] ^= 0xFF
    fresh = victim.with_name(victim.name + ".tmp")
    fresh.write_bytes(bytes(data))
    os.replace(fresh, victim)  # a new inode: v1's file is untouched
    rcs["flipped"], err = run(bad)
    if rcs["flipped"] != 1 or "PROBLEM:" not in err:
        raise AssertionError(f"check twin on a flipped byte: rc "
                             f"{rcs['flipped']} {err[-1000:]}")
    shutil.rmtree(bad)
    return rcs


def capacity_pipeline_phase(result, tmp, v1, v2, spec=C55,
                            answer=(69763700, "TIE", 25), extra=(),
                            window_block=1 << 20, store_mb=64, cutover=16,
                            resident=None):
    """Phase 18: the capacity and pipeline machinery. `result` is phase
    9's classic solve of `spec`, `v1`/`v2` phase 12's DBs, `resident`
    phase 14's one-process sharded fields; `extra` (`--device cpu`), a
    smaller board, block and cache rehearse the phase on the CPU. ->
    the level kernels' launches of its dense children."""
    t0 = time.perf_counter()
    extra = list(extra)
    pipe = pipeline_runs(result, tmp, spec, answer, extra)
    streamed = streaming_runs(result, tmp, spec, answer, extra,
                              window_block, store_mb)
    counts, count_launches = counts_file_children(tmp, spec, answer, extra)
    hybrid, hybrid_launches = hybrid_records_child(tmp, spec, answer, extra,
                                                   cutover)
    twin = check_twin(tmp, v1, v2, extra)
    emit("capacity and pipeline 5x5", spec=spec, pipeline=pipe,
         streaming=streamed,
         resident_peak_mem_bytes=(resident or {}).get("peak_mem_bytes"),
         counts_file=counts, hybrid=hybrid, check_twin_rc=twin,
         secs=time.perf_counter() - t0)
    return {"counts_file": count_launches, "hybrid_records": hybrid_launches}


@contextlib.contextmanager
def plain_reach_steps():
    """The reach sweep on the reach step's plain version (the backward's
    plain route is GAMESMAN_DENSE_GATHER=plain): a whole solve on the
    plain steps, for phase 19 (c)'s comparison."""
    from gamesmanmpi_tpu_torch.ops import dense_level

    kernel = dense_level.reach_step
    dense_level.reach_step = dense_level.reach_step_ref
    try:
        yield
    finally:
        dense_level.reach_step = kernel


def checked_solves(dev):
    """(a) Both kernels held against their plain versions on every launch
    of dense solves of 4x4 (one device, 2 and 3 shards) and 5x4, in
    blocks small enough for several blocks per level and ragged pad
    lanes; the reach counts are Tromp's; the shards' cells and nmiss are
    the one-device run's. -> {case: fields}, the 4x4 one-device solve."""
    import numpy as np

    from gamesmanmpi_tpu_torch.games import get_game
    from gamesmanmpi_tpu_torch.solve import dense

    out, base = {}, {}
    for spec, block, want, shards in (
            ("connect4:w=4,h=4", 1 << 14, 161029, (1, 2, 3)),
            ("connect4:w=5,h=4", 1 << 18, 3945711, (1,))):
        for devices in shards:
            tally = new_tally()
            dense._REACH_COUNTS.clear()  # so the reach sweep runs
            with env_set(GAMESMAN_FAKE_DEVICES=4), checked_step(tally):
                r = dense.DenseSolver(get_game(spec), device=dev,
                                      block_elems=block,
                                      devices=devices).solve()
            launches = step_launches(r.stats["kernel_launches"])
            if r.num_positions != want \
                    or tally["plain_reach"] != want - 1 \
                    or tally["plain_nmiss"] != r.stats["gather_nmiss"] \
                    or (dev.type == "cuda"
                        and tally["launches_checked"] != launches):
                raise AssertionError(f"checked {spec} devices={devices}: "
                                     f"{r.num_positions}, {tally}, "
                                     f"{launches}")
            b = base.setdefault(spec, r)
            if b.stats["gather_nmiss_per_level"] != r.stats[
                    "gather_nmiss_per_level"] or not all(
                    np.array_equal(b.cells[L], c) for L, c in
                    r.cells.items()):
                raise AssertionError(f"{spec} devices={devices} differs "
                                     "from the one-device run")
            out[f"{spec} devices={devices}"] = dict(
                launches=launches, shapes=len(tally["shapes"]),
                gather_nmiss=r.stats["gather_nmiss"],
                reach_count=tally["plain_reach"] + 1)
    dense._REACH_COUNTS.clear()
    return out, base["connect4:w=4,h=4"]


def wide_word_steps(dev, solved):
    """(a) The 64-bit instantiations (the words of 6x5 and of 6x6 and up)
    on every level of 4x4: each rank block of each level through both
    kernels and their plain versions, in-range lanes bit-identical and
    nmiss / the reach count equal (the reach over a seeded parent reach).
    -> launches checked per word set."""
    import dataclasses

    from gamesmanmpi_tpu_torch.ops import dense_level
    from gamesmanmpi_tpu_torch.solve import dense

    s = dense.DenseSolver(solved.game, device=dev, block_elems=1 << 14)
    t = s.tables
    gen = torch.Generator(device="cpu").manual_seed(19)
    out = {}
    for words in (dense_level.Words(64, 32, 32), dense_level.Words(64, 32, 64),
                  dense_level.Words(64, 64, 64)):
        n = 0
        for L in range(t.ncells + 1):
            geom = dataclasses.replace(dense_level.level_geom(t, L),
                                       words=words)
            cblock, nblk = s._cblock(L)
            for for_reach in ((False, True) if L else (False,)):
                consts = dict(s._level_tensors(L, for_reach),
                              kernel=dense_level.kernel_consts(
                                  t, L, for_reach, dev, words))
                if for_reach:
                    m = len(t.profiles[L - 1]) * t.class_size[L - 1]
                    src = torch.randint(0, 2, (m,), generator=gen).to(
                        torch.uint8).to(dev)
                    kern, ref = dense_level.reach_step, \
                        dense_level.reach_step_ref
                else:
                    src = (torch.from_numpy(solved.cells[L + 1]).reshape(-1)
                           if L < t.ncells
                           else torch.zeros(1, dtype=torch.uint8)).to(dev)
                    kern = dense_level.dense_step

                    def ref(*a):
                        return dense_level.dense_step_ref(*a, "window")
                for b in range(nblk):
                    args = (geom, b * cblock, cblock, src, consts, s._binom)
                    got, extra = kern(*args)
                    want, extra_ref = ref(*args)
                    same_step("reach_step" if for_reach else "dense_step",
                              geom, b * cblock, cblock, got, want, extra,
                              extra_ref)
                    n += 1
        out[f"bits{words.bits}_rank{words.rank}_flat{words.flat}"] = n
    return out


def timed_block(dev, rate, int_rate, dense_result, for_reach):
    """(b) At 5x5, the widest block of the backward (or the reach sweep):
    kernel and plain version timed in turns, the kernel's bound the
    larger of its bytes over the memory rate and its integer operations
    (ops/dense_level.step_work) over the INT32 issue rate."""
    from gamesmanmpi_tpu_torch.bench.kernel_cases import time_turns
    from gamesmanmpi_tpu_torch.games import get_game
    from gamesmanmpi_tpu_torch.ops import dense_level
    from gamesmanmpi_tpu_torch.solve import dense

    s = dense.DenseSolver(get_game(C55), device=dev)
    t = s.tables
    levels = range(1, t.ncells + 1) if for_reach else range(t.ncells)
    L = max(levels, key=lambda k: len(t.profiles[k]) * s._cblock(k)[0])
    width = s._cblock(L)[0]
    geom = dense_level.level_geom(t, L)
    consts = s._level_tensors(L, for_reach)
    if for_reach:
        _, src = s._sweep_levels(L - 1)  # the parent level's real reach
        kern, name = dense_level.reach_step, "reach_step"

        def plain():
            return dense_level.reach_step_ref(geom, 0, width, src, consts,
                                              s._binom)
        lanes, followed = dense_level.reach_followed(geom, 0, width, consts,
                                                     s._binom, src)
    else:
        src = torch.from_numpy(dense_result.cells[L + 1]).reshape(-1).to(dev)
        kern, name = dense_level.dense_step, "dense_step"

        def plain():
            return dense_level.dense_step_ref(geom, 0, width, src, consts,
                                              s._binom, "window")
        lanes, followed = dense_level.dense_followed(geom, 0, width, consts)

    def kernel():
        return kern(geom, 0, width, src, consts, s._binom)

    got, extra = kernel()
    want, extra_ref = plain()
    same_step(name, geom, 0, width, got, want, extra, extra_ref)
    del got, want
    times = time_turns({"kernel": kernel, "plain": plain}, rounds=3,
                       iters=2, warmup=1)
    P = consts["filled"].shape[0]
    nbytes, ops = dense_level.step_work(geom, P, width, src.shape[0], lanes,
                                        followed, for_reach)
    by_bytes, by_ops = nbytes / rate * 1e3, ops / int_rate * 1e3
    k = times["kernel"]
    bound = max(by_bytes, by_ops)
    return dict(level=L, rows=P, width=width, lanes=P * width,
                in_range_lanes=lanes, followed=followed, bound_bytes=nbytes,
                bound_ops=ops, bytes_ms=by_bytes, ops_ms=by_ops,
                ms=k["median_ms"], ms_min=k["min_ms"], ms_max=k["max_ms"],
                samples=k["samples"], plain_ms=times["plain"]["median_ms"],
                library_ms=None, bound_ms=bound,
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bound_share=bound / k["median_ms"], max_abs_err=0,
                extra=None if extra is None else int(extra))


def cli_in_turns(dense_result, spec=C55, answer=(69763700, "TIE", 25),
                 extra=()):
    """(c) The CLI's 5x5 dense solve on the kernels against the solve on
    the plain steps (GAMESMAN_DENSE_GATHER=plain, the reach sweep on its
    plain version), in turns kernel, plain, plain, kernel, each with the
    reach sweep run (the in-process counts cleared): every level of every
    run byte-identical to phase 6's cells, 69,763,700 / TIE / 25."""
    import numpy as np

    from gamesmanmpi_tpu_torch import kernels
    from gamesmanmpi_tpu_torch.solve import dense

    runs = []
    for mode in ("kernels", "plain", "plain", "kernels"):
        dense._REACH_COUNTS.clear()
        kernels.reset_launches()
        env = {} if mode == "kernels" else {"GAMESMAN_DENSE_GATHER": "plain"}
        with env_set(**env), (plain_reach_steps() if mode == "plain"
                              else contextlib.nullcontext()):
            r, report = cli_solve(["solve", spec, "--engine", "dense",
                                   *extra])
        launches = step_launches(kernels.LAUNCHES)
        on_card = "cpu" not in extra
        if report_answer(report) != answer \
                or (mode == "kernels" and on_card
                    and min(launches.values()) <= 0) \
                or (mode == "plain" and max(launches.values()) != 0):
            raise AssertionError(f"{spec} {mode}: {report}, {launches}")
        if sorted(r.cells) != sorted(dense_result.cells) or not all(
                np.array_equal(r.cells[L], c)
                for L, c in dense_result.cells.items()):
            raise AssertionError(f"{spec} {mode}: cells differ from "
                                 "phase 6's")
        s = r.stats
        runs.append(dict(mode=mode, secs_backward=s["secs_backward"],
                         secs_count_reachable=s["secs_count_reachable"],
                         peak_mem_bytes=s.get("peak_mem_bytes"),
                         launches=launches))
        del r
    dense._REACH_COUNTS.clear()
    return runs


def dense_level_phase(dev, rate, int_rate, dense_result, spec=C55,
                      answer=(69763700, "TIE", 25), extra=()):
    """Phase 19: the dense level kernels. `dense_result` is phase 6's
    solve of `spec`; on the CPU (`extra` = `--device cpu`, a smaller
    `spec`) the wrappers take their plain versions and (b) is left out.
    -> the rows of (b)."""
    t0 = time.perf_counter()
    checked, solved = checked_solves(dev)
    words = wide_word_steps(dev, solved)
    emit("dense level kernels (a)", checked=checked, wide_words=words,
         secs=time.perf_counter() - t0)
    rows = {}
    if dev.type == "cuda":
        for name, reach in (("dense_step", False), ("reach_step", True)):
            rows[name] = timed_block(dev, rate, int_rate, dense_result,
                                     reach)
            emit(f"dense level kernels (b) {name}", int32_ops_per_sec=int_rate,
                 hbm_bytes_per_sec=rate, **rows[name])
    runs = cli_in_turns(dense_result, spec, answer, extra)
    emit("dense level kernels (c)", runs=runs, levels_identical=len(
        dense_result.cells), secs=time.perf_counter() - t0)
    return rows


def main() -> int:
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    # No dense counts file outside phase 18 (d), which names its own: a
    # file in the checkout would let later dense solves skip their reach
    # sweep and change their seconds from one run of the script to the
    # next.
    os.environ["GAMESMAN_DENSE_COUNTS_FILE"] = "0"
    from gamesmanmpi_tpu_torch.bench.kernel_cases import (
        hbm_bytes_per_sec,
        int32_ops_per_sec,
        nvidia_smi_line,
    )
    from gamesmanmpi_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    rate = hbm_bytes_per_sec(name)
    int_rate = int32_ops_per_sec()
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
        sharded_one = sharded_phase(classic_result, tmp)
        path_launches = reshard_hybrid_phase(
            classic_result, dense_result, tmp, v1,
            world_table=tmp / "sharded_one.npz")
        spec_instrumentation_phase(classic_result, dense_result, tmp)
        campaign_launches = campaign_registry_phase(
            classic_result, dense_result, tmp, v1)
        capacity_launches = capacity_pipeline_phase(
            classic_result, tmp, v1, v2, resident=sharded_one)
        del classic_result
        checkpoint_dense_phase(dense_result, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steps = dense_level_phase(dev, rate, int_rate, dense_result)

    def row(name, source, replaces, launches, m, by_path=None):
        r = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": m["max_abs_err"], "ms": m["ms"],
             "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
             "bound_by": m.get("bound_by", "bytes"),
             "library_ms": m["library_ms"],
             "bound_share": m["bound_share"]}
        if by_path:
            r["launches_by_path"] = by_path
        if "shapes" in m:
            r["shapes"] = [{k: s[k] for k in (
                "shape", "n", "m", "ms", "plain_ms", "library_ms",
                "bound_ms", "bound_share")} for s in m["shapes"]]
        return r

    # Each level kernel's launches per dense path (the kernels line).
    paths = dict(dense=step_launches(dense_launches), **path_launches,
                 campaign_dense=campaign_launches, **capacity_launches)

    emit("total", secs=time.perf_counter() - t_script)
    print(json.dumps({"kernels": [
        # Launches on the path that runs each kernel: the microbench for
        # the window gather (times at the dense level-18 shape, then every
        # shape) and the doubling; for the level kernels the dense 5x5
        # solve, the dense campaign's resumed attempt and the two
        # counts-file dense children, with every dense path's count
        # beside (times at the widest 5x5 block, phase 19 (b)).
        row("monotone_window_gather",
            "gamesmanmpi_tpu_torch/kernels/csrc/window_gather.cu",
            "gamesmanmpi_tpu/ops/pallas_gather.py:116",
            bench_launches["monotone_window_gather"], k),
        row("double_u32",
            "gamesmanmpi_tpu_torch/kernels/csrc/double_u32.cu",
            "tools/microbench2.py:210",
            bench_launches["double_u32"], d),
        *(row(kname, "gamesmanmpi_tpu_torch/kernels/csrc/dense_level.cu",
              STEP_KERNELS[kname],
              sum(paths[p][kname] for p in ("dense", "campaign_dense",
                                            "counts_file")),
              steps[kname], {p: v[kname] for p, v in paths.items()})
          for kname in STEP_KERNELS),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
