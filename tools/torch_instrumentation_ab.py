"""What the solve's instrumentation costs: the same CLI solve in child
processes, with and without the instrumentation flags, in turns.

    python tools/torch_instrumentation_ab.py [--game connect4:w=5,h=5]
        [--engine classic] [--rounds 2] [--device cuda] [--out FILE]

Variants, each a fresh `python -m gamesmanmpi_tpu_torch solve` child (so
each pays its own CUDA bring-up, as a user's solve does):

* ``plain``   — no instrumentation flag;
* ``jsonl``   — ``--jsonl`` only (the per-level records);
* ``all``     — ``--jsonl --trace-events --metrics-out --heartbeat-secs
  0.5 --status-port 0``, nobody reading ``/status``;
* ``scraped`` — ``all``, with this process fetching ``/status`` every
  50 ms while the child runs (what chip_smoke.py phase 16 does).

Each round runs the variants forwards, the next backwards, so drift
across the call does not favour one. One JSON line per run (the solve's
forward and backward seconds and its positions/s from the child's stats),
then one per variant with the medians, then the `nvidia-smi`
name/power-limit line; everything also in --out.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

#: The CLI in a child: its report, then the solve's stats as the last
#: line.
CHILD = """
import json, sys
from gamesmanmpi_tpu_torch.cli import solve_main
rc, result = solve_main(sys.argv[1:])
if result is not None:
    print(json.dumps(result.stats, default=str), flush=True)
sys.exit(rc)
"""

VARIANTS = ("plain", "jsonl", "all", "scraped")


def run_variant(variant: str, argv: list, tmp: pathlib.Path, tag: str):
    from gamesmanmpi_tpu_torch.obs.status import fetch_status

    d = tmp / tag
    d.mkdir()
    extra = []
    if variant != "plain":
        extra += ["--jsonl", str(d / "r.jsonl")]
    if variant in ("all", "scraped"):
        extra += ["--trace-events", str(d / "t.json"), "--metrics-out",
                  str(d / "m.json"), "--heartbeat-secs", "0.5",
                  "--status-port", "0"]
    addr = d / "addr"
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD, *argv, *extra], cwd=REPO,
        env=dict(os.environ, GAMESMAN_STATUS_ADDR_FILE=str(addr)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    scrapes = 0
    try:
        while variant == "scraped" and proc.poll() is None:
            if addr.exists() and fetch_status(addr.read_text(),
                                              timeout=2) is not None:
                scrapes += 1
            time.sleep(0.05)
        out, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise SystemExit(f"{variant} child exited {proc.returncode}:\n"
                         f"{err[-3000:]}")
    s = json.loads(out.splitlines()[-1])
    return {"variant": variant, "wall_secs": time.perf_counter() - t0,
            "secs_forward": s["secs_forward"],
            "secs_backward": s["secs_backward"],
            "positions_per_sec": s["positions_per_sec"],
            "peak_mem_bytes": s.get("peak_mem_bytes"), "scrapes": scrapes}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--game", default="connect4:w=5,h=5")
    p.add_argument("--engine", default="classic",
                   choices=("classic", "dense"))
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from gamesmanmpi_tpu_torch.bench.kernel_cases import nvidia_smi_line

    solve = ["solve", args.game, "--engine", args.engine, "--device",
             args.device]
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="instr_ab_"))
    lines, runs = [], []
    try:
        for r in range(args.rounds):
            order = VARIANTS if r % 2 == 0 else VARIANTS[::-1]
            for v in order:
                rec = dict(run_variant(v, solve, tmp, f"{r}_{v}"), round=r,
                           game=args.game, engine=args.engine)
                runs.append(rec)
                lines.append(json.dumps(rec))
                print(lines[-1], flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for v in VARIANTS:
        mine = [x for x in runs if x["variant"] == v]
        lines.append(json.dumps({
            "variant": v, "game": args.game, "engine": args.engine,
            "runs": len(mine), **{
                f"median_{k}": statistics.median(x[k] for x in mine)
                for k in ("secs_forward", "secs_backward", "wall_secs")}}))
        print(lines[-1], flush=True)
    smi = nvidia_smi_line() if args.device == "cuda" else "cpu"
    lines.append(smi)
    print(smi, flush=True)
    if args.out:
        pathlib.Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
