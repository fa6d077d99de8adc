"""The port's benchmark: one run of one cell.

    python3 h100bench/run.py --workload CELL --seed N --seconds S --trace 0|1

Everything is found by name, as files of their own:

- the cell:      h100bench/workloads/<cell>.json    (config, traffic, params)
- its config:    h100bench/configs/<config>.json    (board, engine, deployment:
                  the engine's class, its keyword arguments, and the
                  environment the program runs in)
- its traffic:   h100bench/traffic/<traffic>.json   ("kind" picks the driver)
- each metric:   h100bench/metrics/<metric>.py      (read(ctx) -> number|None)

and BENCHMARK.json says which metrics each cell reports. A run loads the
program (gamesmanmpi_tpu_torch), sets up and warms up what the cell
uses, measures for --seconds, then judges what the timed path produced
against the plain reference (reference.py) and prints one JSON line last
on stdout: end-to-end metrics with --trace 0, per-layer metrics with
--trace 1 (the window under torch.profiler). The numbers compared, each
beside its limit, are the last lines of stderr and the result's last key.

Exits 2 without enough CUDA devices, 3 when a JAX module was loaded, and
1 on any other failure; a failed run prints no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
sys.path[:0] = [str(HERE), str(ROOT)]

#: Top-level module names that must not be loaded: JAX and the JAX
#: package the program was ported from (compared whole, so the port's
#: own gamesmanmpi_tpu_torch passes).
FORBIDDEN = ("jax", "jaxlib", "flax", "gamesmanmpi_tpu")


class CellError(RuntimeError):
    pass


def process_age() -> float:
    """Seconds since this process started (/proc)."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# -- the registry: everything by name -------------------------------------------


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def resolve(root: Path, cell_name: str) -> dict:
    """The cell's entry in BENCHMARK.json, its files, and the metrics it
    reports: {"entry", "cell", "config", "mix", "end_to_end",
    "per_layer", "readers"}."""
    bench_dir = root / "h100bench"
    spec = load_json(root / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == cell_name),
                 None)
    if entry is None:
        raise CellError(f"no cell {cell_name!r} in BENCHMARK.json")
    cell = load_json(bench_dir / "workloads" / f"{cell_name}.json")
    for key in ("config", "traffic"):
        if cell[key] != entry[key]:
            raise CellError(f"{cell_name}: {key} {cell[key]!r} in its file, "
                            f"{entry[key]!r} in BENCHMARK.json")
    config = load_json(bench_dir / "configs" / f"{entry['config']}.json")
    mix = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in spec["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (cell_name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    readers = {m["name"]: bench_dir / "metrics" / f"{m['name']}.py"
               for m in per_layer}
    for name, path in readers.items():
        if not path.exists():
            raise CellError(f"metric {name}: no reader {path}")
    return {"entry": entry, "cell": cell, "config": config, "mix": mix,
            "end_to_end": e2e, "per_layer": per_layer, "readers": readers,
            "cache": bench_dir / ".cache"}


def load_reader(path: Path):
    spec = importlib.util.spec_from_file_location(
        "metric_" + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- the device -------------------------------------------------------------------


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def smi_used_bytes() -> int:
    """The card's used memory, all processes (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,"
         "nounits", "-i", "0"], capture_output=True, text=True, timeout=60)
    return int(out.stdout.split()[0]) << 20


def smi_power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=60)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def free_device(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# -- solve cells ------------------------------------------------------------------


def import_program():
    """The program, from this checkout and nowhere else."""
    import gamesmanmpi_tpu_torch

    where = Path(gamesmanmpi_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        raise CellError(f"the program was imported from {where}, not from "
                        f"this checkout ({ROOT})")


def program_attr(path: str):
    """"module:name" of the program (gamesmanmpi_tpu_torch, and nothing
    else) -> that object."""
    module, _, name = path.partition(":")
    if module.split(".", 1)[0] != "gamesmanmpi_tpu_torch" or not name:
        raise CellError(f"{path!r}: a config names gamesmanmpi_tpu_torch's "
                        "own objects, as 'module:name'")
    obj = importlib.import_module(module)
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def build(value, cache: Path):
    """A config's value as the program takes it: {"call": "module:name",
    "args": [...], "kwargs": {...}} is what that call returns (such as a
    checkpointer), "{cache}" in a string is the cell's cache directory,
    and lists and other objects are built item by item."""
    if isinstance(value, dict):
        if "call" in value:
            return program_attr(value["call"])(
                *build(value.get("args", []), cache),
                **build(value.get("kwargs", {}), cache))
        return {k: build(v, cache) for k, v in value.items()}
    if isinstance(value, list):
        return [build(v, cache) for v in value]
    if isinstance(value, str):
        return value.replace("{cache}", str(cache))
    return value


def _solver_factory(config: dict, device, cache: Path):
    """The config's engine, built as it says: its class ("solver":
    {"call": "module:Class", "kwargs": {...}}) on the config's game and
    the run's device, a new object (and new keyword objects) per solve."""
    from gamesmanmpi_tpu_torch.games import get_game

    game = get_game(config["game"])
    spec = config["solver"]
    cls = program_attr(spec["call"])
    return lambda: cls(game, device=device,
                       **build(spec.get("kwargs", {}), cache))


def drive_solves(r: dict, args, device) -> dict:
    """Back-to-back solves of one board, one at a time (closed loop)."""
    import numpy as np
    import torch

    import devtrace
    import reference
    import work

    config, mix = r["config"], r["mix"]
    make = _solver_factory(config, device, r["cache"])
    for _ in range(int(mix["warmup_solves"])):
        make().solve()
        sync(device)
    free_device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    rng = np.random.default_rng(args.seed % 2 ** 63)
    tracer = (devtrace.DeviceTrace(str(r["cache"] / "trace")) if args.trace
              else None)
    walls, stats, peak, kept = [], [], 0, None
    setup_s = process_age()
    if tracer:
        tracer.start()
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        res = make().solve()
        sync(device)
        te = time.perf_counter()
        walls.append(te - ts)
        stats.append(dict(res.stats))
        if cuda:
            peak = max(peak, torch.cuda.max_memory_allocated(device))
        # One solve of the window, drawn uniformly by the seed, is judged.
        if rng.random() * len(walls) < 1.0:
            kept = res
        del res
        if te - t0 >= args.seconds:
            break
    window_s = time.perf_counter() - t0
    trace = None
    if tracer:
        tracer.stop()
        trace = tracer.summary()
    n = len(walls)
    q = sorted(walls)
    # A drift of the solve time inside the window shows in the median of
    # each fifth of it.
    fifths = [statistics.median(walls[i * n // 5:(i + 1) * n // 5] or walls)
              for i in range(5)]
    print(f"solves: {n} in {window_s:.6f} s; each min {q[0]:.6f}, p10 "
          f"{q[n // 10]:.6f}, median {q[n // 2]:.6f}, p90 "
          f"{q[9 * n // 10]:.6f}, max {q[-1]:.6f} s; median by fifth of "
          f"the window {[round(v, 6) for v in fifths]} s; judged: one "
          "drawn by the seed", file=sys.stderr, flush=True)

    # The program's device state is gone; the reference runs now.
    free_device(device)
    w, h, connect = reference.parse_connect4(config["game"])
    board = reference.Board(w, h, connect, device=device)
    t_ref = time.perf_counter()
    sol = board.solve()
    mism = reference.check_solve(board, sol, getattr(kept, "cells", None),
                                 getattr(kept, "levels", None), device)
    print(f"reference: {time.perf_counter() - t_ref:.3f} s, "
          f"{sol.positions} positions, root {sol.value}/{sol.remoteness}",
          file=sys.stderr, flush=True)
    ops, nbytes = work.least_work(sol.reachable, sol.moves, connect)
    checks = {
        "position_mismatches": (mism, 0),
        "root_mismatch": (int((kept.value, kept.remoteness)
                              != (sol.value, sol.remoteness)), 0),
        "positions_diff": (abs(kept.num_positions - sol.positions), 0),
    }
    return {
        "e2e": {"setup_s": setup_s,
                "solve_ms": 1e3 * window_s / n,
                "solve_peak_mem_gib": peak / 2 ** 30},
        "memory_peak_bytes": peak,
        "attempted": n,
        "failed": 0,
        "checks": checks,
        "trace": trace,
        "ctx": {"solves": n, "positions": sol.positions,
                "window_s": window_s, "walls": walls,
                "stats": stats, "work": (ops, nbytes), "trace": trace,
                "config": config},
    }


# -- query cells ------------------------------------------------------------------


def ensure_db(config: dict, device_arg: list, cache: Path) -> Path:
    """The cell's DB, exported by the program's CLI into a fixed, ignored
    directory on the checkout's first run and reused by later runs."""
    out = cache / "db" / config["name"]
    if (out / "manifest.json").exists():
        return out
    tmp = out.with_name(out.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(out, ignore_errors=True)
    tmp.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gamesmanmpi_tpu_torch", "export-db",
         config["game"], "--out", str(tmp), *config.get("export_args", []),
         *device_arg], cwd=ROOT, capture_output=True, text=True,
        timeout=1100)
    if proc.returncode != 0:
        raise CellError(f"export-db exited {proc.returncode}: "
                        f"{proc.stderr[-3000:]}")
    tmp.rename(out)
    print(f"export-db: {time.perf_counter() - t0:.3f} s into {out}",
          file=sys.stderr, flush=True)
    return out


#: The program's serving CLI, as the fleet's command (before its
#: arguments). The tests put a wrapper here that plants faults.
SERVE = [sys.executable, "-m", "gamesmanmpi_tpu_torch", "serve"]


class Fleet:
    """`serve DB --workers N` (the program's CLI, SERVE) as a child in
    its own session; stopped with SIGTERM, its group killed if need be."""

    def __init__(self, db: Path, config: dict, device_arg, cache: Path):
        self.log_path = cache / "fleet.log"
        self.log = open(self.log_path, "w")
        argv = [*SERVE, str(db),
                "--workers", str(config["workers"]), "--port", "0",
                "--control-port", "0", *config.get("serve_args", []),
                *device_arg]
        self.proc = subprocess.Popen(
            argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=self.log,
            text=True, start_new_session=True)
        banner = self.proc.stdout.readline()
        ports = re.findall(r"127\.0\.0\.1:(\d+)", banner)
        if len(ports) < 2:
            self.stop()
            raise CellError(f"fleet banner {banner!r}: {self.tail()}")
        self.port, self.control = int(ports[0]), int(ports[1])
        self.workers = int(config["workers"])
        deadline = time.monotonic() + 600
        restarts = 0
        while True:
            try:
                st = http_json(self.control, "/healthz")
                if st.get("ready") == self.workers:
                    break
                restarts = sum(w.get("restarts", 0)
                               for w in st.get("workers", {}).values())
            except OSError:
                pass
            if (self.proc.poll() is not None or restarts > 2
                    or time.monotonic() > deadline):
                self.stop()
                raise CellError(f"fleet never ready: {self.tail()}")
            time.sleep(0.1)

    def tail(self) -> str:
        self.log.flush()
        return self.log_path.read_text()[-3000:]

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                pass
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        rc = self.proc.wait()
        self.proc.stdout.close()
        self.log.close()
        return rc


def http_json(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return json.loads(resp.read())


_SAMPLE = re.compile(r'^(\w+)\{([^}]*)\} (\S+)$', re.M)


def scrape(port: int, workers: int) -> dict:
    """{worker: {series: value}} of every worker's /metrics (the workers
    share one socket, so the fleet port is asked until each has answered)."""
    seen: dict = {}
    for _ in range(64 * workers):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as resp:
            text = resp.read().decode()
        series: dict = {}
        worker = None
        for name, labels, value in _SAMPLE.findall(text):
            lab = dict(re.findall(r'(\w+)="([^"]*)"', labels))
            worker = lab.get("worker", worker)
            if name.endswith(("_sum", "_count")):
                series[name] = series.get(name, 0.0) + float(value)
        if worker is not None:
            seen[worker] = series
        if len(seen) >= workers:
            break
    return seen


def drive_queries(r: dict, args, device) -> dict:
    """Open-loop POST /query traffic to a fleet serving the cell's DB."""
    import numpy as np

    import loadgen
    import reference

    config, mix, cell = r["config"], r["mix"], r["cell"]
    if args.trace:
        # The card's work happens in the fleet's worker processes, which
        # this process cannot profile, and torch.profiler started inside
        # a forked worker recorded no device activity on the card.
        raise CellError("a query cell has no traced run yet")
    device_arg = [] if device.type == "cuda" else ["--device", "cpu"]
    db = ensure_db(config, device_arg, r["cache"])
    w, h, connect = reference.parse_connect4(config["game"])
    cpu_board = reference.Board(w, h, connect)
    if mix["arrivals"] != "poisson":
        raise CellError(f"arrivals {mix['arrivals']!r}: the generator knows "
                        "'poisson'")
    seed = args.seed % 2 ** 63
    pool = loadgen.playout_pool(cpu_board, int(mix["pool"]), seed)
    rng = np.random.default_rng(seed + 1)
    rates = args.rates or [float(cell["rate_qps"])]
    fleet = Fleet(db, config, device_arg, r["cache"])
    try:
        due, batches = loadgen.requests(pool, mix, rates[0],
                                        float(mix["warmup_seconds"]), rng)
        warm = loadgen.run_open_loop("127.0.0.1", fleet.port, due, batches)
        if args.rates:
            for rate in rates:
                due, batches = loadgen.requests(pool, mix, rate,
                                                args.seconds, rng)
                print(json.dumps(sweep_point(rate, due, loadgen.run_open_loop(
                    "127.0.0.1", fleet.port, due, batches))), flush=True)
            return {"sweep": True}
        before = scrape(fleet.port, fleet.workers)
        mem = [smi_used_bytes()] if device.type == "cuda" else [0]
        due, batches = loadgen.requests(pool, mix, rates[0], args.seconds,
                                        rng)
        setup_s = process_age()
        rec = loadgen.run_open_loop("127.0.0.1", fleet.port, due, batches)
        after = scrape(fleet.port, fleet.workers)
        if device.type == "cuda":
            mem.append(smi_used_bytes())
        health = http_json(fleet.control, "/healthz")
        restarts = sum(wk.get("restarts", 0)
                       for wk in health["workers"].values())
    finally:
        rc = fleet.stop()
    print(f"fleet: exit {rc} on SIGTERM; worker restarts {restarts}",
          file=sys.stderr, flush=True)
    print(f"generator: {rec['requests']} requests due in "
          f"{rec['window_s']:.6f} s; sent late by p99 "
          f"{rec['send_lag_p99_ms']:.3f} ms, at most "
          f"{rec['send_lag_max_ms']:.3f} ms; ok {rec['ok']}, errors "
          f"{rec['errors']}, shed {rec['shed']}, dropped {rec['dropped']}, "
          f"never answered {rec['never']}", file=sys.stderr, flush=True)
    print("timeline: p95 ms by eighth of the window "
          f"{[round(v, 3) for v in loadgen.tail_by_part(due, rec, 8)]}",
          file=sys.stderr, flush=True)
    p95 = loadgen.percentile(rec["latencies"], 0.95) * 1e3
    if math.isinf(p95):
        print("query_p95_ms: more than 5% of requests failed; reported as "
              "1e9 ms", file=sys.stderr)
        p95 = 1e9

    free_device(device)
    board = reference.Board(w, h, connect, device=device)
    t_ref = time.perf_counter()
    sol = board.solve()
    answers = rec["answers"]
    wrong_echo = sum(res.get("position") != hex(pos) for pos, res in answers)
    wrong = reference.check_answers(
        board, sol, [p for p, _ in answers],
        [res.get("value") for _, res in answers],
        [res.get("remoteness") for _, res in answers],
        [None if res.get("best") is None else int(res["best"], 16)
         for _, res in answers]) if answers else 0
    print(f"reference: {time.perf_counter() - t_ref:.3f} s; judged "
          f"{len(answers)} answers", file=sys.stderr, flush=True)
    checks = {
        "answer_mismatches": (wrong + wrong_echo, 0),
        "failed_requests": (rec["failed"], 0),
        "warmup_failed_requests": (warm["failed"], 0),
        "worker_restarts": (restarts, 0),
        "fleet_exit_code": (abs(rc), 0),
    }
    return {
        "e2e": {"setup_s": setup_s, "query_p95_ms": p95},
        "memory_peak_bytes": max(mem),
        "attempted": rec["requests"],
        "failed": rec["failed"],
        "checks": checks,
        "trace": None,
        "ctx": {"scrape": (before, after), "window_s": rec["window_s"],
                "config": config},
    }


def sweep_point(rate: float, due, rec: dict) -> dict:
    """One rate of the knee sweep: the tail in each third of the window
    (a tail that grows third by third is a growing backlog)."""
    import loadgen

    return {"rate_qps": rate, "requests": rec["requests"],
            "failed": rec["failed"],
            "p50_ms": 1e3 * loadgen.percentile(rec["latencies"], 0.5),
            "p95_ms": 1e3 * loadgen.percentile(rec["latencies"], 0.95),
            "p99_ms": 1e3 * loadgen.percentile(rec["latencies"], 0.99),
            "p50_ms_by_third": loadgen.tail_by_part(due, rec, 3, 0.5),
            "p95_ms_by_third": loadgen.tail_by_part(due, rec, 3),
            "send_lag_p99_ms": rec["send_lag_p99_ms"]}


DRIVERS = {"solve_loop": drive_solves, "http_query": drive_queries}


# -- the run ------------------------------------------------------------------


def run_cell(args, device_name: str = "cuda", root: Path = ROOT) -> dict:
    """One run of a cell on `device_name` -> the result line's object (or
    {"sweep": True} for a knee sweep). The tests call it with "cpu"."""
    import torch

    r = resolve(root, args.workload)
    r["cache"].mkdir(exist_ok=True)
    with config_env(r["config"].get("env", {})):
        import_program()
        device = torch.device(device_name)
        out = DRIVERS[r["mix"]["kind"]](r, args, device)
    if out.get("sweep"):
        return out
    checks = out["checks"]
    correct = all(v <= lim for v, lim in checks.values())
    if args.trace:
        ctx = dict(out["ctx"], notes=[],
                   card=smi_power_limit() if device.type == "cuda" else "cpu")
        metrics = {}
        for m in r["per_layer"]:
            v = load_reader(r["readers"][m["name"]])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        for note in ctx["notes"]:
            print(note, file=sys.stderr)
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]} for m in r["end_to_end"]}
    cuda = device.type == "cuda"
    result = {
        "correct": correct,
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": int(r["entry"]["chips"]),
            "memory_peak_bytes": int(out["memory_peak_bytes"]),
        },
    }
    trace = out["trace"]
    if args.trace and trace is not None:
        import devtrace

        result["device"]["busy_s"] = trace["busy_s"]
        result["device"]["window_s"] = trace["window_s"]
        result["breakdown"] = {"device_ops": devtrace.top(trace["by_name"]),
                               "idle_gaps": devtrace.top(trace["gaps"])}
        print(f"trace: {trace['events']} device events; copies by kind "
              f"{json.dumps(trace['copies'])}", file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


@contextlib.contextmanager
def config_env(env: dict):
    """The environment a config runs the program in (such as
    GAMESMAN_PIPELINE), set for the run and put back after it; the
    fleet's processes inherit it."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rates", default=None,
                    help="query cells: the knee sweep, comma-separated "
                    "rates, one window each on one fleet; prints one line "
                    "per rate and no result")
    args = ap.parse_args(argv)
    if args.rates:
        args.rates = [float(x) for x in args.rates.split(",")]
    return args


def configure_env() -> None:
    """Caches at fixed places inside the checkout; the reach counts
    swept in each process (set-up) rather than read from a file another
    run left."""
    os.environ["GAMESMAN_DENSE_COUNTS_FILE"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def _terminated(signum, frame):
    raise SystemExit(128 + signum)


def main(argv=None) -> int:
    # A run ended from outside still stops the processes it started.
    signal.signal(signal.SIGTERM, _terminated)
    args = parse_args(argv)
    configure_env()
    import torch

    chips = int(resolve(ROOT, args.workload)["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: {chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    print(f"card: {smi_power_limit()}", file=sys.stderr, flush=True)
    result = run_cell(args)
    bad = forbidden_modules()
    if bad:
        print(f"run: loaded {bad}: nothing run here may import JAX or the "
              "JAX package", file=sys.stderr)
        return 3
    if result.get("sweep"):
        return 0
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CellError as e:
        print(f"run: {e}", file=sys.stderr)
        sys.exit(1)
