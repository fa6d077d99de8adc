"""Time one source tree's CUDA kernels on one card: the window gather and
the doubling in turns with their PyTorch calls, the dense level kernels
at the widest 5x5 levels.

    python tools/torch_kernel_ab.py [--tree DIR] [--label NAME] [--rounds 5]
                                    [--levels-only] [--out FILE]

`--tree` is the root of a checkout of this repository (default: this
one). Its `gamesmanmpi_tpu_torch` is the one imported, so its kernels are
built from its own sources into its own `build/torch_ext/`. The inputs,
byte bounds and timing come from this file's checkout
(`bench/kernel_cases.py`, loaded by path), so two trees are measured
alike. To compare two commits on one card, unpack the older one with
`git archive` into a directory that .gitignore lists and run, in one
command, base, change, change, base; then compare the medians across the
runs, and each run's kernel against the library call it was timed with.

The level kernels (`dense_step`, `reach_step`) run through whichever API
the tree has: one launch per level over a `LaunchMap` (since the fused
walk), or one launch per rank block (before it, all of the level's blocks
timed together). Both take the widest 5x5 backward level (over the
solve's own child cells) and the widest reach level (over the sweep's
parent reach), so two trees do the same work; each level is first held
bit-identical to the tree's plain block steps on its in-range lanes.
Their bound is the tree's own `step_work` where it has the revised count
(`dense_level.Work`), else null. `--levels-only` skips the gather and
the doubling.

Needs an NVIDIA card; exits 1 without one. Each kernel is first held
bit-identical to the tree's plain version (and the gather's `nmiss`
equal). One JSON line per kernel and shape on stdout, then the
`nvidia-smi` name/power-limit line; everything also in --out.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]


def _kernel_cases():
    """This checkout's bench/kernel_cases.py, whatever tree is imported."""
    path = REPO / "gamesmanmpi_tpu_torch" / "bench" / "kernel_cases.py"
    spec = importlib.util.spec_from_file_location("_ab_kernel_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _signed(t: torch.Tensor) -> torch.Tensor:
    """Same-size signed view: torch's CUDA index and compare kernels do
    not cover every unsigned dtype."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _record(kernel, times, bound_ms, **fields):
    k, lib = times["kernel"]["median_ms"], times["library"]["median_ms"]
    return {"kernel": kernel, **fields, "ms": k,
            "ms_min": times["kernel"]["min_ms"],
            "ms_max": times["kernel"]["max_ms"], "library_ms": lib,
            "bound_ms": bound_ms, "bound_share": bound_ms / k,
            "kernel_over_library": k / lib}


def _level_launch(dense_level, s, L, for_reach, src):
    """(run, result) closures of level L's kernel work in the tree's API:
    run() launches, result() gives the [P, C] level array."""
    t = s.tables
    geom = dense_level.level_geom(t, L)
    P, C = len(t.profiles[L]), t.class_size[L]
    cblock, nblk = s._cblock(L)
    step = dense_level.reach_step if for_reach else dense_level.dense_step
    if hasattr(dense_level, "LaunchMap"):
        lmap = dense_level.LaunchMap(P, C, cblock, nblk)
        consts = s._kernel_consts(L, for_reach, src.device)
        out = torch.empty((P, C), dtype=torch.uint8, device=src.device)

        def run():
            return step(geom, lmap, src, consts, None, out)

        def result():
            run()
            return out
    else:
        consts = s._level_tensors(L, for_reach)

        def run():
            return [step(geom, b * cblock, cblock, src, consts, s._binom)
                    for b in range(nblk)]

        def result():
            return torch.cat([o for o, _ in run()], dim=1)[:, :C]
    return run, result


def measure_levels(dev, kc, rounds):
    """Yield one record per level kernel of the imported tree: the widest
    5x5 backward and reach levels."""
    from gamesmanmpi_tpu_torch.games import get_game
    from gamesmanmpi_tpu_torch.ops import dense_level
    from gamesmanmpi_tpu_torch.solve import dense

    game = get_game("connect4:w=5,h=5")
    solved = dense.DenseSolver(game, device=dev).solve()
    s = dense.DenseSolver(game, device=dev)
    t = s.tables
    rate = kc.hbm_bytes_per_sec(torch.cuda.get_device_name(dev))
    int_rate = kc.int32_ops_per_sec()
    for name, for_reach in (("dense_step", False), ("reach_step", True)):
        levels = range(1, t.ncells + 1) if for_reach else range(t.ncells)
        L = max(levels, key=lambda k: len(t.profiles[k]) * s._cblock(k)[0])
        if for_reach:
            _, src = s._sweep_levels(L - 1)
        else:
            src = torch.from_numpy(solved.cells[L + 1]).reshape(-1).to(dev)
        run, result = _level_launch(dense_level, s, L, for_reach, src)
        got = result()
        P, C = got.shape
        cblock, nblk = s._cblock(L)
        eager = {k: v for k, v in s._level_tensors(L, for_reach).items()
                 if k != "kernel"}
        want = []
        for b in range(nblk):
            args = (dense_level.level_geom(t, L), b * cblock, cblock, src,
                    eager, s._binom)
            want.append(dense_level.reach_step_ref(*args)[0] if for_reach
                        else dense_level.dense_step_ref(*args, "window")[0])
        if not torch.equal(got, torch.cat(want, dim=1)[:, :C]):
            raise AssertionError(f"{name} at level {L} differs from the "
                                 "tree's plain version")
        del got, want
        times = kc.time_turns({"kernel": run}, rounds, iters=2, warmup=1)
        bound_ms = None
        if hasattr(dense_level, "Work"):
            lmap = dense_level.LaunchMap(P, C, cblock, nblk)
            work = (dense_level.reach_followed(
                dense_level.level_geom(t, L), lmap, eager, s._binom, src)
                if for_reach else dense_level.dense_followed(
                    dense_level.level_geom(t, L), lmap, eager))
            nbytes, ops = dense_level.step_work(
                dense_level.level_geom(t, L), src.shape[0], work,
                s._kernel_consts(L, for_reach, dev)["pack"].numel() * 4)
            bound_ms = max(nbytes / rate, ops / int_rate) * 1e3
        k = times["kernel"]
        yield {"kernel": name, "level": L, "rows": P, "size": C,
               "blocks": nblk, "ms": k["median_ms"], "ms_min": k["min_ms"],
               "ms_max": k["max_ms"], "samples": k["samples"],
               "bound_ms": bound_ms,
               "bound_share": bound_ms / k["median_ms"] if bound_ms
               else None}


def measure(dev, kc, rounds):
    """Yield one record per kernel and shape of the imported tree."""
    from gamesmanmpi_tpu_torch.ops import elementwise, window_gather

    rate = kc.hbm_bytes_per_sec(torch.cuda.get_device_name(dev))
    n = 32 << 20
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randint(0, 1 << 32, (n,), generator=g, device=dev,
                      dtype=torch.int64).to(torch.int32).view(torch.uint32)
    if not torch.equal(elementwise.double_u32(x).view(torch.int32),
                       elementwise.double_u32_ref(x).view(torch.int32)):
        raise AssertionError("double_u32 differs from its plain version")
    times = kc.time_turns({"kernel": lambda: elementwise.double_u32(x),
                           "library": lambda: x.view(torch.int32) * 2},
                          rounds)
    yield _record("double_u32", times,
                  kc.double_bound_bytes(n) / rate * 1e3, n=n)
    del x

    for label, table, idx in kc.gather_shapes(dev):
        ref, nref = window_gather.monotone_window_gather_ref(table, idx)
        out, nm = window_gather.monotone_window_gather(table, idx)
        if not torch.equal(_signed(out), _signed(ref)) or int(nm) != int(nref):
            raise AssertionError(f"gather at {label} differs from its plain "
                                 "version")
        del out, ref
        st = _signed(table)
        times = kc.time_turns({
            "kernel": lambda: window_gather.monotone_window_gather(table, idx),
            "library": lambda: st[idx]}, rounds)
        nbytes = kc.gather_bound_bytes(idx.shape[0], table.shape[0],
                                       idx.element_size(),
                                       table.element_size())
        yield _record("monotone_window_gather", times, nbytes / rate * 1e3,
                      shape=label, n=idx.shape[0], m=table.shape[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(REPO))
    ap.add_argument("--label", default=None)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--levels-only", action="store_true",
                    help="time only the dense level kernels")
    ap.add_argument("--out", default="chiprun_out/torch_kernel_ab.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    tree = pathlib.Path(args.tree).resolve()
    label = args.label or tree.name
    sys.path.insert(0, str(tree))
    import gamesmanmpi_tpu_torch

    pkg = pathlib.Path(gamesmanmpi_tpu_torch.__file__).resolve()
    if tree not in pkg.parents:
        raise RuntimeError(f"imported {pkg}, not the package of {tree}")
    kc = _kernel_cases()
    smi = kc.nvidia_smi_line()
    dev = torch.device("cuda", 0)
    records = []
    cases = [] if args.levels_only else [measure(dev, kc, args.rounds)]
    cases.append(measure_levels(dev, kc, args.rounds))
    for rec in (r for case in cases for r in case):
        rec["tree"] = label
        records.append(rec)
        print(json.dumps(rec), flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"tree": label, "nvidia_smi": smi,
                               "records": records}, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
