"""Time one source tree's two CUDA kernels on one card, in turns with their
PyTorch calls.

    python tools/torch_kernel_ab.py [--tree DIR] [--label NAME] [--rounds 5] [--out FILE]

`--tree` is the root of a checkout of this repository (default: this
one). Its `gamesmanmpi_tpu_torch` is the one imported, so its kernels are
built from its own sources into its own `build/torch_ext/`. The inputs,
byte bounds and timing come from this file's checkout
(`bench/kernel_cases.py`, loaded by path), so two trees are measured
alike. To compare two commits on one card, unpack the older one with
`git archive` into a directory that .gitignore lists and run, in one
command, base, change, change, base; then compare the medians across the
runs, and each run's kernel against the library call it was timed with.

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
    for rec in measure(dev, kc, args.rounds):
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
