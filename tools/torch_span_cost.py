"""What a dense solve's span sites cost the host, off and on.

    python tools/torch_span_cost.py [--n 200000] [--out FILE]

One JSON line per case, nanoseconds per operation (the best of 5 rounds
of --n operations; on cases use --n // 10):

* ``off_switch``  — ``tracing_on()``, read once per solve;
* ``off_site``    — one detail-span site with the switch off
  (``sp = None if tree is None else Span(...)``, then ``if sp is not
  None``), against the same loop without it (``loop``);
* ``on_detail``   — a detail span of a tree opened and ended, with a sink
  installed and no profiler;
* ``on_backward`` — the per-level backward span joined to a tree, its
  own fan-out (registry, flight recorder, sink) included;
* ``on_finish``   — a tree's finish per detail span it ends (the solve's
  one fan-out to stats, registry and sink);
* ``on_detail_profiler_<activities>`` — a detail span while a
  torch.profiler records (``cpu``; ``cuda``, the benchmark's, and
  ``cpu_cuda``, the CLI's ``--profile-dir``, where a card is present);
  with CPU activity inside ``profiler_ranges``, as the CLI records, so
  the profiler range's enter and exit are included.

Then the device line (``nvidia-smi`` name and power limit, or ``cpu``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def best_ns(fn, n: int, rounds: int = 5) -> float:
    best = float("inf")
    for _ in range(rounds):
        t = time.perf_counter_ns()
        fn(n)
        best = min(best, (time.perf_counter_ns() - t) / n)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gamesmanmpi_tpu_torch.obs import MetricsRegistry
    from gamesmanmpi_tpu_torch.obs.tracing import (
        Span,
        SpanTree,
        TraceEventSink,
        profiler_ranges,
        set_trace_sink,
        tracing_on,
    )

    n, m = args.n, max(args.n // 10, 1)
    rows = []

    def emit(case, ns):
        row = {"case": case, "ns_per_op": round(ns, 1)}
        rows.append(row)
        print(json.dumps(row), flush=True)

    def loop(k):
        for L in range(k):
            pass

    def off_site(k):
        tree = None
        for L in range(k):
            sp = (None if tree is None
                  else Span("dense_pack", tree=tree, detail=True, level=L))
            if sp is not None:
                sp.end()

    def switch(k):
        for _ in range(k):
            tracing_on()

    emit("loop", best_ns(loop, n))
    emit("off_site", best_ns(off_site, n))
    emit("off_switch", best_ns(switch, n))

    def detail(k):
        tree = SpanTree()
        for L in range(k):
            Span("dense_pack", tree=tree, detail=True, level=L).end()

    def backward(k):
        tree = SpanTree()
        reg = MetricsRegistry()
        for L in range(k):
            Span("backward", log=False, level=L, tree=tree,
                 registry=reg).end()

    prev = set_trace_sink(TraceEventSink())
    try:
        emit("on_detail", best_ns(detail, m))
        emit("on_backward", best_ns(backward, m))
        tree = SpanTree()
        for L in range(m):
            Span("dense_pack", tree=tree, detail=True, level=L).end()
        t = time.perf_counter_ns()
        tree.finish()
        emit("on_finish", (time.perf_counter_ns() - t) / m)
    finally:
        set_trace_sink(prev)

    kinds = {"cpu": [ProfilerActivity.CPU]}
    if torch.cuda.is_available():
        kinds["cuda"] = [ProfilerActivity.CUDA]
        kinds["cpu_cuda"] = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for name, acts in kinds.items():
        ranges = (profiler_ranges() if ProfilerActivity.CPU in acts
                  else contextlib.nullcontext())
        with profile(activities=acts), ranges:
            emit(f"on_detail_profiler_{name}", best_ns(detail, m, rounds=3))

    if torch.cuda.is_available():
        dev = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    else:
        dev = "cpu"
    print(json.dumps({"device": dev, "torch": torch.__version__}))
    if args.out:
        pathlib.Path(args.out).write_text(
            "\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
