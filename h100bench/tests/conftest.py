"""Shared set-up of the benchmark's own tests (run them from the repo root:
`python -m pytest h100bench/tests -q`; the card test: `-m cuda` on the
chip). The harness's modules are plain scripts: put their folder and the
repo root on the path."""

import json
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def small_root(tmp, game="connect4:w=4,h=4", pool=4096, rate=100):
    """A copy of the benchmark's files under tmp whose boards are `game`:
    the real cells at a size a test can hold."""
    (tmp / "h100bench").mkdir(parents=True)
    for d in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(BENCH / d, tmp / "h100bench" / d)
    shutil.copy(ROOT / "BENCHMARK.json", tmp)
    for f in (tmp / "h100bench" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["game"] = game
        f.write_text(json.dumps(c))
    for f in (tmp / "h100bench" / "traffic").glob("*.json"):
        m = json.loads(f.read_text())
        if "pool" in m:
            m["pool"] = pool
        f.write_text(json.dumps(m))
    for f in (tmp / "h100bench" / "workloads").glob("*.json"):
        w = json.loads(f.read_text())
        if "rate_qps" in w:
            w["rate_qps"] = rate
        f.write_text(json.dumps(w))
    return tmp


#: The cells that have files in h100bench/ but are not in BENCHMARK.json
#: yet (PERF.md says why), as its entries would list them.
UNLISTED = {
    "configs": [
        {"name": "c4_5x5_classic", "source": "https://tromp.github.io/c4/c4.html",
         "file": "h100bench/configs/c4_5x5_classic.json", "reduced": [],
         "why": "the 5x5 board on the classic engine"},
        {"name": "c4_5x5_db", "source": "https://tromp.github.io/c4/c4.html",
         "file": "h100bench/configs/c4_5x5_db.json", "reduced": [],
         "why": "the 5x5 DB served by a 2-worker fleet"},
        {"name": "c4_6x5_dense", "source": "https://tromp.github.io/c4/c4.html",
         "file": "h100bench/configs/c4_6x5_dense.json", "reduced": [],
         "why": "the 6x5 board on the dense engine"}],
    "workloads": [
        {"name": "c4_5x5_classic.solve", "config": "c4_5x5_classic",
         "traffic": "solve_loop", "chips": 1, "why": "classic solves"},
        {"name": "c4_5x5_db.query", "config": "c4_5x5_db",
         "traffic": "query_open", "chips": 1, "why": "queries"},
        {"name": "c4_6x5_dense.solve", "config": "c4_6x5_dense",
         "traffic": "solve_loop", "chips": 1, "why": "6x5 solves"}],
    "end_to_end": [
        {"name": "query_p95_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["c4_5x5_db.query"]}],
    "per_layer": [
        {"name": f"classic_{p}_ms.solve", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "classic level loop",
         "moves": "solve_ms", "workloads": ["c4_5x5_classic.solve"]}
        for p in ("forward", "backward")] + [
        {"name": f"query_{p}_ms.query", "unit": "ms", "better": "lower",
         "source": "program_counter", "layer": layer,
         "moves": "query_p95_ms", "workloads": ["c4_5x5_db.query"]}
        for p, layer in (("server", "serving"),
                         ("flush", "DB reader through the batcher"))],
}


def with_unlisted_cells(root):
    """Add the unlisted cells' entries to root's BENCHMARK.json."""
    path = root / "BENCHMARK.json"
    b = json.loads(path.read_text())
    for key, entries in UNLISTED.items():
        b[key].extend(entries)
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in ("solve_ms", "solve_peak_mem_gib",
                         "traced_pos_per_s.solve",
                         "device_idle_pct.solve", "copy_ms.solve"):
            m["workloads"] += ["c4_5x5_classic.solve", "c4_6x5_dense.solve"]
        if m["name"] == "dense_roofline_pct.solve":
            m["workloads"].append("c4_6x5_dense.solve")
    path.write_text(json.dumps(b))
    return root


def classic_tables(board, sol) -> dict:
    """A reference solve's reachable positions as the classic engine's
    tables: level -> (packed states ascending, values, remoteness)."""
    import torch

    out = {}
    for L, reach in sol.reach.items():
        flat = reach.reshape(-1).nonzero().reshape(-1)
        C = board.size[L]
        row, rank = flat // C, flat % C
        p1 = board.unrank(L, row, rank)
        to_move = p1 if L % 2 == 0 else board.filled[L][row] ^ p1
        states = board.pack(board.profiles[L][row], to_move)
        order = torch.argsort(states)
        cell = sol.cells[L].reshape(-1)[flat][order].to(torch.int64)
        out[L] = SimpleNamespace(states=states[order].cpu().numpy(),
                                 values=(cell & 3).cpu().numpy(),
                                 remoteness=(cell >> 2).cpu().numpy())
    return out
