"""Open-loop query traffic: the position pool, the request stream and the
client that sends it on schedule.

Request format and classification are copied from tools/load_gen.py (POST
/query {"positions": [...]}, one request per connection; ok / errors /
shed / dropped), but its closed loop of N threads is replaced by an open
loop: each request has a due time drawn before the window opens, is sent
at that time whether or not earlier ones have been answered, and is timed
from its due time, so a stall shows in the tail instead of lowering the
load offered. One asyncio loop on one thread sends everything; how late it
sent (its own lag behind the schedule) is reported beside the latencies.

Every seed gets the same inter-arrival gaps (the exponential
distribution's quantiles at the mix's rate) in another order, so seeds
change which positions are asked and when, not how much load arrives.
"""

from __future__ import annotations

import asyncio
import gc
import json
import math

import numpy as np
import torch

import reference


def playout_pool(board: reference.Board, size: int, seed: int) -> np.ndarray:
    """`size` distinct packed positions, each reached by a uniformly random
    game from the empty board stopped after a depth drawn uniformly from
    0..ncells (or where the game ended), in an order drawn from the seed."""
    rng = np.random.default_rng(seed)
    w, h = board.width, board.height
    found = np.zeros(0, dtype=np.int64)
    while found.size < size:
        g = 2 * (size - found.size) + 1024
        depth = rng.integers(0, board.ncells + 1, size=g)
        heights = np.zeros((g, w), dtype=np.int64)
        to_move = np.zeros(g, dtype=np.int64)
        other = np.zeros(g, dtype=np.int64)
        live = np.ones(g, dtype=bool)
        for ply in range(board.ncells):
            rows = np.nonzero(live & (depth > ply))[0]
            if rows.size == 0:
                break
            pick = rng.random((rows.size, w)) * (heights[rows] < h)
            c = pick.argmax(1)
            bit = np.left_shift(1, heights[rows, c] + c * board.h1)
            heights[rows, c] += 1
            mover = to_move[rows] | bit
            to_move[rows], other[rows] = other[rows], mover
            won = board.has_line(torch.from_numpy(mover)).numpy()
            live[rows[won]] = False
        states = board.pack(torch.from_numpy(heights),
                            torch.from_numpy(to_move)).numpy()
        grown = np.unique(np.concatenate([found, states]))
        if grown.size == found.size:
            raise ValueError(f"no {size} distinct positions on this board")
        found = grown
    return rng.choice(found, size=size, replace=False)


def zipf_ranks(n_items: int, s: float, count: int,
               rng: np.random.Generator) -> np.ndarray:
    """`count` ranks in 0..n_items-1, rank i drawn with probability
    proportional to 1/(i+1)**s."""
    cdf = np.cumsum(1.0 / np.arange(1, n_items + 1, dtype=np.float64) ** s)
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, rng.random(count)), n_items - 1)


def arrivals(rate: float, seconds: float, rng: np.random.Generator
             ) -> np.ndarray:
    """Due times in [0, seconds) of round(rate*seconds) Poisson arrivals:
    the exponential quantiles as gaps, scaled to fill the window, in an
    order drawn from rng."""
    n = max(int(round(rate * seconds)), 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = gaps[rng.permutation(n)]
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return due * (seconds / gaps.sum())


def requests(pool: np.ndarray, mix: dict, rate: float, seconds: float,
             rng: np.random.Generator):
    """(due times, [positions per request]) of one window."""
    due = arrivals(rate, seconds, rng)
    per = int(mix["positions_per_request"])
    ranks = zipf_ranks(pool.size, float(mix["zipf_s"]), due.size * per, rng)
    return due, pool[ranks].reshape(due.size, per)


def percentile(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile of an ascending list (tools/load_gen.py's)."""
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


async def _one(host: str, port: int, body: bytes, timeout: float):
    """-> (kind, results or None)."""
    head = (f"POST /query HTTP/1.1\r\nHost: {host}:{port}\r\n"
            "Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n")
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout)
    except (OSError, asyncio.TimeoutError):
        return "dropped", None
    try:
        writer.write(head.encode() + body)
        await writer.drain()
        data = await asyncio.wait_for(reader.read(), timeout)
    except (OSError, asyncio.TimeoutError):
        return "dropped", None
    finally:
        writer.close()
    top, _, payload = data.partition(b"\r\n\r\n")
    try:
        code = int(top.split(b" ", 2)[1])
    except (IndexError, ValueError):
        return "dropped", None
    if code == 503:
        return "shed", None
    if code != 200:
        return "errors", None
    try:
        results = json.loads(payload).get("results", [])
    except ValueError:
        return "errors", None
    clean = all(r.get("found") and "error" not in r for r in results)
    return ("ok" if clean else "errors"), results


async def _drive(host, port, due, batches, timeout, grace):
    loop = asyncio.get_running_loop()
    n = len(due)
    recs = [None] * n
    base = loop.time() + 0.05

    async def send(i, t_due, body):
        t_sent = loop.time()
        kind, results = await _one(host, port, body, timeout)
        if kind == "ok" and len(results) != len(batches[i]):
            kind = "errors"
        recs[i] = (t_due, t_sent, loop.time(), kind, results)

    bodies = [json.dumps({"positions": [hex(int(p)) for p in b]}).encode()
              for b in batches]
    tasks = []
    for i in range(n):
        t_due = base + float(due[i])
        wait = t_due - loop.time()
        if wait > 0:
            await asyncio.sleep(wait)
        tasks.append(asyncio.create_task(send(i, t_due, bodies[i])))
    t_close = loop.time()
    if tasks:
        _, pending = await asyncio.wait(tasks, timeout=grace)
        for t in pending:
            t.cancel()
        await asyncio.gather(*pending, return_exceptions=True)
    return recs, base, t_close


def run_open_loop(host: str, port: int, due, batches, timeout: float = 30.0,
                  grace: float = 60.0) -> dict:
    """Send batches[i] at due[i] seconds from now (open loop), wait for the
    answers (up to `grace` s past the last send) -> the window's record."""
    # The collector's pauses would stall the sender: off for the window.
    gc.disable()
    try:
        recs, base, t_close = asyncio.run(
            _drive(host, port, due, batches, timeout, grace))
    finally:
        gc.enable()
    kinds = {"ok": 0, "errors": 0, "shed": 0, "dropped": 0, "never": 0}
    lat, lag, answers = [], [], []
    for i, r in enumerate(recs):
        if r is None:
            kinds["never"] += 1
            lat.append(math.inf)
            continue
        t_due, t_sent, t_done, kind, results = r
        kinds[kind] += 1
        lag.append(t_sent - t_due)
        lat.append(t_done - t_due if kind == "ok" else math.inf)
        if kind == "ok":
            for pos, res in zip(batches[i], results):
                answers.append((int(pos), res))
    lat.sort()
    lag.sort()
    return {
        "requests": len(recs),
        **kinds,
        "failed": len(recs) - kinds["ok"],
        "latencies": lat,
        "send_lag_p99_ms": 1e3 * percentile(lag, 0.99),
        "send_lag_max_ms": 1e3 * (lag[-1] if lag else 0.0),
        "window_s": t_close - base,
        "answers": answers,
        "records": recs,
    }


def tail_by_part(due, rec: dict, parts: int, q: float = 0.95) -> list:
    """The q-th latency percentile in ms of the requests due in each of
    `parts` equal spans of the window (a tail that grows span by span is
    a growing backlog); a failed request counts as infinite."""
    lat = [(d, math.inf if r is None or r[3] != "ok" else r[2] - r[0])
           for d, r in zip(due, rec["records"])]
    span = float(due[-1]) if len(due) else 1.0
    out = []
    for k in range(parts):
        part = sorted(t for d, t in lat
                      if k * span / parts <= d <= (k + 1) * span / parts + 1e-9)
        out.append(1e3 * percentile(part, q))
    return out
