"""Live solve status: ``/status`` + ``/metrics`` served from the solver
(port of gamesmanmpi_tpu/obs/status.py).

Before this module the only windows into a running solve were the
per-process heartbeat line and post-hoc ``tools/obs_report.py`` — the
blind spot the Pentago solve (arXiv:1404.0743) and the consumer-grade
7x6 Connect-Four solve (arXiv:2507.05267) both had to engineer around
with live per-phase accounting. One read-only stdlib HTTP endpoint per
solver process answers the operator's four questions — where are you,
how fast, what's the bottleneck, when will you finish:

* ``GET /status`` — JSON: game/config, current phase+level, positions
  discovered/solved (monotone), the per-level schedule-based progress
  model with an ETA that converges as backward levels complete,
  io_wait/prefetch/write-behind stats, retries, and (rank 0 of a
  multi-process run) the fleet-merged per-rank view with stragglers
  flagged;
* ``GET /metrics`` — the process registry's Prometheus text exposition,
  exactly what the serving stack already exposes.

Enable with ``GAMESMAN_STATUS_PORT`` / ``--status-port`` (0 = ephemeral;
``GAMESMAN_STATUS_ADDR_FILE`` publishes the bound ``host:port`` for
supervisors — the campaign proxies its child's status through one
stable operator port this way). The server must never be able to kill
or slow the solve it is watching: bind failures degrade to "no status
server" with a warning, handler errors answer 500, and every read is a
snapshot of atomically-replaced dicts — no lock is shared with the
solve thread.
"""

from __future__ import annotations

import json
import os
import socket
import statistics
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.request import urlopen

from gamesmanmpi_tpu_torch.obs.registry import MetricsRegistry, default_registry
from gamesmanmpi_tpu_torch.utils.env import env_float, env_opt, env_str

#: ETA smoothing: weight of the newest completed level's throughput in
#: the running estimate (EWMA — late levels dominate, early compile-
#: polluted levels wash out, so the ETA converges).
_EWMA_ALPHA = 0.4


def status_port_configured() -> Optional[int]:
    """The configured status port, or None (unset/malformed = off).
    0 means "bind an ephemeral port" (used with
    ``GAMESMAN_STATUS_ADDR_FILE`` by supervisors)."""
    raw = env_opt("GAMESMAN_STATUS_PORT")
    if raw is None or not raw.strip():
        return None
    try:
        port = int(raw)
    except ValueError:
        sys.stderr.write(
            f"warning: GAMESMAN_STATUS_PORT={raw!r} is not an integer; "
            "status server disabled\n"
        )
        return None
    return port if port >= 0 else None


def straggler_factor() -> float:
    """A rank is flagged as a straggler when its per-level wall exceeds
    this multiple of the fleet's median for that level."""
    return max(env_float("GAMESMAN_STATUS_STRAGGLER_FACTOR", 1.5), 1.0)


class SolveStatusTracker:
    """The per-solver progress model behind ``/status``.

    Written only by the solve thread (every mutation replaces a dict or
    bumps a scalar — atomic under the GIL, the ``progress`` contract);
    read by HTTP handler threads via :meth:`snapshot`.

    The ETA is level-schedule based: once forward discovery fixes the
    per-level position counts, the remaining backward work is known
    exactly, and the estimate is remaining positions over an EWMA of
    completed backward levels' throughput — so it starts as soon as the
    first level resolves and converges as the sweep proceeds.
    """

    def __init__(self, *, clock=time.monotonic):
        self._clock = clock
        self.t0 = clock()
        self.meta: dict = {}
        #: level -> {"n", "secs"} per phase; replaced, never mutated.
        self.forward_levels: Dict[int, dict] = {}
        self.backward_levels: Dict[int, dict] = {}
        #: level -> positions, fixed when forward completes.
        self.schedule: Dict[int, int] = {}
        self.positions_discovered = 0
        self.positions_solved = 0
        self._ewma_pps: Optional[float] = None

    def begin(self, **meta) -> None:
        """Identity fields echoed into every snapshot (game, engine,
        shards, world, rank, attempt...)."""
        self.meta = {**self.meta, **meta}

    def forward_level(self, level, n, secs) -> None:
        self.forward_levels = {
            **self.forward_levels,
            int(level): {"n": int(n), "secs": round(float(secs or 0.0), 6)},
        }
        self.positions_discovered += int(n)

    def set_schedule(self, schedule: Dict[int, int]) -> None:
        self.schedule = {int(k): int(v) for k, v in schedule.items()}

    def backward_level(self, level, n, secs, resumed: bool = False) -> None:
        secs = float(secs or 0.0)
        self.backward_levels = {
            **self.backward_levels,
            int(level): {"n": int(n), "secs": round(secs, 6)},
        }
        self.positions_solved += int(n)
        # Checkpoint-resumed levels replay millions of positions in
        # milliseconds (loaded, not computed): feeding them into the
        # throughput EWMA would make a restarted run's ETA claim a
        # multi-hour sweep finishes in seconds. They still count as
        # solved work (the ETA numerator shrinks); only the rate model
        # skips them.
        if n and secs > 0 and not resumed:
            pps = int(n) / secs
            self._ewma_pps = (
                pps if self._ewma_pps is None
                else (1 - _EWMA_ALPHA) * self._ewma_pps + _EWMA_ALPHA * pps
            )

    # -------------------------------------------------------------- reading

    def eta_secs(self) -> Optional[float]:
        """Predicted seconds to finish the backward sweep, or None while
        unestimable (no schedule yet / nothing resolved yet)."""
        if not self.schedule or self._ewma_pps is None:
            return None
        done = self.backward_levels
        remaining = sum(
            n for k, n in self.schedule.items() if k not in done
        )
        if remaining <= 0:
            return 0.0
        return round(remaining / max(self._ewma_pps, 1e-9), 3)

    def snapshot(self, progress: Optional[dict] = None) -> dict:
        fwd, bwd = self.forward_levels, self.backward_levels
        levels = {}
        for k in sorted(set(fwd) | set(bwd)):
            row: dict = {}
            if k in fwd:
                row["n"] = fwd[k]["n"]
                row["fwd_secs"] = fwd[k]["secs"]
            if k in bwd:
                row["n"] = bwd[k]["n"]
                row["bwd_secs"] = bwd[k]["secs"]
            levels[str(k)] = row
        snap = {
            **self.meta,
            "uptime_secs": round(self._clock() - self.t0, 3),
            "phase": (progress or {}).get("phase"),
            "level": (progress or {}).get("level"),
            "positions_discovered": self.positions_discovered,
            "positions_solved": self.positions_solved,
            "levels_total": len(self.schedule) or None,
            "levels_solved": len(bwd),
            "throughput_pps": (
                round(self._ewma_pps, 1) if self._ewma_pps else None
            ),
            "eta_secs": self.eta_secs(),
            "levels": levels,
        }
        return snap


# --------------------------------------------------------------- the server


class _StatusHandler(BaseHTTPRequestHandler):
    server_version = "gamesman-status/1"
    protocol_version = "HTTP/1.1"
    timeout = 30

    def log_message(self, fmt, *args):  # quiet: one scrape/s is not news
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True

    def do_GET(self):  # noqa: N802 - http.server API
        srv = self.server
        route = self.path.partition("?")[0]
        srv.registry.counter(
            "gamesman_status_requests_total",
            "GET requests answered by the live status endpoint",
            # Bounded label set: a port scanner walking a wordlist must
            # not mint one permanent registry series per probed path.
            path=route if route in ("/status", "/metrics") else "other",
        ).inc()
        if route == "/status":
            try:
                body = json.dumps(srv.provider(), default=str).encode()
                self._send(200, body, "application/json")
            except Exception as e:  # noqa: BLE001 - must not kill the solve
                self._send(
                    500,
                    json.dumps({"error": f"{type(e).__name__}: {e}"})
                    .encode(),
                    "application/json",
                )
        elif route == "/metrics":
            self._send(
                200, srv.registry.render_prometheus().encode(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
        else:
            self._send(
                404,
                json.dumps({"error": f"no such path {self.path!r}"})
                .encode(),
                "application/json",
            )


class _StatusHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, provider, registry):
        super().__init__(addr, _StatusHandler)
        self.provider = provider
        self.registry = registry


class StatusServer:
    """Read-only status endpoint for one process (daemon thread).

    ``provider`` is a zero-arg callable returning the ``/status`` body;
    it runs on handler threads, so it must only read atomically-replaced
    state (the tracker/progress contract). ``addr_file`` (optional)
    publishes the bound ``host:port`` atomically for supervisors.
    """

    def __init__(self, provider: Callable[[], dict], *,
                 port: int = 0, host: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 addr_file=None):
        if host is None:
            # Bind this host (GAMESMAN_STATUS_HOST): on a real
            # multi-host run each rank must announce an address its
            # peers can actually reach, not loopback — same reason the
            # retry coordinator's host is configurable.
            host = env_str("GAMESMAN_STATUS_HOST", "127.0.0.1")
        self._http = _StatusHTTPServer(
            (host, int(port)), provider, registry or default_registry()
        )
        self.host = host
        self.port = self._http.server_address[1]
        # Advertised address != bind address for wildcard binds: a rank
        # announcing "0.0.0.0:<port>" would make every peer (and the
        # addr-file reader) dial its OWN loopback — derive a reachable
        # name instead.
        adv = host
        if host in ("", "0.0.0.0", "::"):
            try:
                adv = socket.gethostname() or "127.0.0.1"
            except OSError:
                adv = "127.0.0.1"
        self.address = f"{adv}:{self.port}"
        self._thread: Optional[threading.Thread] = None
        if addr_file:
            tmp = f"{addr_file}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                fh.write(self.address)
            os.replace(tmp, addr_file)

    def start(self) -> "StatusServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._http.serve_forever,
                name="gamesman-status", daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "StatusServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def maybe_status_server(provider, *, registry=None,
                        rank: int = 0, world: int = 1,
                        ) -> Optional[StatusServer]:
    """Env-gated status server: ``GAMESMAN_STATUS_PORT`` unset = off.

    Multi-process runs offset a nonzero base port by rank (rank i binds
    port+i — the convention the fleet scraper falls back to); rank 0
    alone honors ``GAMESMAN_STATUS_ADDR_FILE`` so N ranks never race
    onto one file. A bind failure warns and returns None — the status
    plane must never abort a solve.
    """
    port = status_port_configured()
    if port is None:
        return None
    if port > 0 and world > 1:
        port = port + int(rank)
    addr_file = env_opt("GAMESMAN_STATUS_ADDR_FILE") if rank == 0 else None
    try:
        return StatusServer(
            provider, port=port, registry=registry, addr_file=addr_file
        ).start()
    except (OSError, OverflowError) as e:
        # OverflowError: an out-of-range port (typo, or a high base plus
        # the rank offset walking past 65535) raises it from bind() —
        # it must degrade like any other bind failure, not abort a
        # multi-hour solve at startup.
        sys.stderr.write(
            f"warning: status server failed to bind port {port} ({e}); "
            "continuing without /status\n"
        )
        return None


# ------------------------------------------------------- fleet aggregation


def fetch_status(address: str, timeout: Optional[float] = None,
                 ) -> Optional[dict]:
    """GET ``http://<address>/status`` -> dict, or None on any failure
    (a dead peer must degrade the fleet view, not the scrape)."""
    if timeout is None:
        timeout = env_float("GAMESMAN_STATUS_SCRAPE_TIMEOUT", 2.0)
    try:
        with urlopen(f"http://{address}/status", timeout=timeout) as resp:
            return json.loads(resp.read().decode())
    except Exception:  # noqa: BLE001 - peer death is a normal condition
        return None


def _level_walls(snap: dict) -> Dict[int, float]:
    """level -> this rank's wall seconds (forward + backward)."""
    out: Dict[int, float] = {}
    for k, row in (snap.get("levels") or {}).items():
        try:
            lvl = int(k)
        except (TypeError, ValueError):
            continue
        out[lvl] = (float(row.get("fwd_secs") or 0.0)
                    + float(row.get("bwd_secs") or 0.0))
    return out


def merge_fleet(rank_snaps: Dict[int, dict], *, world: int,
                factor: Optional[float] = None) -> dict:
    """Fold per-rank ``/status`` snapshots into the fleet view rank 0
    serves: per-level wall = MAX across ranks (the level ran once,
    collectively — same rule as tools/obs_report.py), per-rank progress
    summaries, and stragglers — ranks whose wall for some level exceeds
    ``factor`` x the fleet median for that level."""
    if factor is None:
        factor = straggler_factor()
    walls = {r: _level_walls(s) for r, s in rank_snaps.items()}
    levels: Dict[int, dict] = {}
    for r, per in walls.items():
        for lvl, w in per.items():
            row = levels.setdefault(lvl, {"wall_secs": 0.0, "by_rank": {}})
            row["wall_secs"] = max(row["wall_secs"], w)
            row["by_rank"][str(r)] = round(w, 6)
    stragglers: Dict[int, dict] = {}
    for lvl, row in levels.items():
        vals = [w for w in row["by_rank"].values() if w > 0]
        if len(vals) < 2:
            continue
        med = statistics.median(vals)
        if med <= 0:
            continue
        for r, w in row["by_rank"].items():
            if w > factor * med:
                cur = stragglers.get(int(r))
                if cur is None or w / med > cur["lag"]:
                    stragglers[int(r)] = {
                        "rank": int(r), "level": lvl,
                        "wall_secs": round(w, 6),
                        "median_secs": round(med, 6),
                        "lag": round(w / med, 3),
                    }
    etas = [
        s.get("eta_secs") for s in rank_snaps.values()
        if isinstance(s.get("eta_secs"), (int, float))
    ]
    return {
        "world": int(world),
        "ranks_reporting": sorted(rank_snaps),
        "ranks": {
            str(r): {
                k: s.get(k)
                for k in ("phase", "level", "positions_solved",
                          "positions_discovered", "eta_secs",
                          "throughput_pps", "uptime_secs")
            }
            for r, s in sorted(rank_snaps.items())
        },
        "levels": {
            str(k): {"wall_secs": round(v["wall_secs"], 6),
                     "by_rank": v["by_rank"]}
            for k, v in sorted(levels.items())
        },
        "stragglers": [stragglers[r] for r in sorted(stragglers)],
        "straggler_factor": factor,
        "eta_secs": max(etas) if etas else None,
    }
