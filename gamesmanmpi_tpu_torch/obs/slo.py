"""SLO objectives + multi-window burn-rate computation for serving (port of
gamesmanmpi_tpu/obs/slo.py).

Aggregate histograms say *how* the fleet performed; an SLO says whether
that performance is *acceptable*, and a burn rate says how fast the
error budget is being spent. Two declared objectives per route:

* **availability** — a request is bad when it errored (5xx) or was shed
  (503 under overload/breaker). Target ``GAMESMAN_SLO_AVAIL_TARGET``
  (default 0.999 → budget 0.1%).
* **latency** — a request is bad when it took longer than
  ``GAMESMAN_SLO_P99_MS`` (default 250 ms). Target
  ``GAMESMAN_SLO_LATENCY_TARGET`` (default 0.99 → budget 1%: the p99
  objective spelled as a ratio SLO).

Burn rate = (bad fraction over a window) / error budget: 1.0 means the
budget is being spent exactly at the rate that exhausts it at the
window's end; 14.4 over a short window is the classic "page now"
threshold (Google SRE workbook, ch. 5). Two windows are computed —
fast (``GAMESMAN_SLO_FAST_WINDOW_SECS``, default 300) and slow
(``GAMESMAN_SLO_SLOW_WINDOW_SECS``, default 3600) — from a ring of
per-second good/bad buckets, so memory is bounded and the fast window
recovers quickly once the bad minute ends. A fast-window burn above
``GAMESMAN_SLO_FAST_BURN`` (default 14.4) with at least
``GAMESMAN_SLO_MIN_REQUESTS`` requests in the window flips
``fast_burn`` for that
objective; the server folds any tripped objective into its ``/healthz``
status as ``degraded``, which the fleet supervisor already propagates
(a degraded worker beat degrades fleet ``/status``) — the fleet goes
amber *before* the budget is gone, not after.

All observation goes through ``observe()`` on the request path (one
lock, two bucket increments); burn rates are derived at read time
(``snapshot()``), which is when the gauges are refreshed too.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

from gamesmanmpi_tpu_torch.obs.registry import MetricsRegistry, default_registry
from gamesmanmpi_tpu_torch.utils.env import env_float

#: Registry families the SLO engine records into.
SLO_REQUESTS = "gamesman_slo_requests_total"
SLO_BURN_RATE = "gamesman_slo_burn_rate"
SLO_FAST_BURN = "gamesman_slo_fast_burn"
SLO_FAST_BURN_TRIPS = "gamesman_slo_fast_burn_trips_total"

#: Good/bad accounting granularity (seconds per bucket). One second so
#: a test can shrink the fast window to a few seconds and still watch
#: the burn rate rise AND recover; memory stays O(slow_window) cells.
BUCKET_SECS = 1.0

#: The two declared objectives, in snapshot order.
OBJECTIVES = ("availability", "latency")


class _Window:
    """Ring of (bucket_start, good, bad) for one (route, objective)."""

    __slots__ = ("buckets",)

    def __init__(self):
        self.buckets: "OrderedDict[int, list]" = OrderedDict()

    def add(self, now: float, good: int, bad: int, horizon: float) -> None:
        key = int(now // BUCKET_SECS)
        cell = self.buckets.get(key)
        if cell is None:
            cell = self.buckets[key] = [0, 0]
        cell[0] += good
        cell[1] += bad
        # Prune past the slow horizon; the ring stays O(horizon / 10s).
        floor = key - int(horizon // BUCKET_SECS) - 1
        while self.buckets:
            k = next(iter(self.buckets))
            if k >= floor:
                break
            del self.buckets[k]

    def totals(self, now: float, window: float):
        """(good, bad) over the trailing ``window`` seconds."""
        floor = int((now - window) // BUCKET_SECS)
        good = bad = 0
        for k, (g, b) in self.buckets.items():
            if k > floor:
                good += g
                bad += b
        return good, bad


class SloEngine:
    """Per-route availability + latency objectives with fast/slow
    burn-rate windows. One engine per server; thread-safe."""

    def __init__(self, *, p99_ms: Optional[float] = None,
                 avail_target: Optional[float] = None,
                 latency_target: Optional[float] = None,
                 fast_window: Optional[float] = None,
                 slow_window: Optional[float] = None,
                 fast_burn: Optional[float] = None,
                 min_requests: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None,
                 clock=time.time):
        self.p99_ms = float(
            p99_ms if p99_ms is not None
            else env_float("GAMESMAN_SLO_P99_MS", 250.0)
        )
        self.targets = {
            "availability": float(
                avail_target if avail_target is not None
                else env_float("GAMESMAN_SLO_AVAIL_TARGET", 0.999)
            ),
            "latency": float(
                latency_target if latency_target is not None
                else env_float("GAMESMAN_SLO_LATENCY_TARGET", 0.99)
            ),
        }
        self.fast_window = float(
            fast_window if fast_window is not None
            else env_float("GAMESMAN_SLO_FAST_WINDOW_SECS", 300.0)
        )
        self.slow_window = max(self.fast_window, float(
            slow_window if slow_window is not None
            else env_float("GAMESMAN_SLO_SLOW_WINDOW_SECS", 3600.0)
        ))
        self.fast_burn_threshold = float(
            fast_burn if fast_burn is not None
            else env_float("GAMESMAN_SLO_FAST_BURN", 14.4)
        )
        # Volume gate: with a 0.1% availability budget a SINGLE bad
        # request among ten is a 100x burn — statistically meaningless.
        # fast_burn only trips once the fast window holds this many
        # requests (burn rates themselves are always reported).
        self.min_requests = max(1, int(
            min_requests if min_requests is not None
            else env_float("GAMESMAN_SLO_MIN_REQUESTS", 100)
        ))
        self._registry = registry or default_registry()
        self._clock = clock
        self._lock = threading.Lock()
        # (route, objective) -> _Window
        self._windows: Dict[tuple, _Window] = {}
        # (route, objective) -> currently tripped?  (edge-detects trips)
        self._tripped: Dict[tuple, bool] = {}

    # ------------------------------------------------------------ writes

    def observe(self, route: str, secs: float, code: int,
                *, shed: bool = False) -> None:
        """One finished request. ``shed`` marks load-shedding 503s
        (breaker/overload/drain) — bad for availability even though the
        status code is intentional."""
        now = self._clock()
        bad_avail = bool(shed or int(code) >= 500)
        bad_latency = (secs * 1e3) > self.p99_ms
        with self._lock:
            for obj, bad in (("availability", bad_avail),
                             ("latency", bad_latency)):
                win = self._windows.get((route, obj))
                if win is None:
                    win = self._windows[(route, obj)] = _Window()
                win.add(now, 0 if bad else 1, 1 if bad else 0,
                        self.slow_window)
                self._registry.counter(
                    SLO_REQUESTS,
                    "requests per SLO objective by good/bad outcome",
                    route=route, slo=obj,
                    outcome="bad" if bad else "good",
                ).inc()

    # ------------------------------------------------------------- reads

    def _burn(self, win: _Window, now: float, window: float,
              budget: float) -> float:
        good, bad = win.totals(now, window)
        total = good + bad
        if total == 0:
            return 0.0
        return (bad / total) / max(budget, 1e-9)

    def snapshot(self) -> dict:
        """Per-route burn rates + fast-burn flags; refreshes the
        ``gamesman_slo_*`` gauges as a side effect (read-time derivation:
        the request path never computes a burn rate)."""
        now = self._clock()
        out: dict = {
            "p99_ms": self.p99_ms,
            "fast_window_secs": self.fast_window,
            "slow_window_secs": self.slow_window,
            "fast_burn_threshold": self.fast_burn_threshold,
            "routes": {},
            "fast_burn": False,
        }
        with self._lock:
            keys = list(self._windows.items())
        for (route, obj), win in keys:
            budget = 1.0 - self.targets[obj]
            fast = self._burn(win, now, self.fast_window, budget)
            slow = self._burn(win, now, self.slow_window, budget)
            good, bad = win.totals(now, self.fast_window)
            tripped = (
                fast > self.fast_burn_threshold
                and (good + bad) >= self.min_requests
            )
            route_view = out["routes"].setdefault(route, {})
            route_view[obj] = {
                "target": self.targets[obj],
                "burn_fast": round(fast, 4),
                "burn_slow": round(slow, 4),
                "fast_burn": tripped,
            }
            if tripped:
                out["fast_burn"] = True
            self._registry.gauge(
                SLO_BURN_RATE, "SLO error-budget burn rate per window",
                route=route, slo=obj, window="fast",
            ).set(fast)
            self._registry.gauge(
                SLO_BURN_RATE, "SLO error-budget burn rate per window",
                route=route, slo=obj, window="slow",
            ).set(slow)
            self._registry.gauge(
                SLO_FAST_BURN,
                "1 when the fast-window burn rate exceeds its threshold",
                route=route, slo=obj,
            ).set(1.0 if tripped else 0.0)
            with self._lock:
                was = self._tripped.get((route, obj), False)
                self._tripped[(route, obj)] = tripped
            if tripped and not was:
                self._registry.counter(
                    SLO_FAST_BURN_TRIPS,
                    "fast-burn threshold crossings (edge-triggered)",
                    route=route, slo=obj,
                ).inc()
        return out

    def fast_burning(self) -> bool:
        """True when any (route, objective) is past fast-burn right now
        (the health_status() hook)."""
        return bool(self.snapshot()["fast_burn"])
