"""Stdlib HTTP front-end over one or many solved-position databases
(port of gamesmanmpi_tpu/serve/server.py).

A `ThreadingHTTPServer` (one thread per connection — the stdlib answer,
no framework dependency, matching the repo's plain-npz/no-deps stance)
exposing:

    POST /query         {"positions": ["0x1b", 42, ...]} ->
                        per-position value / remoteness / best child
                        (the default route: a single-DB server, or a
                        fleet whose manifest has exactly one game)
    POST /query/<name>  the same against the fleet-manifest game <name>
    GET  /healthz       liveness + DB identity (+ per-game state when
                        the server routes a fleet)
    GET  /metrics       Prometheus text exposition v0.0.4 (the process
                        metrics registry: request/batch/cache/db series);
                        answers JSON instead when the Accept header
                        prefers application/json
    GET  /metrics.json  the legacy JSON counter dict, retained verbatim
                        for existing consumers

Every request thread funnels through one serve/batcher.Batcher per
routed game, so concurrent requests coalesce into single vectorized
DbReader probes; the HTTP layer only parses, delegates, and formats.
Positions echo back in hex (the CLI's --query spelling) so responses are
copy-pasteable into `cli query` / `--query` for cross-checking.

Fleet mode (docs/SERVING.md "Fleet serving"): a supervisor process binds
the listening socket ONCE and hands it to N forked workers
(`serve/supervisor.py`), each of which constructs a QueryServer over the
inherited socket (``listen_sock=``) — the kernel load-balances accepts
across the workers, and a worker that stops accepting (drain) simply
leaves the shared queue to its siblings. The per-worker breaker /
deadline / shed machinery is exactly the single-process one.
"""

from __future__ import annotations

import json
import socket
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np

from gamesmanmpi_tpu_torch.core.values import value_name
from gamesmanmpi_tpu_torch.db.format import parse_position
from gamesmanmpi_tpu_torch.obs import default_registry
from gamesmanmpi_tpu_torch.obs.qtrace import (
    QueryTrace,
    TraceRing,
    activate,
    format_traceparent,
    qspan,
)
from gamesmanmpi_tpu_torch.utils.env import env_int
from gamesmanmpi_tpu_torch.obs.slo import SloEngine
from gamesmanmpi_tpu_torch.serve.batcher import (
    Batcher,
    BatcherTripped,
    BatcherUnavailable,
)

#: Socket errors a disconnecting client inflicts on the handler's write
#: path. Counted (http_client_aborts), never a thread traceback: a
#: hung-up client is load, not a server bug.
CLIENT_ABORT_ERRORS = (BrokenPipeError, ConnectionResetError)

#: The exposition format version the /metrics endpoint speaks.
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: Served from /metrics only when the client's Accept names it — carries
#: histogram exemplars (trace ids of slow observations) + "# EOF".
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)

# Refuse absurd request bodies before json.loads allocates for them.
_MAX_BODY_BYTES = 16 << 20
_MAX_POSITIONS_PER_REQUEST = 1 << 16

#: Accept backlog for the listening socket (also used by the supervisor
#: when it pre-binds): the stdlib default of 5 overflows under a barrier
#: burst of clients — observed as ECONNRESET under 8 synchronized
#: clients — and during a rolling restart the backlog is what holds
#: arriving connections while a replacement worker warms up.
LISTEN_BACKLOG = 128


class _Route:
    """One routed game: its reader and the batcher in front of it."""

    __slots__ = ("name", "reader", "batcher")

    def __init__(self, name: str, reader):
        self.name = name
        self.reader = reader
        self.batcher = None  # attached by QueryServer AFTER the bind


# wire: etag-cache-control, 503-retry-after, echo-traceparent
class _Handler(BaseHTTPRequestHandler):
    server_version = "gamesman-serve/1"
    protocol_version = "HTTP/1.1"
    # Socket timeout for blocking reads: a client that promises
    # Content-Length N and sends fewer bytes must not pin a handler
    # thread forever (slowloris); on timeout the connection is reaped.
    timeout = 30

    # self.server is the _QueryHTTPServer below.

    def setup(self):
        super().setup()
        # Register the connection so a drain can wake handler threads
        # parked in recv on idle keep-alive sockets (QueryServer.stop).
        self.server.conn_opened(self.connection)

    def finish(self):
        try:
            super().finish()
        finally:
            self.server.conn_closed(self.connection)

    def _send_json(self, code: int, payload: dict, headers=None) -> int:
        return self._send_text(
            code, json.dumps(payload), "application/json", headers
        )

    def _send_text(self, code: int, text: str, content_type: str,
                   headers=None) -> int:
        body = text.encode()
        try:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            trace = getattr(self, "_qtrace", None)
            if trace is not None:
                # Echo the (possibly freshly minted) context so a client
                # that sent none can still join its record to the
                # server-side trace; rides a header, never the body —
                # response shapes are a compatibility surface.
                self.send_header(
                    "traceparent",
                    format_traceparent(trace.trace_id, trace.root_id),
                )
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            if self.close_connection:
                # HTTP/1.1 defaults to keep-alive: a client must be TOLD the
                # connection is closing, or its next request hits a dead
                # socket (the early-400 path closes without draining).
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)
        except CLIENT_ABORT_ERRORS:
            # The client hung up mid-response: count it and reap the
            # connection — the old behavior was a handler-thread
            # traceback per disconnect.
            self.server.note_client_abort()
            self.close_connection = True
        return code

    def log_message(self, fmt, *args):  # quiet by default; JSONL has it
        pass

    def _wants_json(self) -> bool:
        """Content negotiation for /metrics: Prometheus scrapers send no
        Accept (or */*) and get the text exposition; a client that asks
        for application/json gets the legacy JSON dict. The full q-value
        dance is not worth stdlib-reimplementing — naming application/
        json anywhere in Accept is the opt-in."""
        accept = self.headers.get("Accept", "")
        return "application/json" in accept.lower()

    def _send_status(self, code: int, headers=None) -> int:
        """Header-only response (304: no body by definition)."""
        try:
            self.send_response(code)
            trace = getattr(self, "_qtrace", None)
            if trace is not None:
                self.send_header(
                    "traceparent",
                    format_traceparent(trace.trace_id, trace.root_id),
                )
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            if self.close_connection:
                self.send_header("Connection", "close")
            self.end_headers()
        except CLIENT_ABORT_ERRORS:
            self.server.note_client_abort()
            self.close_connection = True
        return code

    def do_GET(self):  # noqa: N802 - http.server API
        srv = self.server
        parts = urlsplit(self.path)
        if parts.path == "/query" or parts.path.startswith("/query/"):
            # The idempotent, edge-cacheable query form:
            # same trace/metrics/SLO bookkeeping as a POST — a CDN miss
            # that lands here is serving load like any other request.
            self._run_traced(lambda: self._handle_get_query(parts))
            return
        if self.path == "/healthz":
            self._send_json(200, srv.healthz())
        elif self.path == "/metrics":
            if self._wants_json():
                self._send_json(200, srv.metrics())
            elif "application/openmetrics-text" in (
                self.headers.get("Accept", "").lower()
            ):
                self._send_text(
                    200,
                    srv.registry.render_openmetrics(),
                    OPENMETRICS_CONTENT_TYPE,
                )
            else:
                self._send_text(
                    200,
                    srv.registry.render_prometheus(),
                    PROMETHEUS_CONTENT_TYPE,
                )
        elif self.path == "/metrics.json":
            self._send_json(200, srv.metrics())
        elif self.path == "/traces":
            self._send_json(200, srv.trace_ring.snapshot())
        else:
            self._send_json(404, {"error": f"no such path {self.path!r}"})

    def do_POST(self):  # noqa: N802 - http.server API
        # Every POST counts in /metrics, rejects included — an operator
        # watching the counters must see a server busy answering 400s as
        # busy, and http_errors makes the reject rate derivable.
        self._run_traced(self._handle_post)

    def _run_traced(self, handle) -> None:
        """The per-query-request bookkeeping shared by POST /query and
        GET /query: one trace per request (accept the client's
        traceparent or mint a root), inflight accounting, and the
        latency/SLO observation. The handler instance persists across
        keep-alive requests, so the attrs are (re)set per request and
        cleared in the finally (plain do_GET responses must never echo
        a stale trace)."""
        t0 = time.perf_counter()
        code = 500
        srv = self.server
        self._qtrace = (
            QueryTrace(
                traceparent=self.headers.get("traceparent"),
                worker=srv.worker_id,
            )
            if srv.trace_ring.enabled else None
        )
        self._route_name = ""
        self._shed_status = None  # "shed" | "tripped" when a 503 path
        srv.note_inflight(+1, self.connection)
        try:
            code = handle()
        finally:
            srv.note_inflight(-1, self.connection)
            secs = time.perf_counter() - t0
            trace = self._qtrace
            self._qtrace = None
            if trace is not None:
                status = (self._shed_status if self._shed_status
                          else ("error" if code >= 500 else "ok"))
                trace.route = self._route_name
                trace.finish(status=status, code=code)
                srv.trace_ring.offer(trace)
            srv.note_request(
                secs, code, route=self._route_name,
                shed=self._shed_status is not None, trace=trace,
            )

    def _resolve_route(self, path=None):
        """Route a query path: "/query" is the default route (single-DB
        servers and one-game fleets), "/query/<name>" a fleet game."""
        srv = self.server
        if path is None:
            path = self.path
        if path == "/query":
            if srv.default_route is not None:
                return srv.default_route
            return None
        if path.startswith("/query/"):
            return srv.routes.get(path[len("/query/"):])
        return None

    def _handle_get_query(self, parts) -> int:
        """GET /query[/<name>]?p=<pos>: one position, idempotent, with
        the edge-cache contract — ``ETag: "<epoch16>-<pos-hex>"`` +
        ``Cache-Control: public, max-age=...`` on every answer, and
        ``If-None-Match`` revalidation answered 304 with no lookup work
        at all. The ETag embeds the DB epoch (the manifest sha), so a
        rolling reload that swaps the DB flips every ETag at once: a
        CDN's cached body revalidates as stale and refetches — the
        response is immutable WHILE the epoch holds, never across it.
        """
        srv = self.server
        if srv.draining:
            self.close_connection = True
            self._shed_status = "shed"
            return self._send_json(
                503, {"error": "server is draining"},
                headers={"Retry-After": "1"},
            )
        route = self._resolve_route(parts.path)
        if route is not None:
            self._route_name = route.name or "default"
        if route is None:
            return self._send_json(
                404,
                {"error": f"no such path {parts.path!r}",
                 "games": sorted(n for n in srv.routes if n)},
            )
        raw = parse_qs(parts.query).get("p")
        if not raw or len(raw) != 1:
            return self._send_json(
                400, {"error": "GET /query needs exactly one "
                               "?p=<position>"},
            )
        reader = route.reader
        try:
            state = parse_position(reader.game, raw[0])
        except (ValueError, TypeError) as e:
            return self._send_json(400,
                                   {"error": f"invalid position ({e})"})
        # The validator: epoch prefix + the position in its one
        # canonical hex spelling (?p=12 and ?p=0xc revalidate the same
        # entry; distinct URLS may still cache distinct copies — the
        # body is identical, correctness never depends on the URL).
        etag = f'"{reader.epoch[:16]}-{state:x}"'
        cache_headers = {
            "ETag": etag,
            "Cache-Control": f"public, max-age={srv.query_max_age}",
        }
        inm = self.headers.get("If-None-Match", "")
        if inm.strip() == "*" or etag in inm:
            # Same epoch, same position: the client's copy is current.
            return self._send_status(304, cache_headers)
        answer = None
        with activate((self._qtrace,)):
            hit = srv.book_lookup(route, [state])
        if hit is not None and bool(hit[2][0]):
            bbest = int(hit[3][0])
            answer = (
                int(hit[0][0]), int(hit[1][0]), True,
                None if bbest == int(reader.game.sentinel) else bbest,
            )
        if answer is None:
            try:
                answer = route.batcher.submit(
                    [state], trace=self._qtrace
                )[0]
            except BatcherUnavailable as e:
                self._shed_status = (
                    "tripped" if isinstance(e, BatcherTripped) else "shed"
                )
                return self._send_json(
                    503, {"error": str(e)},
                    headers={"Retry-After": str(e.retry_after)},
                )
            except Exception as e:  # noqa: BLE001 - reader faults: 500,
                # uncached (no validator on an error body).
                return self._send_json(500,
                                       {"error": f"lookup failed: {e}"})
        value, rem, found, best = answer
        rec = {"position": hex(state), "found": bool(found)}
        if found:
            rec["value"] = value_name(value)
            rec["remoteness"] = int(rem)
            rec["best"] = None if best is None else hex(best)
        return self._send_json(
            200, {"game": reader.game.name, "results": [rec]},
            headers=cache_headers,
        )

    def _handle_post(self) -> int:
        srv = self.server
        if srv.draining:
            # Graceful shutdown: finish what is in flight, refuse new
            # work loudly so clients fail over instead of timing out.
            self.close_connection = True
            self._shed_status = "shed"
            return self._send_json(
                503, {"error": "server is draining"},
                headers={"Retry-After": "1"},
            )
        route = self._resolve_route()
        if route is not None:
            self._route_name = route.name or "default"
        if route is None:
            # The body (if any) is never read on this branch; its bytes
            # would desync the keep-alive socket (same guard as below).
            self.close_connection = True
            return self._send_json(
                404,
                {"error": f"no such path {self.path!r}",
                 "games": sorted(n for n in srv.routes if n)},
            )
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = -1
        if self.headers.get("Transfer-Encoding"):
            # Chunked bodies are not read; their bytes would desync the
            # keep-alive socket exactly like an undrained oversize body.
            length = -1
        if not 0 <= length <= _MAX_BODY_BYTES:
            # Refusing without reading the body leaves its bytes on the
            # keep-alive socket, where they would parse as the next
            # request line — drop the connection instead.
            self.close_connection = True
            return self._send_json(400, {"error": "bad Content-Length"})
        try:
            payload = json.loads(self.rfile.read(length) or b"{}")
            positions = payload["positions"]
            if not isinstance(positions, list):
                raise TypeError
        except (ValueError, KeyError, TypeError):
            # ValueError covers JSONDecodeError AND CPython's int-digit
            # limit on absurd JSON number literals — either way a 400,
            # never a handler traceback.
            return self._send_json(
                400,
                {"error": 'body must be {"positions": [int|"0x..", ...]}'},
            )
        if len(positions) > _MAX_POSITIONS_PER_REQUEST:
            return self._send_json(
                400,
                {"error": f"at most {_MAX_POSITIONS_PER_REQUEST} positions "
                          "per request"},
            )
        reader = route.reader
        parsed: list = []  # (echo, packed int) or (echo, error string)
        for p in positions:
            try:
                parsed.append((p, parse_position(reader.game, p)))
            except (ValueError, TypeError) as e:
                parsed.append((p, f"invalid position ({e})"))
        states = [s for _, s in parsed if isinstance(s, int)]
        # Resident-book short path: positions the opening book answers
        # never reach the batcher (no coalescing wait, no canonicalize,
        # no block decode); only the remainder is submitted.
        with activate((self._qtrace,)):
            book = srv.book_lookup(route, states)
        if book is not None:
            pending = [s for i, s in enumerate(states) if not book[2][i]]
        else:
            pending = states
        try:
            answers = iter(route.batcher.submit(pending,
                                                trace=self._qtrace))
        except BatcherUnavailable as e:
            # Genuinely transient (shutdown, deadline, shed, breaker):
            # 503 + Retry-After so a well-behaved client backs off
            # instead of hammering a recovering server.
            self._shed_status = (
                "tripped" if isinstance(e, BatcherTripped) else "shed"
            )
            return self._send_json(
                503, {"error": str(e)},
                headers={"Retry-After": str(e.retry_after)},
            )
        except Exception as e:  # noqa: BLE001 - reader faults re-raise in
            # submit (a truncated shard, an unreadable mmap): answer 500
            # rather than dropping the connection mid-response.
            return self._send_json(500, {"error": f"lookup failed: {e}"})
        sentinel = int(reader.game.sentinel)
        results = []
        j = 0  # index into states (and the book arrays)
        for echo, s in parsed:
            if not isinstance(s, int):
                results.append({"position": echo, "error": s})
                continue
            if book is not None and book[2][j]:
                value, rem, found = (
                    int(book[0][j]), int(book[1][j]), True,
                )
                best = int(book[3][j])
                best = None if best == sentinel else best
            else:
                value, rem, found, best = next(answers)
            j += 1
            rec = {"position": hex(s), "found": found}
            if found:
                rec["value"] = value_name(value)
                rec["remoteness"] = rem
                rec["best"] = None if best is None else hex(best)
            results.append(rec)
        return self._send_json(
            200, {"game": reader.game.name, "results": results}
        )


class _QueryHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    request_queue_size = LISTEN_BACKLOG

    def __init__(self, addr, routes, registry=None, listen_sock=None,
                 worker_id=None):
        if listen_sock is None:
            super().__init__(addr, _Handler)
        else:
            # Fleet worker: adopt the supervisor's pre-bound, already-
            # listening socket instead of binding — N workers share one
            # accept queue, so the kernel spreads connections across
            # them and a draining worker's unaccepted backlog is simply
            # picked up by its siblings.
            super().__init__(addr, _Handler, bind_and_activate=False)
            # TCPServer.__init__ unconditionally created a socket we
            # will never bind; close it rather than leak one fd per
            # worker for the process lifetime.
            self.socket.close()
            self.socket = listen_sock
            self.server_address = listen_sock.getsockname()
            # server_bind would also resolve these; it never ran.
            self.server_name = self.server_address[0]
            self.server_port = self.server_address[1]
        #: name -> _Route; "" is the default (bare /query) route.
        self.routes = dict(routes)
        self.default_route = (
            next(iter(self.routes.values()))
            if len(self.routes) == 1 else self.routes.get("")
        )
        self.worker_id = worker_id
        self.registry = registry or default_registry()
        #: flipped by QueryServer.begin_drain(): /healthz says so and new
        #: POST /query work answers 503 while in-flight requests finish.
        self.draining = False
        self._stats_lock = threading.Lock()
        self._t0 = time.time()
        self._http_requests = 0  # guarded-by: _stats_lock
        self._http_errors = 0  # guarded-by: _stats_lock
        self._http_client_aborts = 0  # guarded-by: _stats_lock
        # POSTs between entry and response written
        self._inflight = 0  # guarded-by: _stats_lock
        # Open connections -> POSTs in flight on each. Tracking them is
        # what lets stop() wake handler threads parked in recv on IDLE
        # keep-alive sockets instead of waiting out their 30 s socket
        # timeout one by one during a supervisor-initiated drain.
        self._conns = {}  # guarded-by: _stats_lock
        self._latency_total = 0.0  # guarded-by: _stats_lock
        self._latency_max = 0.0  # guarded-by: _stats_lock
        # server_start_time makes uptime derivable from any scrape
        # (time() - server_start_time), the Prometheus convention.
        self.registry.gauge(
            "gamesman_server_start_time_seconds",
            "unix time the query server bound its port",
        ).set(self._t0)
        self._m_requests = self.registry.counter(
            "gamesman_http_requests_total", "POST requests, rejects included"
        )
        self._m_errors = self.registry.counter(
            "gamesman_http_errors_total", "POST requests answered >= 400"
        )
        self._m_latency = self.registry.histogram(
            "gamesman_http_request_seconds",
            "wall seconds per POST request, parse to response",
        )
        self._m_client_aborts = self.registry.counter(
            "gamesman_http_client_aborts_total",
            "responses abandoned by a disconnecting client "
            "(BrokenPipe/ConnectionReset on the write path)",
        )
        #: Tail-sampled per-worker query traces (GET /traces) and the
        #: declared availability/latency objectives. Both read their
        #: knobs from GAMESMAN_TRACE_* / GAMESMAN_SLO_* env.
        self.trace_ring = TraceRing(registry=self.registry)
        self.slo = SloEngine(registry=self.registry)
        #: max-age of the GET /query edge-cache contract; the ETag's
        #: epoch prefix is what actually bounds staleness across a
        #: reload (docs/SERVING.md "Hot path").
        self.query_max_age = env_int("GAMESMAN_QUERY_MAX_AGE_SECS", 3600)
        #: route name -> gamesman_book_hits_total counter. Registry
        #: lookups validate the metric name per call; the book path is
        #: hot enough that we resolve each route's counter once.
        self._book_counters = {}

    def _book_counter(self, route):
        counter = self._book_counters.get(route.name)
        if counter is None:
            counter = self.registry.counter(
                "gamesman_book_hits_total",
                "queries answered from the resident opening book "
                "(no batcher, no canonicalize, no block decode)",
                route=route.name or "default",
            )
            self._book_counters[route.name] = counter
        return counter

    def book_lookup(self, route, states):
        """Probe a route's resident opening book (db/book.py) -> the
        (values, remoteness, found, best) arrays, or None when the
        route serves no book. Counted per route; the ``book`` span
        lands on whatever trace the caller has activated."""
        book = getattr(route.reader, "book", None)
        if book is None or not states:
            return None
        with qspan("book", queries=len(states)) as sp:
            out = book.lookup(np.asarray(
                states, dtype=route.reader.game.state_dtype
            ))
            hits = int(out[2].sum())
            if sp is not None:
                sp["hits"] = hits
        if hits:
            self._book_counter(route).inc(hits)
        return out

    # Single-DB back-compat aliases: most callers (tests, the batcher's
    # half-open probe wiring) speak "the reader"/"the batcher".
    @property
    def reader(self):
        route = self.default_route or next(iter(self.routes.values()))
        return route.reader

    @property
    def batcher(self):
        route = self.default_route or next(iter(self.routes.values()))
        return route.batcher

    def health_status(self) -> str:
        if self.draining:
            return "draining"
        for route in self.routes.values():
            if route.batcher is not None and route.batcher.state != "ok":
                return "degraded"
        if self.slo.fast_burning():
            # An SLO fast-burn is pre-emptive degradation: the error
            # budget is being spent ~14x faster than sustainable, so go
            # amber BEFORE it is gone. The fleet supervisor already
            # propagates a degraded worker beat into fleet /status.
            return "degraded"
        return "ok"

    # wire: producer
    def healthz(self) -> dict:
        """The /healthz payload. Three states, one field: "ok" (serving
        normally), "degraded" (some reader's circuit breaker open —
        misses answer 503, cache hits still serve), "draining" (shutdown
        in progress; stop routing here). Always 200: a load balancer
        reads the body, an operator reads it too. Single-DB servers keep
        the legacy flat identity fields; every server also carries the
        per-game "games" map (the fleet view)."""
        games = {}
        for name, route in self.routes.items():
            games[name or "default"] = {
                "game": route.reader.game.name,
                "spec": route.reader.manifest["spec"],
                "positions": route.reader.num_positions,
                "levels": len(route.reader.levels),
                "breaker": route.batcher.state
                if route.batcher is not None else "ok",
            }
        payload = {
            "status": self.health_status(),
            "games": games,
            "slo": self.slo.snapshot(),
        }
        if self.worker_id is not None:
            payload["worker"] = self.worker_id
        if self.default_route is not None:
            r = self.default_route
            payload.update({
                "breaker": r.batcher.state if r.batcher is not None
                else "ok",
                "game": r.reader.game.name,
                "spec": r.reader.manifest["spec"],
                "positions": r.reader.num_positions,
                "levels": len(r.reader.levels),
            })
        return payload

    def note_client_abort(self) -> None:
        with self._stats_lock:
            self._http_client_aborts += 1
        self._m_client_aborts.inc()

    def conn_opened(self, conn) -> None:
        with self._stats_lock:
            self._conns[conn] = 0

    def conn_closed(self, conn) -> None:
        with self._stats_lock:
            self._conns.pop(conn, None)

    def note_inflight(self, delta: int, conn=None) -> None:
        with self._stats_lock:
            self._inflight += delta
            if conn is not None and conn in self._conns:
                self._conns[conn] += delta

    def shutdown_idle_conns(self, force: bool = False) -> int:
        """Shut down tracked connections with no POST in flight (all of
        them when ``force``), waking their handler threads out of the
        blocking keep-alive read immediately. Returns how many were
        closed. A keep-alive client sees a clean connection close
        between requests — the normal HTTP/1.1 end-of-keep-alive, not a
        failed request."""
        with self._stats_lock:
            victims = [
                c for c, inflight in self._conns.items()
                if force or inflight == 0
            ]
        for conn in victims:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already dying; the handler's read still returns
        return len(victims)

    @property
    def inflight(self) -> int:
        with self._stats_lock:
            return self._inflight

    def handle_error(self, request, client_address):
        """Client aborts escaping outside _send_text (e.g. during the
        request read) are counted, not dumped as thread tracebacks;
        everything else keeps the stdlib report."""
        exc = sys.exc_info()[1]
        if isinstance(exc, CLIENT_ABORT_ERRORS):
            self.note_client_abort()
            return
        super().handle_error(request, client_address)

    def note_request(self, secs: float, code: int, *, route: str = "",
                     shed: bool = False, trace=None) -> None:
        with self._stats_lock:
            self._http_requests += 1
            if code >= 400:
                self._http_errors += 1
            self._latency_total += secs
            self._latency_max = max(self._latency_max, secs)
        self._m_requests.inc()
        if code >= 400:
            self._m_errors.inc()
        # Exemplar: the trace id of the last SLOW observation rides the
        # histogram (OpenMetrics style) so a scrape's p99 bucket links
        # straight to a concrete kept trace.
        exemplar = None
        if trace is not None and secs * 1e3 >= self.trace_ring.slow_ms:
            exemplar = {"trace_id": trace.trace_id}
        self._m_latency.observe(secs, exemplar=exemplar)
        if route:
            self.registry.histogram(
                "gamesman_http_route_request_seconds",
                "wall seconds per POST request by route",
                route=route,
            ).observe(secs, exemplar=exemplar)
            self.slo.observe(route, secs, code, shed=shed)

    def metrics(self) -> dict:
        with self._stats_lock:
            n = self._http_requests
            errors = self._http_errors
            aborts = self._http_client_aborts
            mean = self._latency_total / max(n, 1)
            peak = self._latency_max
            uptime = time.time() - self._t0
        payload = {
            "server_start_time": self._t0,
            "uptime_secs": uptime,
            "status": self.health_status(),
            "http_requests": n,
            "http_errors": errors,
            "http_client_aborts": aborts,
            "latency_mean_ms": mean * 1e3,
            "latency_max_ms": peak * 1e3,
        }
        if self.worker_id is not None:
            payload["worker"] = self.worker_id
        if len(self.routes) == 1:
            # Legacy single-DB shape: batcher counters flat in the dict.
            payload.update(self.batcher.metrics())
        else:
            payload["games"] = {
                (name or "default"): route.batcher.metrics()
                for name, route in self.routes.items()
                if route.batcher is not None
            }
        return payload


class QueryServer:
    """Owns the HTTP server + per-game batcher lifecycle.

    One positional ``reader`` serves a single DB on the default route
    (unchanged contract); ``readers={name: DbReader}`` serves a fleet —
    each game gets its own coalescing batcher (and so its own circuit
    breaker: one rotting DB degrades one route, not the fleet).

    port=0 binds an ephemeral port (tests); `.port` reports the bound
    one. ``listen_sock`` adopts a pre-bound, already-listening socket
    instead of binding (the supervised-worker path). Use `.start()` for
    a background thread (in-process tests, workers) or
    `.serve_forever()` to block (the CLI `serve` subcommand).
    """

    def __init__(self, reader=None, *, readers=None,
                 host: str = "127.0.0.1", port: int = 0,
                 listen_sock=None, worker_id=None,
                 window: float = 0.002, cache_size: int = 65536,
                 max_queue: int = 1024, request_timeout: float | None = None,
                 breaker_threshold: int = 3, breaker_cooldown: float = 5.0,
                 logger=None, registry=None):
        if (reader is None) == (readers is None):
            raise ValueError("pass exactly one of reader= or readers=")
        routes = (
            {"": _Route("", reader)} if reader is not None
            else {name: _Route(name, r) for name, r in readers.items()}
        )
        if not routes:
            raise ValueError("readers= must name at least one DB")
        self.logger = logger
        self.registry = registry or default_registry()
        # Bind FIRST: a bind failure (port in use) must raise before any
        # batcher spawns its worker thread, or every failed construction
        # would leak unjoinable daemon threads.
        self._httpd = _QueryHTTPServer(
            (host, port), routes, self.registry,
            listen_sock=listen_sock, worker_id=worker_id,
        )
        for route in self._httpd.routes.values():
            route.batcher = Batcher(
                route.reader, window=window, cache_size=cache_size,
                max_queue=max_queue, request_timeout=request_timeout,
                breaker_threshold=breaker_threshold,
                breaker_cooldown=breaker_cooldown,
                logger=logger, registry=self.registry,
            )
        self._thread: threading.Thread | None = None

    @property
    def reader(self):
        return self._httpd.reader

    @property
    def batcher(self):
        return self._httpd.batcher

    @property
    def routes(self) -> dict:
        return self._httpd.routes

    @property
    def inflight(self) -> int:
        return self._httpd.inflight

    @property
    def trace_ring(self):
        return self._httpd.trace_ring

    @property
    def slo(self):
        return self._httpd.slo

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="gamesman-serve",
            daemon=True,
        )
        self._thread.start()

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def metrics(self) -> dict:
        return self._httpd.metrics()

    def healthz(self) -> dict:
        return self._httpd.healthz()

    def self_probe(self) -> None:
        """Warm-start self-probe: one REAL lookup of every routed game's
        initial position through the full batcher->reader path. Raises
        on any failure (a worker must not join the ready set answering
        from a path it has never exercised); as a side effect the
        canonicalize/expand kernels compile here, off the serving path,
        so the first client request never pays a cold compile."""
        for route in self._httpd.routes.values():
            out = route.batcher.submit(
                [int(route.reader.game.initial_state())]
            )
            if not out or not out[0][2]:
                raise RuntimeError(
                    f"self-probe: initial position of "
                    f"{route.reader.game.name!r} not found in its DB"
                )

    def begin_drain(self) -> None:
        """Flip /healthz to "draining" and 503 new queries while
        in-flight requests finish — the first half of a SIGTERM
        shutdown; stop() completes it."""
        self._httpd.draining = True

    def serve_stats(self) -> dict:
        """One summary record (phase ``serve_stats``): per-route
        estimated latency quantiles from the route histogram plus the
        SLO burn snapshot — the JSONL twin of /status, logged once at
        stop() and folded by tools/obs_report.py into the per-route
        serving table."""
        fam = self.registry.snapshot().get(
            "gamesman_http_route_request_seconds", {}
        )
        routes = {}
        for row in fam.get("values", ()):
            q = row.get("quantiles", {})
            routes[row["labels"].get("route", "default")] = {
                "count": row.get("count", 0),
                **{
                    f"{k}_ms": round(q[k] * 1e3, 3)
                    for k in ("p50", "p95", "p99")
                    if q.get(k) is not None
                },
            }
        slo = self.slo.snapshot()
        return {
            "phase": "serve_stats",
            "routes": routes,
            "slo": {
                "fast_burn": slo["fast_burn"],
                "p99_ms": slo["p99_ms"],
                "routes": slo["routes"],
            },
        }

    def stop(self) -> None:
        # Stop ACCEPTING first: a connection this server never accepted
        # is someone else's to answer (a fleet sibling's via the shared
        # accept queue; a load balancer's retry single-process). Flip
        # draining only AFTER the accepted requests got their grace —
        # a request the server chose to accept arrived before the drain
        # and deserves an answer, not a 503 from a batcher closed under
        # it (observed as rolling-reload request failures).
        self._httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # Grace: accepted requests reach and clear the still-open
        # batchers. inflight counts POSTs between entry and response
        # written; the settle re-check catches one accepted and parsed
        # but not yet counted. Keep-alive clients issuing NEW requests
        # during the grace are bounded by the deadline.
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if self._httpd.inflight == 0:
                time.sleep(0.05)
                if self._httpd.inflight == 0:
                    break
            else:
                time.sleep(0.01)
        self.begin_drain()
        # Requests still coalescing get one final flush (drain=True).
        for route in self._httpd.routes.values():
            route.batcher.close(drain=True)
        if self.logger is not None:
            # After the final flush so every answered request's latency
            # observation is in the histogram the quantiles summarize.
            self.logger.log(self.serve_stats())
        # Handler threads are daemons ThreadingHTTPServer never joins: a
        # process exit right after this call would kill them mid-write,
        # truncating the very responses the drain flushed. Two-step
        # teardown: (1) shut down IDLE keep-alive connections now —
        # their handler threads sit in a blocking recv waiting for a
        # next request that will never come, and without the nudge each
        # would pin the drain until its socket timeout; (2) bounded wait
        # for the in-flight POSTs to finish writing (their batch answers
        # arrived in the close(drain=True) above, so this is socket-
        # write time — milliseconds; the deadline only guards a hung
        # client), then force-close whatever remains.
        self._httpd.shutdown_idle_conns()
        deadline = time.monotonic() + 5.0
        while self._httpd.inflight > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        self._httpd.shutdown_idle_conns(force=True)
        self._httpd.server_close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
