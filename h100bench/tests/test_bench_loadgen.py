"""The open-loop generator: sends leave at their due times whatever the
server does, latency counts from the due time, and every seed offers the
same load."""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

import loadgen


class _Slow(BaseHTTPRequestHandler):
    delay = 0.2
    arrivals: list = []

    def do_POST(self):  # noqa: N802 - http.server API
        _Slow.arrivals.append(time.monotonic())
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        time.sleep(self.delay)
        out = json.dumps({"results": [
            {"position": p, "found": True, "value": "TIE", "remoteness": 1,
             "best": None} for p in body["positions"]]}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(out)))
        self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *a):
        pass


def test_sends_leave_on_schedule_and_latency_counts_from_due():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Slow)
    srv.daemon_threads = True
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    _Slow.arrivals = []
    try:
        due = np.arange(40) * 0.025  # 40/s for 1 s, each answered in 0.2 s
        batches = np.arange(80).reshape(40, 2)
        t0 = time.monotonic()
        rec = loadgen.run_open_loop("127.0.0.1", srv.server_address[1], due,
                                    batches, timeout=10, grace=10)
    finally:
        srv.shutdown()
        srv.server_close()
    assert rec["ok"] == 40 and rec["failed"] == 0
    # Open loop: eight requests are in flight at once, and none waits for
    # another; every send left within 20 ms of its due time.
    assert rec["send_lag_max_ms"] < 20
    offsets = np.array(sorted(_Slow.arrivals)) - t0
    assert offsets[-1] - offsets[0] < 1.2
    for (t_due, t_sent, t_done, kind, _), lat in zip(rec["records"],
                                                     rec["latencies"]):
        assert kind == "ok" and t_sent >= t_due - 1e-3
    assert min(rec["latencies"]) >= 0.2
    assert len(rec["answers"]) == 80


def test_a_refused_request_counts_as_failed_and_infinite():
    due = np.array([0.0])
    rec = loadgen.run_open_loop("127.0.0.1", 1, due, np.array([[5]]),
                                timeout=2, grace=5)
    assert rec["failed"] == 1 and rec["dropped"] == 1
    assert rec["latencies"] == [float("inf")]


def test_every_seed_offers_the_same_load_in_another_order():
    a = loadgen.arrivals(500, 10, np.random.default_rng(1))
    b = loadgen.arrivals(500, 10, np.random.default_rng(2))
    assert a.size == b.size == 5000
    assert 0 <= a.min() and a.max() < 10
    ga, gb = np.diff(np.append(a, 10)), np.diff(np.append(b, 10))
    assert np.allclose(np.sort(ga), np.sort(gb))
    assert not np.allclose(ga, gb)


def test_device_summary_unions_overlapping_activity():
    import devtrace

    ev = [("k1", "kernel", 0.0, 10.0), ("copy", "gpu_memcpy", 5.0, 10.0),
          ("k2", "kernel", 30.0, 5.0), ("Memcpy DtoH", "gpu_memcpy", 40.0, 2.0)]
    s = devtrace.summarize(ev, 1e-4)
    assert abs(s["busy_s"] - 22e-6) < 1e-12  # [0,15] + [30,35] + [40,42]
    assert s["gaps"] == {"copy -> k2": 15e-6, "k2 -> Memcpy DtoH": 5e-6}
    assert abs(s["copy_s"] - 2e-6) < 1e-12


def test_zipf_ranks_follow_the_exponent():
    r = loadgen.zipf_ranks(1 << 20, 1.1, 200000, np.random.default_rng(3))
    counts = np.bincount(r, minlength=8)
    # P(rank 0) / P(rank 1) = 2 ** 1.1
    assert abs(counts[0] / counts[1] - 2 ** 1.1) < 0.15
