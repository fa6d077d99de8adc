"""Torch port's single-process serving (serve/batcher, serve/server, the
reader's serving parts, store/shm) against the JAX package.

* The port's QueryServer answers every reachable nim 3-4-5 and
  tic-tac-toe position exactly as the reference's scalar oracle does
  (the ``tests/test_serve.py`` oracle queries), under concurrent load.
* Over HTTP, the port's server and the JAX package's, each on an
  ephemeral port over the SAME database directory (exported by the port
  with ``--device cpu``), return the same status codes, JSON bodies and
  headers (``ETag``, ``Cache-Control``, ``Content-Type``, 304s, 4xx) for
  the same requests, single-DB and multi-route, v1 and v2 + book. The
  fields that differ by nature are named in :data:`TIMING_FIELDS`.
* The shared-memory tier: round trip, epoch and eviction, a segment
  either package wrote read by the other, and the reader's epoch.
* ``verify_for_serving`` gives the reference's verdicts.
* ``serve.flush`` chaos: the same seeded schedule gives the same status
  codes in both servers; a wedged flush answers 503 within the deadline;
  a torch runtime error in the reader answers 500, never 503.
* The CLI's ``serve``: banner, answers and SIGTERM drain; ``--device
  cuda`` exits 2 without a card.

Everything is integers or exact JSON, so tolerance zero. Every server
and subprocess has a hard time limit of its own.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gamesmanmpi_tpu.core.values import value_name
from gamesmanmpi_tpu.db import DbReader as RefReader
from gamesmanmpi_tpu.db import check as ref_check
from gamesmanmpi_tpu.obs import MetricsRegistry as RefRegistry
from gamesmanmpi_tpu.resilience import faults as ref_faults
from gamesmanmpi_tpu.serve import QueryServer as RefServer
from gamesmanmpi_tpu.solve.oracle import oracle_solve
from gamesmanmpi_tpu.store.shm import ShmBlockCache as RefShm
from gamesmanmpi_tpu_torch import cli
from gamesmanmpi_tpu_torch.db import DbFormatError, DbReader, export_result
from gamesmanmpi_tpu_torch.db.book import build_book
from gamesmanmpi_tpu_torch.db.check import verify_for_serving
from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.obs import MetricsRegistry
from gamesmanmpi_tpu_torch.resilience import faults
from gamesmanmpi_tpu_torch.serve import Batcher, QueryServer
from gamesmanmpi_tpu_torch.solve.engine import Solver
from gamesmanmpi_tpu_torch.store import ShmBlockCache

from helpers import REF_GAMES, REPO, load_module

#: Response fields that differ between two servers by nature: wall
#: times, uptimes, trace ids and the SLO burn rates computed from them.
TIMING_FIELDS = ("slo", "server_start_time", "uptime_secs",
                 "latency_mean_ms", "latency_max_ms", "batch_secs_total",
                 "mean_batch_secs_ms", "traceparent")

#: Headers held equal between the two servers.
HEADERS = ("Content-Type", "ETag", "Cache-Control", "Retry-After")

SUB = "subtract:total=10,moves=1-2"
NIM = "nim:heaps=3-4-5"


@pytest.fixture(autouse=True)
def _disarmed():
    faults.clear()
    ref_faults.clear()
    yield
    faults.clear()
    ref_faults.clear()


def _export(spec, d, compress=False, book_plies=0):
    export_result(Solver(get_game(spec), device="cpu").solve(), d, spec,
                  compress=compress)
    if book_plies:
        build_book(d, book_plies, device="cpu")
    return d


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """Port-exported DBs: nim and tic-tac-toe v1, subtract v2 + book."""
    root = tmp_path_factory.mktemp("torch_serve")
    return {
        "nim": _export(NIM, root / "nim"),
        "ttt": _export("tictactoe", root / "ttt"),
        "sub2": _export(SUB, root / "sub2", compress=True, book_plies=3),
    }


def _oracle(name):
    return oracle_solve(load_module(REF_GAMES / name))[2]


def _request(url, payload=None, headers=None, raw=None, timeout=30):
    """-> (status, headers dict, body bytes); never raises on 4xx/5xx."""
    data = raw if raw is not None else (
        json.dumps(payload).encode() if payload is not None else None)
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method="POST" if data is not None
                                 else "GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post(url, payload, timeout=30):
    status, _, body = _request(url, payload, timeout=timeout)
    return status, json.loads(body)


def _strip(obj):
    """Drop TIMING_FIELDS recursively."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in TIMING_FIELDS}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _answer(status, headers, body):
    """One response in comparable form."""
    try:
        payload = _strip(json.loads(body)) if body else None
    except ValueError:
        payload = body.decode()
    return (status, {h: headers.get(h) for h in HEADERS}, payload)


# --------------------------------------------------------------- oracle


def _fire_concurrent(port, chunks):
    url = f"http://127.0.0.1:{port}/query"
    barrier = threading.Barrier(len(chunks))
    out = [None] * len(chunks)
    errors = []

    def worker(i, chunk):
        try:
            barrier.wait(timeout=30)
            status, body = _post(url, {"positions": chunk})
            assert status == 200
            out[i] = body
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i, c))
               for i, c in enumerate(chunks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    return out


@pytest.mark.parametrize("db,module", [("nim", "nim_345.py"),
                                       ("ttt", "tictactoe.py")])
def test_port_server_answers_the_oracle(dbs, db, module):
    oracle = _oracle(module)
    positions = sorted(oracle)
    with DbReader(dbs[db], device="cpu") as reader, QueryServer(
            reader, window=0.02, registry=MetricsRegistry()) as server:
        chunks = [[hex(p) for p in positions[i::6]] for i in range(6)]
        for _ in range(2):  # the second round answers from the cache
            bodies = _fire_concurrent(server.port, chunks)
            for chunk, body in zip(chunks, bodies):
                for q, rec in zip(chunk, body["results"]):
                    v, r = oracle[int(q, 0)]
                    assert (rec["found"], rec["value"],
                            rec["remoteness"]) == (True, value_name(v), r), q
        m = server.metrics()
        assert m["mean_batch_size"] > 1 and m["cache_hits"] >= len(positions)


# ------------------------------------------------- HTTP parity vs JAX


def _both(readers_port, readers_ref, **kw):
    """The port's and the JAX package's servers, each on its own
    registry; `readers_*` is one reader or a {name: reader} dict."""
    def build(cls, readers, reg):
        if isinstance(readers, dict):
            return cls(readers=readers, registry=reg, **kw)
        return cls(readers, registry=reg, **kw)

    return (build(QueryServer, readers_port, MetricsRegistry()),
            build(RefServer, readers_ref, RefRegistry()))


def _exchange(servers, requests):
    """Send each (path, payload, headers, raw) to both servers in turn;
    -> list of (port answer, reference answer)."""
    out = []
    for path, payload, headers, raw in requests:
        pair = []
        for s in servers:
            pair.append(_answer(*_request(
                f"http://127.0.0.1:{s.port}{path}", payload,
                headers=headers, raw=raw)))
        out.append((path, pair[0], pair[1]))
    return out


@pytest.mark.parametrize("db", ["nim", "sub2"])
def test_http_bodies_match_the_jax_server(dbs, db):
    d = dbs[db]
    port_reader, ref_reader = DbReader(d, device="cpu"), RefReader(d)
    assert port_reader.epoch == ref_reader.epoch
    game = port_reader.game
    rng = np.random.default_rng(5)
    positions = [int(game.initial_state())] + [
        int(x) for x in rng.integers(0, 1 << 12, size=40)]
    post = [hex(p) for p in positions] + ["zz", -3, 4.2, True, "0x5"]
    servers = _both(port_reader, ref_reader, window=0.001)
    try:
        for s in servers:
            s.start()
        first = [("/query", {"positions": post}, None, None),
                 ("/query", {"wrong": []}, None, None),
                 ("/query", None, None, b"{not json"),
                 ("/query", {"positions": "0x1"}, None, None),
                 ("/query/nope", {"positions": [1]}, None, None),
                 ("/nope", None, None, None),
                 ("/nope", {}, None, None),
                 ("/query?p=" + hex(positions[0]), None, None, None),
                 ("/query?p=10", None, None, None),
                 ("/query?p=zz", None, None, None),
                 ("/query", None, None, None),
                 ("/healthz", None, None, None)]
        got = _exchange(servers, first)
        for path, port_ans, ref_ans in got:
            assert port_ans == ref_ans, path
        etag = [a for p, a, _ in got if p == "/query?p=10"][0][1]["ETag"]
        assert etag and etag.startswith(f'"{port_reader.epoch[:16]}-')
        again = _exchange(servers, [
            ("/query?p=10", None, {"If-None-Match": etag}, None),
            ("/query?p=10", None, {"If-None-Match": "*"}, None),
            ("/query?p=9", None, {"If-None-Match": etag}, None),
            ("/query?p=10", None, {"If-None-Match": '"stale-a"'}, None)])
        for path, port_ans, ref_ans in again:
            assert port_ans == ref_ans, path
        assert again[0][1][0] == 304 and again[0][1][2] is None
        # The counters' and traces' shapes: same keys, same families.
        shapes = []
        for s in servers:
            base = f"http://127.0.0.1:{s.port}"
            m = json.loads(_request(base + "/metrics.json")[2])
            tr = json.loads(_request(base + "/traces")[2])
            text = _request(base + "/metrics")[2].decode()
            fams = sorted(ln for ln in text.splitlines()
                          if ln.startswith("# TYPE"))
            shapes.append((sorted(m), sorted(tr), fams))
        assert shapes[0] == shapes[1]
    finally:
        for s in servers:
            s.stop()
        port_reader.close()
        ref_reader.close()


def test_multi_route_bodies_match_the_jax_server(dbs):
    port = {"nim": DbReader(dbs["nim"], device="cpu"),
            "sub": DbReader(dbs["sub2"], device="cpu")}
    ref = {"nim": RefReader(dbs["nim"]), "sub": RefReader(dbs["sub2"])}
    servers = _both(port, ref, window=0.001)
    try:
        for s in servers:
            s.start()
        reqs = [("/query/nim", {"positions": [int(port["nim"].game
                                                  .initial_state()), 5]},
                 None, None),
                ("/query/sub", {"positions": [10, 9, 1, 0]}, None, None),
                ("/query", {"positions": [1]}, None, None),
                ("/query/chess", {"positions": [1]}, None, None),
                ("/query/sub?p=10", None, None, None),
                ("/healthz", None, None, None)]
        for path, port_ans, ref_ans in _exchange(servers, reqs):
            assert port_ans == ref_ans, path
    finally:
        for s in servers:
            s.stop()
        for r in (*port.values(), *ref.values()):
            r.close()


def test_book_short_path_and_counters(dbs):
    with DbReader(dbs["sub2"], device="cpu") as reader:
        assert reader.book is not None
        reg = MetricsRegistry()
        with QueryServer(reader, registry=reg) as server:
            base = f"http://127.0.0.1:{server.port}"
            for p in (10, 9, 8, 10):
                assert _request(f"{base}/query?p={p}")[0] == 200
            text = _request(base + "/metrics")[2].decode()
        hits = re.search(r"^gamesman_book_hits_total\S* (\S+)$", text, re.M)
        assert hits and float(hits.group(1)) >= 4


def test_device_none_reader_refuses_to_answer(dbs):
    with DbReader(dbs["nim"], device=None) as reader:
        assert reader.device is None and reader.num_positions > 0
        with pytest.raises(ValueError, match="without a device"):
            reader.lookup([1])


# ------------------------------------------------------ shared memory


def _payload_for(key, salt=0):
    dev, ino, block = key
    base = (dev * 1000003 + ino * 101 + block * 7 + salt) % (1 << 31)
    keys = np.arange(16, dtype=np.uint64) + np.uint64(base)
    cells = np.arange(16, dtype=np.uint32) * np.uint32(3) + np.uint32(
        base % 97)
    return keys, cells


def test_shm_roundtrip_epoch_and_eviction():
    cache = ShmBlockCache.create(f"gmtt-{os.getpid()}-rt", slot_bytes=4096,
                                 budget_bytes=1 << 20)
    try:
        key = (5, 42, 7)
        keys, cells = _payload_for(key)
        assert cache.get(key, "epochA") is None
        assert cache.put(key, "epochA", keys, cells) is True
        hit = cache.get(key, "epochA")
        np.testing.assert_array_equal(hit[0], keys)
        np.testing.assert_array_equal(hit[1], cells)
        assert cache.put(key, "epochA", keys, cells) is False
        assert cache.get(key, "epochB") is None
        assert cache.put(key, "epochB", keys, cells) is True
        assert cache.get(key, "epochA") is None
        big = np.zeros(4096, dtype=np.uint64)
        assert cache.put((1, 1, 1), "epochA", big, big) is False
        st = cache.stats()
        assert st["stores"] == 2 and st["hits"] == 1
        assert st["evictions"] >= 1
    finally:
        cache.unlink()
    with pytest.raises(ValueError):
        ShmBlockCache.create("gmtt-tiny", slot_bytes=1 << 20,
                             budget_bytes=4096)


@pytest.mark.parametrize("writer,reader", [(ShmBlockCache, RefShm),
                                           (RefShm, ShmBlockCache)])
def test_shm_segment_is_shared_with_the_reference(writer, reader):
    """One segment layout: either package attaches the other's segment
    and reads its blocks; an epoch mismatch is a miss in both."""
    seg = writer.create(f"gmtt-{os.getpid()}-x", slot_bytes=1024,
                        budget_bytes=64 << 10)
    try:
        keys = {(3, 9, b): _payload_for((3, 9, b)) for b in range(8)}
        for k, (kk, cc) in keys.items():
            seg.put(k, "e1", kk, cc)
        other = reader.attach(seg.name)
        try:
            for k, (kk, cc) in keys.items():
                got = other.get(k, "e1")
                if got is not None:  # a collision may have evicted it
                    np.testing.assert_array_equal(got[0], kk)
                    np.testing.assert_array_equal(got[1], cc)
                assert other.get(k, "e2") is None
            assert other.stats()["hits"] >= 1
        finally:
            other.close()
    finally:
        seg.unlink()


def test_reader_publishes_decoded_blocks_to_shm(dbs, monkeypatch):
    """A v2 reader with an shm tier: the first reader decodes and
    publishes, a second reader (a sibling worker) reads the published
    block instead of decoding it; both answer identically. Each reader
    gets a private store (GAMESMAN_DB_CACHE_MB), so neither finds the
    blocks already decoded in this process's shared store."""
    monkeypatch.setenv("GAMESMAN_DB_CACHE_MB", "1")
    seg = ShmBlockCache.create(f"gmtt-{os.getpid()}-rd", slot_bytes=1 << 16,
                               budget_bytes=8 << 20)
    try:
        pos = list(range(11))
        r1 = DbReader(dbs["sub2"], device="cpu", shm=seg,
                      registry=MetricsRegistry())
        with r1:
            want = r1.lookup_best(pos)
        stores = seg.stats()["stores"]
        assert stores >= 1
        attached = ShmBlockCache.attach(seg.name)
        r2 = DbReader(dbs["sub2"], device="cpu", shm=attached,
                      registry=MetricsRegistry())
        with r2:
            got = r2.lookup_best(pos)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)
        assert attached.stats()["hits"] >= 1
        assert seg.stats()["stores"] == stores  # no second publish
        attached.close()
    finally:
        seg.unlink()


def test_private_db_cache_is_labeled(dbs, monkeypatch):
    monkeypatch.setenv("GAMESMAN_DB_CACHE_MB", "1")
    reg = MetricsRegistry()
    with DbReader(dbs["sub2"], device="cpu", registry=reg) as reader:
        reader.lookup(list(range(11)))
        reader.lookup(list(range(11)))
        assert reader._private_store
    text = reg.render_prometheus()
    name = dbs["sub2"].name
    assert f'gamesman_store_cache_misses_total{{db="{name}"}}' in text
    assert f'gamesman_db_cache_hits_total{{db="{name}"}}' in text


# --------------------------------------------------- verify_for_serving


def test_verify_for_serving_matches_the_reference(dbs, tmp_path,
                                                  monkeypatch):
    d = dbs["sub2"]
    assert verify_for_serving(d) is True
    assert ref_check.verify_for_serving(d) is True
    monkeypatch.setenv("GAMESMAN_SERVE_VERIFY", "0")
    assert verify_for_serving(d) is False
    monkeypatch.delenv("GAMESMAN_SERVE_VERIFY")
    bad = tmp_path / "bad"
    _export(NIM, bad)
    victim = sorted(bad.glob("level_*.cells.npy"))[-1]
    raw = bytearray(victim.read_bytes())
    raw[-1] ^= 0xFF
    victim.write_bytes(bytes(raw))
    with pytest.raises(DbFormatError) as port_err:
        verify_for_serving(bad)
    with pytest.raises(ref_check.DbFormatError) as ref_err:
        ref_check.verify_for_serving(bad)
    assert str(port_err.value) == str(ref_err.value)


# ---------------------------------------------------- serve.flush chaos


def test_flush_chaos_gives_the_references_codes(dbs):
    """The same seeded coin-flip at serve.flush: sequential single
    requests (no cache, breaker out of the way) get the same codes from
    both servers — 500 for an injected reader fault, 200 otherwise."""
    spec = "serve.flush:transient:p0.5@7"
    codes = []
    for mod, cls, rcls, reg in ((ref_faults, RefServer, RefReader,
                                 RefRegistry),
                                (faults, QueryServer, DbReader,
                                 MetricsRegistry)):
        reader = (rcls(dbs["nim"], device="cpu") if rcls is DbReader
                  else rcls(dbs["nim"]))
        mod.configure(spec)
        seq = []
        with reader, cls(reader, window=0.0005, cache_size=0,
                         breaker_threshold=1000, registry=reg()) as srv:
            for p in range(12):
                seq.append(_request(f"http://127.0.0.1:{srv.port}/query",
                                    {"positions": [p + 1]})[0])
        mod.clear()
        codes.append(seq)
    assert codes[0] == codes[1]
    assert 500 in codes[1] and 200 in codes[1]


def test_wedged_flush_answers_503_within_the_deadline(dbs):
    faults.configure("serve.flush:delay=0.5:always")
    with DbReader(dbs["nim"], device="cpu") as reader, QueryServer(
            reader, window=0.001, cache_size=0, request_timeout=0.05,
            registry=MetricsRegistry()) as server:
        status, headers, _ = _request(
            f"http://127.0.0.1:{server.port}/query", {"positions": [1]},
            timeout=10)
        assert status == 503 and headers.get("Retry-After")
        assert server.metrics()["timeouts"] >= 1


def test_torch_runtime_error_is_a_reader_fault_not_503(dbs, monkeypatch):
    """A device error in the reader (torch raises RuntimeError) is a 500
    and counts toward the breaker; it is never dressed up as a
    retryable 503."""
    with DbReader(dbs["nim"], device="cpu") as reader:
        def broken(_):
            raise torch.cuda.OutOfMemoryError("CUDA error: out of memory")

        monkeypatch.setattr(reader, "lookup_best", broken)
        batcher = Batcher(reader, window=0.001, cache_size=0,
                          breaker_threshold=5, registry=MetricsRegistry())
        try:
            with pytest.raises(RuntimeError, match="CUDA error"):
                batcher.submit([1])
            assert batcher.metrics()["reader_faults"] == 1
        finally:
            batcher.close()
        with QueryServer(reader, window=0.001, cache_size=0,
                         registry=MetricsRegistry()) as server:
            status = _request(f"http://127.0.0.1:{server.port}/query",
                              {"positions": [1]})[0]
        assert status == 500


# ------------------------------------------------------------------ CLI


def test_cli_serve_answers_and_drains(dbs):
    proc = subprocess.Popen(
        [sys.executable, "-m", "gamesmanmpi_tpu_torch", "serve",
         str(dbs["sub2"]), "--device", "cpu", "--port", "0"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    watchdog = threading.Timer(120, proc.kill)  # no banner: killed
    watchdog.start()
    try:
        banner = proc.stdout.readline()
        watchdog.cancel()
        port = int(re.search(r"127\.0\.0\.1:(\d+)", banner).group(1))
        assert banner.startswith("serving subtract_10_1-2 (11 positions)")
        status, body = _post(f"http://127.0.0.1:{port}/query",
                             {"positions": [10]})
        assert status == 200 and body["results"][0] == {
            "position": "0xa", "found": True, "value": "WIN",
            "remoteness": 7, "best": "0x9"}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "draining" in proc.stderr.read()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_cli_serve_usage_errors(dbs, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would serve")
    assert cli.main(["serve", str(dbs["nim"]), "--port", "0"]) == 2
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
    assert cli.main(["serve", str(dbs["nim"]), "--workers", "2",
                     "--port", "0"]) == 2
    assert cli.main(["serve"]) == 2
    assert "serve needs a DB directory" in capsys.readouterr().err
    assert cli.main(["serve", str(dbs["nim"]), "--device", "cpu",
                     "--fleet-manifest", "x.json"]) == 2
