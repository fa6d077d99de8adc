"""The torch port's consensus primitive (resilience/coordination.py, a
copy of the reference's with its imports changed): the reference's
consensus tests (tests/test_coordination.py) run against the port's
copy — real server and clients over loopback sockets, threads standing
in for ranks — plus the wire in both directions between the packages.
"""

import json
import socket
import threading
import time

import pytest

from gamesmanmpi_tpu.resilience import coordination as ref_coordination
from gamesmanmpi_tpu_torch.resilience import faults
from gamesmanmpi_tpu_torch.resilience.coordination import (
    ABORT,
    OK,
    RETRY,
    CoordinatedAbort,
    CoordinationError,
    Coordination,
    CoordinatorServer,
    EpochBarrier,
    coordination_from_env,
)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture
def server():
    srv = CoordinatorServer(2, deadline=5.0)
    yield srv
    srv.close()


def _clients(server, n=2, **kw):
    kw.setdefault("deadline", server.deadline)
    return [EpochBarrier(server.address, r, **kw) for r in range(n)]


def _propose_all(clients, tag, verdicts):
    """Every client proposes concurrently; return the per-rank decisions
    (None where the client raised — the exception lands in errs)."""
    decisions = [None] * len(clients)
    errs = [None] * len(clients)

    def run(i):
        try:
            decisions[i] = clients[i].propose(tag, verdicts[i])
        except Exception as e:  # noqa: BLE001 - recorded for asserts
            errs[i] = e

    threads = [
        threading.Thread(target=run, args=(i,), daemon=True)
        for i in range(len(clients))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return decisions, errs


# ------------------------------------------------------------ happy path


def test_unanimous_ok_resolves_ok(server):
    a, b = _clients(server)
    decisions, errs = _propose_all([a, b], "fwd:L3", [OK, OK])
    assert errs == [None, None]
    assert decisions == [OK, OK]


def test_one_retry_makes_everyone_retry(server):
    """A transient on ONE rank must turn into a retry on EVERY rank —
    the collective-safety property."""
    a, b = _clients(server)
    decisions, errs = _propose_all([a, b], "fwd:L3", [RETRY, OK])
    assert errs == [None, None]
    assert decisions == [RETRY, RETRY]


def test_abort_beats_retry(server):
    a, b = _clients(server)
    decisions, errs = _propose_all([a, b], "fwd:L3", [ABORT, RETRY])
    assert errs == [None, None]
    assert decisions == [ABORT, ABORT]


def test_sequence_numbers_keep_rounds_apart(server):
    """The same tag proposed twice is two DIFFERENT epochs (the client
    seq is folded in): round 2 must not be answered by round 1's
    resolution."""
    a, b = _clients(server)
    d1, _ = _propose_all([a, b], "fwd:L3", [OK, OK])
    d2, _ = _propose_all([a, b], "fwd:L3", [RETRY, OK])
    assert d1 == [OK, OK]
    assert d2 == [RETRY, RETRY]
    assert a.seq == b.seq == 2


def test_barrier_agreement_and_divergence():
    srv = CoordinatorServer(2, deadline=0.5)
    try:
        a, b = _clients(srv)
        # Identical tags meet at one epoch: both pass.
        errs = [None, None]

        def run(i, cl):
            try:
                cl.barrier("resume:abc123")
            except Exception as e:  # noqa: BLE001
                errs[i] = e

        ts = [threading.Thread(target=run, args=(i, c), daemon=True)
              for i, c in enumerate((a, b))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        assert errs == [None, None]
        # Divergent tags land on different epochs -> both rounds expire
        # -> both ranks raise CoordinatedAbort instead of one proceeding
        # alone on a forked view.
        def run2(i, cl, tag):
            try:
                cl.barrier(tag)
            except Exception as e:  # noqa: BLE001
                errs[i] = e

        ts = [
            threading.Thread(target=run2, args=(0, a, "resume:abc"),
                             daemon=True),
            threading.Thread(target=run2, args=(1, b, "resume:DEF"),
                             daemon=True),
        ]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        assert all(isinstance(e, CoordinatedAbort) for e in errs), errs
    finally:
        srv.close()


# -------------------------------------------------------- deadline expiry


def test_deadline_expiry_aborts_the_present_rank():
    """A peer that never arrives (dead or wedged) must not hold the
    fleet: the round resolves ABORT at the deadline, and the waiting
    rank gets the answer within ~the deadline, not a hang."""
    srv = CoordinatorServer(2, deadline=0.3)
    try:
        (a,) = _clients(srv, n=1)
        t0 = time.monotonic()
        decision = a.propose("fwd:L9", OK)
        elapsed = time.monotonic() - t0
        assert decision == ABORT
        assert elapsed < 5.0  # resolved by the sweep, not the socket belt
    finally:
        srv.close()


def test_late_joiner_of_timed_out_round_aborts():
    """The laggard shows up after its peers gave up: it must abort too
    (reason 'late'), not proceed alone on a resolved-by-timeout round."""
    srv = CoordinatorServer(2, deadline=0.2)
    try:
        a, b = _clients(srv)
        assert a.propose("fwd:L1", OK) == ABORT  # round timed out
        # b's seq advances to the SAME epoch key; raw wire so the reason
        # is visible (propose() only returns the decision).
        b.seq += 1
        with socket.create_connection((srv.host, srv.port), timeout=5) as c:
            c.sendall((json.dumps({
                "op": "propose", "epoch": f"{b.seq}:fwd:L1", "rank": 1,
                "verdict": OK,
            }) + "\n").encode())
            reply = json.loads(c.makefile().readline())
        assert reply == {"decision": ABORT, "reason": "late"}
    finally:
        srv.close()


def test_late_joiner_of_consensus_round_gets_recorded_decision():
    """A rank that arrives AFTER a round resolved by full consensus gets
    the recorded decision — it was merely slow to ask, not absent."""
    srv = CoordinatorServer(1, deadline=5.0)  # world 1: instant rounds
    try:
        (a,) = _clients(srv, n=1)
        assert a.propose("fwd:L1", RETRY) == RETRY
        with socket.create_connection((srv.host, srv.port), timeout=5) as c:
            c.sendall((json.dumps({
                "op": "propose", "epoch": "1:fwd:L1", "rank": 0,
                "verdict": OK,
            }) + "\n").encode())
            reply = json.loads(c.makefile().readline())
        assert reply == {"decision": RETRY, "reason": "consensus"}
    finally:
        srv.close()


# ------------------------------------------------------- coordinator death


def test_coordinator_death_raises_within_deadline():
    """close() while participants are parked in a round: every one of
    them raises CoordinationError promptly (EOF on the round socket) —
    the failure mode is an error, never a hang."""
    srv = CoordinatorServer(3, deadline=30.0)
    clients = _clients(srv, n=2, deadline=30.0)
    errs = [None, None]

    def run(i):
        try:
            clients[i].propose("fwd:L2", OK)
        except Exception as e:  # noqa: BLE001
            errs[i] = e

    ts = [threading.Thread(target=run, args=(i,), daemon=True)
          for i in range(2)]
    for t in ts:
        t.start()
    time.sleep(0.3)  # both proposals parked (world is 3, only 2 arrive)
    t0 = time.monotonic()
    srv.close()
    for t in ts:
        t.join(timeout=10)
    assert time.monotonic() - t0 < 10
    assert all(isinstance(e, CoordinationError) for e in errs), errs


def test_dead_address_raises_not_hangs():
    with socket.socket() as s:  # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cl = EpochBarrier(f"127.0.0.1:{port}", 0, deadline=1.0,
                      connect_timeout=0.5)
    t0 = time.monotonic()
    with pytest.raises(CoordinationError):
        cl.propose("fwd:L1", OK)
    assert time.monotonic() - t0 < 5


def test_junk_reply_is_an_error():
    """A coordinator replying garbage must not be interpreted as a
    decision."""
    srv_sock = socket.socket()
    srv_sock.bind(("127.0.0.1", 0))
    srv_sock.listen(1)
    port = srv_sock.getsockname()[1]

    def bad_server():
        conn, _ = srv_sock.accept()
        conn.recv(4096)
        conn.sendall(b'{"decision": "frobnicate"}\n')
        conn.close()

    t = threading.Thread(target=bad_server, daemon=True)
    t.start()
    try:
        cl = EpochBarrier(f"127.0.0.1:{port}", 0, deadline=2.0)
        with pytest.raises(CoordinationError):
            cl.propose("fwd:L1", OK)
    finally:
        srv_sock.close()


# --------------------------------------------------- fault points & env


def test_fault_points_fire_in_client_paths(server):
    """coord.handshake fires on dial, coord.barrier on every proposal —
    the distributed chaos matrix (tests/test_resilience.py) arms these."""
    (a,) = _clients(server, n=1)
    faults.configure("coord.handshake:transient:1")
    with pytest.raises(faults.TransientFault):
        a.propose("fwd:L1", OK)
    faults.clear()
    faults.configure("coord.barrier:fatal:1")
    with pytest.raises(faults.FatalFault):
        a.propose("fwd:L1", OK)


def test_coordination_from_env(monkeypatch):
    # Unconfigured or single-process: no handle — rank-local retry.
    monkeypatch.delenv("GAMESMAN_COORD_ADDR", raising=False)
    assert coordination_from_env(0, 2) is None
    monkeypatch.setenv("GAMESMAN_COORD_ADDR", "127.0.0.1:1")
    assert coordination_from_env(0, 1) is None
    # Rank 0 hosts the server at the configured port; peers dial it.
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("GAMESMAN_COORD_ADDR", f"127.0.0.1:{port}")
    monkeypatch.setenv("GAMESMAN_BARRIER_SECS", "7.5")
    c0 = coordination_from_env(0, 2)
    try:
        assert isinstance(c0, Coordination)
        assert c0.server is not None and c0.server.port == port
        assert c0.server.deadline == 7.5
        c1 = coordination_from_env(1, 2)
        assert c1.server is None and c1.client.rank == 1
        decisions, errs = _propose_all([c0, c1], "boot", [OK, OK])
        assert decisions == [OK, OK] and errs == [None, None]
    finally:
        c0.close()
        c0.close()  # idempotent


# ------------------------------------------------------------ interop


@pytest.mark.parametrize("server_cls,client_cls", [
    (CoordinatorServer, ref_coordination.EpochBarrier),
    (ref_coordination.CoordinatorServer, EpochBarrier),
], ids=["port-server", "reference-server"])
def test_wire_interop_with_the_reference(server_cls, client_cls):
    """One JSON line each way: a port rank and a reference rank agree in
    one round, whichever package hosts the coordinator."""
    srv = server_cls(2, deadline=5.0)
    try:
        clients = [client_cls(srv.address, 0, deadline=5.0),
                   EpochBarrier(srv.address, 1, deadline=5.0)]
        decisions, errs = _propose_all(clients, "fwd:L3", [RETRY, OK])
        assert errs == [None, None]
        assert decisions == [RETRY, RETRY]
    finally:
        srv.close()
