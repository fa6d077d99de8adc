"""Cross-rank retry/abort consensus: the epoch barrier (a copy of
gamesmanmpi_tpu/resilience/coordination.py with its imports changed).

A rank-local retry is right in one process and a latent deadlock in N:
one rank retrying a level step that contains an exchange while its peers
proceed into the collective wedges the job forever. The primitive here
is agreement: at every collective fault point all ranks either enter
together, retry together, or abort together.

It is deliberately tiny and torch-free (it must keep working when the
device runtime or the process group is the thing that is sick):

* :class:`CoordinatorServer` — a thread-based TCP service rank 0 hosts
  beside the process group's rendezvous. State is a table of *epoch
  rounds*; each participant proposes a verdict (``ok`` / ``retry`` /
  ``abort``) for an epoch and blocks until the round resolves:

  - all ``world`` ranks arrived → ``abort`` if anyone proposed abort,
    else ``retry`` if anyone proposed retry, else ``ok``;
  - the round's deadline expired first → ``abort`` (reason
    ``timeout``) to everyone present — a peer that never arrives (dead,
    wedged, or diverged onto a different epoch) must not hold the
    fleet;
  - a late joiner of an already-resolved round gets the recorded
    decision if the round resolved by consensus, and ``abort`` (reason
    ``late``) if it resolved by timeout — its peers have already given
    up on this epoch, so proceeding alone would desynchronize.

* :class:`EpochBarrier` — the per-rank client. ``propose()`` carries a
  monotonically increasing sequence number mixed into the epoch key:
  the sharded solve's control flow is replicated (counts are
  all-gathered), so every rank proposes the same epochs in the same
  order, and any divergence turns into mismatched epochs that resolve
  as coordinated timeouts instead of silent corruption. Coordinator
  death surfaces as a socket error → :class:`CoordinationError` within
  the deadline, never a hang.

Deadlines: ``GAMESMAN_BARRIER_SECS`` (round + client wait budget,
default 30 s). The wire format is one JSON line each way per proposal —
at one round per retried level step the coordinator is microscopic
next to the collectives it guards.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Dict, List, Optional

from gamesmanmpi_tpu_torch.obs import default_registry
from gamesmanmpi_tpu_torch.resilience import faults
from gamesmanmpi_tpu_torch.utils.env import env_float, env_opt

#: Verdicts a participant may propose / decisions a round may reach.
OK, RETRY, ABORT = "ok", "retry", "abort"

#: Resolved rounds kept for late joiners before being evicted.
_RESOLVED_KEEP = 1024


class CoordinationError(RuntimeError):
    """The consensus service failed (coordinator death, deadline, wire
    junk) — the caller must treat the step as a coordinated abort."""


class CoordinatedAbort(RuntimeError):
    """The fleet agreed to abort this step (a peer hit a fatal fault,
    timed out, or diverged). Checkpoint prefix is intact; a restarted
    run resumes."""


class _Round:
    """One epoch's in-flight state on the coordinator."""

    __slots__ = ("verdicts", "waiters", "t0", "decision", "reason")

    def __init__(self, now: float):
        self.verdicts: Dict[int, str] = {}
        self.waiters: List[socket.socket] = []
        self.t0 = now
        self.decision: Optional[str] = None
        self.reason = ""


def _decide(verdicts: Dict[int, str]) -> str:
    vs = set(verdicts.values())
    if ABORT in vs:
        return ABORT
    if RETRY in vs:
        return RETRY
    return OK


def _send_json(conn: socket.socket, obj: dict) -> None:
    conn.sendall((json.dumps(obj) + "\n").encode())


def _recv_line(conn: socket.socket, limit: int = 1 << 16) -> bytes:
    buf = bytearray()
    while not buf.endswith(b"\n"):
        chunk = conn.recv(4096)
        if not chunk:
            raise CoordinationError("connection closed mid-message")
        buf += chunk
        if len(buf) > limit:
            raise CoordinationError("oversized coordination message")
    return bytes(buf)


class CoordinatorServer:
    """Rank 0's consensus service (daemon threads, one per connection).

    ``world`` is the participant count; a round resolves when all
    ``world`` ranks proposed, or at ``deadline`` seconds after its first
    proposal, whichever is sooner.
    """

    def __init__(self, world: int, *, host: str = "127.0.0.1",
                 port: int = 0, deadline: float = 30.0,
                 clock=time.monotonic):
        if world < 1:
            raise ValueError("world size must be >= 1")
        self.world = int(world)
        self.deadline = float(deadline)
        self._clock = clock
        self._lock = threading.Lock()
        self._rounds: Dict[str, _Round] = {}  # guarded-by: _lock
        self._resolved: Dict[str, tuple] = {}  # guarded-by: _lock
        #: rank -> announced service address (the address book the live
        #: status fleet scraper reads; ISSUE 15). guarded-by: _lock
        self._peers: Dict[int, str] = {}
        self._closed = False
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(max(8, 2 * world))
        self.host, self.port = self._sock.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="gamesman-coord-accept",
            daemon=True,
        )
        self._accept_thread.start()
        self._sweep_thread = threading.Thread(
            target=self._sweep_loop, name="gamesman-coord-sweep",
            daemon=True,
        )
        self._sweep_thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def close(self) -> None:
        with self._lock:
            self._closed = True
            pending = [
                (r, w) for r in self._rounds.values() for w in r.waiters
            ]
            self._rounds.clear()
        for _, w in pending:
            try:
                w.close()  # waiters see EOF -> CoordinationError
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass

    # --------------------------------------------------------------- serving

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:  # closed
                return
            threading.Thread(
                target=self._serve_one, args=(conn,),
                name="gamesman-coord-conn", daemon=True,
            ).start()

    # wire: producer, consumer
    def _serve_one(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(self.deadline + 5.0)
            req = json.loads(_recv_line(conn).decode())
            if req.get("op") == "ping":
                _send_json(conn, {"ok": True, "world": self.world})
                conn.close()
                return
            if req.get("op") == "announce":
                # Address-book registration (one line, no round): rank i
                # publishes where its /status endpoint listens so rank
                # 0's fleet-merged status view can scrape it.
                with self._lock:
                    self._peers[int(req["rank"])] = str(req["addr"])
                _send_json(conn, {"ok": True})
                conn.close()
                return
            if req.get("op") == "peers":
                with self._lock:
                    peers = {str(r): a for r, a in self._peers.items()}
                _send_json(conn, {"ok": True, "peers": peers})
                conn.close()
                return
            if req.get("op") != "propose":
                _send_json(conn, {"error": "unknown op"})
                conn.close()
                return
            self._propose(conn, str(req["epoch"]), int(req["rank"]),
                          str(req["verdict"]))
        except (OSError, ValueError, KeyError, CoordinationError):
            try:
                conn.close()
            except OSError:
                pass

    # wire: producer
    def _propose(self, conn, epoch: str, rank: int, verdict: str) -> None:
        if verdict not in (OK, RETRY, ABORT):
            _send_json(conn, {"error": f"bad verdict {verdict!r}"})
            conn.close()
            return
        # Socket replies happen OUTSIDE the lock: sendall can block on a
        # sick peer, and the lock also gates the deadline sweep.
        notify: List[socket.socket] = []
        decision = reason = None
        with self._lock:
            if self._closed:
                notify = [conn]
                decision, reason = ABORT, "closed"
            else:
                done = self._resolved.get(epoch)
                if done is not None:
                    decision, reason = done
                    if reason == "timeout":
                        # Late joiner of a timed-out round: its peers
                        # already gave up on this epoch — proceeding
                        # alone would desynchronize the fleet.
                        decision, reason = ABORT, "late"
                    notify = [conn]
                else:
                    rnd = self._rounds.get(epoch)
                    if rnd is None:
                        rnd = self._rounds[epoch] = _Round(self._clock())
                    rnd.verdicts[rank] = verdict
                    rnd.waiters.append(conn)
                    if len(rnd.verdicts) >= self.world:
                        decision, reason = _decide(rnd.verdicts), "consensus"
                        notify = self._resolve(epoch, rnd, decision, reason)
        for c in notify:
            self._reply_and_close(c, decision, reason)

    # requires-lock: _lock
    def _resolve(self, epoch: str, rnd: _Round, decision: str,
                 reason: str) -> List[socket.socket]:
        """Record the round's outcome; return the waiters to notify
        (the caller replies after releasing the lock)."""
        rnd.decision, rnd.reason = decision, reason
        self._rounds.pop(epoch, None)
        self._resolved[epoch] = (decision, reason)
        while len(self._resolved) > _RESOLVED_KEEP:
            self._resolved.pop(next(iter(self._resolved)))
        waiters, rnd.waiters = rnd.waiters, []
        return waiters

    @staticmethod
    # wire: producer
    def _reply_and_close(conn, decision: str, reason: str) -> None:
        try:
            _send_json(conn, {"decision": decision, "reason": reason})
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _sweep_loop(self) -> None:
        poll = min(0.05, max(0.01, self.deadline / 100))
        while True:
            time.sleep(poll)
            notify: List[socket.socket] = []
            with self._lock:
                if self._closed:
                    return
                now = self._clock()
                expired = [
                    (e, r) for e, r in list(self._rounds.items())
                    if now - r.t0 > self.deadline
                ]
                for epoch, rnd in expired:
                    notify.extend(
                        self._resolve(epoch, rnd, ABORT, "timeout")
                    )
            for conn in notify:
                self._reply_and_close(conn, ABORT, "timeout")


class EpochBarrier:
    """One rank's handle on the consensus service.

    ``propose(tag, verdict)`` blocks until the fleet decides; every call
    advances the local sequence number folded into the epoch key (see
    module docstring). ``barrier(tag)`` is the agreement form: it
    proposes ``ok`` and raises :class:`CoordinatedAbort` unless everyone
    reached the same epoch — used to verify all ranks agree on resume
    state (identical tags → consensus; divergent tags → timeout abort).
    """

    def __init__(self, address: str, rank: int, *,
                 deadline: float = 30.0, connect_timeout: float = 10.0):
        host, _, port = address.rpartition(":")
        if not host or not port:
            raise ValueError(
                f"coordination address {address!r} is not host:port"
            )
        self.host, self.port = host, int(port)
        self.rank = int(rank)
        self.deadline = float(deadline)
        self.connect_timeout = float(connect_timeout)
        self.seq = 0

    # ----------------------------------------------------------------- wire

    def _connect(self) -> socket.socket:
        """Dial the coordinator, retrying refusals inside the connect
        budget (rank 0 may still be binding when peers arrive)."""
        faults.fire("coord.handshake", rank=self.rank)
        t0 = time.monotonic()
        while True:
            try:
                conn = socket.create_connection(
                    (self.host, self.port), timeout=self.connect_timeout
                )
                return conn
            except OSError as e:
                if time.monotonic() - t0 > self.connect_timeout:
                    raise CoordinationError(
                        f"cannot reach coordinator {self.host}:{self.port}"
                        f" ({e})"
                    ) from e
                time.sleep(0.05)

    # wire: producer, consumer
    def propose(self, tag: str, verdict: str) -> str:
        """Propose ``verdict`` for this rank's next epoch round; return
        the fleet's decision (``ok``/``retry``/``abort``). Raises
        :class:`CoordinationError` on coordinator death or wire failure
        — always within roughly the round deadline, never a hang."""
        self.seq += 1
        epoch = f"{self.seq}:{tag}"
        faults.fire("coord.barrier", rank=self.rank, epoch=epoch)
        conn = self._connect()
        try:
            # The server replies the moment the round resolves; its own
            # deadline sweep bounds that, the socket timeout is the
            # belt-and-braces on a dead coordinator.
            conn.settimeout(self.deadline + 10.0)
            _send_json(conn, {
                "op": "propose", "epoch": epoch, "rank": self.rank,
                "verdict": verdict,
            })
            reply = json.loads(_recv_line(conn).decode())
        except (OSError, ValueError) as e:
            raise CoordinationError(
                f"coordination round {epoch!r} failed ({e})"
            ) from e
        finally:
            try:
                conn.close()
            except OSError:
                pass
        decision = reply.get("decision")
        if decision not in (OK, RETRY, ABORT):
            raise CoordinationError(
                f"coordinator replied junk for {epoch!r}: {reply!r}"
            )
        default_registry().counter(
            "gamesman_coord_rounds_total",
            "cross-rank consensus rounds by decision",
            decision=decision,
        ).inc()
        return decision

    def barrier(self, tag: str) -> None:
        """All ranks must reach the same ``tag`` (at the same sequence
        point) or everyone aborts — the agreement primitive resume
        verification uses."""
        decision = self.propose(tag, OK)
        if decision != OK:
            raise CoordinatedAbort(
                f"ranks disagree at barrier {tag!r} "
                f"(decision={decision})"
            )

    # wire: fetch
    def _one_shot(self, req: dict) -> dict:
        """One request/reply exchange outside the round protocol (the
        address-book ops — no sequence number, no consensus)."""
        conn = self._connect()
        try:
            conn.settimeout(self.connect_timeout)
            _send_json(conn, req)
            return json.loads(_recv_line(conn).decode())
        except (OSError, ValueError) as e:
            raise CoordinationError(
                f"coordination op {req.get('op')!r} failed ({e})"
            ) from e
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def announce(self, addr: str) -> None:
        """Publish this rank's service address (its /status endpoint)
        into the coordinator's address book."""
        self._one_shot({"op": "announce", "rank": self.rank,
                        "addr": str(addr)})

    def peers(self) -> Dict[int, str]:
        """The announced address book: ``{rank: "host:port"}``."""
        reply = self._one_shot({"op": "peers"})
        peers = reply.get("peers")
        if not isinstance(peers, dict):
            raise CoordinationError(f"coordinator replied junk: {reply!r}")
        out: Dict[int, str] = {}
        for r, a in peers.items():
            try:
                out[int(r)] = str(a)
            except (TypeError, ValueError):
                continue
        return out


class Coordination:
    """What a solver holds: the client, plus the server when this rank
    hosts it. ``close()`` tears both down (idempotent)."""

    def __init__(self, client: EpochBarrier,
                 server: Optional[CoordinatorServer] = None):
        self.client = client
        self.server = server

    def propose(self, tag: str, verdict: str) -> str:
        return self.client.propose(tag, verdict)

    def barrier(self, tag: str) -> None:
        self.client.barrier(tag)

    def announce(self, addr: str) -> None:
        self.client.announce(addr)

    def peers(self) -> Dict[int, str]:
        return self.client.peers()

    def close(self) -> None:
        if self.server is not None:
            self.server.close()
            self.server = None


def coordination_from_env(rank: int, world: int) -> Optional[Coordination]:
    """Build the rank's coordination handle from ``GAMESMAN_COORD_ADDR``
    (host:port; rank 0 binds the server there). None when unconfigured
    or single-process — the caller falls back to rank-local retry."""
    if world <= 1:
        return None
    addr = env_opt("GAMESMAN_COORD_ADDR")
    if not addr:
        return None
    deadline = env_float("GAMESMAN_BARRIER_SECS", 30.0)
    server = None
    if rank == 0:
        host, _, port = addr.rpartition(":")
        server = CoordinatorServer(
            world, host=host or "127.0.0.1", port=int(port),
            deadline=deadline,
        )
    client = EpochBarrier(addr, rank, deadline=deadline)
    return Coordination(client, server)
