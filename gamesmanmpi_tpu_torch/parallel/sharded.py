"""The sharded level-synchronous solver over S shards (port of
gamesmanmpi_tpu/parallel/sharded.py).

The rebuild of the upstream GamesmanMPI's hash-partitioned ranks: its
``comm.send(Job(LOOK_UP, child), dest=hash(child) % world_size)`` becomes
one bucket exchange per level step.

  upstream (per message)           here (per level, per shard)
  -------------------------------  ------------------------------------
  send each child to               forward: expand and canonicalize the
  hash(child) % world_size         shard's frontier, order the children
                                   by owner_shard (core/hashing.py),
                                   exchange (parallel/exchange.py), then
                                   dedup locally: after owner routing
                                   every copy of a state meets on one
                                   shard
  per-rank memo {pos: value}       per-shard sorted (states, values,
                                   remoteness): the hash-partitioned table
  SEND_BACK child result           backward, deepest level first: the
                                   owners answer for their children and
                                   the answers travel back

Two forward paths, as in the reference:

* **Fast** (``uniform_level_jump`` games: tictactoe, connect4): the
  frontier chains on the devices. The owner's dedup keeps its provenance
  (``dedup_provenance``), and each child's index within its owner's level
  slice travels back to the parent through the reverse exchange (``eidx``,
  with the parent's ``slot`` map of where each child's answer will land).
* **Generic** (nim, subtract, chomp): children span up to
  ``max_level_jump`` levels, so per-target-level pools on the devices are
  merged by sort-unique (``compact_sorted`` picks each target level's
  children) as contributions arrive.

Two backwards:

* **Edges** (``GAMESMAN_BACKWARD=edges``, the default, fast path): send
  the stored indices to the owners, gather the packed cells there, reply,
  place them by ``slot``, combine (``combine_edge_cells``,
  ``combine_children``). No sort, no search, no re-expansion. Edges stay
  on the device within ``GAMESMAN_DEVICE_STORE_MB`` (with the level
  states), past it in host RAM, and return to the device for their level.
* **Lookup** (``GAMESMAN_BACKWARD=lookup``, the generic path, and any
  level without edges): regenerate the children, route the queries to
  their owners, ``lookup_window`` there, reply, un-permute, combine; in
  blocks of ``GAMESMAN_BACKWARD_BLOCK`` rows.

The control plane (each step's per-destination counts, the frontier
sizes, the generic path's per-level child counts, the misses and the
root answer) is all-gathered in one call per step, so every rank takes
the same branches. The global tables (``store_tables=True``, or the root
level) are gathered to every rank, ordered on the device by ``torch.sort``
and downloaded once: every rank of a world holds the same global table.

Collective-safe retry (the reference's ``_retry``/``_retry_collective``):
in one process a level step is retried rank-locally like the classic
engine's; in a world with a coordinator (``GAMESMAN_COORD_ADDR``,
resilience/coordination.py) every retry decision is a consensus round,
so all ranks retry or abort a step together, and a peer lost inside a
collective ends in :class:`CoordinatedAbort` (the CLI's exit 124) or, past
``GAMESMAN_COLLECTIVE_TIMEOUT``, the deadline's exit 124.

Checkpoint/resume (``checkpointer=``, utils/checkpoint.py), in the
reference's directory format, so either package resumes the other's:

* forward: each discovered level's shard rows and each expanded level's
  edges (in the reference's padded layout, :func:`edges_to_reference`)
  are saved as the forward finds them, and a per-shard frontier snapshot
  supersedes the level files once the forward completes;
* backward: each resolved level is saved per shard. A resume loads the
  snapshot (or continues a partial forward from its deepest sealed
  level), loads every sealed level instead of resolving it, and takes
  sealed edges where their geometry matches; edges sealed at another
  shard count fall back to the lookup join (``stats
  ["edges_geometry_fallback_levels"]``). A tree sealed at another shard
  count reshards on load (``stats["resharded_from"]``) unless
  ``GAMESMAN_RESHARD=0``, which refuses it naming both geometries.
* Payloads ride the block store's write-behind queue; a set is sealed
  only after its payloads landed: one level later in one process (the
  seal pipeline), at once after a barrier in a world, where rank 0 seals
  and stamps the run epoch after every rank agreed on the directory
  (``resume_digest``).

Preemption grace in a world: at every level boundary each rank folds its
grace flag into a consensus round (:meth:`ShardedSolver._check_preempt`),
so the whole world stops at the same boundary and exits 75 together.

Not ported here: the host-memory guard (``memguard``, with the campaign
work), window streaming (``GAMESMAN_WINDOW_BLOCK``), the route capacity
and its spill loop (parallel/exchange.py says why), background compiles,
status and logging.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from gamesmanmpi_tpu_torch.core.bitops import SENTINEL
from gamesmanmpi_tpu_torch.core.codec import (
    pack_cells,
    pack_cells_np,
    unpack_cells,
    unpack_cells_np,
)
from gamesmanmpi_tpu_torch.core.hashing import owner_shard, owner_shard_np
from gamesmanmpi_tpu_torch.core.values import UNDECIDED
from gamesmanmpi_tpu_torch.games.base import TensorGame
from gamesmanmpi_tpu_torch.obs import default_registry
from gamesmanmpi_tpu_torch.ops.combine import combine_children
from gamesmanmpi_tpu_torch.ops.dedup import compact_sorted, sort_unique
from gamesmanmpi_tpu_torch.ops.lookup import lookup_window
from gamesmanmpi_tpu_torch.ops.provenance import (
    combine_edge_cells,
    dedup_provenance,
    gather_cells,
)
from gamesmanmpi_tpu_torch.parallel.exchange import all_gather, all_to_all
from gamesmanmpi_tpu_torch.parallel.mesh import make_mesh
from gamesmanmpi_tpu_torch.resilience import faults, preempt
from gamesmanmpi_tpu_torch.resilience.coordination import (
    ABORT,
    OK,
    RETRY,
    CoordinatedAbort,
    CoordinationError,
    coordination_from_env,
)
from gamesmanmpi_tpu_torch.resilience.preempt import WATCHDOG_EXIT_CODE
from gamesmanmpi_tpu_torch.resilience.retry import is_transient, retry_call
from gamesmanmpi_tpu_torch.store import TORN_SEAL_ERRORS as TORN_NPZ_ERRORS
from gamesmanmpi_tpu_torch.store import default_store
from gamesmanmpi_tpu_torch.solve.engine import (
    LevelTable,
    SolveResult,
    SolverError,
    _backward_block,
    _finish,
    canonical_children,
    canonical_scalar,
)
from gamesmanmpi_tpu_torch.utils.checkpoint import (
    CheckpointGeometryError,
    reshard_enabled,
    reshard_shard_stream,
)
from gamesmanmpi_tpu_torch.utils.device import resolve_device
from gamesmanmpi_tpu_torch.utils.env import env_float, env_int, env_str

#: The reference's smallest capacity bucket: a sealed edge level's slot
#: map spans bucket_size(the level's widest shard) * max_moves lanes.
MIN_BUCKET = 256


def bucket_size(n: int, minimum: int = MIN_BUCKET) -> int:
    """Smallest power of two >= max(n, minimum) (the reference's
    ops/padding.bucket_size): the capacity its edge files are laid out
    at."""
    return 1 << int(max(n, minimum, 1) - 1).bit_length()


def edges_to_reference(eidx, slot, crow, ecap: int, slot_len: int):
    """One shard's edges, the port's layout -> the reference's.

    Port: ``eidx`` [crow.sum()] int32 destination-major (each child's
    index within its owner's next-level slice, in routing order), ``slot``
    [n*M] int32 (where lane j's answer sits in that buffer, -1 for none).
    Reference: ``eidx`` [S*ecap] with row d's ``crow[d]`` entries first,
    ``slot`` [slot_len] as d*ecap + position; -1 pads both."""
    crow = np.asarray(crow, dtype=np.int64)
    S = crow.shape[0]
    off = np.concatenate([[0], np.cumsum(crow)[:-1]])
    dest = np.repeat(np.arange(S), crow)
    pos = np.arange(dest.shape[0]) - off[dest]
    e = np.full(S * ecap, -1, dtype=np.int32)
    e[dest * ecap + pos] = np.asarray(eidx)
    slot = np.asarray(slot)
    sl = np.full(slot_len, -1, dtype=np.int32)
    real = slot >= 0
    j = slot[real]
    head = sl[:slot.shape[0]]
    head[real] = dest[j] * ecap + pos[j]
    return e, sl


def edges_from_reference(e, sl, lanes: int, S: int, ecap: int):
    """Inverse of :func:`edges_to_reference` for one shard's ``lanes`` =
    n*M child lanes -> (eidx, slot, crow [S] route counts). The counts
    are the slot map's per-destination tallies: each routed child has
    exactly one slot."""
    sl = np.asarray(sl[:lanes], dtype=np.int64)
    real = sl >= 0
    d = np.where(real, sl // ecap, 0)
    crow = np.bincount(d[real], minlength=S).astype(np.int64)
    off = np.concatenate([[0], np.cumsum(crow)[:-1]])
    slot = np.where(real, off[d] + sl % ecap, -1).astype(np.int32)
    dest = np.repeat(np.arange(S), crow)
    pos = np.arange(dest.shape[0]) - off[dest]
    eidx = np.asarray(e)[dest * ecap + pos].astype(np.int32)
    return eidx, slot, crow


def route_by_owner(flat: torch.Tensor, S: int):
    """Order a flat int64 state array by owner shard for the exchange.

    The device half of the upstream ``dest=hash(pos) % world_size`` send:
    a stable sort by ``owner_shard``, with SENTINEL lanes sent to bucket S
    (after every real bucket) and so never sent. Returns (send buffer,
    destination-major; per-destination counts [S] int64 on the device;
    order, the sort's permutation).
    """
    owner = torch.where(flat == SENTINEL, S, owner_shard(flat, S))
    order = torch.sort(owner, stable=True).indices
    counts = torch.bincount(owner, minlength=S + 1)[:S]
    return flat[order], counts, order


def reply_slots(order: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Where each child slot's answer lands in the reply buffer.

    The reply to an exchange arrives in the sender's layout, so child j's
    answer sits at its position in the routing sort: the inverse of
    `order`. Sentinel lanes (sorted past ``counts.sum()``) map to -1.
    """
    n = order.numel()
    slot = torch.empty(n, dtype=torch.int32, device=order.device)
    slot[order] = torch.arange(n, dtype=torch.int32, device=order.device)
    return torch.where(slot < counts.sum(), slot, -1)


def place_replies(got: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Reply cells (int32 view) placed in child-slot order; -1 slots get
    the UNDECIDED cell 0. The mask is explicit: torch does not clamp an
    out-of-range gather, and on the card one would poison the context."""
    if got.numel() == 0:
        return torch.zeros(slot.shape, dtype=torch.int32, device=slot.device)
    picked = got[slot.clamp(0, got.numel() - 1).to(torch.int64)]
    return torch.where(slot >= 0, picked, 0)


class _SLevel:
    """One discovered level: the global per-shard counts, this process's
    shard slices (on the devices, or spilled to the host), and on the
    fast path its forward edges."""

    __slots__ = ("counts", "dev", "host", "eidx", "slot", "C")

    def __init__(self, counts: np.ndarray, dev: Optional[list]):
        self.counts = counts  # np [S] int64, the same on every rank
        self.dev = dev  # per local shard: sorted int64 states
        self.host: Optional[list] = None  # per local shard: np.int64
        self.eidx: Optional[list] = None  # per local shard: int32, send order
        self.slot: Optional[list] = None  # per local shard: int32 [n*M]
        self.C: Optional[np.ndarray] = None  # [S, S] forward route counts


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class ShardedSolver:
    """Hash-partitioned level-synchronous solver over a shard mesh.

    ShardedSolver(game, num_shards=N, device="cuda").solve() ->
    SolveResult. The mesh (parallel/mesh.make_mesh) spans this process's
    ``torch.distributed`` world when init_distributed ran, else this
    process alone. paranoid=True checks each level's consistency counter
    and raises on a miss.
    store_tables=False keeps only the root level's table (the root
    level's table is always kept: the hybrid's boundary join reads it,
    the reference's ``materialize_root_table``). checkpointer: a
    utils/checkpoint.LevelCheckpointer to seal into and resume from.
    """

    def __init__(self, game: TensorGame, *, num_shards: int = 1,
                 device="cuda", paranoid: bool = False,
                 store_tables: bool = True, checkpointer=None):
        self.game = game
        self.checkpointer = checkpointer
        self.store = (checkpointer.store if checkpointer is not None
                      else default_store())
        #: deferred seals (one process, write-behind): (tickets, seal_fn)
        self._pending_seals: List = []
        #: checkpoint payload bytes handed over / landed on disk, and the
        #: solve thread's seconds in checkpoint work (downloads, layout,
        #: ticket waits, seals)
        self.ckpt_bytes_raw = 0
        self.ckpt_bytes_stored = 0
        self.ckpt_save_secs = 0.0
        #: elastic resume: the shard count the adopted tree was sealed at
        #: (None: no reshard), and the levels whose sealed edges carry
        #: another geometry and took the lookup backward
        self.resharded_from = None
        self.edges_geometry_fallback_levels = 0
        self.mesh = make_mesh(num_shards, resolve_device(device))
        self.S = self.mesh.S
        self.paranoid = paranoid
        self.store_tables = store_tables
        self.fast = bool(game.uniform_level_jump)
        mode = env_str("GAMESMAN_BACKWARD", "edges")
        if mode not in ("edges", "lookup"):
            raise SolverError(
                f"GAMESMAN_BACKWARD={mode!r}: expected 'edges' or 'lookup'")
        self.backward_mode = mode
        self.use_edges = mode == "edges" and self.fast
        self.backward_block = _backward_block()
        self.device_store_bytes = env_int("GAMESMAN_DEVICE_STORE_MB",
                                          8192) << 20
        #: levels resolved by the edge-cached backward
        self.backward_edges_levels = 0
        #: bytes of edges and of level states moved to host RAM past the
        #: device-store budget
        self.edges_bytes_spilled = 0
        self.states_bytes_spilled = 0
        #: host synchronisations: control gathers, dedup sizes, downloads
        self.syncs = 0
        #: transient level-step failures absorbed by retry
        self.retries = 0
        self.rank = self.mesh.rank
        self.num_processes = self.mesh.world
        # Cross-rank retry/abort consensus in a world (None in one
        # process, or without GAMESMAN_COORD_ADDR: rank-local retry).
        self.coord = coordination_from_env(self.rank, self.num_processes)
        #: per-collective deadline in a world, seconds (0 = off)
        self.collective_timeout = env_float("GAMESMAN_COLLECTIVE_TIMEOUT",
                                            0.0)
        #: phase/level progress, replaced at each boundary (the deadline's
        #: diagnostics read it from a timer thread)
        self.progress: dict = {"phase": "init", "rank": self.rank}
        self._misses: List[torch.Tensor] = []

    # ------------------------------------------------------------- retry

    def _retry(self, point: str, fn, level=None, entry=None):
        """Level-step retry. ``entry`` is the step's host-side prelude
        (its ``faults.fire``), evaluated before any collective: the one
        point where a rank-local failure is still safely retryable. In
        one process (or without coordination) a transient is retried
        rank-locally, as the classic engine does; in a world every
        decision is a consensus round (:meth:`_retry_collective`)."""
        if self.coord is None:

            def unit():
                if entry is not None:
                    entry()
                return fn()

            def on_retry(attempt, exc):
                self.retries += 1

            return retry_call(unit, point=point, level=level,
                              on_retry=on_retry)
        return self._retry_collective(point, fn, level, entry)

    def _retry_collective(self, point: str, fn, level, entry=None):
        """All ranks enter, retry, or abort a level step together.

        Per attempt every rank evaluates the step's entry (fault points
        fire here, before any collective), proposes ok/retry/abort for the
        shared epoch and acts on the fleet's decision: a transient on ONE
        rank becomes a retry on EVERY rank (each counts it), a fatal
        anywhere aborts everywhere. A failure inside the dispatched step
        goes through a ``post`` round: peers that completed the step never
        join it, so it resolves by deadline into a coordinated abort,
        while a symmetric failure agrees to retry. A lost peer (a
        process-group transport error) is a coordinated abort at once.
        """
        attempts = max(1, env_int("GAMESMAN_RETRY_ATTEMPTS", 3))
        base = env_float("GAMESMAN_RETRY_BASE_SECS", 0.25)
        for attempt in range(1, attempts + 1):
            err = None
            try:
                faults.fire("sharded.collective", step=point, level=level)
                if entry is not None:
                    entry()
            except Exception as e:  # noqa: BLE001 - classified below
                err = e
            verdict = self._verdict_for(err, attempt, attempts)
            decision = self._propose_step(point, level, attempt, "pre",
                                          verdict, err)
            if decision == RETRY:
                self._note_coordinated_retry(point, level, attempt)
                if base > 0:
                    time.sleep(base * (2 ** (attempt - 1)))
                continue
            if decision != OK:
                self._coordinated_abort(point, level, err, verdict)
            try:
                with self._collective_deadline(point, level):
                    return fn()
            except Exception as e:  # noqa: BLE001 - classified below
                if _peer_lost(e):
                    raise CoordinatedAbort(
                        f"peer lost inside {point} level {level} (rank "
                        f"{self.rank}): {str(e)[:200]}") from e
                if not is_transient(e) or attempt >= attempts:
                    raise
                decision = self._propose_step(point, level, attempt,
                                              "post", RETRY, e)
                if decision == RETRY:
                    self._note_coordinated_retry(point, level, attempt)
                    if base > 0:
                        time.sleep(base * (2 ** (attempt - 1)))
                    continue
                self._coordinated_abort(point, level, e, RETRY)
        raise SolverError(
            f"retry loop for {point} level {level} exhausted without a "
            "decision")  # pragma: no cover - every branch leaves above

    @staticmethod
    def _verdict_for(err, attempt: int, attempts: int) -> str:
        if err is None:
            return OK
        if is_transient(err) and attempt < attempts:
            return RETRY
        return ABORT

    def _propose_step(self, point: str, level, attempt: int, phase: str,
                      verdict: str, err) -> str:
        tag = f"{point}:L{level}:a{attempt}:{phase}"
        try:
            return self.coord.propose(tag, verdict)
        except CoordinationError as e:
            # The consensus service itself failed: abort — a guess here
            # could strand a peer inside a collective.
            raise CoordinatedAbort(
                f"coordination failed at {tag} (rank {self.rank}): {e}"
            ) from (err or e)

    def _note_coordinated_retry(self, point: str, level, attempt: int):
        """Every rank counts the fleet-wide retry, whichever rank hosted
        the fault (the registry's constant ``rank`` label tells them
        apart), and writes one line to stderr."""
        self.retries += 1
        sys.stderr.write(f"[coordination] rank {self.rank} retries {point} "
                         f"level {level} (attempt {attempt})\n")
        sys.stderr.flush()
        default_registry().counter(
            "gamesman_retries_total",
            "transient step failures absorbed by retry", point=point,
        ).inc()

    def _coordinated_abort(self, point: str, level, err, verdict):
        """Raise this rank's own error when it caused the abort, else
        :class:`CoordinatedAbort` naming the peer as the cause."""
        if err is not None and verdict == ABORT:
            raise err
        detail = (f"rank {self.rank} was healthy" if err is None
                  else f"rank {self.rank} proposed retry for: "
                  f"{str(err)[:200]}")
        raise CoordinatedAbort(
            f"fleet aborted at {point} level {level} ({detail})") from err

    def _collective_deadline(self, point: str, level):
        """Deadline around one dispatched step in a world: a rank blocked
        inside a collective on a dead peer cannot be interrupted from
        Python, so a daemon timer writes this rank's progress to stderr
        and exits 124. Off unless GAMESMAN_COLLECTIVE_TIMEOUT > 0 and the
        run has more than one process."""
        secs = self.collective_timeout
        if secs <= 0 or self.num_processes <= 1:
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def guard():
            def expire():
                rec = {"phase": "collective_abort", "point": point,
                       "level": level, "rank": self.rank,
                       "deadline_secs": secs,
                       "progress": dict(self.progress)}
                sys.stderr.write(
                    f"[coordination] collective deadline expired: {rec}\n")
                sys.stderr.flush()
                default_registry().counter(
                    "gamesman_collective_deadline_expired_total",
                    "collectives aborted by the per-collective deadline",
                    point=point,
                ).inc()
                os._exit(WATCHDOG_EXIT_CODE)

            timer = threading.Timer(secs, expire)
            timer.daemon = True
            timer.start()
            try:
                yield
            finally:
                timer.cancel()

        return guard()

    # -------------------------------------------------------- preemption

    def _check_preempt(self, phase: str, level) -> None:
        """Level-boundary preemption point. In one process, one flag
        check. In a world every rank folds its grace flag into a
        consensus round (ABORT from any preempted rank wins), so every
        rank raises :class:`~..resilience.preempt.PreemptionRequested`
        at the same boundary and the world exits 75 together. A failed
        round is a CoordinatedAbort (exit 124), still resumable. The
        reference's host-memory guard (``memguard.check``) runs here
        too; it belongs to the campaign work and is not ported."""
        flagged = preempt.requested()
        if self.coord is not None:
            decision = self._propose_step(
                "preempt", level, 0, phase, ABORT if flagged else OK, None)
            flagged = flagged or decision != OK
        if flagged:
            preempt.check(phase, level=level)
            # A peer was preempted and this rank's own signal has not
            # arrived: the same unwind, attributed to the peer.
            raise preempt.PreemptionRequested(
                f"peer rank preempted at {phase} boundary (level {level})")

    # -------------------------------------------------------- checkpoint

    def _shard_ranks(self) -> List[int]:
        """shard -> owning rank: the rank set each seal records."""
        per = self.S // self.num_processes
        return [s // per for s in range(self.S)]

    def _sync_processes(self, tag: str) -> None:
        """Barrier across a world's processes before rank 0 seals a set
        (rank 0 must not list shard files a peer is still writing). A
        lost peer is a CoordinatedAbort; past the collective deadline the
        rank exits 124."""
        if self.num_processes <= 1:
            return
        try:
            with self._collective_deadline(f"sync:{tag}", None):
                dist.barrier(group=self.mesh.group)
        except Exception as e:  # noqa: BLE001 - classified below
            if _peer_lost(e):
                raise CoordinatedAbort(
                    f"peer lost at barrier {tag} (rank {self.rank}): "
                    f"{str(e)[:200]}") from e
            raise

    def _run_seal(self, tickets, seal_fn) -> None:
        t0 = time.perf_counter()
        for t in tickets:
            try:
                raw, stored = t.result()
            except BaseException:
                # A payload that never landed: no later set may be sealed
                # past the hole (resume reads a prefix contiguous from the
                # root).
                self._pending_seals.clear()
                raise
            self.ckpt_bytes_raw += int(raw)
            self.ckpt_bytes_stored += int(stored)
        waited = time.perf_counter() - t0
        if waited > 1e-6:
            self.store._note_wait(waited)
        seal_fn()
        self.ckpt_save_secs += time.perf_counter() - t0

    def _seal_after_writes(self, tickets, seal_fn) -> None:
        """Schedule one artifact set's seal after its payload writes: at
        once in a world (the barrier is a collective) or without
        write-behind, else deferred so a level's writes overlap the next
        level's compute (depth 2: one level's edges and frontier)."""
        if self.num_processes > 1 or not self.store.writebehind:
            self._run_seal(tickets, seal_fn)
            return
        self._pending_seals.append((tickets, seal_fn))
        while len(self._pending_seals) > 2:
            self._run_seal(*self._pending_seals.pop(0))

    def _flush_seals(self) -> None:
        """Run every deferred seal (phase boundaries and the solve's
        end)."""
        while self._pending_seals:
            self._run_seal(*self._pending_seals.pop(0))

    @staticmethod
    def _host(t) -> np.ndarray:
        if isinstance(t, np.ndarray):
            return t
        if t.dtype == torch.uint32:
            return t.view(torch.int32).cpu().numpy().view(np.uint32)
        return t.cpu().numpy()

    def _ckpt_forward_level(self, k: int, rows) -> None:
        """Save one just-discovered level's local shard rows; seal the
        set after its writes."""
        ck = self.checkpointer
        if ck is None:
            return
        t0 = time.perf_counter()
        tickets = [ck.save_forward_level_shard(k, s, self._host(r))
                   for s, r in zip(self.mesh.local, rows)]

        def seal(k=k):
            self._sync_processes(f"forward_level_{k}_shards_written")
            if self.rank == 0:
                ck.finish_forward_level(k, self.S, ranks=self._shard_ranks(),
                                        drain=False)

        self.ckpt_save_secs += time.perf_counter() - t0
        self._seal_after_writes(tickets, seal)

    def _ckpt_edges_level(self, k: int, rec: _SLevel) -> None:
        """Save one expanded level's edges per local shard, in the
        reference's layout (ecap = the widest route, slot length = the
        reference's capacity bucket * max_moves), so either package's
        backward reads them."""
        ck = self.checkpointer
        if ck is None:
            return
        t0 = time.perf_counter()
        ecap = max(1, int(rec.C.max()))
        slot_len = bucket_size(int(rec.counts.max())) * self.game.max_moves
        tickets = []
        for i, s in enumerate(self.mesh.local):
            e, sl = edges_to_reference(self._host(rec.eidx[i]),
                                       self._host(rec.slot[i]), rec.C[s],
                                       ecap, slot_len)
            tickets.append(ck.save_edges_shard(k, s, e, sl))

        def seal(k=k):
            self._sync_processes(f"edges_level_{k}_shards_written")
            if self.rank == 0:
                ck.finish_edges_level(k, self.S, ecap, slot_len,
                                      ranks=self._shard_ranks(), drain=False)

        self.ckpt_save_secs += time.perf_counter() - t0
        self._seal_after_writes(tickets, seal)

    def _checkpoint_frontier_shards(self, levels: Dict[int, _SLevel]):
        """The per-shard frontier snapshot: one file per local shard with
        its rows of every level; it supersedes the forward level files."""
        ck = self.checkpointer
        self._flush_seals()
        t0 = time.perf_counter()
        tickets = []
        for i, s in enumerate(self.mesh.local):
            pools = {k: (rec.host[i] if rec.host is not None
                         else self._host(rec.dev[i]))
                     for k, rec in levels.items()}
            tickets.append(ck.save_frontier_shard(s, pools))
        self.ckpt_save_secs += time.perf_counter() - t0
        self._run_seal(tickets, lambda: None)
        self._sync_processes("frontier_shards_written")
        if self.rank == 0:
            ck.finish_frontier_shards(self.S, drain=False)

    def _checkpoint_level_shards(self, k: int, states, values, rems):
        """Save one resolved level per local shard; seal after the
        writes."""
        ck = self.checkpointer
        t0 = time.perf_counter()
        tickets = []
        for s, st, v, r in zip(self.mesh.local, states, values, rems):
            tickets.append(ck.save_level_shard(
                k, s, self._host(st), self._host(pack_cells(v, r))))

        def seal(k=k):
            self._sync_processes(f"level_{k}_shards_written")
            if self.rank == 0:
                ck.finish_level_shards(k, self.S, ranks=self._shard_ranks(),
                                       drain=False)

        self.ckpt_save_secs += time.perf_counter() - t0
        self._seal_after_writes(tickets, seal)

    def _hint_backward_level(self, k: int, rec: _SLevel, completed) -> None:
        """Readahead for the next backward level: its sealed level files
        on a resume, else its sealed edges. Advisory only."""
        ck = self.checkpointer
        manifest = ck.load_manifest()
        if k in completed:
            num = manifest.get("sharded_levels", {}).get(str(k))
            if num:
                ck.prefetch_level_shards(k, int(num), manifest)
            else:
                ck.prefetch_level(k)
        elif self.use_edges and rec.eidx is None:
            info = manifest.get("edge_levels", {}).get(str(k))
            if info and info.get("shards") == self.S:
                ck.prefetch_edges_level(k, self.S, manifest)

    def _load_checkpointed_level(self, k: int, rec: _SLevel, states):
        """A sealed level's (values, remoteness) per local shard, on the
        devices, checked against the discovered frontier.

        Every rank reads the whole sealed set, so a torn file is seen by
        every rank of a world and the fallback is taken together. A set
        sealed at another shard count reshards on load; a global level
        file (a single-device run's) is partitioned by the owner hash.
        Raises a TORN_NPZ_ERRORS member on a torn file (the caller
        quarantines and recomputes) and SolverError on a mismatch (a
        stale directory)."""
        ck, S = self.checkpointer, self.S
        manifest = ck.load_manifest()
        sealed = manifest.get("sharded_levels", {}).get(str(k))
        if sealed == S:
            # Same geometry: each shard file is already this shard's
            # sorted slice, so it loads as it is.
            per = [ck.load_level_shard(k, s, manifest) for s in range(S)]
        elif sealed is not None and reshard_enabled():
            sealed = int(sealed)
            ck.prefetch_level_shards(k, sealed, manifest)
            per = reshard_shard_stream(
                lambda s: ck.load_level_shard(k, s, manifest), sealed, S)
        else:
            table = ck.load_level(k)
            owners = owner_shard_np(table.states, S)
            cells = pack_cells_np(table.values, table.remoteness)
            per = [(table.states[owners == s], cells[owners == s])
                   for s in range(S)]
        values, rems = [], []
        for i, (s, dev) in enumerate(zip(self.mesh.local, self.mesh.devices)):
            st, cells = per[s]
            have = rec.host[i] if rec.host is not None else self._host(
                states[i])
            if st.shape != have.shape or not np.array_equal(st, have):
                raise SolverError(
                    f"checkpointed level {k} (shard {s}) does not match the "
                    "discovered frontier — stale checkpoint directory?")
            v, r = unpack_cells_np(cells)
            values.append(torch.from_numpy(v).to(dev))
            rems.append(torch.from_numpy(r.astype(np.int32)).to(dev))
        return values, rems

    def _load_edges(self, k: int, rec: _SLevel) -> bool:
        """Level k's sealed edges into ``rec`` (eidx, slot, C), when they
        were sealed at this shard count and capacity. Edges of another
        shard count cannot re-map (they index per-owner slices that no
        longer exist): the level takes the lookup join and is counted.
        A torn file anywhere degrades the level on every rank together
        (one control round carries each shard's verdict and its route
        counts)."""
        ck = self.checkpointer
        manifest = ck.load_manifest()
        info = manifest.get("edge_levels", {}).get(str(k))
        if not info:
            return False
        if info.get("shards") != self.S:
            self.edges_geometry_fallback_levels += 1
            return False
        M = self.game.max_moves
        if info.get("slot_len") != bucket_size(int(rec.counts.max())) * M:
            return False
        ecap = int(info["ecap"])
        eidx, slot, rows = [], [], []
        for i, s in enumerate(self.mesh.local):
            good = False
            crow = np.zeros(self.S, dtype=np.int64)
            try:
                e, sl = ck.load_edges_shard(k, s, manifest)
                good = (e.shape[0] == self.S * ecap
                        and sl.shape[0] == int(info["slot_len"]))
            except TORN_NPZ_ERRORS:
                pass
            if good:
                ei, si, crow = edges_from_reference(
                    e, sl, int(rec.counts[s]) * M, self.S, ecap)
                eidx.append(torch.from_numpy(ei))
                slot.append(torch.from_numpy(si))
            rows.append(torch.from_numpy(np.concatenate(
                [[int(good)], crow])).to(self.mesh.devices[i]))
        ctl = self._control(rows)
        if not ctl[:, 0].all():
            return False
        rec.eidx, rec.slot, rec.C = eidx, slot, ctl[:, 1:]
        return True

    # ------------------------------------------------------- shard work

    def _control(self, rows: List[torch.Tensor]) -> np.ndarray:
        """All-gather one int64 control row per local shard -> [S, K] on
        the host of every rank (one synchronisation)."""
        K = rows[0].numel()
        flat = all_gather(self.mesh, [r.to(torch.int64) for r in rows],
                          [K] * self.S)
        self.syncs += 1
        return flat.cpu().numpy().reshape(self.S, K)

    def _prim(self, states: torch.Tensor) -> torch.Tensor:
        """primitive() of real states; an empty slice never reaches the
        game."""
        if states.numel() == 0:
            return torch.empty(0, dtype=torch.uint8, device=states.device)
        return self.game.primitive(states)

    def _children(self, states: torch.Tensor):
        """Canonical children of a shard slice: ([n*M] with SENTINEL
        lanes, prim [n], mask [n, M])."""
        g = self.game
        prim = self._prim(states)
        if states.numel() == 0:
            mask = torch.zeros((0, g.max_moves), dtype=torch.bool,
                               device=states.device)
            return (torch.empty(0, dtype=torch.int64, device=states.device),
                    prim, mask)
        children, mask = canonical_children(g, states, prim == UNDECIDED)
        return children.reshape(-1), prim, mask

    def _seed(self, init) -> List[torch.Tensor]:
        """The starting states on their owner shards: one root, or a
        whole frontier (the hybrid starts the BFS at its boundary level's
        reachable set), sorted per shard."""
        arr = np.atleast_1d(np.asarray(init, dtype=np.int64))
        if arr.shape[0] > 1:
            arr = np.sort(arr)
        owners = owner_shard_np(arr, self.S)
        return [torch.from_numpy(arr[owners == s]).to(dev)
                for s, dev in zip(self.mesh.local, self.mesh.devices)]

    def _forward_step(self, frontier: List[torch.Tensor], k: int):
        """One forward level step on every local shard: expand, route,
        exchange, dedup; on the edges path, return each child's index
        within its owner to the parent.

        Returns (sizes [S] of the frontier, C [S, S] route counts, uniq
        per local shard or None when the level had no child, eidx, slot,
        per_target [J] global child counts per deeper level).
        """
        g, S, mesh = self.game, self.S, self.mesh
        J = g.max_level_jump
        kmax = min(k + J, g.num_levels - 1)
        sends, rows, slots = [], [], []
        for states in frontier:
            flat, _, _ = self._children(states)
            send, counts, order = route_by_owner(flat, S)
            valid = flat != SENTINEL
            if self.fast:
                # Every child is at level k+1, which must exist.
                n = valid.sum()
                extra = [n if k + 1 >= g.num_levels else torch.zeros_like(n)]
                per = [n]
            else:
                # Each child's level, taken on real lanes only (a
                # sentinel lane reads its parent, then is masked out).
                parents = states.repeat_interleave(g.max_moves)
                lv = torch.where(valid, g.level_of(
                    torch.where(valid, flat, parents)), -1)
                extra = [(valid & ((lv <= k) | (lv > kmax))).sum()]
                per = [(lv == k + 1 + j).sum() for j in range(J)]
            rows.append(torch.cat([
                counts, torch.stack([torch.tensor(states.numel(),
                                                  device=states.device)]
                                    + extra + per).to(torch.int64)]))
            sends.append(send)
            if self.use_edges:
                slots.append(reply_slots(order, counts))
            del flat, order
        ctl = self._control(rows)
        C, sizes = ctl[:, :S], ctl[:, S]
        bad, per_target = int(ctl[:, S + 1].sum()), ctl[:, S + 2:].sum(0)
        if bad:
            raise SolverError(
                f"game {g.name}: {bad} children of level {k} outside levels "
                f"({k}, {kmax}] — level_of/max_level_jump/num_levels "
                "inconsistent")
        if C.sum() == 0:
            return sizes, C, None, None, None, per_target
        recv = all_to_all(mesh, sends, C, "route")
        del sends
        uniq, uidx = [], []
        for r in recv:
            if self.use_edges:
                u, n, ui = dedup_provenance(r)
                uidx.append(ui)
            else:
                u, n = sort_unique(r)
            self.syncs += 1
            uniq.append(u[:n])
        del recv
        eidx = (all_to_all(mesh, uidx, C.T, "reply") if self.use_edges
                else None)
        return sizes, C, uniq, eidx, slots or None, per_target

    # ------------------------------------------------------ forward

    def _forward_fast(self, init, start: int,
                      resume: Optional[Dict[int, list]] = None
                      ) -> Dict[int, _SLevel]:
        """Device-resident forward for uniform_level_jump games: the
        routed, deduplicated children of level k are level k+1's
        frontier, shard to shard. ``init``: the root, or a sorted
        frontier array at level ``start``.

        With a checkpointer each discovered level's shard rows and each
        expanded level's edges are saved as they appear. ``resume`` is a
        sealed forward prefix ({level: per-shard int64 arrays at this
        shard count}): expansion continues from its deepest level, and
        the earlier levels carry no edges (the backward joins them)."""
        levels: Dict[int, _SLevel] = {}
        if resume:
            ks = sorted(resume)
            if ks != list(range(start, ks[-1] + 1)):
                raise SolverError(
                    f"forward checkpoint levels {ks} are not contiguous "
                    f"from the root level {start} — stale checkpoint "
                    "directory?")
            for kk in ks:
                levels[kk] = self._host_level(resume[kk])
            k = ks[-1]
            frontier = self._states(levels[k])
        else:
            frontier, k = self._seed(init), start
            self._ckpt_forward_level(k, frontier)
        stored = 0
        while True:
            self.progress = {"phase": "forward", "level": k,
                             "rank": self.rank}
            # Level boundary: level k's files are enqueued or sealed.
            self._check_preempt("forward", k)

            def _step(frontier=frontier, k=k):
                return self._forward_step(frontier, k)

            sizes, C, uniq, eidx, slot, _ = self._retry(
                "sharded.forward", _step, level=k,
                entry=lambda k=k: faults.fire("sharded.forward", level=k))
            rec = levels.get(k)
            if rec is None:
                rec = levels[k] = _SLevel(sizes, frontier)
            else:  # the resumed prefix's deepest level
                rec.dev = frontier
            stored += _nbytes(frontier)
            if uniq is None:
                break
            rec.C = C
            if eidx is not None:
                extra = _nbytes(eidx) + _nbytes(slot)
                if stored + extra <= self.device_store_bytes:
                    rec.eidx, rec.slot = eidx, slot
                    stored += extra
                else:
                    # Past the budget the edges wait in host RAM and
                    # return to the device for their level's backward.
                    rec.eidx = [e.cpu() for e in eidx]
                    rec.slot = [s.cpu() for s in slot]
                    self.edges_bytes_spilled += extra
                self._ckpt_edges_level(k, rec)
            self._spill_if_over(rec, stored)
            self._ckpt_forward_level(k + 1, uniq)
            frontier, k = uniq, k + 1
        return levels

    def _host_level(self, per_shard) -> _SLevel:
        """A level from host arrays of every shard (a loaded snapshot):
        the global counts, this process's shard slices on the host."""
        rec = _SLevel(np.array([a.shape[0] for a in per_shard],
                               dtype=np.int64), None)
        rec.host = [np.asarray(per_shard[s], dtype=np.int64)
                    for s in self.mesh.local]
        return rec

    def _spill_if_over(self, rec: _SLevel, stored: int) -> None:
        """Keep a level's states in host RAM once the device-store budget
        is spent (the backward re-uploads them); the live frontier still
        chains on the device."""
        if stored > self.device_store_bytes:
            rec.host = [t.cpu().numpy() for t in rec.dev]
            self.states_bytes_spilled += _nbytes(rec.dev)
            rec.dev = None

    def _forward_generic(self, init: int, start: int) -> Dict[int, _SLevel]:
        """Forward for multi-jump games: each level's routed children are
        merged into per-target-level pools on the devices (sort-unique),
        and levels pop in ascending order, so every contribution to level
        L lands before L is expanded."""
        g = self.game
        levels: Dict[int, _SLevel] = {}
        pools: Dict[int, List[torch.Tensor]] = {start: self._seed(init)}
        stored = 0
        while pools:
            k = min(pools)
            frontier = pools.pop(k)
            self.progress = {"phase": "forward", "level": k,
                             "rank": self.rank}
            self._check_preempt("forward", k)

            def _step(frontier=frontier, k=k):
                return self._forward_step(frontier, k)

            sizes, _, uniq, _, _, per_target = self._retry(
                "sharded.forward", _step, level=k,
                entry=lambda k=k: faults.fire("sharded.forward", level=k))
            rec = levels[k] = _SLevel(sizes, frontier)
            stored += _nbytes(frontier)
            self._spill_if_over(rec, stored)
            if uniq is None:
                continue
            kid_levels = [g.level_of(u) if u.numel() else
                          torch.empty(0, dtype=torch.int32, device=u.device)
                          for u in uniq]
            for j, n in enumerate(per_target, start=1):
                if n == 0:
                    continue  # no shard received a child of this level
                L = k + j
                pool = pools.get(L) or [u[:0] for u in uniq]
                merged = []
                for p, u, lv in zip(pool, uniq, kid_levels):
                    m, c = sort_unique(torch.cat(
                        [p, compact_sorted(u, lv == L)]))
                    self.syncs += 1
                    merged.append(m[:c])
                pools[L] = merged
        return levels

    # ------------------------------------------------------ backward

    def _states(self, rec: _SLevel) -> List[torch.Tensor]:
        if rec.dev is not None:
            return rec.dev
        return [torch.from_numpy(h).to(d)
                for h, d in zip(rec.host, self.mesh.devices)]

    def _resolve_edges(self, rec: _SLevel, states, window):
        """Resolve one level from its stored edges: the indices go to the
        owners, the owners gather packed cells of the level below, the
        cells come back and land by ``slot``. No search, no re-expansion.
        window: per local shard, (values, remoteness) of level k+1."""
        g, mesh = self.game, self.mesh
        eidx = [e.to(d) for e, d in zip(rec.eidx, mesh.devices)]
        slots = [s.to(d) for s, d in zip(rec.slot, mesh.devices)]
        q = all_to_all(mesh, eidx, rec.C, "route")
        cells = [gather_cells(qo, wv, wr).view(torch.int32)
                 for qo, (wv, wr) in zip(q, window)]
        got = all_to_all(mesh, cells, rec.C.T, "reply")
        out = []
        for st, slot, gs in zip(states, slots, got):
            prim = self._prim(st)
            undecided = prim == UNDECIDED
            cv, cr, mask = combine_edge_cells(
                place_replies(gs, slot).view(torch.uint32), g.max_moves)
            mask = mask & undecided.unsqueeze(-1)
            values, rem = combine_children(cv, cr, mask)
            misses = (undecided & ~mask.any(dim=-1)).sum()
            out.append((*_finish(values, rem, prim, undecided), misses))
        return out

    def _resolve_lookup(self, states, window):
        """Resolve one block of rows by the lookup join: regenerate each
        row's children, route them to their owners, look them up in the
        owners' window slices, reply, un-permute, combine.
        window: per local shard, a list of (states, values, remoteness)."""
        S, mesh = self.S, self.mesh
        sends, rows, kept = [], [], []
        for st in states:
            flat, prim, mask = self._children(st)
            send, counts, order = route_by_owner(flat, S)
            sends.append(send)
            rows.append(counts)
            kept.append((prim, mask, reply_slots(order, counts)))
        Cq = self._control(rows)
        q = all_to_all(mesh, sends, Cq, "route")
        del sends
        cells = []
        for qo, win in zip(q, window):
            v, r, _ = lookup_window(qo, win)
            cells.append(pack_cells(v, r).view(torch.int32))
        got = all_to_all(mesh, cells, Cq.T, "reply")
        out = []
        for (prim, mask, slot), gs in zip(kept, got):
            cv, cr = unpack_cells(
                place_replies(gs, slot).view(torch.uint32).view(mask.shape))
            undecided = prim == UNDECIDED
            values, rem = combine_children(cv, cr, mask)
            misses = ((mask & (cv == UNDECIDED)).sum()
                      + (undecided & ~mask.any(dim=-1)).sum())
            out.append((*_finish(values, rem, prim, undecided), misses))
        return out

    def _resolve_blocked(self, rec: _SLevel, states, window):
        """The lookup join in blocks of backward_block rows; every rank
        runs the same number of blocks (from the global counts)."""
        step = self.backward_block
        nb = max(1, math.ceil(int(rec.counts.max()) / step))
        parts = [self._resolve_lookup(
            [st[b * step:(b + 1) * step] for st in states], window)
            for b in range(nb)]
        return [(torch.cat([p[i][0] for p in parts]),
                 torch.cat([p[i][1] for p in parts]),
                 sum(p[i][2] for p in parts)) for i in range(len(states))]

    def _materialize(self, rec: _SLevel, states, values, rems) -> LevelTable:
        """The level's global table on every rank: gathered, ordered on
        the device, downloaded once."""
        sizes = [int(c) for c in rec.counts]
        st = all_gather(self.mesh, states, sizes)
        cells = all_gather(self.mesh, [pack_cells(v, r).view(torch.int32)
                                       for v, r in zip(values, rems)], sizes)
        st, order = torch.sort(st)
        v, r = unpack_cells(cells[order].view(torch.uint32))
        self.syncs += 3
        return LevelTable(st.cpu().numpy(), v.cpu().numpy(),
                          r.cpu().numpy())

    def _level_step(self, k: int, root: int, rec: _SLevel, states,
                    cache: Dict[int, list]):
        """Resolve level k (edges when its edges and level k+1 are at
        hand, else the lookup join), then its paranoid check and its
        global table. Returns (per local shard (values, remoteness),
        misses, paranoid count or None, table or None)."""
        g = self.game
        if self.use_edges and rec.eidx is not None and (k + 1) in cache:
            res = self._resolve_edges(
                rec, states, [(v, r) for _, v, r in cache[k + 1]])
        else:
            window = [[cache[k + j][i] for j in range(1, g.max_level_jump
                                                       + 1)
                       if (k + j) in cache]
                      for i in range(len(states))]
            res = self._resolve_blocked(rec, states, window)
        values = [x[0] for x in res]
        rems = [x[1] for x in res]
        misses = sum(x[2].to(self.mesh.home) for x in res)
        checked = (int(self._control([x[2].reshape(1) for x in res]).sum())
                   if self.paranoid else None)
        table = (self._materialize(rec, states, values, rems)
                 if self.store_tables or k == root else None)
        return values, rems, misses, checked, table

    def _root_step(self, init: int, states, values, rems) -> tuple:
        """(value, remoteness, total misses) on every rank: the root's
        owner shard looks it up, and one control gather replicates the
        answer and every shard's misses."""
        owner = int(owner_shard(torch.tensor([init]), self.S)[0])
        local_misses = (sum(self._misses) if self._misses
                        else torch.zeros((), dtype=torch.int64))
        rows = []
        for i, (s, st) in enumerate(zip(self.mesh.local, states)):
            row = torch.zeros(4, dtype=torch.int64, device=st.device)
            if s == owner and st.numel():
                j = torch.searchsorted(st, torch.tensor(
                    [init], device=st.device)).clamp(max=st.numel() - 1)
                row[0] = (st[j] == init).to(torch.int64)[0]
                row[1] = values[i][j].to(torch.int64)[0]
                row[2] = rems[i][j].to(torch.int64)[0]
            if i == 0:
                row[3] = local_misses.to(st.device)
            rows.append(row)
        ctl = self._control(rows)
        if not ctl[owner, 0]:
            raise SolverError(
                f"root state {init:#x} missing from its solved level — "
                "canonicalize/level_of inconsistent")
        return int(ctl[owner, 1]), int(ctl[owner, 2]), int(ctl[:, 3].sum())

    def _backward(self, levels: Dict[int, _SLevel], root: int, init: int):
        g, ck = self.game, self.checkpointer
        # The forward's seals must be visible before the sealed sets are
        # read.
        self._flush_seals()
        completed = set(ck.completed_levels()) if ck is not None else set()
        resolved: Dict[int, LevelTable] = {}
        cache: Dict[int, list] = {}  # level -> per local shard triples
        answer = None
        order = sorted(levels, reverse=True)
        for i, k in enumerate(order):
            rec = levels[k]
            self.progress = {"phase": "backward", "level": k,
                             "rank": self.rank}
            self._check_preempt("backward", k)
            if ck is not None and i + 1 < len(order):
                self._hint_backward_level(order[i + 1], levels[order[i + 1]],
                                          completed)
            states = self._states(rec)
            loaded = None
            if k in completed:
                try:
                    loaded = self._load_checkpointed_level(k, rec, states)
                except TORN_NPZ_ERRORS as e:
                    # Torn or crc-mismatching: quarantine and recompute
                    # (the frontier is known, the deeper window solved).
                    ck.quarantine_and_log(k, e)
            if loaded is not None:
                values, rems = loaded
                table = (self._materialize(rec, states, values, rems)
                         if self.store_tables or k == root else None)
            else:
                if (ck is not None and self.use_edges and rec.eidx is None
                        and (k + 1) in cache):
                    self._load_edges(k, rec)
                edges = self.use_edges and rec.eidx is not None and (
                    k + 1) in cache

                def _level(k=k, rec=rec, states=states):
                    return self._level_step(k, root, rec, states, cache)

                values, rems, misses, checked, table = self._retry(
                    "sharded.backward", _level, level=k,
                    entry=lambda k=k: faults.fire("sharded.backward",
                                                  level=k))
                self.backward_edges_levels += int(edges)
                if checked:
                    raise SolverError(
                        f"level {k}: {checked} consistency failures (child "
                        "lookups outside the solved window, or "
                        "non-primitive positions with zero legal moves)")
                self._misses.append(misses)
                if ck is not None:
                    self._checkpoint_level_shards(k, states, values, rems)
            if table is not None:
                resolved[k] = table
            if k == root:

                def _root(states=states, values=values, rems=rems):
                    return self._root_step(init, states, values, rems)

                answer = self._retry(
                    "sharded.backward", _root, level=k,
                    entry=lambda k=k: faults.fire("sharded.backward",
                                                  level=k))
            cache[k] = list(zip(states, values, rems))
            rec.dev = rec.host = rec.eidx = rec.slot = None
            for done in [d for d in cache if d > k + g.max_level_jump]:
                del cache[done]
        return resolved, answer

    # ------------------------------------------------------------ solve

    def solve(self) -> SolveResult:
        try:
            return self._solve_impl()
        finally:
            # Deferred seals are safe on the error path too (their
            # payloads are queued and waited on), and losing them would
            # unseal intact levels. Never mask the primary failure.
            try:
                self._flush_seals()
            except Exception:  # noqa: BLE001 - secondary failure only
                pass
            if self.coord is not None:
                self.coord.close()

    def _resume_gate(self) -> None:
        """Bind the directory, compare its sealed geometry with this run's
        (a reshard is adopted, or refused under GAMESMAN_RESHARD=0), have
        every rank of a world agree on it (``resume_digest``), then rank 0
        stamps the run epoch."""
        ck = self.checkpointer
        ck.bind_game(self.game.name, self.game.state_dtype)
        try:
            geom = ck.check_resume_geometry(self.S, self.num_processes)
        except CheckpointGeometryError as e:
            raise SolverError(str(e)) from e
        if geom["status"] == "reshard":
            sealed = geom["sealed"]
            self.resharded_from = (sealed["num_shards"]
                                   or sealed["shard_counts"][-1])
        if self.coord is not None:
            self.coord.barrier(f"resume:{ck.resume_digest(self.S)}")
        else:
            self._sync_processes("resume")
        if self.rank == 0:
            ck.stamp_run(self.num_processes, self._shard_ranks())
        if self.coord is not None:
            self.coord.barrier("run_stamped")
        else:
            self._sync_processes("run_stamped")

    def _discover(self, init: int, start: int) -> Dict[int, _SLevel]:
        """The forward, or what the checkpoint holds of it: the per-shard
        snapshot, else a global snapshot (a single-device run's), else a
        partial forward continued from its deepest sealed level. A
        forward run here seals its snapshot and drops its level files."""
        ck = self.checkpointer
        snap = ck.load_frontier_shards(self.S) if ck is not None else None
        glob = ck.load_frontiers() if ck is not None and snap is None else None
        if snap is not None:
            return {k: self._host_level(arrs) for k, arrs in snap.items()}
        if glob is not None:
            S = self.S
            levels = {}
            for k, v in glob.items():
                owners = owner_shard_np(v, S)
                levels[k] = self._host_level([v[owners == s]
                                              for s in range(S)])
            return levels
        if self.fast:
            partial = (ck.load_forward_level_shards(self.S)
                       if ck is not None else {})
            levels = self._forward_fast(init, start, resume=partial or None)
        else:
            levels = self._forward_generic(init, start)
        if ck is not None:
            self._checkpoint_frontier_shards(levels)
            self._sync_processes("forward_level_files_superseded")
            if self.rank == 0:
                ck.drop_forward_level_shards()
        return levels

    def _solve_impl(self) -> SolveResult:
        g, mesh = self.game, self.mesh
        cuda = mesh.home.type == "cuda"
        if cuda:
            # An indexed device does not initialize CUDA by itself, and the
            # allocator refuses its statistics before that.
            torch.cuda.init()
            torch.cuda.reset_peak_memory_stats(mesh.home)
        t0 = time.perf_counter()
        init, start = canonical_scalar(g, g.initial_state())
        store0 = self.store.stats()
        if self.checkpointer is not None:
            self._resume_gate()
        levels = self._discover(init, start)
        t_forward = time.perf_counter() - t0
        num_positions = sum(int(rec.counts.sum()) for rec in levels.values())
        resolved, (value, remoteness, misses) = self._backward(
            levels, start, init)
        self._flush_seals()
        t_total = time.perf_counter() - t0
        traffic = mesh.traffic
        self.progress = {"phase": "done", "rank": self.rank}
        stats = {
            "game": g.name,
            "engine": "sharded",
            "device": str(mesh.home),
            "devices": self.S,
            "shards": self.S,
            "processes": mesh.world,
            "backend": mesh.backend or "local",
            "path": "fast" if self.fast else "generic",
            "positions": num_positions,
            "levels": len(levels),
            "secs_forward": t_forward,
            "secs_backward": t_total - t_forward,
            "secs_total": t_total,
            "positions_per_sec": num_positions / max(t_total, 1e-9),
            "backward": self.backward_mode,
            "backward_edges_levels": self.backward_edges_levels,
            "misses": misses,
            "retries": self.retries,
            "syncs": self.syncs,
            "syncs_per_level": self.syncs / max(len(levels), 1),
            "exchange_bytes": dict(traffic.bytes),
            "exchange_calls": dict(traffic.calls),
            "exchange_secs": traffic.seconds(),
            "edges_bytes_spilled": self.edges_bytes_spilled,
            "states_bytes_spilled": self.states_bytes_spilled,
            "resharded_from": self.resharded_from,
            "edges_geometry_fallback_levels":
                self.edges_geometry_fallback_levels,
            "ckpt_bytes_raw": self.ckpt_bytes_raw,
            "ckpt_bytes_stored": self.ckpt_bytes_stored,
            "ckpt_save_secs": self.ckpt_save_secs,
            "io_wait_secs": (self.store.stats()["io_wait_secs"]
                             - store0["io_wait_secs"]),
            "peak_mem_bytes": (torch.cuda.max_memory_allocated(mesh.home)
                               if cuda else None),
        }
        return SolveResult(g, value, remoteness, resolved, stats)


def _peer_lost(exc: BaseException) -> bool:
    """Is this a process-group transport failure (a peer died or hung up
    inside a collective)? Retrying it alone would wedge the world."""
    if isinstance(exc, dist.DistNetworkError):
        return True
    msg = str(exc).lower()
    return any(m in msg for m in (
        "connection closed by peer", "connection reset by peer",
        "broken pipe", "timed out"))
