"""The level-synchronous retrograde solver, one device (port of
gamesmanmpi_tpu/solve/engine.py, the "classic" engine).

Two bulk phases per level replace the reference solver's message loop:

* forward: expand a whole level's frontier, canonicalize the children,
  and dedup them (sort-unique) into the next level(s);
* backward, deepest level first: give each state the negamax combine of
  its children's (value, remoteness) from the already solved deeper
  levels.

Two paths, as in the reference:

* **Fast path** (``game.uniform_level_jump``: tic-tac-toe, connect4).
  Every child of level k lies in level k+1, so the frontier chains on the
  device. The forward dedup keeps its provenance (``uidx``, each child's
  index in the next level's sorted table, and the level's primitive
  values) within ``GAMESMAN_DEVICE_STORE_MB``, and the backward resolves
  such a level with gathers only (:func:`resolve_provenance`). A level
  without provenance (past the budget, or with ``GAMESMAN_PROVENANCE=0``)
  regenerates its children and looks them up in level k+1
  (:func:`resolve_level`, a binary-search join).
* **Generic path** (nim, subtract, chomp): children land in up to
  ``max_level_jump`` deeper levels, so per-level pools are merged on the
  host and the backward looks children up in a window of that many
  deeper levels.

Checkpoint/resume (``checkpointer=``, utils/checkpoint.LevelCheckpointer),
as in the reference's ``_solve_impl``: each forward level is sealed the
moment its count is known and a complete forward is marked so; a resume
skips a complete forward, or continues an interrupted one from its
deepest sealed level (those levels carry no provenance, so the backward
joins them by lookup); the backward loads every sealed level instead of
resolving it, recomputes a quarantined one, and seals each level it
resolves. Preemption checks (resilience/preempt.py) and fault points
(resilience/faults.py) sit at the reference's level boundaries.

Level-step retry (resilience/retry.py), as in the reference's
``Solver._retry``: each forward expand+dedup and each backward resolve
runs under a bounded exponential-backoff retry that absorbs transient
runtime errors. A re-attempt starts again from the step's held inputs
(the level's frontier on the device, or its host pool, and the solved
window), so it is idempotent; ``stats["retries"]`` counts the absorbed
failures and ``gamesman_retries_total{point=...}`` carries them per
point.

Instrumentation, as in the reference: one ``forward`` and one
``backward`` record per level (obs/tracing.Span into ``logger``, the
registry and an installed Chrome trace sink), nested ``dedup``,
``checkpoint`` and ``db_export`` spans, and a ``done`` record. Each span
ends where the engine already waits for the device (the dedup count, a
level's host copy), so it adds no synchronisation; a record carries only
what the engine holds on the host. ``progress`` is replaced, never
mutated, at every boundary: the heartbeat (``heartbeat_secs`` /
``GAMESMAN_HEARTBEAT_SECS``), the watchdog (``GAMESMAN_WATCHDOG_SECS``,
exit 124 on a stall) and the live ``/status`` server
(``GAMESMAN_STATUS_PORT``) read it from their threads. Each boundary also
runs the host-memory guard (resilience/memguard.py) and notes the level
in the flight recorder (obs/flightrec.boundary).

The backward's pipeline (``GAMESMAN_PIPELINE``, ops/fused.pipeline_mode),
as the reference's fast path runs it. A level's host tail is its table's
download, the level sink, the checkpoint seal and the release of its
forward copies. Under ``level`` (the default) the tail runs before the
next level is enqueued. Under ``pingpong`` level k's tail runs after
level k-1's resolve is enqueued. On the card the level's arrays then
download on a copy stream of their own, which waits on an event recorded
after the level's resolve, into one of two sets of pinned host buffers
that alternate between levels (:class:`_PinnedPipe`); the tail reads a
set only after its copy event completed. The seconds the deferred tails
run with a resolve in flight are ``stats["overlap_secs"]``. The root
level's tail runs before the backward returns, and a preemption at a
level boundary runs the pending tail before it stops. Tables, checkpoint
files and DB files are byte for byte the same in both modes. The generic
path keeps the ``level`` order, as the reference's does.

What the port leaves out of the reference's machinery: background
precompiles and power-of-two capacity buckets (they bound XLA's compiled
shapes; eager torch runs every level at its exact size), speculation,
the analytic sort/gather byte and dispatch counts, and the fused modes.

Host synchronisation: one per forward level, inside ``torch.unique``
(the unique count sizes the next level); the backward resolves in blocks
of ``GAMESMAN_BACKWARD_BLOCK`` rows with no sync, and downloads a level's
table when the result keeps it, a level sink takes it or a checkpoint
seals it (one copy per array per level). Lookup misses and
non-primitive positions without moves are counted on the device
(``stats["misses"]``, read once at the end) and raise per level only
under ``paranoid``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from gamesmanmpi_tpu_torch.core.bitops import SENTINEL
from gamesmanmpi_tpu_torch.core.codec import unpack_cells
from gamesmanmpi_tpu_torch.core.values import UNDECIDED
from gamesmanmpi_tpu_torch.games.base import TensorGame
from gamesmanmpi_tpu_torch.obs import (
    Heartbeat,
    SolveStatusTracker,
    Span,
    default_registry,
    flightrec,
    maybe_status_server,
    trace_span,
)
from gamesmanmpi_tpu_torch.ops.combine import combine_children
from gamesmanmpi_tpu_torch.ops.dedup import unique_tailed, with_sentinel_slot
from gamesmanmpi_tpu_torch.ops.fused import pipeline_mode
from gamesmanmpi_tpu_torch.ops.lookup import lookup_window
from gamesmanmpi_tpu_torch.ops.provenance import gather_cells, uidx_from_inverse
from gamesmanmpi_tpu_torch.resilience import faults, memguard, preempt
from gamesmanmpi_tpu_torch.resilience.retry import retry_call
from gamesmanmpi_tpu_torch.resilience.supervisor import maybe_watchdog
from gamesmanmpi_tpu_torch.store import TORN_SEAL_ERRORS as TORN_NPZ_ERRORS
from gamesmanmpi_tpu_torch.utils.device import resolve_device
from gamesmanmpi_tpu_torch.utils.env import env_bool, env_float, env_int

#: Host bytes per position: a state on the int64 carrier, and a solved
#: cell (the uint8 value and the int32 remoteness).
_STATE_BYTES = 8
_CELL_BYTES = 1 + 4


class SolverError(RuntimeError):
    pass


class LevelTable(NamedTuple):
    """Solved records for one level: parallel host arrays sorted by state."""

    states: np.ndarray  # int64 carrier, sorted ascending
    values: np.ndarray  # uint8
    remoteness: np.ndarray  # int32


class SolveResult:
    """Full solve output: root answer + per-level tables + stats."""

    def __init__(self, game: TensorGame, value: int, remoteness: int,
                 levels: Dict[int, LevelTable], stats: dict):
        self.game = game
        self.value = int(value)
        self.remoteness = int(remoteness)
        self.levels = levels
        self.stats = stats

    @property
    def num_positions(self) -> int:
        return self.stats["positions"]

    def lookup(self, state) -> tuple[int, int]:
        """(value, remoteness) of a reachable packed state, given in the
        reference's packing. Queries are canonicalized, so a
        symmetry-reduced table answers for every member of a class."""
        state, level = canonical_scalar(self.game, state)
        table = self.levels.get(level)
        if table is not None:
            i = int(np.searchsorted(table.states, state))
            if i < table.states.shape[0] and table.states[i] == state:
                return int(table.values[i]), int(table.remoteness[i])
        raise KeyError(f"state {int(state):#x} not reachable/solved")


def canonical_scalar(game: TensorGame, state) -> tuple[int, int]:
    """(canonical state, topological level) of one packed state.

    The state must fit the game's reference dtype: numpy raises the same
    OverflowError the reference's query path raises. A 64-bit state with
    the top bit set cannot be reachable (states fit 63 bits) and raises
    KeyError.
    """
    state = int(np.array([state], dtype=game.state_dtype)[0])
    if state >= SENTINEL:
        raise KeyError(f"state {state:#x} not reachable/solved")
    t = game.canonicalize(torch.tensor([state], dtype=torch.int64))
    return int(t[0]), int(game.level_of(t)[0])


def undecided_mask(game: TensorGame, states):
    """Which lanes hold real, non-terminal positions: [B] bool."""
    return (states != SENTINEL) & (game.primitive(states) == UNDECIDED)


def canonical_children(game: TensorGame, states, active):
    """expand + canonicalize + deactivate parents + sentinel-fill.

    Children of inactive parents (primitives) are SENTINEL; survivors are
    symmetry-class representatives. Returns (children [B, M], mask [B, M]).
    """
    children, mask = game.expand(states)
    children = game.canonicalize(children)
    mask = mask & active.unsqueeze(-1)
    sent = torch.tensor(SENTINEL, dtype=torch.int64, device=states.device)
    return torch.where(mask, children, sent), mask


def _unique_children(game: TensorGame, states, prim):
    """Sorted unique canonical children of the non-primitive states ->
    ops/dedup.unique_tailed's (uniq, count, inverse)."""
    children, _ = canonical_children(game, states, prim == UNDECIDED)
    buf = with_sentinel_slot(children)
    # Freed before the sort allocates its temporaries, the level's memory
    # peak: holding it costs 0.36 GB of peak on Connect-4 5x5 (H100).
    del children
    return unique_tailed(buf)


def expand_provenance(game: TensorGame, states):
    """Forward expand that keeps the dedup's provenance.

    states: [n] int64 (one level, real states only). Returns (uniq [count]
    sorted children, count (host int), uidx [n*M] int32, prim [n] uint8):
    uidx[b*M + m] is the index of child (b, m) in `uniq`, -1 where there
    is no child.
    """
    prim = game.primitive(states)
    uniq, count, inv = _unique_children(game, states, prim)
    return uniq, count, uidx_from_inverse(inv, count), prim


def expand_unique(game: TensorGame, states):
    """Forward expand without provenance -> (uniq [count], count)."""
    uniq, count, _ = _unique_children(game, states, game.primitive(states))
    return uniq, count


def expand_with_levels(game: TensorGame, states):
    """Generic-path forward -> (uniq [count] sorted children, their int32
    topological levels)."""
    uniq, _ = expand_unique(game, states)
    return uniq, game.level_of(uniq)


def _finish(values, remoteness, prim, undecided):
    """Primitives keep their own value with remoteness 0."""
    values = torch.where(undecided, values, prim)
    remoteness = torch.where(undecided, remoteness, 0)
    return values, remoteness


def resolve_provenance(prim, uidx, wvals, wrem, max_moves: int):
    """Backward resolve from stored provenance: gathers + combine only.

    prim: [B] uint8 (from forward). uidx: [B*M] int32 child indices into
    the deeper level's table (-1 = no child). wvals/wrem: that level's
    solved values/remoteness. Lookup misses cannot happen here (the
    indices came from the sort that built the deeper level), so the
    counter only tracks non-primitive rows without moves.
    Returns (values [B] uint8, remoteness [B] int32, misses 0-d tensor).
    """
    undecided = prim == UNDECIDED
    m = uidx.view(-1, max_moves)
    mask = (m >= 0) & undecided.unsqueeze(-1)
    cv, cr = unpack_cells(gather_cells(m, wvals, wrem))
    values, remoteness = combine_children(cv, cr, mask)
    misses = (undecided & ~mask.any(dim=-1)).sum()
    return (*_finish(values, remoteness, prim, undecided), misses)


def resolve_level(game: TensorGame, states, window):
    """[B] states + solved deeper levels -> (values, remoteness, misses).

    Children are regenerated and canonicalized to match the canonical
    solved tables, then looked up in `window` (a list of (states, values,
    remoteness) device triples). misses counts child lookups that missed
    the window and non-primitive positions with no legal move.
    """
    prim = game.primitive(states)
    undecided = prim == UNDECIDED
    children, mask = canonical_children(game, states, undecided)
    cv, cr, hit = lookup_window(children, window)
    values, remoteness = combine_children(cv, cr, mask)
    misses = (mask & ~hit).sum() + (undecided & ~mask.any(dim=-1)).sum()
    return (*_finish(values, remoteness, prim, undecided), misses)


class _Level:
    """One discovered level: its states on the device or the host, and,
    on the fast path, its forward provenance (prim, uidx) while the
    device-store budget allows."""

    __slots__ = ("n", "dev", "host", "prim", "uidx")

    def __init__(self, n: int, dev=None, host=None):
        self.n = n
        self.dev = dev  # int64 [n] on the solve's device, or None
        self.host = host  # np.int64 [n], or None
        self.prim = None  # uint8 [n] on the device, or None
        self.uidx = None  # int32 [n*M] on the device, or None

    def host_states(self) -> np.ndarray:
        if self.host is None:
            self.host = self.dev.cpu().numpy()
        return self.host


def _backward_block() -> int:
    """Rows per backward resolve call (GAMESMAN_BACKWARD_BLOCK; 0 = never
    block). It bounds the [block, M] temporaries, not the level."""
    n = env_int("GAMESMAN_BACKWARD_BLOCK", 1 << 22)
    return n if n > 0 else 1 << 62


class _PinnedPipe:
    """The pingpong backward's downloads on the card: a copy stream and
    two sets of pinned host buffers that alternate between levels.

    :meth:`download` records an event on the current (compute) stream
    after the level's resolve, makes the copy stream wait on it, copies
    each tensor into the set's pinned buffers there and records the
    set's copy event. The tensors are marked used by the copy stream
    (``record_stream``), so the allocator does not hand their memory to
    the compute stream before the copies are done. The returned fetch
    waits on the copy event and hands back host copies of the buffers:
    a set is written again two levels later, after its previous fetch
    ran, and every reuse first waits on the set's last copy event."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self._bufs: List[Dict[int, torch.Tensor]] = [{}, {}]
        self._done: List[Optional[torch.cuda.Event]] = [None, None]
        self._turn = 0

    def _buffer(self, i: int, j: int, t: torch.Tensor) -> torch.Tensor:
        """Set i's pinned buffer for the j-th tensor, grown to fit t."""
        buf = self._bufs[i].get(j)
        if buf is None or buf.dtype != t.dtype or buf.numel() < t.numel():
            buf = self._bufs[i][j] = torch.empty(
                max(t.numel(), 1), dtype=t.dtype, pin_memory=True)
        return buf

    def download(self, tensors):
        i = self._turn
        self._turn ^= 1
        if self._done[i] is not None:
            self._done[i].synchronize()  # the set's last copy has landed
        ready = torch.cuda.Event()
        ready.record()
        views = []
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(ready)
            for j, t in enumerate(tensors):
                view = self._buffer(i, j, t)[:t.numel()]
                view.copy_(t, non_blocking=True)
                t.record_stream(self.stream)
                views.append(view)
            done = torch.cuda.Event()
            done.record(self.stream)
        self._done[i] = done

        def fetch():
            done.synchronize()
            # Out of the reused buffers into the table's own arrays:
            # torch's CPU copy runs on the intra-op threads, a numpy copy
            # on one.
            return [torch.empty(v.shape, dtype=v.dtype).copy_(v).numpy()
                    for v in views]

        return fetch


class Solver:
    """Single-device level-synchronous solver for a TensorGame.

    Solver(game, device="cuda").solve() -> SolveResult. device "cuda"
    (default) or "cpu"; a missing card raises DeviceUnavailable.
    store_tables=False keeps only the root level's table on the host.
    level_sink(level, LevelTable) receives every level's table the moment
    the backward has it (resolved or loaded from the checkpoint), also
    with store_tables=False: the streamed DB export (db/writer.py).
    paranoid=True syncs each level's consistency counter and raises on a
    miss. use_provenance defaults to GAMESMAN_PROVENANCE (on); the
    backward block and the device-store budget come from
    GAMESMAN_BACKWARD_BLOCK and GAMESMAN_DEVICE_STORE_MB. checkpointer:
    a utils/checkpoint.LevelCheckpointer to seal levels into and resume
    from (with store_tables=False every level is still sealed). logger:
    a utils/metrics logger for the per-level records. heartbeat_secs:
    the heartbeat period (0 = off; None reads GAMESMAN_HEARTBEAT_SECS).
    """

    def __init__(self, game: TensorGame, *, device="cuda",
                 paranoid: bool = False, store_tables: bool = True,
                 use_provenance: Optional[bool] = None, checkpointer=None,
                 level_sink=None, logger=None,
                 heartbeat_secs: Optional[float] = None):
        self.game = game
        self.checkpointer = checkpointer
        self.level_sink = level_sink
        self.logger = logger
        if heartbeat_secs is None:
            heartbeat_secs = env_float("GAMESMAN_HEARTBEAT_SECS", 0.0)
        self.heartbeat_secs = float(heartbeat_secs)
        #: phase/level progress, replaced (never mutated) at every
        #: boundary: the heartbeat, watchdog and status threads read it.
        self.progress: dict = {"phase": "init"}
        #: the live /status progress model (obs/status.py)
        self.status_tracker = SolveStatusTracker()
        #: host-transfer bytes of the solve (the records' bytes_host)
        self.bytes_host = 0
        self.device = resolve_device(device)
        self.paranoid = paranoid
        self.store_tables = store_tables
        self.fast = bool(game.uniform_level_jump)
        self.use_provenance = (env_bool("GAMESMAN_PROVENANCE", True)
                               if use_provenance is None else use_provenance)
        self.backward_block = _backward_block()
        self.device_store_bytes = env_int("GAMESMAN_DEVICE_STORE_MB", 8192) << 20
        #: the fast backward's pipeline mode (ops/fused.pipeline_mode)
        self.pipeline = pipeline_mode()
        #: host seconds the pingpong backward ran deferred level tails
        #: while a resolve was in flight
        self.overlap_secs = 0.0
        self.provenance_levels = 0
        #: transient level-step failures absorbed by _retry.
        self.retries = 0
        self._completed: set = set()  # levels sealed in the checkpoint

    # ------------------------------------------------------------ helpers

    def _retry(self, point: str, fn, level=None):
        """Level-step retry: bounded exponential backoff on transient
        runtime errors (resilience/retry.py). ``fn`` re-enters from the
        step's held inputs, so every attempt computes the same level."""

        def on_retry(attempt, exc):
            self.retries += 1

        return retry_call(fn, point=point, level=level, logger=self.logger,
                          on_retry=on_retry)

    def _misses_check(self, k: int, misses) -> None:
        if self.paranoid and int(misses) > 0:
            raise SolverError(
                f"level {k}: {int(misses)} consistency failures (child "
                "lookups outside the solved window — level_of/"
                "max_level_jump inconsistent — or non-primitive positions "
                "with zero legal moves)")

    def _blocks(self, n: int):
        step = self.backward_block
        return [(off, min(off + step, n)) for off in range(0, n, step)]

    def _resolve_blocked(self, states, window):
        """resolve_level in blocks of backward_block rows, one window."""
        parts = [resolve_level(self.game, states[a:b], window)
                 for a, b in self._blocks(states.numel())]
        return self._concat(parts)

    def _resolve_blocked_prov(self, rec: _Level, wvals, wrem):
        M = self.game.max_moves
        parts = [resolve_provenance(rec.prim[a:b], rec.uidx[a * M:b * M],
                                    wvals, wrem, M)
                 for a, b in self._blocks(rec.n)]
        return self._concat(parts)

    @staticmethod
    def _concat(parts):
        if len(parts) == 1:
            return parts[0]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]),
                sum(p[2] for p in parts))

    def _check_level(self, level: int) -> None:
        g = self.game
        if level >= g.num_levels:
            raise SolverError(
                f"game {g.name}: children found at level {level} but "
                f"num_levels={g.num_levels} — level_of/num_levels "
                "inconsistent")

    # ---------------------------------------------------------- checkpoint

    def _load_sealed(self, k: int, host_states):
        """Level k's sealed table, or None when it is not sealed or its
        file is torn (then quarantined: the level recomputes). A sealed
        table whose states differ from the discovered level's
        (``host_states()``) means the directory is stale, and raises."""
        ckpt = self.checkpointer
        if ckpt is None or k not in self._completed:
            return None
        try:
            table = ckpt.load_level(k)
        except TORN_NPZ_ERRORS as e:
            ckpt.quarantine_and_log(k, e, self.logger)
            return None
        if not np.array_equal(table.states, host_states()):
            raise SolverError(f"checkpointed level {k} does not match the "
                              "discovered frontier — stale checkpoint "
                              "directory?")
        return table

    def _level_fetch(self, k: int, root: int, table: Optional[LevelTable],
                     host, states, values, rem, pipe=None):
        """Start a backward level's download. `table` is the sealed table
        when the level was loaded, None when it was resolved: then the
        table is needed when the result keeps it, the level sink takes it
        or the checkpoint seals it. `host` is the level's host states, or
        None when they are on the device only (`states`). -> (fetch, the
        bytes it downloads): fetch() returns the level's table or None.
        With `pipe` (pingpong on the card) the copies are enqueued on its
        copy stream now; else fetch downloads when it is called."""
        if table is not None:
            return (lambda: table), 0
        if not (self.store_tables or k == root
                or self.checkpointer is not None
                or self.level_sink is not None):
            return (lambda: None), 0
        n = values.numel()
        nbytes = n * _CELL_BYTES + (n * _STATE_BYTES if host is None else 0)
        if pipe is not None:
            fetched = pipe.download([values, rem] if host is not None
                                    else [values, rem, states])

            def fetch():
                got = fetched()
                return LevelTable(got[2] if host is None else host,
                                  got[0], got[1])
        else:
            def fetch():
                return LevelTable(states.cpu().numpy() if host is None
                                  else host,
                                  values.cpu().numpy(), rem.cpu().numpy())
        return fetch, nbytes

    def _level_tail(self, k: int, root: int, fetch, resumed: bool,
                    resolved: Dict[int, LevelTable]) -> None:
        """A backward level's host tail: its table (fetch()), kept when
        the result keeps it, handed to the level sink and sealed when it
        was resolved here."""
        table = fetch()
        if table is None:
            return
        if self.store_tables or k == root:
            resolved[k] = table
        if self.level_sink is not None:
            with trace_span("db_export", level=k,
                            n=int(table.states.shape[0])):
                self.level_sink(k, table)
        if self.checkpointer is not None and not resumed:
            with trace_span("checkpoint", level=k, kind="level"):
                self.checkpointer.save_level(k, table)

    def _boundary(self, phase: str, k: int, **progress) -> None:
        """A level boundary: replace ``progress``, then the preemption
        point and the host-memory guard (everything before it is sealed
        or sealable)."""
        self.progress = {"phase": phase, "level": k, **progress}
        preempt.check(phase, level=k, logger=self.logger)
        memguard.check(phase, level=k, logger=self.logger)

    def _save_frontier(self, k: int, host_states) -> None:
        with trace_span("checkpoint", level=k, kind="frontier"):
            self.checkpointer.save_frontier_level(k, host_states)

    # ---------------------------------------------------------- fast path

    def _forward_fast(self, init, start: int,
                      resume: Optional[Dict[int, np.ndarray]] = None
                      ) -> Dict[int, _Level]:
        """Device-resident forward sweep for uniform_level_jump games.
        ``init``: the root state, or a sorted frontier array at level
        ``start`` (the hybrid starts the BFS at its boundary level).

        With a checkpointer each level's frontier is sealed the moment its
        count is known (its host copy is kept for the backward). `resume`
        is a previous run's sealed prefix: expansion continues from its
        deepest level, and the earlier levels carry no provenance.
        """
        g, dev, ckpt = self.game, self.device, self.checkpointer
        levels: Dict[int, _Level] = {}
        if resume:
            ks = sorted(resume)
            if ks != list(range(start, ks[-1] + 1)):
                raise SolverError(
                    f"forward checkpoint levels {ks} are not contiguous from "
                    f"the root level {start} — stale checkpoint directory?")
            for kk in ks:
                levels[kk] = _Level(resume[kk].shape[0], host=resume[kk])
            k = ks[-1]
            frontier = torch.from_numpy(levels[k].host).to(dev)
            levels[k].dev = frontier
        else:
            k = start
            frontier = torch.from_numpy(np.atleast_1d(
                np.asarray(init, dtype=np.int64))).to(dev)
            levels[k] = _Level(frontier.numel(), dev=frontier)
            if ckpt is not None:
                self._save_frontier(k, levels[k].host_states())
        stored = frontier.numel() * 8
        while True:
            rec = levels[k]
            sp = Span("forward", logger=self.logger, level=k)
            # Level boundary: everything before this level is sealed.
            self._boundary("forward", k, frontier=rec.n)
            states = rec.dev if rec.dev is not None else frontier

            def _step(states=states, k=k):
                faults.fire("engine.forward", level=k)
                faults.fire("engine.dedup", level=k)
                if self.use_provenance:
                    return expand_provenance(g, states)
                return (*expand_unique(g, states), None, None)

            # The expand and the dedup's sort retire at the unique count's
            # host sync, inside the step: what this span times.
            with trace_span("dedup", level=k):
                uniq, n, uidx, prim = self._retry("engine.forward", _step,
                                                  level=k)
            if uidx is not None:
                extra = prim.numel() + uidx.numel() * 4
                if n > 0 and stored + extra <= self.device_store_bytes:
                    rec.prim, rec.uidx = prim, uidx
                    stored += extra
                    self.provenance_levels += 1
            if n == 0:
                # The terminal probe: its trace event is kept, but no
                # JSONL record (the reference writes none).
                sp.end(log=False)
                self.status_tracker.forward_level(k, rec.n, sp.secs)
                flightrec.boundary("forward", k)
                break
            self._check_level(k + 1)
            nxt = _Level(n, dev=uniq)
            if stored + n * 8 > self.device_store_bytes:
                # Past the budget: the level's table lives on the host
                # (the backward re-uploads it); the frontier still chains.
                nxt.host_states()
                nxt.dev = None
            else:
                stored += n * 8
            levels[k + 1] = nxt
            if ckpt is not None:
                self._save_frontier(k + 1, nxt.host_states())
            # The next level's download (a checkpoint seal or a spill).
            host_bytes = n * _STATE_BYTES if nxt.host is not None else 0
            self.bytes_host += host_bytes
            sp.end(frontier=rec.n, children=n, bytes_host=host_bytes)
            self.status_tracker.forward_level(k, rec.n, sp.secs)
            flightrec.boundary("forward", k)
            frontier = uniq
            k += 1
        return levels

    def _backward_fast(self, levels: Dict[int, _Level], root: int,
                       misses: List) -> Dict[int, LevelTable]:
        dev = self.device
        resolved: Dict[int, LevelTable] = {}
        pingpong = self.pipeline == "pingpong"
        pipe = _PinnedPipe(dev) if pingpong and dev.type == "cuda" else None
        pending = None  # pingpong: the deeper level's deferred tail
        prev = None  # (states, values, remoteness) of level k+1 on device
        try:
            for k in sorted(levels, reverse=True):
                rec = levels[k]
                sp = Span("backward", logger=self.logger, level=k)
                self._boundary("backward", k, n=rec.n)
                uploaded = rec.dev is None
                states = (rec.dev if rec.dev is not None
                          else torch.from_numpy(rec.host).to(dev))
                had_host = rec.host is not None
                table = self._load_sealed(k, rec.host_states)
                resumed = table is not None
                if table is not None:
                    values = torch.from_numpy(table.values).to(dev)
                    rem = torch.from_numpy(table.remoteness).to(dev)
                else:
                    def _resolve(rec=rec, states=states, prev=prev, k=k):
                        faults.fire("engine.backward", level=k)
                        if prev is not None and rec.uidx is not None:
                            return self._resolve_blocked_prov(
                                rec, prev[1], prev[2])
                        window = [prev] if prev is not None else []
                        return self._resolve_blocked(states, window)

                    values, rem, miss = self._retry("engine.backward",
                                                    _resolve, level=k)
                    misses.append(miss)
                    self._misses_check(k, miss)
                prev = (states, values, rem)
                host_bytes = rec.n * _STATE_BYTES if uploaded else 0
                if not had_host and rec.host is not None:
                    host_bytes += rec.n * _STATE_BYTES  # the resume's check
                fetch, down = self._level_fetch(k, root, table, rec.host,
                                                states, values, rem, pipe)
                host_bytes += down
                tail = (lambda k=k, fetch=fetch, resumed=resumed:
                        self._level_tail(k, root, fetch, resumed, resolved))
                if pending is not None:
                    # The deeper level's tail, with this level's resolve
                    # in flight: the pipeline's overlap.
                    t0 = time.perf_counter()
                    pending()
                    self.overlap_secs += time.perf_counter() - t0
                    pending = None
                if pingpong:
                    pending = tail
                else:
                    tail()
                self.bytes_host += host_bytes
                # Release the forward copies and provenance of this level
                # (the tail holds what it downloads).
                rec.dev = rec.prim = rec.uidx = None
                if not self.store_tables:
                    rec.host = None
                sp.end(n=rec.n, resumed=resumed, bytes_host=host_bytes)
                self.status_tracker.backward_level(k, rec.n, sp.secs,
                                                   resumed=resumed)
                flightrec.boundary("backward", k)
        except preempt.PreemptionRequested:
            # Everything resolved before the boundary is sealed first.
            if pending is not None:
                pending()
            raise
        if pending is not None:
            pending()  # the root level's tail
        return resolved

    # ------------------------------------------------------- generic path

    def _forward_generic(self, pools: Dict[int, np.ndarray], start: int):
        """Host-pooled forward for multi-jump games."""
        g, dev = self.game, self.device
        k = start
        while pools and k <= max(pools):
            if k not in pools:
                k += 1
                continue
            n = int(pools[k].shape[0])
            sp = Span("forward", logger=self.logger, level=k)
            self._boundary("forward", k, frontier=n)

            def _step(k=k):
                faults.fire("engine.forward", level=k)
                faults.fire("engine.dedup", level=k)
                frontier = torch.from_numpy(pools[k]).to(dev)
                uniq, kid_levels = expand_with_levels(g, frontier)
                return uniq.cpu().numpy(), kid_levels.cpu().numpy()

            # Two-stage dedup: the step's sort-unique (its wait is the
            # download) and the host merge into per-level pools.
            with trace_span("dedup", level=k):
                kids, kid_levels = self._retry("engine.forward", _step,
                                               level=k)
                for lv in np.unique(kid_levels):
                    lv = int(lv)
                    self._check_level(lv)
                    batch = kids[kid_levels == lv]
                    pools[lv] = (np.union1d(pools[lv], batch) if lv in pools
                                 else batch)
            sp.end(frontier=n, children=int(kids.shape[0]))
            self.status_tracker.forward_level(k, n, sp.secs)
            flightrec.boundary("forward", k)
            k += 1

    def _backward_generic(self, pools: Dict[int, np.ndarray], root: int,
                          misses: List) -> Dict[int, LevelTable]:
        g, dev = self.game, self.device
        resolved: Dict[int, LevelTable] = {}
        cache: Dict[int, tuple] = {}  # level -> device (states, values, rem)
        for k in sorted(pools, reverse=True):
            n = int(pools[k].shape[0])
            sp = Span("backward", logger=self.logger, level=k)
            self._boundary("backward", k, n=n)
            states = torch.from_numpy(pools[k]).to(dev)
            table = self._load_sealed(k, lambda k=k: pools[k])
            resumed = table is not None
            if table is not None:
                values = torch.from_numpy(table.values).to(dev)
                rem = torch.from_numpy(table.remoteness).to(dev)
            else:
                window = [cache[k + j] for j in range(1, g.max_level_jump + 1)
                          if k + j in cache]

                def _resolve(states=states, window=window, k=k):
                    faults.fire("engine.backward", level=k)
                    return self._resolve_blocked(states, window)

                values, rem, miss = self._retry("engine.backward", _resolve,
                                                level=k)
                misses.append(miss)
                self._misses_check(k, miss)
            # The pool uploads every level; its states never download.
            fetch, down = self._level_fetch(k, root, table, pools[k],
                                            states, values, rem)
            self._level_tail(k, root, fetch, resumed, resolved)
            host_bytes = n * _STATE_BYTES + down
            self.bytes_host += host_bytes
            sp.end(n=n, resumed=resumed, bytes_host=host_bytes)
            self.status_tracker.backward_level(k, n, sp.secs,
                                               resumed=resumed)
            flightrec.boundary("backward", k)
            cache[k] = (states, values, rem)
            # Levels deeper than the lookback window are never read again.
            for done in [d for d in cache if d > k + g.max_level_jump]:
                del cache[done]
        return resolved

    # -------------------------------------------------------------- solve

    def solve(self) -> SolveResult:
        """The solve body under the optional heartbeat, the env-gated
        watchdog and the live status server, which all read
        ``progress``."""
        self.status_tracker.begin(game=self.game.name, engine="classic",
                                  world=1, rank=0)
        with watched(lambda: self.progress, self.logger,
                     self.heartbeat_secs, self._status_payload):
            return self._solve_impl()

    def _status_payload(self) -> dict:
        """The /status body (HTTP handler threads: reads only replaced
        state)."""
        snap = self.status_tracker.snapshot(progress=self.progress)
        snap["retries"] = self.retries
        return snap

    def _solve_impl(self) -> SolveResult:
        g, ckpt = self.game, self.checkpointer
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        saved, partial = None, {}
        if ckpt is not None:
            ckpt.begin_solve()
            ckpt.bind_game(g.name, g.state_dtype)
            saved = ckpt.load_frontiers()
            if self.fast and saved is None:
                # An interrupted forward left per-level frontier files.
                partial = ckpt.load_forward_levels()
        self._completed = (set(ckpt.completed_levels()) if ckpt is not None
                           else set())
        init, start = canonical_scalar(g, g.initial_state())
        misses: List[torch.Tensor] = []
        if self.fast:
            if saved is not None:
                levels = {k: _Level(v.shape[0], host=v)
                          for k, v in saved.items()}
            else:
                levels = self._forward_fast(init, start, resume=partial)
                if ckpt is not None:
                    ckpt.mark_frontiers_complete()
            t_forward = time.perf_counter() - t0
            num_positions = sum(rec.n for rec in levels.values())
            nlevels = len(levels)
            # The schedule is fixed: /status's ETA knows the rest exactly.
            self.status_tracker.set_schedule(
                {k: rec.n for k, rec in levels.items()})
            resolved = self._backward_fast(levels, start, misses)
        else:
            if saved is not None:
                pools = saved
            else:
                pools = {start: np.array([init], dtype=np.int64)}
                self._forward_generic(pools, start)
                if ckpt is not None:
                    ckpt.save_frontiers(pools)
            t_forward = time.perf_counter() - t0
            num_positions = sum(int(a.shape[0]) for a in pools.values())
            nlevels = len(pools)
            self.status_tracker.set_schedule(
                {k: int(a.shape[0]) for k, a in pools.items()})
            resolved = self._backward_generic(pools, start, misses)
        total_misses = int(sum(misses)) if misses else 0  # one final sync
        t_total = time.perf_counter() - t0

        root = resolved[start]
        i = int(np.searchsorted(root.states, init))
        if i >= root.states.shape[0] or root.states[i] != init:
            raise SolverError(
                f"root state {init:#x} missing from its solved level "
                f"{start} — canonicalize/level_of inconsistent")
        stats = {
            "game": g.name,
            "engine": "classic",
            "device": str(self.device),
            "devices": 1,
            "path": "fast" if self.fast else "generic",
            "positions": num_positions,
            "levels": nlevels,
            "secs_forward": t_forward,
            "secs_backward": t_total - t_forward,
            "secs_total": t_total,
            "positions_per_sec": num_positions / max(t_total, 1e-9),
            "use_provenance": bool(self.fast and self.use_provenance),
            "provenance_levels": self.provenance_levels,
            "misses": total_misses,
            "retries": self.retries,
            "bytes_host": self.bytes_host,
            "overlap_secs": round(self.overlap_secs, 3),
            "pipeline": self.pipeline,
            # Device memory is a card metric: None for a CPU solve.
            "peak_mem_bytes": (torch.cuda.max_memory_allocated(self.device)
                               if cuda else None),
        }
        if ckpt is not None:
            stats.update(ckpt.solve_stats())
        self.progress = {"phase": "done"}
        if self.logger is not None:
            self.logger.log({"phase": "done", **stats})
        record_solve(g.name, num_positions, t_total)
        return SolveResult(g, int(root.values[i]), int(root.remoteness[i]),
                           resolved, stats)


@contextlib.contextmanager
def watched(progress, logger, heartbeat_secs: float, status_payload=None):
    """The threads that watch a solve, all reading ``progress()`` (a dict
    the engine replaces, never mutates): the heartbeat when
    heartbeat_secs > 0, the watchdog when GAMESMAN_WATCHDOG_SECS > 0 and,
    given a payload, the /status server when GAMESMAN_STATUS_PORT is set.
    Yields the status server (None when off)."""
    hb = (Heartbeat(heartbeat_secs, progress=progress, logger=logger).start()
          if heartbeat_secs > 0 else None)
    wd = maybe_watchdog(progress, logger=logger)
    srv = (maybe_status_server(status_payload)
           if status_payload is not None else None)
    try:
        yield srv
    finally:
        for watcher in (srv, hb, wd):
            if watcher is not None:
                watcher.stop()


def record_solve(game_name: str, positions: int, secs: float) -> None:
    """Solve-level registry rollups (what a /metrics scrape or a
    --metrics-out dump aggregates over every solve of the process)."""
    reg = default_registry()
    reg.counter("gamesman_solves_total", "completed solves",
                game=game_name).inc()
    reg.counter("gamesman_solve_positions_total",
                "reachable positions solved", game=game_name).inc(positions)
    reg.histogram("gamesman_solve_seconds", "wall seconds per full solve",
                  game=game_name).observe(secs)


def solve(game: TensorGame, **kwargs) -> SolveResult:
    """Convenience: Solver(game, **kwargs).solve()."""
    return Solver(game, **kwargs).solve()
