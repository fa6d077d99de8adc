"""Compat shim: unmodified reference-style game modules (port of
gamesmanmpi_tpu/compat/shim.py).

Two paths (see package docstring):

  solve_module(module)   — host solve via the memoized-negamax oracle. The
                           reference's own execution model (per-position
                           Python calls) at single-process scale; correct for
                           any acyclic game with hashable positions.
  TensorizedModule(...)  — lifts a scalar module onto the TensorGame
                           protocol, so the port's classic engine drives an
                           unmodified plugin. In eager torch each batched
                           call copies its states to the host, runs the
                           module's Python functions per position, and
                           copies the result back to the batch's device
                           (the reference does this with jax.pure_callback).
                           Positions must be ints below 2^63 (the int64
                           carrier), and a topological `level_fn` must
                           exist — module attribute `level_of`, or passed
                           explicitly. Deliberately slow (a host round
                           trip per batch) and excluded from benchmarks.
"""

from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import torch

from gamesmanmpi_tpu_torch.core.bitops import SENTINEL
from gamesmanmpi_tpu_torch.core.values import UNDECIDED
from gamesmanmpi_tpu_torch.games.base import TensorGame
from gamesmanmpi_tpu_torch.solve.oracle import (
    module_api,
    normalize_value,
    oracle_solve,
)

# Bounded BFS probe size for auto-deriving max_moves. Small games are fully
# explored (exact bound); larger games get an estimate that the grow-and-
# retry loop in solve_module_tensorized corrects. Tests shrink this to
# force the retry path deterministically.
_PROBE_LIMIT = 1024

#: The retry contract between TensorizedModule's expand and
#: solve_module_tensorized: a token no game module's own error text uses.
_OVERFLOW_TOKEN = "GAMESMAN_MAX_MOVES_OVERFLOW"


def _probe_max_moves(initial, gen, do, prim) -> int:
    """Max observed branching over a bounded BFS from the initial position."""
    seen = {int(initial)}
    frontier = [int(initial)]
    best = 1
    while frontier and len(seen) < _PROBE_LIMIT:
        nxt = []
        for pos in frontier:
            if normalize_value(prim(pos)) != UNDECIDED:
                continue
            moves = list(gen(pos))
            best = max(best, len(moves))
            for m in moves:
                child = int(do(pos, m))
                if child not in seen:
                    seen.add(child)
                    nxt.append(child)
                if len(seen) >= _PROBE_LIMIT:
                    break
        frontier = nxt
    return best


def solve_module_tensorized(module, *, devices: int = 1,
                            max_retries: int = 6, **kwargs):
    """Drive an unmodified scalar module through the port's classic engine
    on one device, or with devices > 1 through the sharded engine over
    that many shards (the reference's solve_module_jitted).

    Lifts the module with TensorizedModule (auto-deriving max_moves when
    the module doesn't declare it) and solves; if a position mid-solve
    turns out to have more moves than the probe saw, expand raises and
    this loop doubles max_moves and re-solves.

    `level_of` cannot be auto-derived the same way: a topological level
    function is a *global* invariant of the game graph (every move
    strictly increases it), and no bounded sample can certify one — so
    modules must still declare it (or callers pass level_fn=).

    kwargs go to the solver (device=, paranoid=, checkpointer=,
    store_tables=, ...). Returns a SolveResult.
    """
    if devices > 1:
        from functools import partial

        from gamesmanmpi_tpu_torch.parallel import ShardedSolver

        solver = partial(ShardedSolver, num_shards=devices)
    else:
        from gamesmanmpi_tpu_torch.solve.engine import Solver as solver

    game = TensorizedModule(module)
    for attempt in range(max_retries + 1):
        try:
            return solver(game, **kwargs).solve()
        except ValueError as e:
            if _OVERFLOW_TOKEN not in str(e) or attempt == max_retries:
                raise
            game = TensorizedModule(module, max_moves=2 * game.max_moves)


def load_game_module(path):
    """Dynamic plugin import, the solver_launcher.py way: load a Python
    file, validate the 4-function API, return the module."""
    path = pathlib.Path(path)
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module_api(module)  # validates required attributes
    return module


def solve_module(module):
    """Solve an unmodified reference-style module on host.

    Returns (value, remoteness, table) — table maps every reachable position
    to (value, remoteness), the same observable output as the reference.
    """
    return oracle_solve(module)


class TensorizedModule(TensorGame):
    """A scalar 4-function module lifted onto the batched TensorGame API."""

    def __init__(
        self,
        module,
        *,
        max_moves: int | None = None,
        level_fn=None,
        max_level_jump: int | None = None,
        num_levels: int | None = None,
    ):
        initial, gen, do, prim = module_api(module)
        if not isinstance(initial, (int, np.integer)):
            raise TypeError(
                "TensorizedModule needs int-packed positions; use "
                "solve_module() for arbitrary hashable positions"
            )
        self._gen, self._do, self._prim = gen, do, prim
        self._initial = int(initial)
        self.name = f"compat_{getattr(module, '__name__', 'module')}"
        level_fn = level_fn or getattr(module, "level_of", None)
        if level_fn is None:
            raise ValueError(
                "a topological level function is required: pass level_fn= or "
                "define level_of(pos) in the module (see games/base.py)"
            )
        self._level_fn = level_fn
        if max_moves is None:
            max_moves = getattr(module, "max_moves", None)
        if max_moves is None:
            # Auto-derive the [B, M] width by a bounded BFS probe. Games
            # whose branching grows beyond the probed sample under-size
            # it; _expand_host then raises a recognizable error and
            # solve_module_tensorized grows max_moves and retries.
            max_moves = _probe_max_moves(self._initial, gen, do, prim)
        self.max_moves = int(max_moves)
        self.max_level_jump = int(
            max_level_jump or getattr(module, "max_level_jump", 1)
        )
        self.num_levels = int(num_levels or getattr(module, "num_levels", 1 << 20))

    def initial_state(self) -> int:
        return self._initial

    # Host round trips — one per batch, not per position.

    def _expand_host(self, states: np.ndarray):
        B = states.shape[0]
        kids = np.full((B, self.max_moves), SENTINEL, dtype=np.int64)
        mask = np.zeros((B, self.max_moves), dtype=bool)
        for i, s in enumerate(states.tolist()):
            if s == SENTINEL:
                continue
            if normalize_value(self._prim(s)) != UNDECIDED:
                continue
            moves = list(self._gen(s))
            if len(moves) > self.max_moves:
                raise ValueError(
                    f"{_OVERFLOW_TOKEN}: position {s:#x} has "
                    f"{len(moves)} moves > max_moves={self.max_moves}"
                )
            for j, m in enumerate(moves):
                kids[i, j] = self._do(s, m)
                mask[i, j] = True
        return kids, mask

    def _per_state(self, states, fn, dtype):
        host = states.cpu().numpy()
        out = np.zeros(host.size, dtype=dtype)
        for i, s in enumerate(host.reshape(-1).tolist()):
            if s != SENTINEL:
                out[i] = fn(s)
        return torch.from_numpy(out.reshape(host.shape)).to(states.device)

    # TensorGame protocol.

    def expand(self, states):
        kids, mask = self._expand_host(states.cpu().numpy())
        return (torch.from_numpy(kids).to(states.device),
                torch.from_numpy(mask).to(states.device))

    def primitive(self, states):
        return self._per_state(
            states, lambda s: normalize_value(self._prim(s)), np.uint8)

    def level_of(self, states):
        return self._per_state(states, self._level_fn, np.int32)
