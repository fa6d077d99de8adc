"""Hybrid dense/BFS solver for Connect-4 boards (port of
gamesmanmpi_tpu/solve/hybrid.py).

The dense engine (solve/dense.py) pays for ENCODABLE positions, a
closed-form superset of the reachable set whose blowup concentrates in
the near-full levels; the level-BFS engines pay for REACHABLE positions
but buy them with sorts and joins. This module composes them at a
cutover level K:

* levels 0..K: dense (no discovery, no sorts, 1 byte per encodable
  position);
* levels K+1..N: level-BFS over reachable positions only, on one device
  (solve/engine.Solver) or sharded (parallel/sharded.ShardedSolver).

The seam:

1. the dense reach sweep runs up to B = K+1 and keeps level B's reach
   array (DenseSolver._sweep_levels);
2. :func:`build_extract_step` turns level B's reachable (row, rank)
   cells into the game's packed states (current player's stones |
   guards), one sorted frontier;
3. the BFS engine solves levels B..N from that frontier and keeps level
   B's table;
4. the boundary join resolves dense level K: each child is built as a
   packed state (opponent | (guards + newbit), the branch-free drop of
   games/connect4.expand) and searched in level B's sorted table,
   resident (:func:`build_boundary_step`) or streamed through the device
   in blocks (:func:`build_boundary_children_step`,
   :func:`build_boundary_lookup_acc_step`,
   :func:`build_boundary_combine_step`), chosen by
   ``GAMESMAN_HYBRID_RESIDENT_MB`` with ``GAMESMAN_HYBRID_WBLOCK``-state
   blocks;
5. levels K-1..0 are ordinary dense steps chained from the boundary
   cells, each through the window-gather kernel (ops/window_gather.py).

Children of reachable positions are reachable, so a reachable level-K
parent never misses the level-B table; an unreachable (garbage) parent
may miss and take UNDECIDED, but garbage is read only by garbage, the
dense engine's own quarantine argument. The hybrid's dense cells
therefore equal the pure dense engine's on reachable positions only.

sym=1: the BFS region keeps the mirror reduction and the dense region
runs a sym-free twin of the game. The seam canonicalizes both ways: the
extracted frontier becomes mirror representatives (deduplicated across
rank blocks on the host) and the join's children are canonicalized
before the search.

Everything here is eager torch on the int64 carrier around the dense
engine's steps; none of these steps is a kernel in the reference either.
devices > 1 rank-partitions the dense region over the mesh and shards
the BFS region; the extraction and the join stay on the home device.

Records (``logger=``), the reference's: ``hybrid_sweep`` (boundary,
frontier, reachable, secs) after the extraction, ``hybrid_bfs``
(levels, positions, secs) after the BFS region, and ``done`` with the
solve's stats. The dense half gets the logger too; as in the reference,
only its solve() writes records, which the hybrid never calls.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from gamesmanmpi_tpu_torch.core.bitops import SENTINEL
from gamesmanmpi_tpu_torch.core.values import LOSE, UNDECIDED
from gamesmanmpi_tpu_torch.games.connect4 import Connect4
from gamesmanmpi_tpu_torch.ops.combine import combine_children
from gamesmanmpi_tpu_torch.solve.dense import (
    DenseSolver,
    _connected_fold,
    _unrank_bits,
    n1_of_level,
)
from gamesmanmpi_tpu_torch.solve.engine import Solver, canonical_scalar
from gamesmanmpi_tpu_torch.utils.env import env_int_strict


def default_cutover(ncells: int) -> int:
    """The 2/3 point of the board's levels (the reference's default)."""
    return (2 * ncells) // 3


def _ranks(rank0: int, cblock: int, device):
    return rank0 + torch.arange(cblock, dtype=torch.int64,
                                device=device)[None, :]


def build_extract_step(tables, level: int, cblock: int, canon_fn=None):
    """Level-B frontier extraction: (row, rank) reach cells -> packed
    states.

    Returned fn: (rank0 int, reach [P, cblock] uint8, consts (the reach
    constants: cellidx, filled), binom, guards [P] int64) -> packed
    [P, cblock] int64, SENTINEL where not reachable or past the class.
    At level B the player to move is player 1 iff B is even. canon_fn
    (sym=1) maps the kept states to mirror representatives, before the
    sentinel fill (canonicalizing the sentinel would corrupt it)."""
    n1 = n1_of_level(level)
    C = tables.class_size[level]
    current_is_p1 = level % 2 == 0
    bitpos = [int(b) for b in tables.bitpos]

    def step(rank0, reach, consts, binom, guards):
        ranks = _ranks(rank0, cblock, reach.device)
        p1 = _unrank_bits(ranks, n1, binom, consts["cellidx"], bitpos)
        current = p1 if current_is_p1 else consts["filled"][:, None] ^ p1
        packed = current | guards[:, None]
        if canon_fn is not None:
            packed = canon_fn(packed)
        keep = (reach != 0) & (ranks < C)
        return torch.where(keep, packed, SENTINEL)

    return step


def _boundary_algebra(tables, level: int, cblock: int):
    """The unrank/line/drop prologue shared by both boundary lowerings:
    -> fn(rank0, consts, binom, guards) -> (children list of w [P, cblock]
    int64 packed states, prim_mask [P, cblock] bool)."""
    w, h, connect = tables.width, tables.height, tables.connect
    n1 = n1_of_level(level)
    p1_moves = level % 2 == 0     # the player moving OUT of level K
    mover_is_p1 = level % 2 == 1  # the player who made the ply INTO it
    bitpos = [int(b) for b in tables.bitpos]

    def children(rank0, consts, binom, guards):
        filled = consts["filled"]
        p1 = _unrank_bits(_ranks(rank0, cblock, filled.device), n1, binom,
                          consts["cellidx"], bitpos)
        p2 = filled[:, None] ^ p1
        mover = p1 if mover_is_p1 else p2
        current = p2 if mover_is_p1 else p1
        prim = (_connected_fold(mover, h, connect)
                | _connected_fold(current, h, connect))
        opponent = p2 if p1_moves else p1
        kids = [opponent | (guards[:, None] + consts["newbit"][:, c:c + 1])
                for c in range(w)]
        return kids, prim

    return children


def _combine_tail(cv, cr, prim, valid, cblock: int):
    """[P, cblock, w] child values/remoteness -> level-K cells [P, cblock]
    uint8 (value | remoteness << 2): the negamax combine, primitives LOSE
    with remoteness 0."""
    P, w = valid.shape
    mk = (valid[:, None, :] & ~prim[..., None]).reshape(P * cblock, w)
    values, rem = combine_children(cv.reshape(P * cblock, w),
                                   cr.reshape(P * cblock, w), mk)
    values = values.reshape(P, cblock).masked_fill_(prim, LOSE)
    rem = rem.reshape(P, cblock).masked_fill_(prim, 0)
    return values | (rem.clamp(0, 63).to(torch.uint8) << 2)


def _search(kstates, kcells, children):
    """Cells of `children` in the sorted (kstates, kcells) table, the
    UNDECIDED cell 0 where absent."""
    flat = children.reshape(-1)
    idx = torch.searchsorted(kstates, flat).clamp(0, kstates.numel() - 1)
    hit = kstates[idx] == flat
    return torch.where(hit, kcells[idx], UNDECIDED).reshape(children.shape)


def build_boundary_step(tables, level: int, cblock: int, canon_fn=None):
    """Dense resolve of cutover level K against the resident level-B
    table.

    Returned fn: (rank0, kstates [wcap] sorted int64 with a SENTINEL
    tail, kcells [wcap] uint8 dense cells, consts (the backward
    constants), binom, guards) -> cells [P, cblock] uint8. canon_fn
    (sym=1): children are canonicalized before the search (the table
    holds representatives; the mirror keeps value and remoteness)."""
    algebra = _boundary_algebra(tables, level, cblock)

    def step(rank0, kstates, kcells, consts, binom, guards):
        kids, prim = algebra(rank0, consts, binom, guards)
        cells = []
        for child in kids:
            if canon_fn is not None:
                child = canon_fn(child)
            cells.append(_search(kstates, kcells, child))
        cell = torch.stack(cells, dim=-1)
        return _combine_tail(cell & 3, (cell >> 2).to(torch.int32), prim,
                             consts["valid"], cblock)

    return step


def build_boundary_children_step(tables, level: int, cblock: int,
                                 canon_fn=None):
    """Streamed boundary, phase 1: one rank block's packed children,
    emitted once so the per-block searches never repeat the unrank walks.

    Returned fn: (rank0, consts, binom, guards) -> (children [P, cblock,
    w] int64, prim_mask [P, cblock] bool)."""
    algebra = _boundary_algebra(tables, level, cblock)

    def step(rank0, consts, binom, guards):
        kids, prim = algebra(rank0, consts, binom, guards)
        children = torch.stack(kids, dim=-1)
        if canon_fn is not None:
            children = canon_fn(children)
        return children, prim

    return step


def build_boundary_lookup_acc_step():
    """Streamed boundary, phase 2 (once per table block): search one
    sorted block of the level-B table and keep the hit cells. Blocks
    partition the sorted table, so a child hits at most one block, and a
    hit cell is nonzero (a decided value): accumulation is a select.

    Returned fn: (children_flat [N], acc [N] uint8, kstates [wb],
    kcells [wb] uint8) -> acc' [N] uint8."""

    def step(children_flat, acc, kstates, kcells):
        idx = torch.searchsorted(kstates, children_flat).clamp(
            0, kstates.numel() - 1)
        hit = kstates[idx] == children_flat
        return torch.where(hit, kcells[idx], acc)

    return step


def build_boundary_combine_step(cblock: int, w: int):
    """Streamed boundary, phase 3: accumulated child cells -> level-K
    cells. Returned fn: (acc [P, cblock, w] uint8, prim_mask [P, cblock],
    valid [P, w]) -> cells [P, cblock] uint8."""

    def step(acc, prim, valid):
        return _combine_tail(acc & 3, (acc >> 2).to(torch.int32), prim,
                             valid, cblock)

    return step


class HybridSolveResult:
    """Duck-typed SolveResult: dense cells up to the cutover, BFS tables
    above it."""

    def __init__(self, game, tables, cutover: int, value: int,
                 remoteness: int, cells, bfs_levels, stats: dict):
        self.game = game
        self._tables = tables
        self.cutover = cutover
        self.value = int(value)
        self.remoteness = int(remoteness)
        self.cells = cells          # {level <= K: [P, C] uint8} or None
        self.levels = bfs_levels    # {level > K: LevelTable} or None
        self.stats = stats

    @property
    def num_positions(self) -> int:
        return self.stats["positions"]

    def lookup(self, state) -> tuple[int, int]:
        """(value, remoteness) of a packed position from the side of the
        cutover that owns its level. Dense side: any encodable position
        but the placeholder class (the player to move already has a
        line), as DenseSolveResult; BFS side: reachable positions only,
        canonicalized under sym=1, as SolveResult."""
        state = int(state)
        level, row, rank = self._tables.locate(state)
        if level <= self.cutover:
            if self.cells is None:
                raise KeyError("solved in no-tables mode")
            if self._tables.current_player_has_line(level, row, rank):
                raise KeyError(
                    f"state {state:#x} is not a position (the player to "
                    "move already has a line); its cell is a placeholder")
            cell = int(self.cells[level][row, rank])
            return cell & 3, cell >> 2
        if self.levels is None:
            raise KeyError("solved in no-tables mode")
        state, level = canonical_scalar(self.game, state)
        table = self.levels.get(level)
        if table is not None:
            i = int(np.searchsorted(table.states, state))
            if i < table.states.shape[0] and int(table.states[i]) == state:
                return int(table.values[i]), int(table.remoteness[i])
        raise KeyError(f"state {state:#x} not reachable/solved")


class HybridSolver:
    """The dense engine at levels <= cutover, level-BFS above (module
    docstring).

    cutover: the last dense level K, 0 <= K < ncells; None reads
    GAMESMAN_HYBRID_CUTOVER, else :func:`default_cutover`. A bad value
    raises ValueError. devices: 1, or N shards for both regions.
    device: "cuda" (default) or "cpu". logger: a utils/metrics logger
    for the records (module docstring).
    """

    def __init__(self, game: Connect4, cutover: Optional[int] = None,
                 store_tables: bool = True, device="cuda", devices: int = 1,
                 logger=None):
        if not isinstance(game, Connect4):
            raise TypeError("HybridSolver requires a Connect4-family game")
        self.game = game
        self.dense_game = (Connect4(game.width, game.height, game.connect,
                                    sym=False) if game.sym else game)
        self.store_tables = store_tables
        self.logger = logger
        self.devices = int(devices)
        if self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        #: table blocks streamed through the boundary join (0: resident)
        self.boundary_stream_blocks = 0
        # Parsed here so a typo fails before the sweep and the BFS run.
        self.resident_mb = env_int_strict("GAMESMAN_HYBRID_RESIDENT_MB",
                                          2048)
        self.wblock = env_int_strict("GAMESMAN_HYBRID_WBLOCK", 1 << 22)
        self.dense = DenseSolver(self.dense_game, store_tables=store_tables,
                                 device=device, devices=self.devices,
                                 logger=logger)
        self.device = self.dense.device
        self.tables = self.dense.tables
        nc = self.tables.ncells
        if cutover is None:
            cutover = env_int_strict("GAMESMAN_HYBRID_CUTOVER",
                                     default_cutover(nc))
        if not 0 <= cutover < nc:
            raise ValueError(f"cutover must be in [0, {nc}) for a "
                             f"{nc}-cell board, got {cutover}")
        self.cutover = int(cutover)

    # ------------------------------------------------------------- phases

    def _log(self, **rec) -> None:
        if self.logger is not None:
            self.logger.log(rec)

    def _guards(self, level: int) -> torch.Tensor:
        return torch.as_tensor(
            self.tables.level_consts(level)["guards"].astype(np.int64),
            device=self.device)

    def _extract_frontier(self, reach_flat) -> np.ndarray:
        """Level-B reachable (row, rank) cells -> sorted packed states
        (int64), deduplicated across rank blocks under sym=1 (a mirror
        pair can fall in two blocks). The merge runs on the device: with
        a host np.unique the extraction took 6.0 s of a 7.7 s 5x5 solve
        at K=16 on the H100 machine (tools/torch_hybrid_cutover.py)."""
        d, t, g = self.dense, self.tables, self.game
        B = self.cutover + 1
        P, C = len(t.profiles[B]), t.class_size[B]
        cblock, nblk = d._cblock(B)
        consts = d._level_tensors(B, for_reach=True)
        guards = self._guards(B)
        reach = reach_flat.reshape(P, C)
        step = build_extract_step(t, B, cblock,
                                  canon_fn=g.canonicalize if g.sym else None)
        pieces = []
        for b in range(nblk):
            lo = b * cblock
            blk = reach[:, lo:lo + cblock]
            if blk.shape[1] != cblock:  # the ragged last block: pad 0s
                blk = torch.cat([blk, blk.new_zeros((P, cblock
                                                     - blk.shape[1]))], 1)
            packed = step(lo, blk, consts, d._binom, guards).reshape(-1)
            pieces.append(packed[packed != SENTINEL])
        return torch.unique(torch.cat(pieces)).cpu().numpy()

    @staticmethod
    def _dense_cell_table(table):
        """A BFS LevelTable -> (sorted int64 states, uint8 dense cells)
        host arrays for the boundary join."""
        cells = (table.values.astype(np.uint8)
                 | (np.clip(table.remoteness, 0, 63).astype(np.uint8) << 2))
        return np.asarray(table.states, dtype=np.int64), cells

    def _resolve_boundary(self, kstates: np.ndarray, kcells: np.ndarray):
        """Dense level-K cells resolved against the level-B table: the
        whole table on the device when its bytes (the reference's state
        dtype + 1 B a state) fit GAMESMAN_HYBRID_RESIDENT_MB, else
        streamed from the host in GAMESMAN_HYBRID_WBLOCK-state blocks
        once per rank block (children built once per rank block, hits
        selected per table block, one combine).

        The 2048 MiB default is the reference's, not a measure of the
        card. At the default cutover 5x5's level-17 table is 34 MB
        (6,789,890 uint32 states) and 5x6's level 21 at most 1.94 GB
        (225,738,240 encodable cells at 9 B), so both stay resident;
        6x5's level 21 (up to 587,624,856 cells, 5.0 GB) is the first
        board that can take the streamed path. No card run takes it."""
        d, t, g = self.dense, self.tables, self.game
        K = self.cutover
        P, C = len(t.profiles[K]), t.class_size[K]
        cblock, nblk = d._cblock(K)
        consts = d._level_tensors(K, for_reach=False)
        guards = self._guards(K)
        canon = g.canonicalize if g.sym else None
        dev = self.device
        wcap = int(kstates.shape[0])
        table_bytes = wcap * (np.dtype(g.state_dtype).itemsize + 1)
        blocks = []
        if table_bytes <= self.resident_mb << 20:
            step = build_boundary_step(t, K, cblock, canon_fn=canon)
            ks = torch.from_numpy(kstates).to(dev)
            kc = torch.from_numpy(kcells).to(dev)
            for b in range(nblk):
                blocks.append(step(b * cblock, ks, kc, consts, d._binom,
                                   guards))
        else:
            wb = min(max(256, 1 << (max(self.wblock, 1) - 1).bit_length()),
                     max(wcap, 1))
            children_step = build_boundary_children_step(t, K, cblock,
                                                         canon_fn=canon)
            acc_step = build_boundary_lookup_acc_step()
            combine_step = build_boundary_combine_step(cblock, t.width)
            for b in range(nblk):
                children, prim = children_step(b * cblock, consts, d._binom,
                                               guards)
                flat = children.reshape(-1)
                acc = torch.zeros(flat.shape, dtype=torch.uint8, device=dev)
                for off in range(0, wcap, wb):
                    acc = acc_step(
                        flat, acc,
                        torch.from_numpy(kstates[off:off + wb]).to(dev),
                        torch.from_numpy(kcells[off:off + wb]).to(dev))
                    self.boundary_stream_blocks += 1
                blocks.append(combine_step(acc.reshape(children.shape),
                                           prim, consts["valid"]))
        cells = blocks[0] if nblk == 1 else torch.cat(blocks, dim=1)
        return cells[:, :C].contiguous()

    def _bfs(self, frontier: np.ndarray, B: int):
        """Levels B..N by level-BFS from the frontier -> ({level:
        LevelTable} with level B's always kept, {level: count}, the
        engine's stats)."""
        g = self.game
        if self.devices > 1:
            from gamesmanmpi_tpu_torch.parallel import ShardedSolver

            bfs = ShardedSolver(g, num_shards=self.devices,
                                device=self.device,
                                store_tables=self.store_tables)
            levels = bfs._forward_fast(frontier, B)
            counts = {L: int(rec.counts.sum()) for L, rec in levels.items()}
            root = int(frontier[0]) if frontier.size else 0
            resolved, _ = bfs._backward(levels, B, root)
            return resolved, counts
        bfs = Solver(g, device=self.device, store_tables=self.store_tables)
        levels = bfs._forward_fast(frontier, B)
        counts = {L: rec.n for L, rec in levels.items()}
        return bfs._backward_fast(levels, B, []), counts

    # -------------------------------------------------------------- solve

    def solve(self) -> HybridSolveResult:
        g, t, d = self.game, self.tables, self.dense
        K = self.cutover
        B = K + 1
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        counts, reach_flat = d._sweep_levels(B)
        t_reach = time.perf_counter() - t0  # the counts synchronised
        frontier = self._extract_frontier(reach_flat)
        del reach_flat
        if g.sym:
            # Representatives number between half and all of the sweep's
            # full-space count (self-mirror positions keep it above N/2).
            ok = (counts[B] == 0 and frontier.shape[0] == 0) or (
                counts[B] // 2 <= frontier.shape[0] <= counts[B])
        else:
            ok = frontier.shape[0] == counts[B]
        if not ok:
            raise RuntimeError(
                f"hybrid seam: extracted {frontier.shape[0]} level-{B} "
                f"states but the sweep counted {counts[B]} "
                f"(sym={int(g.sym)}) — extraction/sweep disagree")
        t_sweep = time.perf_counter() - t0
        # frontier: what the BFS region is handed (representatives under
        # sym=1); reachable: the sweep's full-space count.
        self._log(phase="hybrid_sweep", boundary=B,
                  frontier=int(frontier.shape[0]), reachable=counts[B],
                  secs=round(t_sweep, 3))

        resolved, bfs_counts = self._bfs(frontier, B)
        t_bfs = time.perf_counter() - t0 - t_sweep
        self._log(phase="hybrid_bfs", levels=len(bfs_counts),
                  positions=sum(bfs_counts.values()), secs=round(t_bfs, 3))

        kstates, kcells = self._dense_cell_table(resolved[B])
        boundary = self._resolve_boundary(kstates, kcells)
        t_boundary = time.perf_counter() - t0 - t_sweep - t_bfs

        saved = {} if self.store_tables else None
        if saved is not None:
            saved[K] = boundary.cpu().numpy()
        child_flat = boundary.reshape(-1)
        nmiss = {}
        for L in range(K - 1, -1, -1):
            cells, nm = d._backward_level(L, child_flat)
            if nm is not None:
                nmiss[L] = nm
            child_flat = cells.reshape(-1)
            if saved is not None:
                saved[L] = cells.cpu().numpy()
        root_cell = int(child_flat[0])
        value, remoteness = root_cell & 3, root_cell >> 2
        t_total = time.perf_counter() - t0

        dense_positions = sum(v for L, v in counts.items() if L <= K)
        positions = dense_positions + sum(bfs_counts.values())
        stats = {
            "game": g.name,
            "engine": "hybrid",
            "device": str(self.device),
            "devices": self.devices,
            "cutover": K,
            # sym=1: the dense region counts the full reachable set, the
            # BFS region mirror representatives.
            "positions": positions,
            "positions_dense_region": dense_positions,
            "positions_bfs_region": sum(bfs_counts.values()),
            "positions_per_sec": positions / max(t_total, 1e-9),
            "secs_forward": t_sweep,
            "secs_reach": t_reach,
            "secs_backward": t_total - t_sweep,
            "secs_total": t_total,
            "secs_bfs": t_bfs,
            "secs_boundary": t_boundary,
            "frontier_at_boundary": int(frontier.shape[0]),
            "reachable_at_boundary": counts[B],
            "boundary_stream_blocks": self.boundary_stream_blocks,
            "gather_mode": d.gather_mode,
            "gather_nmiss_per_level": {L: int(v) for L, v in nmiss.items()},
            "peak_mem_bytes": (torch.cuda.max_memory_allocated(self.device)
                               if cuda else None),
        }
        stats["gather_nmiss"] = sum(stats["gather_nmiss_per_level"].values())
        self._log(phase="done", **{k: v for k, v in stats.items()
                                   if k != "game"})
        return HybridSolveResult(
            g, t, K, value, remoteness, saved,
            dict(resolved) if self.store_tables else None, stats)
