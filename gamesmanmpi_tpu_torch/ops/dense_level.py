"""The dense engine's level steps: hand-written CUDA kernels, their plain
PyTorch versions and the kernels' launch arithmetic.

The reference runs each level step of its dense Connect-4 engine as one
XLA program per (level, block width): ``build_dense_step``
(gamesmanmpi_tpu/solve/dense.py:577) for the backward sweep and
``build_reach_step`` (:759) for the reachability sweep, ``lax.fori_loop``
walks over the board's cells in the reference's narrowed words. Here each
is one CUDA kernel (kernels/csrc/dense_level.cu), one thread per lane of a
[P, width] block whose ranks start at ``rank0``; no intermediate touches
device memory.

* :func:`dense_step` — per lane: unrank player 1's stones, both win
  folds, per move the child's bitboard, combinadic rank, flat index
  (with the monotone fill of the window gather) and packed cell, then the
  negamax combine (ops/combine.py's rules) -> the lane's packed cell; and
  the window gather's miss count over the same partition as
  ops/window_gather.monotone_window_gather_ref (so ``nmiss`` equals the
  eager window path's to the lane).
* :func:`reach_step` — per lane: the OR over columns of "the top stone is
  the last mover's, the parent had no line and is reachable" -> the u8
  reach, and the block's count of in-range reached lanes.
* :func:`dense_step_ref`, :func:`reach_step_ref` — the plain PyTorch
  versions (int64 eager ops; the only route of the ``plain`` and
  ``sorted`` gather modes).
* :func:`word_widths`, :func:`level_geom`, :func:`kernel_consts`,
  :func:`step_plan`, :data:`ARGS` — the launch arithmetic: the word widths
  (the reference's bits/rank/flat dtypes), the constants in the kernel's
  layout, grid and shared memory, and the launch's argument vector.

A wrapper launches its kernel for a CUDA tensor (counting the launch in
kernels.LAUNCHES) and returns the plain version for a CPU tensor; any
other device raises. A failed build or launch raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from gamesmanmpi_tpu_torch import kernels
from gamesmanmpi_tpu_torch.core.values import LOSE, TIE
from gamesmanmpi_tpu_torch.ops.combine import combine_children
from gamesmanmpi_tpu_torch.ops.window_gather import (
    monotone_window_gather_ref,
    padded_table_len,
)

#: The CUDA source's constants: threads per CTA, lanes per CTA (the window
#: gather's miss block, so a CTA's lanes are exactly one block of the miss
#: partition) and the window the miss count is taken against.
THREADS = 256
RUN = 2048
WINDOW = 8192
#: Widest board and most cells the kernels take (shared-memory arrays).
MAX_COLS = 32
MAX_CELLS = 64

#: The launch functions' argument vector, in the order of the `Arg` enum
#: of kernels/csrc/dense_level.cu (a test holds the two together).
ARGS = ("P", "width", "rank0", "n", "size", "adj", "m", "nwin", "w", "h",
        "connect", "ncells", "n1", "K", "level", "words", "grid", "smem",
        "src", "out", "counter", "binom", "cellidx", "filled", "bits",
        "valid", "row", "fill", "ccellidx")


# ---------------------------------------------------------------------------
# Word widths and level geometry


@dataclass(frozen=True)
class Words:
    """Bit widths of the kernel's words: bitboards, combinadic ranks and
    flat indices — the reference's ``bits_dtype``, ``_rank_dtype`` and
    ``_flat_dtype``."""

    bits: int
    rank: int
    flat: int

    @property
    def code(self) -> int:
        """The launch's word code: bit 0 for 64-bit bitboards, bit 1 for
        64-bit ranks, bit 2 for 64-bit flat indices."""
        return ((self.bits == 64) | (self.rank == 64) << 1
                | (self.flat == 64) << 2)


@functools.lru_cache(maxsize=None)
def word_widths(width: int, height: int) -> Words:
    """The reference's word choice for a width x height board: uint32
    bitboards when the guard layout fits 31 bits, uint32 ranks when the
    largest class is below 2^31, int32 flat indices when the largest level
    ([P, C] lanes) is below 2^31; 64 bits otherwise. From counts alone
    (profiles per level by composition), no tables."""
    ncells = width * height
    profiles = [1] + [0] * ncells  # compositions into the columns so far
    for _ in range(width):
        nxt = [0] * (ncells + 1)
        for total, k in enumerate(profiles):
            for v in range(min(height, ncells - total) + 1):
                nxt[total + v] += k
        profiles = nxt
    sizes = [math.comb(L, (L + 1) // 2) for L in range(ncells + 1)]
    flat = max(p * s for p, s in zip(profiles, sizes))
    return Words(bits=64 if (height + 1) * width > 31 else 32,
                 rank=32 if max(sizes) < (1 << 31) else 64,
                 flat=32 if flat < (1 << 31) else 64)


@dataclass(frozen=True)
class LevelGeom:
    """What a level step needs of its board and level."""

    width: int
    height: int
    connect: int
    level: int
    size: int         # C: ranks per class at this level
    child_size: int   # the next level's class size (1 at the top)
    parent_size: int  # the previous level's class size (1 at level 0)
    bitpos: Tuple[int, ...]  # guard-layout bit of global cell j
    words: Words

    @property
    def ncells(self) -> int:
        return self.width * self.height

    @property
    def n1(self) -> int:
        """Player-1 stones at this level."""
        return (self.level + 1) // 2

    @property
    def is_top(self) -> bool:
        return self.level == self.ncells

    @property
    def K(self) -> int:
        """Columns of the binomial table (DenseTables.n1_width)."""
        return (self.ncells + 1) // 2 + 2


def level_geom(tables, level: int) -> LevelGeom:
    """The geometry of `level` of a solve/dense.DenseTables."""
    nc = tables.ncells
    return LevelGeom(
        width=tables.width, height=tables.height, connect=tables.connect,
        level=level, size=tables.class_size[level],
        child_size=tables.class_size[level + 1] if level < nc else 1,
        parent_size=tables.class_size[level - 1] if level > 0 else 1,
        bitpos=tuple(int(b) for b in tables.bitpos),
        words=word_widths(tables.width, tables.height))


# ---------------------------------------------------------------------------
# The kernel layout of the constants


def _word_array(a: np.ndarray, bits: int) -> torch.Tensor:
    """Unsigned words as a same-width signed tensor holding their bits."""
    u, s = (np.uint32, np.int32) if bits == 32 else (np.uint64, np.int64)
    return torch.from_numpy(np.ascontiguousarray(a.astype(u)).view(s))


def kernel_consts(tables, level: int, for_reach: bool, device,
                  words: Optional[Words] = None) -> dict:
    """A level's constants in the kernels' layout on `device`: every array
    row-major with the profile row first ([P, ...], where the eager steps
    take them steps first), cell indices int8, row numbers int32, flags
    u8, bit masks (and the binomials) in the kernel's word width (`words`,
    default the board's word_widths; a launch's geometry must carry the
    same), held as same-width signed tensors."""
    words = words or word_widths(tables.width, tables.height)
    c = tables.level_consts(level)

    def i8(a):
        return torch.from_numpy(np.ascontiguousarray(a.astype(np.int8)))

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a.astype(np.int32)))

    out = dict(cellidx=i8(c["cellidx"]),
               filled=_word_array(c["filled"], words.bits),
               binom=_word_array(tables.binom, words.rank))
    if for_reach:
        out.update(topstone=_word_array(c["topstone"], words.bits),
                   parent_row=i32(c["parent_row"]),
                   parent_cellidx=i8(c["parent_cellidx"]))
    else:
        out.update(newbit=_word_array(c["newbit"], words.bits),
                   valid=torch.from_numpy(
                       np.ascontiguousarray(c["valid"].astype(np.uint8))),
                   move_row=i32(c["move_row"]),
                   move_fill=i32(c["move_fill"]),
                   child_cellidx=i8(c["child_cellidx"]))
    return {k: v.to(device) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Launch arithmetic


@dataclass(frozen=True)
class StepPlan:
    """One launch: `grid` CTAs of THREADS threads, CTA b taking lanes
    [b*RUN, min((b+1)*RUN, n)) of the [P, width] block; `smem` dynamic
    shared bytes (the binomial table, then the cells' bit masks); `nwin`
    windows of the gather source (the miss count's clip)."""

    n: int
    grid: int
    smem: int
    nwin: int


def step_plan(geom: LevelGeom, P: int, width: int, m: int) -> StepPlan:
    """The launch arithmetic of either kernel over [P, width] lanes with a
    gather source of m entries."""
    n = P * width
    binom_bytes = (geom.ncells + 1) * geom.K * geom.words.rank // 8
    smem = -(-binom_bytes // 8) * 8 + geom.ncells * geom.words.bits // 8
    return StepPlan(n=n, grid=-(-n // RUN), smem=smem,
                    nwin=padded_table_len(m, WINDOW) // WINDOW)


def launch_args(geom: LevelGeom, rank0: int, width: int, src, kc: dict,
                out, counter, for_reach: bool) -> list:
    """The argument vector of one launch, in ARGS order."""
    P = kc["cellidx"].shape[0]
    plan = step_plan(geom, P, width, src.shape[0])
    a = dict(P=P, width=width, rank0=int(rank0), n=plan.n, size=geom.size,
             adj=geom.parent_size if for_reach else geom.child_size,
             m=src.shape[0], nwin=plan.nwin, w=geom.width, h=geom.height,
             connect=geom.connect, ncells=geom.ncells, n1=geom.n1,
             K=geom.K, level=geom.level,
             words=geom.words.code, grid=plan.grid, smem=plan.smem,
             src=src.data_ptr(), out=out.data_ptr(),
             counter=counter.data_ptr(), binom=kc["binom"].data_ptr(),
             cellidx=kc["cellidx"].data_ptr(),
             filled=kc["filled"].data_ptr())
    if for_reach:
        a.update(bits=kc["topstone"].data_ptr(), valid=0,
                 row=kc["parent_row"].data_ptr(), fill=0,
                 ccellidx=kc["parent_cellidx"].data_ptr())
    else:
        a.update(bits=kc["newbit"].data_ptr(), valid=kc["valid"].data_ptr(),
                 row=kc["move_row"].data_ptr(),
                 fill=kc["move_fill"].data_ptr(),
                 ccellidx=kc["child_cellidx"].data_ptr())
    return [a[k] for k in ARGS]


def _launch(name: str, geom: LevelGeom, rank0: int, width: int, src,
            consts: dict, for_reach: bool):
    """Launch kernel `name` -> (out [P, width] u8, int64 counter)."""
    from gamesmanmpi_tpu_torch.kernels import build

    kc = consts.get("kernel")
    if kc is None:
        raise ValueError(f"{name}: consts carry no kernel layout (build "
                         "them with kernel_consts on the tensor's device)")
    if geom.width > MAX_COLS or geom.ncells > MAX_CELLS:
        raise ValueError(f"{name}: {geom.width} columns, {geom.ncells} "
                         f"cells; the kernel takes at most {MAX_COLS}, "
                         f"{MAX_CELLS}")
    src = src.contiguous()
    P = kc["cellidx"].shape[0]
    out = torch.empty((P, width), dtype=torch.uint8, device=src.device)
    counter = torch.zeros((), dtype=torch.int64, device=src.device)
    if P * width == 0:
        return out, counter
    args = launch_args(geom, rank0, width, src, kc, out, counter, for_reach)
    vec = (ctypes.c_longlong * len(args))(*args)
    lib = build.load("dense_level")
    stream = torch.cuda.current_stream(src.device).cuda_stream
    code = getattr(lib, f"{name}_launch")(vec, len(args), stream)
    build.check(name, code)
    kernels.LAUNCHES[name] += 1
    return out, counter


# ---------------------------------------------------------------------------
# The plain versions (eager int64 torch)


def _connected_fold(stones, h: int, connect: int):
    """Any `connect`-in-a-row in a guard-layout int64 bitboard.

    Same four directions as games/connect4.py: vertical 1, diag-down h,
    horizontal h+1, diag-up h+2.
    """
    won = torch.zeros(stones.shape, dtype=torch.bool, device=stones.device)
    for d in (1, h, h + 1, h + 2):
        x = stones
        for i in range(1, connect):
            x = x & (stones >> (i * d))
        won |= x != 0
    return won


def _unrank_bits(ranks, n1: int, binom, cellidx, bitpos):
    """[P or 1, cb] combinadic ranks -> [P, cb] player-1 bitboards.

    A descending walk over the global cells. binom is the [ncells+1, K]
    int64 table, indexed directly; cellidx[j] is each class's within-class
    index of global cell j ([ncells, P] int64, -1 for an absent cell).
    """
    ncells, P = cellidx.shape
    cb = ranks.shape[1]
    kmax = binom.shape[0] - 1
    bits = torch.zeros((P, cb), dtype=torch.int64, device=ranks.device)
    rem = torch.full((P, cb), n1, dtype=torch.int64, device=ranks.device)
    r = ranks.expand(P, cb).clone()
    for j in range(ncells - 1, -1, -1):
        kj = cellidx[j]
        exists = (kj >= 0)[:, None]
        cki = binom[kj.clamp(0, kmax)[:, None], rem]  # C(k_j, rem)
        # C(k, rem) == 0 (k < rem) means every remaining cell must be a
        # stone; 0 <= r always holds, so `take` fires as required.
        take = exists & (rem > 0) & (cki <= r)
        r -= cki * take
        rem -= take.to(torch.int64)
        bits |= take.to(torch.int64) * (1 << int(bitpos[j]))
    return bits


def _rank_bits(bits, binom, cellidx_c, bitpos):
    """[P, cb] stone bitboards -> combinadic ranks under the cell indexing
    cellidx_c ([ncells, P] int64, the TARGET class per row)."""
    ncells, P = cellidx_c.shape
    kmax = binom.shape[0] - 1
    acc = torch.zeros(bits.shape, dtype=torch.int64, device=bits.device)
    seen = torch.zeros(bits.shape, dtype=torch.int64, device=bits.device)
    for j in range(ncells):
        kj = cellidx_c[j]
        take = (kj >= 0)[:, None] & ((bits & (1 << int(bitpos[j]))) != 0)
        seen += take
        ck = binom[kj.clamp(0, kmax)[:, None], seen]
        acc += ck * take
    return acc


def _ranks(rank0: int, width: int, device):
    return rank0 + torch.arange(width, dtype=torch.int64,
                                device=device)[None, :]  # [1, width]


def dense_step_ref(geom: LevelGeom, rank0: int, width: int, child_flat,
                   consts: dict, binom, gather_mode: str = "window"):
    """Plain version of the backward step over lanes [rank0, rank0+width)
    of every profile row: (cells [P, width] u8, nmiss or None).

    consts are the eager layout (solve/dense.DenseSolver._level_tensors),
    binom the int64 table. gather_mode: "window" feeds the monotone-filled
    flat index to the window gather's plain version (nmiss counted);
    "sorted" gathers the same filled index with a clamped torch index;
    "plain" the clamped unfilled index. All three give the same cells.
    """
    w, h, connect = geom.width, geom.height, geom.connect
    C, Cc = geom.size, geom.child_size
    p1_moves = geom.level % 2 == 0    # the player moving OUT of this level
    mover_is_p1 = geom.level % 2 == 1  # the player who made the ply INTO it
    dev = child_flat.device
    filled = consts["filled"]
    P = filled.shape[0]
    ranks = _ranks(rank0, width, dev)
    p1 = _unrank_bits(ranks, geom.n1, binom, consts["cellidx"], geom.bitpos)
    p2 = filled[:, None] ^ p1
    mover = p1 if mover_is_p1 else p2
    current = p2 if mover_is_p1 else p1
    # mover_line: the player to move already lost. current_line without
    # mover_line: unreachable garbage, made terminal so it never fans out
    # gathers.
    prim = (_connected_fold(mover, h, connect)
            | _connected_fold(current, h, connect))
    del p2, mover, current
    if geom.is_top:
        top = torch.full(prim.shape, TIE, dtype=torch.uint8, device=dev)
        return top.masked_fill_(prim, LOSE), None

    m = child_flat.shape[0]
    in_range = ranks < C
    nmiss = None
    vals, rems, masks = [], [], []
    for c in range(w):
        valid_c = consts["valid"][:, c:c + 1]
        row_c = consts["move_row"][:, c:c + 1]
        cbits = (p1 | consts["newbit"][:, c:c + 1]) if p1_moves else p1
        crank = _rank_bits(cbits, binom, consts["child_cellidx"][:, :, c],
                           geom.bitpos)
        flat = row_c * Cc + crank
        del cbits, crank
        if gather_mode in ("window", "sorted"):
            # Invalid rows take the previous valid row's last slot (0
            # before any), pad lanes (rank >= C) their own row's last
            # slot: the flat vector stays globally non-decreasing.
            fillr = torch.where(valid_c, row_c,
                                consts["move_fill"][:, c:c + 1])
            fill = torch.where(fillr < 0, torch.zeros_like(fillr),
                               fillr * Cc + (Cc - 1))
            flat = torch.where(valid_c & in_range, flat, fill)
        if gather_mode == "window":
            cell, nm = monotone_window_gather_ref(
                child_flat, flat.reshape(-1), RUN, WINDOW)
            cell = cell.reshape(P, width)
            nmiss = nm if nmiss is None else nmiss + nm
        else:
            cell = child_flat[flat.clamp(0, m - 1)]
        del flat
        vals.append(cell & 3)
        rems.append((cell >> 2).to(torch.int32))
        masks.append(valid_c.expand(P, width))

    cv = torch.stack(vals, dim=-1).reshape(P * width, w)
    cr = torch.stack(rems, dim=-1).reshape(P * width, w)
    mk = (torch.stack(masks, dim=-1)
          & ~prim[..., None]).reshape(P * width, w)
    del vals, rems, masks
    values, rem_out = combine_children(cv, cr, mk)
    del cv, cr, mk
    values = values.reshape(P, width).masked_fill_(prim, LOSE)
    rem_out = rem_out.reshape(P, width).masked_fill_(prim, 0)
    return values | (rem_out.clamp(0, 63).to(torch.uint8) << 2), nmiss


def _reach_columns(geom: LevelGeom, rank0: int, width: int, parent_reach,
                   consts: dict, binom):
    """Per column c of the reach step: (in_range [1, width], and per
    column, in order, (followed, hit) [P, width] bools: the top stone is
    the last mover's, and the parent is also live and reachable)."""
    w, h, connect = geom.width, geom.height, geom.connect
    Cp = geom.parent_size
    mover_is_p1 = geom.level % 2 == 1           # who made ply `level`
    parent_mover_is_p1 = (geom.level - 1) % 2 == 1  # who made the one before
    filled = consts["filled"]
    ranks = _ranks(rank0, width, parent_reach.device)
    p1 = _unrank_bits(ranks, geom.n1, binom, consts["cellidx"], geom.bitpos)
    n = parent_reach.shape[0]
    cols = []
    for c in range(w):
        ts = consts["topstone"][:, c:c + 1]  # [P, 1]; 0 for empty columns
        prow = consts["parent_row"][:, c:c + 1]
        stone_is_p1 = (p1 & ts) != 0
        color_ok = (ts != 0) & (stone_is_p1 if mover_is_p1
                                else ~stone_is_p1) & (prow >= 0)
        parent_p1 = (p1 ^ ts) if mover_is_p1 else p1
        parent_filled = filled[:, None] ^ ts
        parent_mover = (parent_p1 if parent_mover_is_p1
                        else parent_filled ^ parent_p1)
        parent_live = ~_connected_fold(parent_mover, h, connect)
        prank = _rank_bits(parent_p1, binom,
                           consts["parent_cellidx"][:, :, c], geom.bitpos)
        flat = prow * Cp + prank
        pr = parent_reach[flat.clamp(0, n - 1)] != 0
        cols.append((color_ok, color_ok & parent_live & pr))
    return ranks < geom.size, cols


def reach_step_ref(geom: LevelGeom, rank0: int, width: int, parent_reach,
                   consts: dict, binom):
    """Plain version of the reachability step (level >= 1) over lanes
    [rank0, rank0+width): (reach [P, width] u8, count int64 tensor).

    reach(y) = OR over columns c of y's class: the top stone of column c
    belongs to the player who made ply `level` AND the position with that
    stone removed is reachable AND was not terminal (its own last mover had
    no line).
    """
    P = consts["filled"].shape[0]
    in_range, cols = _reach_columns(geom, rank0, width, parent_reach,
                                    consts, binom)
    reach = torch.zeros((P, width), dtype=torch.bool,
                        device=parent_reach.device)
    for _, hit in cols:
        reach |= hit
    count = (reach & in_range).sum()
    return reach.to(torch.uint8), count


# ---------------------------------------------------------------------------
# The wrappers


def dense_step(geom: LevelGeom, rank0: int, width: int, child_flat,
               consts: dict, binom):
    """The backward step in window mode over lanes [rank0, rank0+width):
    (cells [P, width] u8, nmiss int64 scalar tensor, or None at the top
    level). Cells are exact on in-range lanes (rank < C); pad lanes are
    left 0 by the kernel.

    On a CUDA tensor this launches the CUDA kernel (consts must carry the
    kernel layout under "kernel"; the launch is counted in
    kernels.LAUNCHES); on a CPU tensor it is the plain version.
    """
    if child_flat.device.type == "cpu":
        return dense_step_ref(geom, rank0, width, child_flat, consts, binom,
                              "window")
    if child_flat.device.type != "cuda":
        raise RuntimeError(f"no dense_step kernel for {child_flat.device}")
    cells, nmiss = _launch("dense_step", geom, rank0, width, child_flat,
                           consts, for_reach=False)
    return cells, (None if geom.is_top else nmiss)


def reach_step(geom: LevelGeom, rank0: int, width: int, parent_reach,
               consts: dict, binom):
    """The reachability step over lanes [rank0, rank0+width): (reach
    [P, width] u8, count of in-range reached lanes, int64 scalar tensor).
    Reach is exact on in-range lanes; pad lanes are left 0 by the kernel.

    On a CUDA tensor this launches the CUDA kernel (counted in
    kernels.LAUNCHES); on a CPU tensor it is the plain version.
    """
    if parent_reach.device.type == "cpu":
        return reach_step_ref(geom, rank0, width, parent_reach, consts,
                              binom)
    if parent_reach.device.type != "cuda":
        raise RuntimeError(f"no reach_step kernel for {parent_reach.device}")
    return _launch("reach_step", geom, rank0, width, parent_reach, consts,
                   for_reach=True)


# ---------------------------------------------------------------------------
# The work a launch must do (its bound)


def step_work(geom: LevelGeom, P: int, width: int, m: int, lanes: int,
              followed: int, for_reach: bool) -> Tuple[int, int]:
    """(bytes, integer operations) that one launch over [P, width] lanes
    must do at the least: `lanes` in-range lanes, `followed` (lane,
    column) pairs whose child (parent) the step must rank.

    Bytes: each output byte written once, each source byte read once (at
    most m, at most one per followed pair), the constants read once.
    Operations: per in-range lane the unrank walk, 3 per cell (compare,
    subtract, or), and (backward step) both win folds; per followed pair
    the rank walk, 2 per cell (test, add), 4 for the flat index and its
    load and 4 for the combine's share, and (reach step) the parent's
    fold. A fold is 2 per shift (shift, and) and 1 per direction.
    """
    nc, w = geom.ncells, geom.width
    fold = 4 * (2 * (geom.connect - 1) + 1)
    per_lane = 3 * nc + (0 if for_reach else 2 * fold)
    per_pair = 2 * nc + 8 + (fold if for_reach else 0)
    ops = lanes * per_lane + followed * per_pair
    nbytes = (P * width + min(m, followed)
              + P * (nc + w * (nc + 13)) + (nc + 1) * (nc + 5) * 8)
    return nbytes, ops


def dense_followed(geom: LevelGeom, rank0: int, width: int,
                   consts: dict) -> Tuple[int, int]:
    """(in-range lanes, followed pairs) of a backward launch: every valid
    move of every in-range lane is ranked and gathered (the combine needs
    each child, the miss count each index)."""
    lanes = max(0, min(width, geom.size - rank0))
    return lanes * consts["filled"].shape[0], lanes * int(
        consts["valid"].sum())


def reach_followed(geom: LevelGeom, rank0: int, width: int, consts: dict,
                   binom, parent_reach) -> Tuple[int, int]:
    """(in-range lanes, followed pairs) of a reach launch on this data:
    per in-range lane, the columns whose top stone is the last mover's,
    up to and including the first that reaches (the OR needs no more)."""
    in_range, cols = _reach_columns(geom, rank0, width, parent_reach,
                                    consts, binom)
    lanes = in_range.expand(consts["filled"].shape[0], width)
    done = ~lanes
    followed = 0
    for ok, hit in cols:
        followed += int((ok & ~done).sum())
        done |= hit
    return int(lanes.sum()), followed
