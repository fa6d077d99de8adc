"""The dense engine's level steps: hand-written CUDA kernels, their plain
PyTorch versions and the kernels' launch arithmetic.

The reference runs each level step of its dense Connect-4 engine as one
XLA program per (level, block width): ``build_dense_step``
(gamesmanmpi_tpu/solve/dense.py:577) for the backward sweep and
``build_reach_step`` (:759) for the reachability sweep, ``lax.fori_loop``
walks over the board's cells in the reference's narrowed words. Here each
is one CUDA kernel (kernels/csrc/dense_level.cu), launched once per level
(and mesh shard) over every rank block of the level, one thread per lane,
writing straight into the level's [P, C] array; no intermediate touches
device memory.

* :func:`dense_step` — per lane: one descending walk over the level's
  class indices that unranks player 1's stones and collects every
  child's combinadic rank (the reference's ``_rank_all_moves_fused``,
  :496, walked downward), both win folds, per move the flat index (with
  the monotone fill of the window gather) and packed cell, then the
  negamax combine (ops/combine.py's rules) -> the lane's packed cell; and
  the window gather's miss count over the same partition as
  ops/window_gather.monotone_window_gather_ref (so ``nmiss`` equals the
  eager window path's to the lane).
* :func:`reach_step` — per lane: the same walk collecting every parent's
  rank, then the OR over columns of "the top stone is the last mover's,
  the parent had no line and is reachable" -> the u8 reach, and the
  count of reached lanes.
* :func:`dense_step_ref`, :func:`reach_step_ref` — the plain PyTorch
  versions of one rank block (int64 eager ops; the only route of the
  ``plain`` and ``sorted`` gather modes); :func:`dense_level_ref`,
  :func:`reach_level_ref` run them over a launch's blocks.
* :class:`LaunchMap`, :func:`kernel_pack`, :func:`step_plan`,
  :data:`ARGS` — the launch arithmetic: which lanes each CTA takes, the
  constants packed in the kernel's layout (one array per level and kind),
  grid and shared memory, and the launch's argument vector.
* :func:`fused_walk` — a numpy model of the kernels' walk, for the tests.
* :func:`step_work` and the counts it takes — the least work of a launch
  (its bound).

A wrapper launches its kernel for a CUDA tensor (counting the launch in
kernels.LAUNCHES) and takes the plain version for a CPU tensor; any other
device raises. A failed build or launch raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

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
#: Widest board and most cells the kernels take.
MAX_COLS = 32
MAX_CELLS = 64
#: int32 words of a row record before its heights (filled, low and high).
REC_HEIGHTS = 2
#: The binomial table's row stride in rank words: K of the widest board
#: (MAX_CELLS), so the kernel's table offsets are immediates.
BINOM_STRIDE = MAX_CELLS // 2 + 2

#: The launch functions' argument vector, in the order of the `Arg` enum
#: of kernels/csrc/dense_level.cu (a test holds the two together).
ARGS = ("P", "size", "cblock", "lo", "width", "nblk", "runs", "adj", "m",
        "nwin", "w", "h", "connect", "ncells", "n1", "K", "level", "words",
        "grid", "smem", "ld", "ostep", "obase", "src", "out", "counter",
        "binom", "rows")


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
# The constants: the plain steps' layout and the kernels' packed one


def eager_consts(tables, level: int, for_reach: bool, device) -> dict:
    """A level's constants in the plain steps' layout on `device`: int64
    (bool for `valid`), cell indices steps first ([ncells, P, ...])."""
    c = tables.level_consts(level)

    def dev(a, dtype=torch.int64):
        return torch.as_tensor(
            np.ascontiguousarray(a.astype(np.int64)), device=device
        ).to(dtype)

    def steps_first(a):  # [P, ..., ncells] -> [ncells, P, ...]
        return dev(np.moveaxis(a, -1, 0))

    out = dict(cellidx=steps_first(c["cellidx"]), filled=dev(c["filled"]))
    if for_reach:
        out.update(topstone=dev(c["topstone"]),
                   parent_row=dev(c["parent_row"]),
                   parent_cellidx=steps_first(c["parent_cellidx"]))
    else:
        out.update(newbit=dev(c["newbit"]),
                   valid=dev(c["valid"], torch.bool),
                   move_row=dev(c["move_row"]),
                   move_fill=dev(c["move_fill"]),
                   child_cellidx=steps_first(c["child_cellidx"]))
    return out


class PackLayout(NamedTuple):
    """Where a pack's parts lie, in int32 words: the binomial table
    ([ncells+2, BINOM_STRIDE] rank words, a zero row first, so row k+1
    holds C(k, .), columns past K zero) from 0, then the [P, stride] row
    records from `rows` (filled's low and high words, the w heights, then
    per column move_row and move_fill, or parent_row)."""

    rows: int
    stride: int

    @property
    def rec_bytes(self) -> int:
        return self.stride * 4


def pack_layout(geom: LevelGeom, for_reach: bool) -> PackLayout:
    nb = (geom.ncells + 2) * BINOM_STRIDE * geom.words.rank // 32
    return PackLayout(rows=nb + (nb & 1),
                      stride=REC_HEIGHTS + (2 if for_reach else 3)
                      * geom.width)


def kernel_pack(tables, level: int, for_reach: bool,
                words: Optional[Words] = None) -> np.ndarray:
    """A level's kernel constants packed into one int32 array (host), laid
    out as :class:`PackLayout` says, in the kernel's word width (`words`,
    default the board's word_widths; a launch's geometry must carry the
    same). One array per level and kind, so one host-to-device copy (the
    solver keeps the copy on its device)."""
    geom = level_geom(tables, level)
    if words is not None:
        geom = dataclasses.replace(geom, words=words)
    lay = pack_layout(geom, for_reach)
    c = tables.level_consts(level)
    P, w = len(tables.profiles[level]), tables.width
    rank_word = np.uint32 if geom.words.rank == 32 else np.uint64
    binom = np.zeros((tables.ncells + 2, BINOM_STRIDE), rank_word)
    binom[1:, :geom.K] = tables.binom.astype(rank_word)
    rec = np.empty((P, lay.stride), np.int32)
    filled = c["filled"].astype(np.uint64)
    rec[:, 0] = (filled & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(
        np.int32)
    rec[:, 1] = (filled >> np.uint64(32)).astype(np.uint32).view(np.int32)
    rec[:, REC_HEIGHTS:REC_HEIGHTS + w] = tables.profiles[level]
    if for_reach:
        rec[:, REC_HEIGHTS + w:] = c["parent_row"]
    else:
        rec[:, REC_HEIGHTS + w:REC_HEIGHTS + 2 * w] = c["move_row"]
        rec[:, REC_HEIGHTS + 2 * w:] = c["move_fill"]
    out = np.zeros(lay.rows + P * lay.stride, np.int32)
    out[:binom.size * binom.itemsize // 4] = binom.reshape(-1).view(np.int32)
    out[lay.rows:] = rec.reshape(-1)
    return out


# ---------------------------------------------------------------------------
# Launch arithmetic


@dataclass(frozen=True)
class LaunchMap:
    """The lanes of one launch: columns [lo, hi) of each of the level's
    `nblk` rank blocks of `cblock` ranks ([P, size] lanes in all; a mesh
    shard takes a slice, one device lo=0, hi=cblock). CTA i takes run
    j = i % runs of block b = i // runs: lanes [j*RUN, min((j+1)*RUN,
    P*width)) of the block's row-major [P, width] lanes, lane q at row
    q // width and rank b*cblock + lo + q % width. Those runs are the
    window gather's miss partition of the block; lanes whose rank is past
    `size` are counted and never written."""

    P: int
    size: int
    cblock: int
    nblk: int
    lo: int = 0
    hi: Optional[int] = None
    compact: bool = False

    def __post_init__(self):
        if self.hi is None:
            object.__setattr__(self, "hi", self.cblock)
        if not (0 <= self.lo <= self.hi <= self.cblock and self.P >= 1
                and self.nblk * self.cblock >= self.size):
            raise ValueError(f"bad launch map {self}")

    @property
    def width(self) -> int:
        return self.hi - self.lo

    @property
    def nlanes(self) -> int:
        """Lanes of one block's slice."""
        return self.P * self.width

    @property
    def runs(self) -> int:
        return -(-self.nlanes // RUN)

    @property
    def grid(self) -> int:
        return self.nblk * self.runs

    def block_ranks(self, b: int) -> Tuple[int, int]:
        """Block b's slice as [rank0, rank0 + width)."""
        rank0 = b * self.cblock + self.lo
        return rank0, rank0 + self.width

    def cta_lanes(self, i: int):
        """CTA i's lanes, as the kernel takes them: (rows, ranks, pad)
        int64 arrays, pad the replicas of the block's last index that its
        ragged last run counts (0 elsewhere)."""
        b, j = divmod(i, self.runs)
        q = np.arange(j * RUN, min((j + 1) * RUN, self.nlanes),
                      dtype=np.int64)
        rows, cols = np.divmod(q, self.width)
        pad = np.where(q == self.nlanes - 1, (j + 1) * RUN - self.nlanes, 0)
        return rows, b * self.cblock + self.lo + cols, pad

    @property
    def out_cols(self) -> int:
        """Columns of the launch's output: the level's [P, size] array,
        or (compact, a mesh shard's) [P, nblk * width], block b's slice
        from column b * width."""
        return self.nblk * self.width if self.compact else self.size

    @property
    def out_step(self) -> int:
        """Output columns from one block's slice to the next's."""
        return self.width if self.compact else self.cblock

    @property
    def out_base(self) -> int:
        """The output column of block 0's first lane."""
        return 0 if self.compact else self.lo

    def out_col(self, b: int) -> int:
        """The output column of block b's first lane."""
        return b * self.out_step + self.out_base

    def columns(self) -> np.ndarray:
        """[size] bool: the ranks this map's lanes cover."""
        cover = np.zeros(self.nblk * self.cblock, bool).reshape(
            self.nblk, self.cblock)
        cover[:, self.lo:self.hi] = True
        return cover.reshape(-1)[:self.size]


class StepPlan(NamedTuple):
    """One launch: `grid` CTAs of THREADS threads, `smem` dynamic shared
    bytes (the binomial table, then the row record), `nwin` windows of the
    gather source (the miss count's clip)."""

    grid: int
    smem: int
    nwin: int


def step_plan(geom: LevelGeom, lmap: LaunchMap, m: int,
              for_reach: bool) -> StepPlan:
    """The launch arithmetic of either kernel over `lmap` with a gather
    source of m entries."""
    lay = pack_layout(geom, for_reach)

    def up8(n):
        return -(-n // 8) * 8

    smem = (up8((geom.ncells + 2) * BINOM_STRIDE * geom.words.rank // 8)
            + up8(lay.rec_bytes))
    return StepPlan(grid=lmap.grid, smem=smem,
                    nwin=padded_table_len(m, WINDOW) // WINDOW)


def launch_args(geom: LevelGeom, lmap: LaunchMap, src, pack, out,
                counter, for_reach: bool) -> list:
    """The argument vector of one launch, in ARGS order."""
    plan = step_plan(geom, lmap, src.shape[0], for_reach)
    lay = pack_layout(geom, for_reach)
    a = dict(P=lmap.P, size=lmap.size, cblock=lmap.cblock, lo=lmap.lo,
             width=lmap.width, nblk=lmap.nblk, runs=lmap.runs,
             adj=geom.parent_size if for_reach else geom.child_size,
             m=src.shape[0], nwin=plan.nwin, w=geom.width, h=geom.height,
             connect=geom.connect, ncells=geom.ncells, n1=geom.n1,
             K=geom.K, level=geom.level, words=geom.words.code,
             grid=plan.grid, smem=plan.smem, ld=lmap.out_cols,
             ostep=lmap.out_step, obase=lmap.out_base, src=src.data_ptr(),
             out=out.data_ptr(), counter=counter.data_ptr(),
             binom=pack.data_ptr(),
             rows=pack.data_ptr() + 4 * lay.rows)
    return [a[k] for k in ARGS]


def _launch(name: str, geom: LevelGeom, lmap: LaunchMap, src,
            consts: dict, out, for_reach: bool):
    """Launch kernel `name` over `lmap`, writing into out [P,
    lmap.out_cols] -> the int64 counter (misses or reached lanes)."""
    from gamesmanmpi_tpu_torch.kernels import build

    pack = consts.get("pack")
    if pack is None:
        raise ValueError(f"{name}: consts carry no kernel pack (build them "
                         "with kernel_pack on the tensor's device)")
    if geom.width > MAX_COLS or geom.ncells > MAX_CELLS:
        raise ValueError(f"{name}: {geom.width} columns, {geom.ncells} "
                         f"cells; the kernel takes at most {MAX_COLS}, "
                         f"{MAX_CELLS}")
    if (out.dtype != torch.uint8
            or tuple(out.shape) != (lmap.P, lmap.out_cols)
            or not out.is_contiguous() or out.device != src.device
            or pack.device != src.device or pack.dtype != torch.int32):
        raise ValueError(f"{name}: out must be a contiguous uint8 "
                         f"[{lmap.P}, {lmap.out_cols}] and the pack int32, "
                         f"on {src.device}")
    if lmap.nlanes >= 1 << 31:
        raise ValueError(f"{name}: {lmap.nlanes} lanes per block; the "
                         "kernel takes under 2^31")
    src = src.contiguous()
    counter = torch.zeros((), dtype=torch.int64, device=src.device)
    if lmap.grid == 0:
        return counter
    args = launch_args(geom, lmap, src, pack, out, counter, for_reach)
    vec = (ctypes.c_longlong * len(args))(*args)
    lib = build.load("dense_level")
    stream = torch.cuda.current_stream(src.device).cuda_stream
    code = getattr(lib, f"{name}_launch")(vec, len(args), stream)
    build.check(name, code)
    kernels.LAUNCHES[name] += 1
    return counter


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


def _in_range(lmap: LaunchMap, b: int) -> int:
    """Lanes per row of block b's slice whose rank is below size."""
    rank0, end = lmap.block_ranks(b)
    return max(min(end, lmap.size) - rank0, 0)


def _level_blocks(lmap: LaunchMap, step, out) -> Optional[torch.Tensor]:
    """Run a block step over each of `lmap`'s rank blocks, writing the
    in-range lanes into out [P, lmap.out_cols] -> the steps' second
    outputs summed (or None)."""
    total = None
    for b in range(lmap.nblk):
        cells, extra = step(lmap.block_ranks(b)[0], lmap.width)
        n, c0 = _in_range(lmap, b), lmap.out_col(b)
        out[:, c0:c0 + n] = cells[:, :n]
        if extra is not None:
            total = extra if total is None else total + extra
    return total


def merge_shard(lmap: LaunchMap, part, out):
    """Copy a compact launch's output, part [P, nblk * width] (one
    transfer to out's device), into the level's out [P, size]: each
    block's in-range lanes to their ranks."""
    part = part.to(out.device)
    for b in range(lmap.nblk):
        n, c0 = _in_range(lmap, b), lmap.out_col(b)
        rank0 = lmap.block_ranks(b)[0]
        out[:, rank0:rank0 + n] = part[:, c0:c0 + n]


def dense_level_ref(geom: LevelGeom, lmap: LaunchMap, child_flat,
                    consts: dict, binom, out, gather_mode: str = "window"):
    """Plain version of one backward launch: dense_step_ref over each rank
    block of `lmap`, the in-range lanes written into out [P,
    lmap.out_cols] -> nmiss summed over the blocks (window mode below the
    top), else None."""
    return _level_blocks(lmap, lambda rank0, width: dense_step_ref(
        geom, rank0, width, child_flat, consts, binom, gather_mode), out)


def reach_level_ref(geom: LevelGeom, lmap: LaunchMap, parent_reach,
                    consts: dict, binom, out):
    """Plain version of one reach launch: reach_step_ref over each rank
    block of `lmap`, the in-range lanes written into out [P,
    lmap.out_cols] -> the reached lanes counted."""
    return _level_blocks(lmap, lambda rank0, width: reach_step_ref(
        geom, rank0, width, parent_reach, consts, binom), out)


# ---------------------------------------------------------------------------
# The wrappers


def dense_step(geom: LevelGeom, lmap: LaunchMap, child_flat, consts: dict,
               binom, out):
    """The backward step in window mode over the lanes of `lmap`: writes
    their in-range lanes into out [P, lmap.out_cols] (u8) -> nmiss (int64
    scalar tensor), or None at the top level.

    On a CUDA tensor this is one launch of the CUDA kernel (consts must
    carry the kernel pack under "pack"; the launch is counted in
    kernels.LAUNCHES); on a CPU tensor the plain version (consts the
    eager layout, binom the int64 table).
    """
    if child_flat.device.type == "cpu":
        return dense_level_ref(geom, lmap, child_flat, consts, binom, out)
    if child_flat.device.type != "cuda":
        raise RuntimeError(f"no dense_step kernel for {child_flat.device}")
    nmiss = _launch("dense_step", geom, lmap, child_flat, consts, out,
                    for_reach=False)
    return None if geom.is_top else nmiss


def reach_step(geom: LevelGeom, lmap: LaunchMap, parent_reach,
               consts: dict, binom, out):
    """The reachability step over the lanes of `lmap`: writes their
    in-range lanes into out [P, lmap.out_cols] (u8) -> the count of
    reached lanes (int64 scalar tensor).

    On a CUDA tensor this is one launch of the CUDA kernel (counted in
    kernels.LAUNCHES); on a CPU tensor the plain version.
    """
    if parent_reach.device.type == "cpu":
        return reach_level_ref(geom, lmap, parent_reach, consts, binom, out)
    if parent_reach.device.type != "cuda":
        raise RuntimeError(f"no reach_step kernel for {parent_reach.device}")
    return _launch("reach_step", geom, lmap, parent_reach, consts, out,
                   for_reach=True)


# ---------------------------------------------------------------------------
# A host model of the kernels' walk


class FusedWalk(NamedTuple):
    """What the walk gives per lane: the player-1 guard-layout bitboard,
    every valid move's child rank and every non-empty column's parent
    rank (0 elsewhere) and whether that column's top stone is player
    1's."""

    p1: np.ndarray       # [n] uint64
    child: np.ndarray    # [n, w] rank words
    parent: np.ndarray   # [n, w] rank words
    top_p1: np.ndarray   # [n, w] bool


def fused_walk(geom: LevelGeom, heights: np.ndarray, ranks: np.ndarray,
               rank_word=None) -> FusedWalk:
    """The kernels' descending walk, in numpy over lanes: `heights` [n, w]
    each lane's column heights, `ranks` [n] its in-range rank; the
    arithmetic in `rank_word` (default the geometry's rank word), wrapping
    as the kernel's unsigned words would. Used by the tests, not by any
    solve path.

    Walking the class indices k = L-1 .. 0 (columns w-1 .. 0, each top
    down) with r the rank left and rem the stones left, the cell at k is a
    stone when C(k, rem) <= r (then r -= C(k, rem), rem -= 1), and a stone
    at k with ordinal rem adds C(k+1, rem + [p1 moves]) to the child
    suffix S and C(k-1, rem - [p1 moved]) to the parent suffix Sp. A child
    inserts the cell t_c = col_base[c] + h_c: child(c) = r + S +
    [p1 moves] C(t_c, rem + 1), taken before column c's cells. A parent
    removes column c's top cell t_c - 1: parent(c) = r after that cell +
    Sp before it.
    """
    w, h, L = geom.width, geom.height, geom.level
    word = rank_word or (np.uint32 if geom.words.rank == 32 else np.uint64)
    heights = np.asarray(heights, np.int64).reshape(-1, w)
    n = heights.shape[0]
    table = np.zeros((geom.ncells + 2, geom.K), np.uint64)
    for k in range(geom.ncells + 1):
        for i in range(min(k, geom.K - 1) + 1):
            table[k + 1, i] = math.comb(k, i)
    table = table.astype(word)  # row k+1: C(k, .); row 0: C(-1, .) = 0
    sh = 1 if L % 2 == 0 else 0   # p1 moves out of this level
    shp = 1 - sh                  # p1 made the ply into it
    r = np.asarray(ranks).astype(word)
    s = np.zeros(n, word)
    sp = np.zeros(n, word)
    p1 = np.zeros(n, np.uint64)
    rem = np.full(n, geom.n1, np.int64)
    k = np.full(n, L, np.int64)  # cells left to walk
    child = np.zeros((n, w), word)
    parent = np.zeros((n, w), word)
    top_p1 = np.zeros((n, w), bool)
    for c in range(w - 1, -1, -1):
        hc = heights[:, c]
        snap = r + s
        if sh:
            snap = snap + table[k + 1, rem + 1]
        child[:, c] = np.where(hc < h, snap, 0)
        above = sp.copy()
        for row in range(h - 1, -1, -1):
            live = row < hc
            k = k - live
            kk = np.where(live, k, 0)
            ck = table[kk + 1, rem]
            take = live & (ck <= r)
            r = r - np.where(take, ck, 0).astype(word)
            s = s + np.where(take, table[kk + 2, np.minimum(
                rem + sh, geom.K - 1)], 0).astype(word)
            sp = sp + np.where(take, table[kk, np.maximum(rem - shp, 0)],
                               0).astype(word)
            p1 |= np.where(take, np.uint64(1) << np.uint64(c * (h + 1) + row),
                           np.uint64(0))
            rem = rem - take
            at_top = live & (row == hc - 1)
            top_p1[:, c] |= at_top & take
            parent[:, c] = np.where(at_top, r + above, parent[:, c])
    return FusedWalk(p1, child, parent, top_p1)


# ---------------------------------------------------------------------------
# The work a launch must do (its bound)


class Work(NamedTuple):
    """The data-dependent counts of a launch: in-range lanes, followed
    (lane, column) pairs (each child or parent ranked and gathered) and
    the win folds the lanes must take."""

    lanes: int
    pairs: int
    folds: int


#: Integer operations of the least work: per class index of the level
#: (the compare against the rank left), per stone (subtract its term, set
#: its bit, add its shifted term), per followed pair (the snapshot's two
#: adds, the flat index, its load and the combine's share).
OPS_PER_INDEX = 1
OPS_PER_STONE = 3
OPS_PER_PAIR = 10


def fold_ops(geom: LevelGeom) -> int:
    """One win fold at its least work: per direction, `connect` in a row
    by doubling (x &= x >> (s*d), the run s doubling up to `connect`):
    ceil(log2 connect) shift-and pairs, then one test."""
    return 4 * (2 * (geom.connect - 1).bit_length() + 1)


def step_work(geom: LevelGeom, m: int, work: Work, pack_bytes: int
              ) -> Tuple[int, int]:
    """(bytes, integer operations) that one launch must do at the least.

    Bytes: each in-range output byte written once, each source byte read
    once (at most m, at most one per followed pair), the packed constants
    read once. Operations: per in-range lane the walk over the level's
    class indices and its stones (OPS_PER_INDEX, OPS_PER_STONE), per
    followed pair OPS_PER_PAIR, and the folds (fold_ops each).
    """
    per_lane = OPS_PER_INDEX * geom.level + OPS_PER_STONE * geom.n1
    ops = (work.lanes * per_lane + work.pairs * OPS_PER_PAIR
           + work.folds * fold_ops(geom))
    nbytes = work.lanes + min(m, work.pairs) + pack_bytes
    return nbytes, ops


def dense_followed(geom: LevelGeom, lmap: LaunchMap, consts: dict) -> Work:
    """The work of a backward launch: every valid move of every in-range
    lane is ranked and gathered (the combine needs each child, the miss
    count each index), and each lane folds both players' stones."""
    cols = int(lmap.columns().sum())
    pairs = 0 if geom.is_top else cols * int(consts["valid"].sum())
    return Work(lanes=cols * lmap.P, pairs=pairs, folds=2 * cols * lmap.P)


def reach_followed(geom: LevelGeom, lmap: LaunchMap, consts: dict, binom,
                   parent_reach) -> Work:
    """The work of a reach launch on this data: per in-range lane the
    columns whose top stone is the last mover's, up to and including the
    first that reaches (the OR needs no more), and one fold (the
    parents' last mover, the same player for every column) where the lane
    follows any column."""
    lanes = pairs = folds = 0
    for b in range(lmap.nblk):
        rank0, _ = lmap.block_ranks(b)
        in_range, cols = _reach_columns(geom, rank0, lmap.width,
                                        parent_reach, consts, binom)
        live = in_range.expand(consts["filled"].shape[0], lmap.width)
        done = ~live
        any_ok = torch.zeros_like(live)
        for ok, hit in cols:
            pairs += int((ok & ~done).sum())
            any_ok |= ok & live
            done |= hit
        lanes += int(live.sum())
        folds += int(any_ok.sum())
    return Work(lanes=lanes, pairs=pairs, folds=folds)
