// The dense Connect-4 engine's level steps for Hopper (sm_90a).
//
// Replaces the two XLA programs of the reference's dense engine, each one
// compiled program per (level, block width) there:
//
// * dense_step_kernel — gamesmanmpi_tpu/solve/dense.py:577
//   `build_dense_step`, the backward step: per lane (one position of a
//   level's [P, C] array) unrank player 1's stones, both win folds
//   (`_connected_fold`, :389), every child's combinadic rank, its flat
//   index row*Cc + rank with the monotone fill of the window gather
//   (:508-516) and its packed cell; the negamax combine of
//   ops/combine.py `combine_children`; the lane's `value | remoteness <<
//   2`. At the top level a lane is TIE, or LOSE on a line. It also counts
//   the window gather's misses exactly as
//   ops/window_gather.monotone_window_gather_ref does per move (the
//   reference's Pallas gather, ops/pallas_gather.py:116): over the flat
//   row-major [P, width] lanes of each rank block in runs of 2,048, each
//   run against the two windows of 8,192 from clip(first / 8192, 0,
//   nwin-2) * 8192, the ragged last run padded with its last index.
// * reach_step_kernel — :759 `build_reach_step`, the reachability step:
//   per lane the OR over columns of "the top stone is the last mover's,
//   the parent (that stone removed) had no line, and the parent's reach
//   byte is set", the u8 reach, and the CTA's count of reached lanes
//   added to one int64 counter with one atomic (integer, so the order of
//   the atomics cannot change the count).
//
// One launch per level (and mesh shard): CTA i takes run j of rank block
// b (b = i / runs, one 32-bit division per CTA), i.e. lanes [j*2048,
// min((j+1)*2048, P*width)) of the block's row-major [P, width] lanes,
// lane q at row q / width and rank b*cblock + lo + q % width. That is the
// miss count's partition; lanes whose rank is past C are counted and
// never written, and the output is the level's [P, C] array itself (on a
// mesh, each shard's compact [P, nblk*width], merged by the host).
//
// The walk. A class's cells carry class indices col_base[c] + r, so one
// descending walk over the level's L class indices (columns w-1..0, each
// top down) unranks the lane (C(k, rem) <= r takes the cell) and, in the
// same walk, collects every child's or parent's rank: a child inserts
// one cell at t_c = col_base[c] + h_c, so with the remaining rank r_t and
// the suffix S of C(k+1, i + [p1 moves]) over the stones seen, reached at
// column c before its cells, child(c) = r_t + S + [p1 moves] C(t_c,
// rem + 1); a parent removes the top cell t = t_c - 1, so with the
// suffix of C(k-1, i - [p1 moved]) taken before column c and r_t after
// its top cell, parent(c) = r_t + suffix. Every term is part of the
// final rank, so no word wraps. The stones land straight in the guard
// layout (cell (c, r) at bit c*(h+1) + r): the walk is column-major.
// The binomials sit in shared memory with a zero row first (row k+1
// holds C(k, .)) and a fixed row stride, so C(k-1, .) at k = 0 reads 0
// and every table offset of a cell is an immediate.
//
// Bound on this card: integer operations, not bytes (a lane reads a few
// bytes of the adjacent level, which the 50 MB L2 holds, and writes
// one); an SM issues at most 128 integer lanes per clock, half of them
// on the ALU pipe (shifts, logic, compares) and half on the FMA pipe
// (IMAD forms of adds, moves, multiply-adds). So the design spends as few
// integer instructions per lane as it can:
// * a cell is a compare and, for a stone, three adds and an or: the
//   table walk moves one pointer, the suffix term's offset is a
//   constant (one instantiation per parity of the level), and on the
//   fixed shapes (connect 4 on columns of 4, 5 or 6) a switch on the
//   column's height enters a fully unrolled run of cells, whose rows are
//   immediates; the folds shift by constants there too;
// * the gathers happen in the walk: each valid move's child cell is
//   loaded as its rank is known and folded one column later (the load
//   overlaps the walk), through a 257-entry key table that turns the
//   negamax combine into one max, and a 256-entry table that turns the
//   best key into the parent's cell; the miss test is one subtract and
//   one compare in the flat word;
// * no division per lane and 32-bit words where the board allows, and
//   the row's record (filled, heights, move or parent rows) staged once
//   in shared memory where the CTA lies in one profile row (its 2,048
//   lanes do whenever the block width is a multiple of 2,048, as
//   _cblock makes it in window mode). CTAs that span rows (levels
//   narrower than 2,048 lanes) read each lane's record from global
//   memory and divide in 32 bits.
// A lane with a line still gathers its children (its line is known only
// after the walk) and discards them; a pad lane (rank past C) computes
// its fills for the miss count only.

// Plain C interface, bound from Python with ctypes
// (gamesmanmpi_tpu_torch/kernels/build.py): each launch function takes
// the argument vector of ops/dense_level.py `launch_args` (the order of
// `Arg` below, ARGS there), launches on the given stream and returns the
// CUDA error code of the launch; it does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 2048;  // lanes per CTA = the miss count's block
constexpr int kLanes = kRun / kThreads;
constexpr long long kWindow = 8192;
constexpr int kWindowShift = 13;
constexpr int kMaxCols = 32;
constexpr int kMaxCells = 64;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kStride = 34;  // binomial row stride: K of the widest board
constexpr unsigned kWin = 1, kLose = 2, kTie = 3;

enum Arg {
  A_P, A_SIZE, A_CBLOCK, A_LO, A_WIDTH, A_NBLK, A_RUNS, A_ADJ, A_M, A_NWIN,
  A_W, A_H, A_CONNECT, A_NCELLS, A_N1, A_K, A_LEVEL, A_WORDS, A_GRID,
  A_SMEM, A_LD, A_OSTEP, A_OBASE, A_SRC, A_OUT, A_COUNTER, A_BINOM, A_ROWS,
  A_COUNT
};

struct Params {
  unsigned long long size;  // C: ranks per class at this level
  unsigned long long cblock, lo;  // rank block width, the slice's offset
  // The output: lane (row, block b, column col of the slice) at
  // row*ld + b*ostep + obase + col; the level's [P, C] (ld = C, ostep =
  // cblock, obase = lo) or a mesh shard's compact [P, nblk*width].
  unsigned long long ld, ostep, obase;
  long long adj;   // the gather source's class size (Cc, or Cp)
  long long m;     // entries of the gather source
  long long nwin;  // windows of the gather source (the miss clip)
  unsigned width, runs, nlanes;  // nlanes = P * width < 2^31
  int w, h, connect, ncells, n1, level, stride;
  const uint8_t* src;   // child cells / parent reach, flat
  uint8_t* out;         // the level's [P, C]
  unsigned long long* counter;
  const void* binom;    // [ncells+2, K] rank words: zeros, then C(k, .)
  const int32_t* rows;  // [P, stride] row records
};

// A row record (int32): filled's low and high words, the w column
// heights, then per column move_row and move_fill (backward step) or
// parent_row (reach step).
constexpr int kRecHeights = 2;

template <typename W>
__device__ __forceinline__ W shr(W x, int s) {
  return s >= static_cast<int>(8 * sizeof(W)) ? W(0) : W(x >> s);
}

// The kernels' board shapes: a fixed shape, kH > 0, is columns of kH
// and connect 4, which the host takes only where every fold shift (up to
// 2(h+2)) is below the word's width; kH = 0 takes h and connect at run
// time, each shift past the width giving 0 (as XLA's).

// Any `connect`-in-a-row along stride d: four in a row by doubling (x =
// s & s>>d, then x & x>>2d) on a fixed shape, the plain fold otherwise.
template <typename W, int kH>
__device__ __forceinline__ bool line_along(W s, int d, int connect) {
  if (kH > 0) {
    const W x = s & (s >> d);
    return (x & (x >> (2 * d))) != 0;
  }
  W x = s;
  for (int i = 1; i < connect; ++i) x &= shr(s, i * d);
  return x != 0;
}

// Any `connect`-in-a-row in a guard-layout bitboard: vertical 1,
// diag-down h, horizontal h+1, diag-up h+2 (games/connect4.py).
template <typename W, int kH>
__device__ __forceinline__ bool has_line(W s, int h, int connect) {
  if (kH > 0) h = kH;
  return line_along<W, kH>(s, 1, connect) ||
         line_along<W, kH>(s, h, connect) ||
         line_along<W, kH>(s, h + 1, connect) ||
         line_along<W, kH>(s, h + 2, connect);
}

template <typename W>
__device__ __forceinline__ W filled_of(const int32_t* rec) {
  const uint64_t f = static_cast<uint32_t>(rec[0]) |
                     (static_cast<uint64_t>(static_cast<uint32_t>(rec[1]))
                      << 32);
  return static_cast<W>(f);
}

// The walk's state: the remaining rank r, the suffix sum, and pk, the
// binomial table's C(k, rem) for k = the cells not yet walked and rem =
// the stones not yet placed (row k+1, column rem of the zero-row table):
// the next cell's C(k-1, rem) is pk[-kStride], and a placed stone moves
// pk one column left.
template <typename R>
struct Walk {
  R r, sum;
  const R* pk;
};

// The suffix term's offset from C(k, rem) in the table: C(k+1, rem + 1)
// or C(k+1, rem) for a child (player 1 moves, or player 2), C(k-1, rem -
// 1) or C(k-1, rem) for a parent (player 1 made the ply, or player 2).
template <bool kChild, bool kP1>
constexpr int kTerm = kChild ? kStride + kP1 : -kStride - kP1;

// One cell, `j` rows below the column's first: a stone when C(k, rem) <=
// r, which then adds the suffix term at kTerm from C(k, rem).
template <int kT, typename R>
__device__ __forceinline__ bool cell(Walk<R>& s, int j) {
  const R* at = s.pk - (j + 1) * kStride;
  const R c = *at;
  const bool take = c <= s.r;
  if (take) {
    s.r -= c;
    s.sum += at[kT];
    --s.pk;
  }
  return take;
}

// N cells of a column, top (row N-1) first -> the stones' rows as bits;
// unrolled, so every offset and bit is an immediate.
template <int N, int kT, typename R>
__device__ __forceinline__ unsigned cells(Walk<R>& s) {
  unsigned col = 0;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (cell<kT>(s, j)) col |= 1u << (N - 1 - j);
  s.pk -= N * kStride;
  return col;
}

// The n cells of a column, top first -> the stones' rows as bits: a
// switch on n into the unrolled runs on a fixed shape, a loop otherwise.
template <int kH, int kT, typename R>
__device__ __forceinline__ unsigned column(Walk<R>& s, int n) {
  if (kH > 0) {
    switch (n) {
#define DENSE_LEVEL_CELLS(N) \
      case N:                \
        if constexpr (N <= kH) return cells<N, kT>(s); \
        break;
      DENSE_LEVEL_CELLS(1)
      DENSE_LEVEL_CELLS(2)
      DENSE_LEVEL_CELLS(3)
      DENSE_LEVEL_CELLS(4)
      DENSE_LEVEL_CELLS(5)
      DENSE_LEVEL_CELLS(6)
#undef DENSE_LEVEL_CELLS
      default:
        break;
    }
    return 0u;
  }
  unsigned col = 0;
  for (int j = 0; j < n; ++j)
    if (cell<kT>(s, j)) col |= 1u << (n - 1 - j);
  s.pk -= n * kStride;
  return col;
}

// The monotone fill of move c where the lane does not follow it: invalid
// rows take the previous valid row's last slot (0 before any), pad lanes
// their own row's last slot.
template <typename F>
__device__ __forceinline__ F fill_of(int fr, F cc) {
  return fr < 0 ? F(0) : static_cast<F>(fr) * cc + (cc - F(1));
}

// The combine as one max: each child cell maps to a key (0 for none, 1 +
// r for a win, 65 + r for a tie, 129 + 63 - r for a loss, so the largest
// is the best move for the mover), and the best key to the parent's cell:
// WIN 1 + min loss remoteness, else TIE 1 + max tie remoteness, else LOSE
// 1 + max remoteness (0 with no child), the remoteness capped at 63.
constexpr unsigned kNoChild = 256;  // key 0

__device__ __forceinline__ void stage_combine(uint8_t* key, uint8_t* dec) {
  for (unsigned i = threadIdx.x; i <= kNoChild; i += blockDim.x) {
    const unsigned v = i & 3, r = i >> 2;
    key[i] = i == kNoChild ? 0 : v == kLose ? 192 - r : v == kTie ? 65 + r
                                                                 : 1 + r;
  }
  for (unsigned b = threadIdx.x; b < 256; b += blockDim.x) {
    unsigned value, rem;
    if (b > 128) {
      value = kWin;
      rem = 193 - b;
    } else if (b > 64) {
      value = kTie;
      rem = b - 64;
    } else {
      value = kLose;
      rem = b;
    }
    dec[b] = static_cast<uint8_t>(value | ((rem > 63 ? 63 : rem) << 2));
  }
}

// The CTA's place in the launch: rank block, first and end lane of its
// run, its first row, and whether the run lies in that row alone.
struct Cta {
  unsigned b, q0, q1, row0;
  bool uniform;
};

// Stage the binomial table and, on thread 0, the CTA's place; then the
// row record where the run lies in one row. Three barriers at most; every
// thread takes them.
template <typename R>
__device__ __forceinline__ Cta stage(const Params& p, R* binom,
                                     int32_t* srec) {
  __shared__ unsigned info[5];
  if (threadIdx.x == 0) {
    const unsigned b = blockIdx.x / p.runs;
    const unsigned q0 = (blockIdx.x - b * p.runs) * kRun;
    const unsigned q1 = q0 + kRun < p.nlanes ? q0 + kRun : p.nlanes;
    const unsigned row0 = q0 / p.width;
    info[0] = b;
    info[1] = q0;
    info[2] = q1;
    info[3] = row0;
    info[4] = (q1 - 1) / p.width == row0;
  }
  const R* g = static_cast<const R*>(p.binom);
  const int nb = (p.ncells + 2) * kStride;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) binom[i] = g[i];
  __syncthreads();
  const Cta cta{info[0], info[1], info[2], info[3], info[4] != 0};
  if (cta.uniform) {
    const int32_t* rec = p.rows + static_cast<size_t>(cta.row0) * p.stride;
    for (int i = threadIdx.x; i < p.stride; i += blockDim.x) srec[i] = rec[i];
  }
  __syncthreads();
  return cta;
}

// Lane q of the CTA: its row, rank and output offset.
struct Lane {
  unsigned row;
  unsigned long long rank;
  size_t at;
  bool in_range;
};

__device__ __forceinline__ Lane lane_of(const Params& p, const Cta& cta,
                                        unsigned q) {
  Lane l;
  l.row = cta.uniform ? cta.row0 : q / p.width;
  const unsigned col = q - l.row * p.width;
  l.rank = static_cast<unsigned long long>(cta.b) * p.cblock + p.lo + col;
  l.at = static_cast<size_t>(l.row) * p.ld + cta.b * p.ostep + p.obase + col;
  l.in_range = l.rank < p.size;
  return l;
}

__device__ __forceinline__ const int32_t* record(const Params& p,
                                                 const Cta& cta,
                                                 const int32_t* srec,
                                                 unsigned row) {
  return cta.uniform ? srec : p.rows + static_cast<size_t>(row) * p.stride;
}

// Dynamic shared memory: the binomial table, then the row record, each
// 8-aligned.
template <typename R>
__device__ __forceinline__ void carve(unsigned char* smem, const Params& p,
                                      R** binom, int32_t** srec) {
  const size_t nb = (static_cast<size_t>(p.ncells + 2) * kStride *
                     sizeof(R) + 7) & ~size_t(7);
  *binom = reinterpret_cast<R*>(smem);
  *srec = reinterpret_cast<int32_t*>(smem + nb);
}

// The backward walk of one in-range lane: its player-1 bitboard; per
// move, the flat child index checked against the run's window (misses
// counted, `pad` replicas more for the block's last lane) and, for a
// valid move, the child's cell gathered and its key folded into *best
// (each gather folded one column late, so its load overlaps the walk).
// kP1: player 1 moves out of this level.
template <typename W, typename R, typename F, int kH, bool kP1>
__device__ __forceinline__ W backward_walk(const Params& p,
                                           const int32_t* rec, R rank,
                                           const R* binom,
                                           const uint8_t* key,
                                           const F* base, unsigned pad,
                                           unsigned* miss, unsigned* best) {
  const int w = p.w, h = kH > 0 ? kH : p.h;
  const int32_t* hts = rec + kRecHeights;
  const int32_t* mrow = hts + w;
  const int32_t* mfill = mrow + w;
  const F cc = static_cast<F>(p.adj), last = static_cast<F>(p.m - 1);
  Walk<R> s{rank, R(0), binom + (p.level + 1) * kStride + p.n1};
  W bits = 0;
  unsigned pending = kNoChild, b = 0, m = 0;
  for (int c = w - 1; c >= 0; --c) {
    const int hc = hts[c];
    F f;
    if (hc < h) {  // the new cell at class index t = the cells left
      R cr = s.r + s.sum;
      if (kP1) cr += s.pk[1];  // C(t, rem + 1)
      f = static_cast<F>(mrow[c]) * cc + static_cast<F>(cr);
      const unsigned kb = key[pending];
      b = kb > b ? kb : b;
      pending = __ldg(p.src + (f < last ? f : last));
    } else {
      f = fill_of(mfill[c], cc);
    }
    // Below the base wraps past the two windows: a miss too.
    if (static_cast<F>(f - base[c]) >= static_cast<F>(2 * kWindow))
      m += 1 + pad;
    bits |= W(column<kH, kTerm<true, kP1>>(s, hc)) << (c * (h + 1));
  }
  const unsigned kb = key[pending];
  *best = kb > b ? kb : b;
  *miss += m;
  return bits;
}

// The miss count of a pad lane (rank past C): its fills only.
template <typename F>
__device__ __forceinline__ unsigned pad_misses(const Params& p,
                                               const int32_t* rec, int h,
                                               const F* base, unsigned pad) {
  const int32_t* hts = rec + kRecHeights;
  const int32_t* mrow = hts + p.w;
  const int32_t* mfill = mrow + p.w;
  const F cc = static_cast<F>(p.adj);
  unsigned m = 0;
  for (int c = 0; c < p.w; ++c) {
    const F f = fill_of(hts[c] < h ? mrow[c] : mfill[c], cc);
    if (static_cast<F>(f - base[c]) >= static_cast<F>(2 * kWindow))
      m += 1 + pad;
  }
  return m;
}

// kP1: player 1 moves out of this level (an even level).
template <typename W, typename R, typename F, int kH, bool kP1>
__global__ void __launch_bounds__(kThreads) dense_step_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ F base[kMaxCols];
  __shared__ uint8_t key[kNoChild + 1], dec[256];
  __shared__ unsigned long long block_miss;
  R* binom;
  int32_t* srec;
  carve(smem, p, &binom, &srec);
  if (threadIdx.x == 0) block_miss = 0;
  stage_combine(key, dec);
  const Cta cta = stage(p, binom, srec);
  const int h = kH > 0 ? kH : p.h;

  const bool top = p.level == p.ncells;  // no gather, no base, no miss
  if (!top && threadIdx.x == 0) {
    // The run's window base per move, from its first lane's index (one
    // walk gives all w), held in base[] until it is clipped to a window.
    const Lane l = lane_of(p, cta, cta.q0);
    const int32_t* rec = record(p, cta, srec, l.row);
    const int32_t* hts = rec + kRecHeights;
    const int32_t* mrow = hts + p.w;
    const int32_t* mfill = mrow + p.w;
    const F cc = static_cast<F>(p.adj);
    if (l.in_range) {
      Walk<R> s{static_cast<R>(l.rank), R(0),
                binom + (p.level + 1) * kStride + p.n1};
      for (int c = p.w - 1; c >= 0; --c) {
        const int hc = hts[c];
        if (hc < h) {
          R cr = s.r + s.sum;
          if (kP1) cr += s.pk[1];
          base[c] = static_cast<F>(mrow[c]) * cc + static_cast<F>(cr);
        } else {
          base[c] = fill_of(mfill[c], cc);
        }
        column<0, kTerm<true, kP1>>(s, hc);
      }
    } else {
      for (int c = 0; c < p.w; ++c)
        base[c] = fill_of(hts[c] < h ? mrow[c] : mfill[c], cc);
    }
    for (int c = 0; c < p.w; ++c) {
      long long bw = static_cast<long long>(
          static_cast<unsigned long long>(base[c]) >> kWindowShift);
      bw = bw > p.nwin - 2 ? p.nwin - 2 : bw;
      base[c] = static_cast<F>((bw < 0 ? 0 : bw) * kWindow);
    }
  }
  __syncthreads();

  unsigned miss = 0;  // at most kLanes * w * kRun per thread
  for (int i = 0; i < kLanes; ++i) {
    const unsigned q = cta.q0 + i * kThreads + threadIdx.x;
    if (q >= cta.q1) break;
    const Lane l = lane_of(p, cta, q);
    const int32_t* rec = record(p, cta, srec, l.row);
    // Replicas of the last index that pad the block's ragged last run.
    const unsigned pad = q == p.nlanes - 1 ? cta.q0 + kRun - p.nlanes : 0u;
    if (!l.in_range) {
      if (!top) miss += pad_misses(p, rec, h, base, pad);
      continue;
    }
    unsigned best;
    const W p1 = backward_walk<W, R, F, kH, kP1>(
        p, rec, static_cast<R>(l.rank), binom, key, base, pad, &miss, &best);
    const W p2 = W(filled_of<W>(rec) ^ p1);
    // The mover's line: the player to move lost. The other's line alone:
    // unreachable garbage, made terminal.
    const bool prim = has_line<W, kH>(p1, p.h, p.connect) ||
                      has_line<W, kH>(p2, p.h, p.connect);
    p.out[l.at] = prim ? kLose : top ? kTie : dec[best];
  }
  if (top) miss = 0;  // no gather at the top level: nothing to count
  if (miss) atomicAdd(&block_miss, static_cast<unsigned long long>(miss));
  __syncthreads();
  if (threadIdx.x == 0 && block_miss) atomicAdd(p.counter, block_miss);
}

// The reach of one in-range lane: any parent (each column whose top
// stone is the last mover's, kP1: player 1's, that stone removed) has no
// line and is reachable. Every followed parent's byte is gathered in the
// walk; the line test, one for all of them, comes after it.
template <typename W, typename R, typename F, int kH, bool kP1>
__device__ __forceinline__ uint8_t reach_lane(const Params& p,
                                              const int32_t* rec, R rank,
                                              const R* binom) {
  const int w = p.w, h = kH > 0 ? kH : p.h;
  const int32_t* hts = rec + kRecHeights;
  const int32_t* prow = hts + w;
  const F cp = static_cast<F>(p.adj), last = static_cast<F>(p.m - 1);
  constexpr int kT = kTerm<false, kP1>;
  Walk<R> s{rank, R(0), binom + (p.level + 1) * kStride + p.n1};
  W p1 = 0;
  unsigned any = 0;
  for (int c = w - 1; c >= 0; --c) {
    const int hc = hts[c];
    if (hc == 0) continue;
    // The parent removes the top cell: its suffix is the cells above, its
    // prefix the rank left after the top cell.
    const R above = s.sum;
    const bool top_p1 = cell<kT>(s, 0);
    s.pk -= kStride;
    if (top_p1 == kP1) {  // the stone's colour: the last mover's
      const F f = static_cast<F>(prow[c]) * cp + static_cast<F>(s.r + above);
      any |= __ldg(p.src + (f < last ? f : last));
    }
    const unsigned col = column<kH, kT>(s, hc - 1) |
                         (top_p1 ? 1u << (hc - 1) : 0u);
    p1 |= W(col) << (c * (h + 1));
  }
  // Every parent's last mover is the player who did not make this ply;
  // removing the top stone leaves that player's stones as they are.
  const W other = kP1 ? W(filled_of<W>(rec) ^ p1) : p1;
  return any != 0 && !has_line<W, kH>(other, p.h, p.connect);
}

// kP1: player 1 made the ply into this level (an odd level).
template <typename W, typename R, typename F, int kH, bool kP1>
__global__ void __launch_bounds__(kThreads) reach_step_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long block_count;
  R* binom;
  int32_t* srec;
  carve(smem, p, &binom, &srec);
  if (threadIdx.x == 0) block_count = 0;
  const Cta cta = stage(p, binom, srec);

  unsigned count = 0;
  for (int i = 0; i < kLanes; ++i) {
    const unsigned q = cta.q0 + i * kThreads + threadIdx.x;
    if (q >= cta.q1) break;
    const Lane l = lane_of(p, cta, q);
    if (!l.in_range) continue;
    const int32_t* rec = record(p, cta, srec, l.row);
    const uint8_t reach = reach_lane<W, R, F, kH, kP1>(
        p, rec, static_cast<R>(l.rank), binom);
    count += reach;
    p.out[l.at] = reach;
  }
  if (count) atomicAdd(&block_count, static_cast<unsigned long long>(count));
  __syncthreads();
  if (threadIdx.x == 0 && block_count) atomicAdd(p.counter, block_count);
}

template <typename K>
cudaError_t run(K kernel, const Params& p, unsigned grid, size_t smem,
                cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// One instantiation per kernel, words, shape and parity: player 1 moves
// out of an even level (backward), made the ply into an odd one (reach).
template <typename W, typename R, typename F, int kH>
cudaError_t launch(bool reach, const Params& p, unsigned grid, size_t smem,
                   cudaStream_t stream) {
  const bool odd = (p.level & 1) == 1;
  if (reach)
    return odd ? run(reach_step_kernel<W, R, F, kH, true>, p, grid, smem,
                     stream)
               : run(reach_step_kernel<W, R, F, kH, false>, p, grid, smem,
                     stream);
  return odd ? run(dense_step_kernel<W, R, F, kH, false>, p, grid, smem,
                   stream)
             : run(dense_step_kernel<W, R, F, kH, true>, p, grid, smem,
                   stream);
}

template <int kH>
cudaError_t launch_words(long long words, bool reach, const Params& p,
                         unsigned grid, size_t smem, cudaStream_t s) {
  switch (words) {  // bit 0: 64-bit bitboards; 1: ranks; 2: flat
    case 0: return launch<uint32_t, uint32_t, uint32_t, kH>(reach, p, grid, smem, s);
    case 1: return launch<uint64_t, uint32_t, uint32_t, kH>(reach, p, grid, smem, s);
    case 5: return launch<uint64_t, uint32_t, uint64_t, kH>(reach, p, grid, smem, s);
    case 7: return launch<uint64_t, uint64_t, uint64_t, kH>(reach, p, grid, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

// The fixed shapes: connect 4 on columns of kH, where every fold shift
// (at most 2(h+2)) is below the bitboard's width.
template <int kH>
bool fixed(const Params& p, long long words) {
  return p.connect == 4 && p.h == kH && 2 * (kH + 2) < ((words & 1) ? 64 : 32);
}

template <typename T>
T ptr(const long long* a, int i) {
  return reinterpret_cast<T>(static_cast<uintptr_t>(a[i]));
}

int dispatch(bool reach, const long long* a, int na, void* stream) {
  if (na != A_COUNT) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  const long long P = a[A_P], width = a[A_WIDTH], runs = a[A_RUNS];
  const long long nblk = a[A_NBLK], grid = a[A_GRID];
  p.size = static_cast<unsigned long long>(a[A_SIZE]);
  p.cblock = static_cast<unsigned long long>(a[A_CBLOCK]);
  p.lo = static_cast<unsigned long long>(a[A_LO]);
  p.ld = static_cast<unsigned long long>(a[A_LD]);
  p.ostep = static_cast<unsigned long long>(a[A_OSTEP]);
  p.obase = static_cast<unsigned long long>(a[A_OBASE]);
  p.adj = a[A_ADJ];
  p.m = a[A_M];
  p.nwin = a[A_NWIN];
  p.w = static_cast<int>(a[A_W]);
  p.h = static_cast<int>(a[A_H]);
  p.connect = static_cast<int>(a[A_CONNECT]);
  p.ncells = static_cast<int>(a[A_NCELLS]);
  p.n1 = static_cast<int>(a[A_N1]);
  p.level = static_cast<int>(a[A_LEVEL]);
  p.stride = kRecHeights + (reach ? 2 : 3) * p.w;
  p.src = ptr<const uint8_t*>(a, A_SRC);
  p.out = ptr<uint8_t*>(a, A_OUT);
  p.counter = ptr<unsigned long long*>(a, A_COUNTER);
  p.binom = ptr<const void*>(a, A_BINOM);
  p.rows = ptr<const int32_t*>(a, A_ROWS);
  const size_t smem = static_cast<size_t>(a[A_SMEM]);
  if (P <= 0 || width <= 0 || P * width >= (1ll << 31) || nblk <= 0 ||
      runs != (P * width + kRun - 1) / kRun || grid != nblk * runs ||
      grid > 0x7fffffffll || p.w > kMaxCols || p.ncells > kMaxCells ||
      p.h <= 0 || p.m <= 0 || p.cblock < p.lo + width || a[A_K] > kStride ||
      a[A_LD] <= 0 || a[A_OSTEP] < width || a[A_OBASE] < 0 ||
      smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  p.width = static_cast<unsigned>(width);
  p.runs = static_cast<unsigned>(runs);
  p.nlanes = static_cast<unsigned>(P * width);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(grid);
  const long long words = a[A_WORDS];
  cudaError_t e;
  if (fixed<4>(p, words))
    e = launch_words<4>(words, reach, p, g, smem, s);
  else if (fixed<5>(p, words))
    e = launch_words<5>(words, reach, p, g, smem, s);
  else if (fixed<6>(p, words))
    e = launch_words<6>(words, reach, p, g, smem, s);
  else
    e = launch_words<0>(words, reach, p, g, smem, s);
  return static_cast<int>(e);
}

}  // namespace

extern "C" int dense_step_launch(const long long* args, int nargs,
                                 void* stream) {
  return dispatch(false, args, nargs, stream);
}

extern "C" int reach_step_launch(const long long* args, int nargs,
                                 void* stream) {
  return dispatch(true, args, nargs, stream);
}
