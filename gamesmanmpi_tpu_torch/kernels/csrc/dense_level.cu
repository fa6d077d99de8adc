// The dense Connect-4 engine's level steps for Hopper (sm_90a).
//
// Replaces the two XLA programs of the reference's dense engine, each one
// compiled program per (level, block width) there:
//
// * dense_step_kernel — gamesmanmpi_tpu/solve/dense.py:577
//   `build_dense_step`, the backward step: per lane (one position of a
//   [P, width] block whose ranks start at rank0) unrank player 1's
//   stones (`_unrank_bits`, :404), both win folds (`_connected_fold`,
//   :389), then per move the child's bitboard, its combinadic rank
//   (`_rank_bits`, :430), its flat index row*Cc + rank with the
//   monotone fill of the window gather (:508-516), and its packed cell;
//   the negamax combine of ops/combine.py `combine_children`; the lane's
//   `value | remoteness << 2`. At the top level a lane is TIE, or LOSE
//   on a line. It also counts the window gather's misses exactly as
//   ops/window_gather.monotone_window_gather_ref does per move (the
//   reference's Pallas gather, ops/pallas_gather.py:116): over the flat
//   row-major [P, width] index vector in blocks of 2,048 lanes, each
//   block against the two windows of 8,192 from clip(first / 8192, 0,
//   nwin-2) * 8192, the ragged last block padded with its last index.
//   One CTA takes exactly one such block, so its base is one value per
//   move, taken from its first lane.
// * reach_step_kernel — :759 `build_reach_step`, the reachability step:
//   per lane the OR over columns of "the top stone is the last mover's,
//   the parent (that stone removed) had no line, and the parent's reach
//   byte is set", the u8 reach, and the CTA's count of in-range reached
//   lanes added to one int64 counter with one atomic (integer, so the
//   order of the atomics cannot change the count).
//
// Bound on this card: integer operations, not bytes. A lane reads a few
// bytes of its child level (at most 18.9 MB at 5x5, which the 50 MB L2
// holds) and writes one; it walks the board's cells once to unrank and
// once per move to rank, about 1-2k integer operations. The design keeps
// every intermediate in registers (one thread per lane, no [P, width]
// temporaries), the binomial table and the cells' bit masks in shared
// memory, the per-row constants in L1 (lanes of a warp share a profile
// row, so their loads are broadcasts), and the words as narrow as the
// reference's (uint32 bitboards, ranks and flat indices at 5x5; 64-bit
// where the board needs them; unsigned, so no wrap is undefined).
// Pad lanes (rank >= C) only compute their fill indices for the miss
// count and write 0.
//
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
constexpr int kMaxCols = 32;
constexpr int kMaxCells = 64;
constexpr unsigned kWin = 1, kLose = 2, kTie = 3;

enum Arg {
  A_P, A_WIDTH, A_RANK0, A_N, A_SIZE, A_ADJ, A_M, A_NWIN, A_W, A_H,
  A_CONNECT, A_NCELLS, A_N1, A_K, A_LEVEL, A_WORDS, A_GRID, A_SMEM,
  A_SRC, A_OUT, A_COUNTER, A_BINOM, A_CELLIDX, A_FILLED, A_BITS, A_VALID,
  A_ROW, A_FILL, A_CCELLIDX, A_COUNT
};

struct Params {
  long long P, width, rank0, n;
  long long size;  // ranks per class at this level (C)
  long long adj;   // the gather source's class size (Cc, or Cp)
  long long m;     // entries of the gather source
  long long nwin;  // windows of the gather source (the miss clip)
  int w, h, connect, ncells, n1, K, level;
  const uint8_t* src;   // child cells / parent reach, flat
  uint8_t* out;         // [P, width]
  unsigned long long* counter;
  const void* binom;    // [ncells+1, K] rank words
  const int8_t* cellidx;  // [P, ncells]
  const void* filled;   // [P] bit words
  const void* bits;     // [P, w] bit words: newbit, or topstone
  const uint8_t* valid;   // [P, w] (backward step)
  const int32_t* row;   // [P, w] move_row, or parent_row
  const int32_t* fill;  // [P, w] move_fill (backward step)
  const int8_t* ccellidx;  // [P, w, ncells] child/parent cell indices
};

template <typename W>
__device__ __forceinline__ W shr(W x, int s) {
  return s >= static_cast<int>(8 * sizeof(W)) ? W(0) : W(x >> s);
}

// Any `connect`-in-a-row along stride d.
template <typename W>
__device__ __forceinline__ bool line_along(W s, int d, int connect) {
  W x = s;
  for (int i = 1; i < connect; ++i) x &= shr(s, i * d);
  return x != 0;
}

// Any `connect`-in-a-row in a guard-layout bitboard: vertical 1,
// diag-down h, horizontal h+1, diag-up h+2 (games/connect4.py).
template <typename W>
__device__ __forceinline__ bool has_line(W s, int h, int connect) {
  return line_along(s, 1, connect) || line_along(s, h, connect) ||
         line_along(s, h + 1, connect) || line_along(s, h + 2, connect);
}

// Rank r -> player-1 bitboard: the descending walk over the cells.
template <typename W, typename R>
__device__ __forceinline__ W unrank(R r, int n1, const int8_t* ci,
                                    const R* binom, const W* mask,
                                    const Params& p) {
  W bits = 0;
  int rem = n1;
  for (int j = p.ncells - 1; j >= 0 && rem > 0; --j) {
    const int k = __ldg(ci + j);
    if (k < 0) continue;
    const R c = binom[k * p.K + rem];  // C(k, rem); 0 when k < rem
    if (c <= r) {
      r -= c;
      --rem;
      bits |= mask[j];
    }
  }
  return bits;
}

// Stones -> combinadic rank under the cell indexing ci (the target class).
template <typename W, typename R>
__device__ __forceinline__ R rank_of(W bits, const int8_t* ci,
                                     const R* binom, const W* mask,
                                     const Params& p) {
  R acc = 0;
  int seen = 0;
  for (int j = 0; j < p.ncells; ++j) {
    const int k = __ldg(ci + j);
    if (k >= 0 && (bits & mask[j])) {
      ++seen;
      acc += binom[k * p.K + seen];
    }
  }
  return acc;
}

struct Lane {
  long long row;
  bool in_range;
  unsigned long long rank;
};

__device__ __forceinline__ Lane lane_of(long long lane, const Params& p) {
  Lane l;
  l.row = lane / p.width;
  l.rank = static_cast<unsigned long long>(p.rank0 + (lane - l.row * p.width));
  l.in_range = l.rank < static_cast<unsigned long long>(p.size);
  return l;
}

// The flat child index of move c (the monotone fill where the lane does
// not follow the move); *live when it does (a valid move, in range).
template <typename W, typename R, typename F>
__device__ __forceinline__ F move_flat(const Params& p, const Lane& l, int c,
                                       W p1, bool p1_moves, const R* binom,
                                       const W* mask, bool* live) {
  const long long rc = l.row * p.w + c;
  const bool valid = __ldg(p.valid + rc) != 0;
  const int mrow = __ldg(p.row + rc);
  const F cc = static_cast<F>(p.adj);
  *live = valid && l.in_range;
  if (*live) {
    const W cbits =
        p1_moves ? W(p1 | static_cast<const W*>(p.bits)[rc]) : p1;
    const R cr = rank_of<W, R>(cbits, p.ccellidx + rc * p.ncells, binom,
                               mask, p);
    return static_cast<F>(mrow) * cc + static_cast<F>(cr);
  }
  // Invalid rows take the previous valid row's last slot (0 before any),
  // pad lanes their own row's last slot.
  const int fr = valid ? mrow : __ldg(p.fill + rc);
  return fr < 0 ? F(0) : static_cast<F>(fr) * cc + (cc - F(1));
}

template <typename W, typename R>
__device__ __forceinline__ void stage(const Params& p, R* binom, W* mask) {
  const R* g = static_cast<const R*>(p.binom);
  const int nb = (p.ncells + 1) * p.K;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) binom[i] = g[i];
  for (int j = threadIdx.x; j < p.ncells; j += blockDim.x)
    mask[j] = W(1) << (j + j / p.h);  // global cell j's bit
}

template <typename W, typename R>
__device__ __forceinline__ void tables_of(unsigned char* smem, const Params& p,
                                          R** binom, W** mask) {
  *binom = reinterpret_cast<R*>(smem);
  const size_t nb = static_cast<size_t>(p.ncells + 1) * p.K * sizeof(R);
  *mask = reinterpret_cast<W*>(smem + ((nb + 7) & ~size_t(7)));
}

template <typename W, typename R, typename F>
__global__ void __launch_bounds__(kThreads) dense_step_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long base[kMaxCols];
  __shared__ unsigned long long block_miss;
  R* binom;
  W* mask;
  tables_of(smem, p, &binom, &mask);
  stage(p, binom, mask);
  if (threadIdx.x == 0) block_miss = 0;
  __syncthreads();

  const bool top = p.level == p.ncells;
  const bool p1_moves = (p.level & 1) == 0;  // the player moving out
  const long long start = static_cast<long long>(blockIdx.x) * kRun;
  if (!top) {
    // The block's window base per move, from its first lane's index.
    if (static_cast<int>(threadIdx.x) < p.w) {
      const Lane l = lane_of(start, p);
      const W p1 = l.in_range
          ? unrank<W, R>(static_cast<R>(l.rank), p.n1,
                         p.cellidx + l.row * p.ncells, binom, mask, p)
          : W(0);
      bool live;
      const F f = move_flat<W, R, F>(p, l, threadIdx.x, p1, p1_moves, binom,
                                     mask, &live);
      long long bw = static_cast<long long>(f) / kWindow;
      bw = bw > p.nwin - 2 ? p.nwin - 2 : bw;
      base[threadIdx.x] = (bw < 0 ? 0 : bw) * kWindow;
    }
    __syncthreads();
  }

  unsigned long long miss = 0;
  for (int i = 0; i < kLanes; ++i) {
    const long long lane = start + i * kThreads + threadIdx.x;
    if (lane >= p.n) break;
    const Lane l = lane_of(lane, p);
    W p1 = 0;
    bool prim = false;
    if (l.in_range) {
      p1 = unrank<W, R>(static_cast<R>(l.rank), p.n1,
                        p.cellidx + l.row * p.ncells, binom, mask, p);
      const W p2 = W(static_cast<const W*>(p.filled)[l.row] ^ p1);
      // The mover's line: the player to move lost. The other's line
      // alone: unreachable garbage, made terminal.
      prim = has_line(p1, p.h, p.connect) || has_line(p2, p.h, p.connect);
    }
    if (top) {
      p.out[lane] = l.in_range ? (prim ? kLose : kTie) : 0;
      continue;
    }
    // Replicas of the last index that pad the ragged last block.
    const unsigned long long pad =
        lane == p.n - 1 ? static_cast<unsigned long long>(start + kRun - p.n)
                        : 0ull;
    bool any_lose = false, any_tie = false;
    int win_rem = 1 << 30, tie_rem = -1, lose_rem = -1;
    for (int c = 0; c < p.w; ++c) {
      bool live;
      const F f = move_flat<W, R, F>(p, l, c, p1, p1_moves, binom, mask,
                                     &live);
      const long long off = static_cast<long long>(f) - base[c];
      if (off < 0 || off >= 2 * kWindow) miss += 1 + pad;
      if (live && !prim) {
        const F last = static_cast<F>(p.m - 1);
        const unsigned cell = __ldg(p.src + (f < last ? f : last));
        const int v = cell & 3, r = cell >> 2;
        lose_rem = r > lose_rem ? r : lose_rem;
        if (v == kLose) {
          any_lose = true;
          win_rem = r < win_rem ? r : win_rem;
        } else if (v == kTie) {
          any_tie = true;
          tie_rem = r > tie_rem ? r : tie_rem;
        }
      }
    }
    unsigned value;
    int rem;
    if (!l.in_range) {
      p.out[lane] = 0;
      continue;
    }
    if (prim) {
      value = kLose;
      rem = 0;
    } else if (any_lose) {
      value = kWin;
      rem = 1 + win_rem;
    } else if (any_tie) {
      value = kTie;
      rem = 1 + tie_rem;
    } else {
      value = kLose;  // every child a win, or none: 1 + max, 0 with none
      rem = 1 + lose_rem;
    }
    rem = rem < 0 ? 0 : (rem > 63 ? 63 : rem);
    p.out[lane] = static_cast<uint8_t>(value | (rem << 2));
  }
  if (miss) atomicAdd(&block_miss, miss);
  __syncthreads();
  if (threadIdx.x == 0 && block_miss) atomicAdd(p.counter, block_miss);
}

template <typename W, typename R, typename F>
__global__ void __launch_bounds__(kThreads) reach_step_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long block_count;
  R* binom;
  W* mask;
  tables_of(smem, p, &binom, &mask);
  stage(p, binom, mask);
  if (threadIdx.x == 0) block_count = 0;
  __syncthreads();

  const bool mover_is_p1 = (p.level & 1) == 1;  // who made ply `level`
  const long long start = static_cast<long long>(blockIdx.x) * kRun;
  unsigned long long count = 0;
  for (int i = 0; i < kLanes; ++i) {
    const long long lane = start + i * kThreads + threadIdx.x;
    if (lane >= p.n) break;
    const Lane l = lane_of(lane, p);
    uint8_t reach = 0;
    if (l.in_range) {
      const W p1 = unrank<W, R>(static_cast<R>(l.rank), p.n1,
                                p.cellidx + l.row * p.ncells, binom, mask, p);
      const W filled = static_cast<const W*>(p.filled)[l.row];
      for (int c = 0; c < p.w && !reach; ++c) {
        const long long rc = l.row * p.w + c;
        const int prow = __ldg(p.row + rc);
        const W ts = static_cast<const W*>(p.bits)[rc];
        if (prow < 0 || ts == 0) continue;
        if (((p1 & ts) != 0) != mover_is_p1) continue;  // the stone's colour
        const W parent_p1 = mover_is_p1 ? W(p1 ^ ts) : p1;
        // The parent's last mover: the other player than this ply's.
        const W parent_mover =
            mover_is_p1 ? W((filled ^ ts) ^ parent_p1) : parent_p1;
        if (has_line(parent_mover, p.h, p.connect)) continue;
        const R pr = rank_of<W, R>(parent_p1, p.ccellidx + rc * p.ncells,
                                   binom, mask, p);
        const F f = static_cast<F>(prow) * static_cast<F>(p.adj) +
                    static_cast<F>(pr);
        const F last = static_cast<F>(p.m - 1);
        reach = __ldg(p.src + (f < last ? f : last)) != 0;
      }
      count += reach;
    }
    p.out[lane] = reach;
  }
  if (count) atomicAdd(&block_count, count);
  __syncthreads();
  if (threadIdx.x == 0 && block_count) atomicAdd(p.counter, block_count);
}

template <typename W, typename R, typename F>
cudaError_t launch(bool reach, const Params& p, unsigned grid, size_t smem,
                   cudaStream_t stream) {
  if (reach)
    reach_step_kernel<W, R, F><<<grid, kThreads, smem, stream>>>(p);
  else
    dense_step_kernel<W, R, F><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
T ptr(const long long* a, int i) {
  return reinterpret_cast<T>(static_cast<uintptr_t>(a[i]));
}

int dispatch(bool reach, const long long* a, int na, void* stream) {
  if (na != A_COUNT) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.P = a[A_P];
  p.width = a[A_WIDTH];
  p.rank0 = a[A_RANK0];
  p.n = a[A_N];
  p.size = a[A_SIZE];
  p.adj = a[A_ADJ];
  p.m = a[A_M];
  p.nwin = a[A_NWIN];
  p.w = static_cast<int>(a[A_W]);
  p.h = static_cast<int>(a[A_H]);
  p.connect = static_cast<int>(a[A_CONNECT]);
  p.ncells = static_cast<int>(a[A_NCELLS]);
  p.n1 = static_cast<int>(a[A_N1]);
  p.K = static_cast<int>(a[A_K]);
  p.level = static_cast<int>(a[A_LEVEL]);
  p.src = ptr<const uint8_t*>(a, A_SRC);
  p.out = ptr<uint8_t*>(a, A_OUT);
  p.counter = ptr<unsigned long long*>(a, A_COUNTER);
  p.binom = ptr<const void*>(a, A_BINOM);
  p.cellidx = ptr<const int8_t*>(a, A_CELLIDX);
  p.filled = ptr<const void*>(a, A_FILLED);
  p.bits = ptr<const void*>(a, A_BITS);
  p.valid = ptr<const uint8_t*>(a, A_VALID);
  p.row = ptr<const int32_t*>(a, A_ROW);
  p.fill = ptr<const int32_t*>(a, A_FILL);
  p.ccellidx = ptr<const int8_t*>(a, A_CCELLIDX);
  const long long grid = a[A_GRID];
  const size_t smem = static_cast<size_t>(a[A_SMEM]);
  if (p.n <= 0 || p.width <= 0 || p.w > kMaxCols || p.ncells > kMaxCells ||
      p.h <= 0 || p.m <= 0 || grid != (p.n + kRun - 1) / kRun ||
      grid > 0x7fffffffll || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(grid);
  cudaError_t e;
  switch (a[A_WORDS]) {  // bit 0: 64-bit bitboards; 1: ranks; 2: flat
    case 0: e = launch<uint32_t, uint32_t, uint32_t>(reach, p, g, smem, s); break;
    case 1: e = launch<uint64_t, uint32_t, uint32_t>(reach, p, g, smem, s); break;
    case 5: e = launch<uint64_t, uint32_t, uint64_t>(reach, p, g, smem, s); break;
    case 7: e = launch<uint64_t, uint64_t, uint64_t>(reach, p, g, smem, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
