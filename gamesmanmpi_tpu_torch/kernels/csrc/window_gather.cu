// Monotone-window gather for Hopper (sm_90a).
//
// Replaces the Pallas kernel gamesmanmpi_tpu/ops/pallas_gather.py:116
// `monotone_window_gather` (pl.pallas_call at :223, body :198-221).
//
// out[i] = table[clamp(idx[i], 0, m-1)] for a non-decreasing idx, plus the
// reference's miss count: an element misses when it lies outside the
// two-window view [base, base + 2*window) of its reference block of
// `block` indices, base = clip(idx[b*block] / window, 0, nwin-2) * window
// (pallas_gather.py:159), the replicas of idx[n-1] that pad the last block
// included (pallas_gather.py:142-144, :231-233). Unlike the TPU kernel a
// miss still gets the right value, so callers need no fallback gather.
//
// Bound on this card: bytes. The function reads idx (4 or 8 B/element)
// and writes out (1-4 B/element) once, and reads about the part of the
// table that idx spans; it does no arithmetic worth counting. So the
// design is about the access pattern, not about the reference's tiling:
// `block` and `window` only define the miss count, and the work split is
// the kernel's own. The wrapper (ops/window_gather.py `gather_plan`)
// computes the grid and the run of each CTA, and `staged_span` there
// mirrors the span arithmetic below, so the CPU tests reach both.
//
// * A CTA of 256 threads takes a run of `run` consecutive indices: two
//   tiles of 4,096 (runs of 1 or 4 tiles were no faster at any shape the
//   port runs, PERF.md). In a tile each warp takes 512 indices. It
//   reads them as coalesced 16-byte vectors with a streaming hint (ld.global.cs: read once, so evict first and leave L2 to the
//   table), gathers each value, and writes it into a per-warp buffer in
//   shared memory. Then each lane stores 16 consecutive outputs with
//   16-byte stores: one for a u8 table, four for u32, rotated over the
//   lanes so that the buffer reads are free of bank conflicts.
// * Misses are counted per element against the base of its reference
//   block, which each thread caches for the block it is in: one division
//   and one load of idx[b*block] per block a lane enters.
// * The table span is staged: the CTA reads idx at both ends of its run;
//   one thread copies the table span between them (16-byte aligned, at
//   most `budget` bytes) into shared memory with one 1-D bulk copy (the
//   TMA) that completes on an mbarrier, while every thread loads its
//   first indices. Entries outside the span (a span wider than the
//   budget, a non-monotone idx, a table off 16-byte alignment) come from
//   __ldg. Reading every entry through __ldg instead, which L1 serves for
//   a monotone idx, was 5-16% slower on an H100 (PERF.md).
// * A tile that is not whole, or an idx or out off 16-byte alignment,
//   takes the scalar path: one index per thread, plain loads and stores.
//
// Plain C interface, bound from Python with ctypes
// (gamesmanmpi_tpu_torch/kernels/build.py). The launch returns the CUDA
// error code of the launch; it does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneElems = 16;
constexpr int kWarpElems = 32 * kLaneElems;
constexpr int kTile = kThreads * kLaneElems;

struct Args {
  const void* table;
  long long m;
  const void* idx;
  long long n;
  void* out;
  int* nmiss;
  long long block, window, nwin;
  long long run;     // indices per CTA, a multiple of kTile
  int vector;        // idx and out are 16-byte aligned
  long long budget;  // shared-memory bytes for the span
};

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

template <typename I>
__device__ __forceinline__ long long block_base(const I* idx, long long b,
                                                const Args& a) {
  long long bw = floor_div(static_cast<long long>(idx[b * a.block]), a.window);
  bw = bw < 0 ? 0 : (bw > a.nwin - 2 ? a.nwin - 2 : bw);
  return bw * a.window;
}

// The window base of the reference block holding `pos`, cached for the
// positions [lo, hi) of the last block asked for.
template <typename I>
struct BaseCache {
  long long lo = 0, hi = 0, base = 0;
  __device__ __forceinline__ long long get(const I* idx, long long pos,
                                           const Args& a) {
    if (pos < lo || pos >= hi) {
      const long long b = pos / a.block;
      lo = b * a.block;
      hi = lo + a.block;
      base = block_base(idx, b, a);
    }
    return base;
  }
};

// One 16-byte index vector, widened.
template <typename I>
struct IdxVec;
template <>
struct IdxVec<int32_t> {
  static constexpr int kElems = 4;
  __device__ static void load(const int32_t* p, long long* v) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};
template <>
struct IdxVec<int64_t> {
  static constexpr int kElems = 2;
  __device__ static void load(const int64_t* p, long long* v) {
    const longlong2 q = __ldcs(reinterpret_cast<const longlong2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  }
};

// An unsigned word of kBytes, for one shared-memory store of a lane's
// gathered values.
template <int kBytes>
struct Word;
template <>
struct Word<2> { using type = uint16_t; };
template <>
struct Word<4> { using type = uint32_t; };
template <>
struct Word<8> { using type = unsigned long long; };
template <>
struct Word<16> { using type = uint4; };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const Args a) {
  // [span: a.budget bytes][per-warp buffers: kWarps * kWarpElems * T]
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int warp_miss[kWarps];

  const T* __restrict__ table = static_cast<const T*>(a.table);
  const I* __restrict__ idx = static_cast<const I*>(a.idx);
  T* __restrict__ out = static_cast<T*>(a.out);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long start = static_cast<long long>(blockIdx.x) * a.run;
  const long long stop = start + a.run < a.n ? start + a.run : a.n;

  auto in_table = [&](long long v) -> long long {
    return v < 0 ? 0 : (v >= a.m ? a.m - 1 : v);
  };

  // The span [span_lo, span_lo + span_len) of table entries in shared
  // memory. ops/window_gather.py staged_span mirrors this.
  long long span_lo = 0, span_len = 0;
  const uint32_t bar_addr = smem_addr(&bar);
  {
    const long long tb = sizeof(T);
    const long long lo = in_table(idx[start]), hi = in_table(idx[stop - 1]);
    if ((reinterpret_cast<uintptr_t>(table) & 15) == 0 && hi >= lo) {
      const long long b_lo = lo * tb / 16 * 16;
      long long b_hi = ((hi + 1) * tb + 15) / 16 * 16;
      const long long b_end = a.m * tb / 16 * 16;  // never past the table
      if (b_hi > b_end) b_hi = b_end;
      if (b_hi > b_lo + a.budget) b_hi = b_lo + a.budget;
      if (b_hi > b_lo) {
        span_lo = b_lo / tb;
        span_len = (b_hi - b_lo) / tb;
      }
    }
    if (span_len > 0) {  // the same in every thread of the CTA
      if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     :: "r"(bar_addr) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        const uint32_t nb = static_cast<uint32_t>(span_len * tb);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(bar_addr), "r"(nb) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];"
            :: "r"(smem_addr(smem)), "l"(table + span_lo), "r"(nb),
               "r"(bar_addr)
            : "memory");
      }
    }
  }
  bool ready = span_len == 0;
  const T* span = reinterpret_cast<const T*>(smem);
  auto read = [&](long long v) -> T {
    const long long c = in_table(v);
    const long long o = c - span_lo;
    if (o >= 0 && o < span_len) return span[o];
    return __ldg(table + c);
  };
  auto wait_span = [&]() {
    if (!ready) {
      mbar_wait(bar_addr, 0);
      ready = true;
    }
  };

  constexpr int E = IdxVec<I>::kElems;  // indices per 16-byte load
  constexpr int S = kLaneElems / E;     // loads per lane per tile
  constexpr int R = sizeof(T);          // 16-byte stores per lane per tile
  using W = typename Word<E * sizeof(T)>::type;
  T* wbuf = reinterpret_cast<T*>(smem + a.budget) + warp * kWarpElems;

  BaseCache<I> cache;
  int miss = 0;
  for (long long t0 = start; t0 < stop; t0 += kTile) {
    if (a.vector && t0 + kTile <= a.n) {
      const long long w0 = t0 + warp * kWarpElems;
      long long v[kLaneElems];
#pragma unroll
      for (int s = 0; s < S; ++s)
        IdxVec<I>::load(idx + w0 + (s * 32 + lane) * E, v + s * E);
      wait_span();
#pragma unroll
      for (int s = 0; s < S; ++s) {
        union {
          T t[E];
          W w;
        } u;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const long long pos = w0 + (s * 32 + lane) * E + e;
          const long long off = v[s * E + e] - cache.get(idx, pos, a);
          miss += (off >= 0 && off < 2 * a.window) ? 0 : 1;
          u.t[e] = read(v[s * E + e]);
        }
        reinterpret_cast<W*>(wbuf)[s * 32 + lane] = u.w;
      }
      __syncwarp();
      const uint4* src = reinterpret_cast<const uint4*>(wbuf) + lane * R;
      uint4* dst = reinterpret_cast<uint4*>(out + w0) + lane * R;
      const int rot = lane / (8 / R);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int k = (j + rot) % R;
        dst[k] = src[k];
      }
      __syncwarp();
    } else {
      for (int k = threadIdx.x; k < kTile; k += kThreads) {
        const long long pos = t0 + k;
        if (pos >= stop) break;
        wait_span();
        const long long x = static_cast<long long>(idx[pos]);
        const long long off = x - cache.get(idx, pos, a);
        miss += (off >= 0 && off < 2 * a.window) ? 0 : 1;
        out[pos] = read(x);
      }
    }
  }

  // The replicas of idx[n-1] that pad the last reference block.
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    const long long nblk = (a.n + a.block - 1) / a.block;
    const long long npad = nblk * a.block - a.n;
    if (npad > 0) {
      const long long off = static_cast<long long>(idx[a.n - 1]) -
                            block_base(idx, nblk - 1, a);
      if (!(off >= 0 && off < 2 * a.window)) miss += static_cast<int>(npad);
    }
  }
  // No CTA leaves while its bulk copy may still write its shared memory.
  wait_span();

  // CTA sum of misses, then one atomic per CTA that saw any.
  for (int o = 16; o > 0; o >>= 1) miss += __shfl_down_sync(0xffffffffu, miss, o);
  if (lane == 0) warp_miss[warp] = miss;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_miss[w];
    if (total) atomicAdd(a.nmiss, total);
  }
}

template <typename T, typename I>
int launch(const Args& a, int grid, int smem, cudaStream_t stream) {
  void (*kern)(const Args) = &window_gather_kernel<T, I>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_idx(int idx_bytes, const Args& a, int grid, int smem,
               cudaStream_t stream) {
  if (idx_bytes == 4) return launch<T, int32_t>(a, grid, smem, stream);
  if (idx_bytes == 8) return launch<T, int64_t>(a, grid, smem, stream);
  return -1;
}

}  // namespace

// The gather copies bits, so the table's element type matters only by size:
// 1, 2 or 4 bytes (u8/i8, i16, u32/i32/f32). idx is int32 or int64. The
// launch arithmetic (run, grid, vector, budget, smem) is the wrapper's
// (ops/window_gather.py gather_plan). Returns 0 on success, a cudaError_t
// code on a refused launch, -1 on an unsupported element size.
extern "C" int window_gather_launch(int table_bytes, int idx_bytes,
                                    const void* table, long long m,
                                    const void* idx, long long n, void* out,
                                    void* nmiss, long long block,
                                    long long window, long long nwin,
                                    long long run, int grid, int vector,
                                    long long budget, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{table, m, idx, n, out, static_cast<int*>(nmiss), block, window,
               nwin, run, vector, budget};
  switch (table_bytes) {
    case 1:
      return launch_idx<uint8_t>(idx_bytes, a, grid, smem, s);
    case 2:
      return launch_idx<uint16_t>(idx_bytes, a, grid, smem, s);
    case 4:
      return launch_idx<uint32_t>(idx_bytes, a, grid, smem, s);
    default:
      return -1;
  }
}
