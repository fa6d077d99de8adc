// Monotone-window gather for Hopper (sm_90a).
//
// Replaces the Pallas kernel gamesmanmpi_tpu/ops/pallas_gather.py:116
// `monotone_window_gather` (pl.pallas_call at :223, body :198-221).
//
// out[i] = table[clamp(idx[i], 0, m-1)] for a non-decreasing idx, plus the
// reference's miss count. One CTA serves `block` consecutive indices. It
// takes its window base from its first index, clip(idx[b*block] / window,
// 0, nwin-2) * window (pallas_gather.py:159), stages the two window tiles
// [base, base + 2*window) into shared memory with coalesced 16-byte loads,
// and selects locally. An index outside that view is a miss: it is counted
// exactly as the reference counts it (the replicas of idx[n-1] that pad the
// last block included, pallas_gather.py:142-144, :231-233), and unlike the
// TPU kernel it still gets the right value, read from global memory. So
// callers need no fallback gather.
//
// Bound on this card: bytes. The function moves idx (4 or 8 B/element),
// out (1-4 B/element) and the table once; it does no arithmetic worth
// counting. The staging re-reads neighbouring windows (two tiles per CTA,
// shared with the next CTAs), which L2 absorbs for a monotone idx. The
// TPU work-arounds are gone: no [R,128] two-step dynamic_gather, no i32
// widening of u8 tiles, no offsets computed outside the kernel.
//
// Plain C interface, bound from Python with ctypes
// (gamesmanmpi_tpu_torch/kernels/build.py). The launch returns the CUDA
// error code of the launch; it does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const T* __restrict__ table, long long m,
                     const I* __restrict__ idx, long long n,
                     T* __restrict__ out, int* __restrict__ nmiss,
                     int block, int window, long long nwin) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  __shared__ int warp_miss[kThreads / 32];

  const long long start = static_cast<long long>(blockIdx.x) * block;
  long long bw = floor_div(static_cast<long long>(idx[start]), window);
  bw = bw < 0 ? 0 : (bw > nwin - 2 ? nwin - 2 : bw);
  const long long base = bw * window;
  const int span = 2 * window;
  // Elements of the view that exist in the table (the tail windows may
  // run past m: the reference pads the table with zeros there).
  const long long avail = m - base;
  const int nload = avail >= span ? span : (avail > 0 ? static_cast<int>(avail) : 0);

  const unsigned char* src = reinterpret_cast<const unsigned char*>(table + base);
  const int bytes = span * static_cast<int>(sizeof(T));
  if (nload == span && (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
      (bytes & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < bytes / 16; i += kThreads) d4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < nload; i += kThreads) tile[i] = table[base + i];
  }
  __syncthreads();

  const long long last = static_cast<long long>(idx[n - 1]);
  int miss = 0;
  for (int k = threadIdx.x; k < block; k += kThreads) {
    const long long pos = start + k;
    const long long v = pos < n ? static_cast<long long>(idx[pos]) : last;
    const long long off = v - base;
    const bool hit = off >= 0 && off < span;
    miss += hit ? 0 : 1;
    if (pos < n) {
      if (hit && off < nload) {
        out[pos] = tile[off];
      } else {
        const long long c = v < 0 ? 0 : (v >= m ? m - 1 : v);
        out[pos] = table[c];
      }
    }
  }

  // CTA sum of misses, then one atomic per CTA that saw any.
  for (int o = 16; o > 0; o >>= 1) miss += __shfl_down_sync(0xffffffffu, miss, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_miss[warp] = miss;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_miss[w];
    if (total) atomicAdd(nmiss, total);
  }
}

template <typename T, typename I>
int launch(const void* table, long long m, const void* idx, long long n,
           void* out, void* nmiss, int block, int window, long long nwin,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2) * window * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      window_gather_kernel<T, I>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nblk = (n + block - 1) / block;
  window_gather_kernel<T, I><<<static_cast<unsigned>(nblk), kThreads, smem, stream>>>(
      static_cast<const T*>(table), m, static_cast<const I*>(idx), n,
      static_cast<T*>(out), static_cast<int*>(nmiss), block, window, nwin);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_idx(int idx_bytes, const void* table, long long m, const void* idx,
               long long n, void* out, void* nmiss, int block, int window,
               long long nwin, cudaStream_t stream) {
  if (idx_bytes == 4)
    return launch<T, int32_t>(table, m, idx, n, out, nmiss, block, window, nwin, stream);
  if (idx_bytes == 8)
    return launch<T, int64_t>(table, m, idx, n, out, nmiss, block, window, nwin, stream);
  return -1;
}

}  // namespace

// The gather copies bits, so the table's element type matters only by size:
// 1, 2 or 4 bytes (u8/i8, i16, u32/i32/f32). idx is int32 or int64.
// Returns 0 on success, a cudaError_t code on a refused launch, -1 on an
// unsupported element size.
extern "C" int window_gather_launch(int table_bytes, int idx_bytes,
                                    const void* table, long long m,
                                    const void* idx, long long n, void* out,
                                    void* nmiss, int block, int window,
                                    long long nwin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (table_bytes) {
    case 1:
      return launch_idx<uint8_t>(idx_bytes, table, m, idx, n, out, nmiss, block, window, nwin, s);
    case 2:
      return launch_idx<uint16_t>(idx_bytes, table, m, idx, n, out, nmiss, block, window, nwin, s);
    case 4:
      return launch_idx<uint32_t>(idx_bytes, table, m, idx, n, out, nmiss, block, window, nwin, s);
    default:
      return -1;
  }
}
