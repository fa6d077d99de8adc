// Elementwise u32 doubling for Hopper (sm_90a).
//
// Replaces the Pallas kernel `pallas_double` in tools/microbench2.py
// (pl.pallas_call at :211, body `k_copy` at :207-208): out = x * 2 on
// uint32, wrapping mod 2^32. The TPU kernel writes only whole blocks of
// 1,048,576 elements; this one writes every element, the tail included.
//
// Bound on this card: bytes. It reads 4 B and writes 4 B per element and
// does one shift, so all that counts is keeping the memory busy to the
// last byte. The wrapper (ops/elementwise.py `double_plan`) computes every
// launch's grid; this file only follows it.
//
// The vector kernel covers the 16-byte-aligned part [0, 4 * nvec) on one
// CTA per kThreads * kVecs vectors, as many CTAs as that takes, with no
// device query. Each thread loads its kVecs 16-byte vectors before its
// first store, with streaming hints on loads and stores (ld.global.cs /
// st.global.cs: every byte is touched once). The hardware hands the next
// CTA to whichever SM frees a slot, so the pass ends with a tail of one
// 8 KiB CTA. A persistent grid (exactly the resident CTAs, 4 loads in
// flight per thread) and a persistent ring of 1-D bulk copies through
// shared memory (the TMA) were both slower on an H100 (PERF.md).
//
// The scalar kernel covers [start, n): the n % 4 tail, or the whole pass
// when x or out is off 16-byte alignment (a tensor view at an odd
// offset). Unsigned arithmetic, so the wrap is defined.
//
// Plain C interface, bound from Python with ctypes
// (gamesmanmpi_tpu_torch/kernels/build.py). The launch returns the CUDA
// error code of the launch; it does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;

__device__ __forceinline__ void shift(uint4& v) {
  v.x <<= 1;
  v.y <<= 1;
  v.z <<= 1;
  v.w <<= 1;
}

// One CTA per kThreads * kVecs vectors, each thread kVecs of them,
// neighbouring threads on neighbouring vectors.
__global__ void __launch_bounds__(kThreads)
double_u32_vec(const uint4* __restrict__ x, uint4* __restrict__ out,
               long long nvec) {
  const long long i0 =
      static_cast<long long>(blockIdx.x) * kThreads * kVecs + threadIdx.x;
  uint4 v[kVecs];
#pragma unroll
  for (int u = 0; u < kVecs; ++u)
    if (i0 + u * kThreads < nvec) v[u] = __ldcs(x + i0 + u * kThreads);
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    if (i0 + u * kThreads < nvec) {
      shift(v[u]);
      __stcs(out + i0 + u * kThreads, v[u]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
double_u32_scalar(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                  long long start, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = start + static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = x[i] << 1;
  }
}

}  // namespace

// out[i] = x[i] * 2 mod 2^32: the vector kernel over the first nvec
// 16-byte vectors on `grid` CTAs (skipped when nvec or grid is 0), then
// the scalar kernel over [start, n) on `scalar_grid` CTAs (skipped when
// start >= n). Returns 0 on success or the cudaError_t code of a refused
// launch.
extern "C" int double_u32_launch(const void* x, void* out, long long nvec,
                                 int grid, long long start, long long n,
                                 int scalar_grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nvec > 0 && grid > 0) {
    double_u32_vec<<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(out), nvec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (start < n && scalar_grid > 0) {
    double_u32_scalar<<<scalar_grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), start,
        n);
  }
  return static_cast<int>(cudaGetLastError());
}
