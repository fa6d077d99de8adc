// Elementwise u32 doubling for Hopper (sm_90a).
//
// Replaces the Pallas kernel `pallas_double` in tools/microbench2.py
// (pl.pallas_call at :211, body `k_copy` at :207-208): out = x * 2 on
// uint32, wrapping mod 2^32. The TPU kernel writes only whole blocks of
// 1,048,576 elements; this one writes every element, the tail included.
//
// Bound on this card: bytes. It reads 4 B and writes 4 B per element and
// does one shift. The design is the plain one for a streaming pass: a
// grid-stride loop over 16-byte uint4 loads and stores (four elements per
// thread per step, neighbouring threads on neighbouring addresses), then a
// scalar loop for the n % 4 tail. When the input and output are not both
// 16-byte aligned (a tensor view at an odd offset), the whole pass takes
// the scalar loop. Unsigned arithmetic, so the wrap is defined.
//
// Plain C interface, bound from Python with ctypes
// (gamesmanmpi_tpu_torch/kernels/build.py). The launch returns the CUDA
// error code of the launch; it does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
double_u32_vec(const uint4* __restrict__ x, uint4* __restrict__ out,
               long long nvec) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < nvec; i += stride) {
    uint4 v = x[i];
    v.x <<= 1;
    v.y <<= 1;
    v.z <<= 1;
    v.w <<= 1;
    out[i] = v;
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

unsigned grid_for(long long work, int sms) {
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 16;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

}  // namespace

// out[i] = x[i] * 2 mod 2^32 for i in [0, n). Returns 0 on success or the
// cudaError_t code of a refused launch.
extern "C" int double_u32_launch(const void* x, void* out, long long n,
                                 void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const uint32_t* xs = static_cast<const uint32_t*>(x);
  uint32_t* os = static_cast<uint32_t*>(out);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  long long done = 0;
  if (aligned) {
    const long long nvec = n / 4;
    if (nvec > 0) {
      double_u32_vec<<<grid_for(nvec, sms), kThreads, 0, s>>>(
          reinterpret_cast<const uint4*>(xs), reinterpret_cast<uint4*>(os),
          nvec);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    done = nvec * 4;
  }
  if (done < n) {
    double_u32_scalar<<<grid_for(n - done, sms), kThreads, 0, s>>>(
        xs, os, done, n);
  }
  return static_cast<int>(cudaGetLastError());
}
