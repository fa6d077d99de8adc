// Integer issue rate of one SM, by instruction pipe.
//
// Each thread runs kChains dependency chains of one instruction form for
// `iters` iterations of kUnroll steps; thread 0 of each CTA reads clock64
// around the loop. The forms, one instantiation each:
// * kMode 0: funnel shifts by a run-time amount (SHF, the ALU pipe);
// * kMode 1: multiply-adds by a run-time factor (IMAD, the FMA pipe);
// * kMode 2: the two in turn, chain by chain (both pipes at once).
// Every step reads another chain's value, so no two steps fold into one
// instruction. Built by tools/torch_int_rate.py with the port's nvcc
// flags; plain C interface, bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;
constexpr int kUnroll = 16;

template <int kMode>
__global__ void __launch_bounds__(256, 8)
    spin(unsigned* out, long long* cycles, int iters, unsigned a,
         unsigned b) {
  unsigned x[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) x[c] = threadIdx.x * (c + 3) + a;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        const unsigned y = x[(c + 1) % kChains];
        const bool shift = kMode == 0 || (kMode == 2 && (c & 1));
        x[c] = shift ? __funnelshift_l(x[c], y, b) : x[c] * b + y;
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  unsigned acc = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) acc ^= x[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

}  // namespace

// Integer steps per thread: iters * kUnroll * kChains.
extern "C" int int_rate_steps_per_iter() { return kUnroll * kChains; }

extern "C" int int_rate_launch(int mode, unsigned* out, long long* cycles,
                               int grid, int threads, int iters, unsigned a,
                               unsigned b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: spin<0><<<grid, threads, 0, s>>>(out, cycles, iters, a, b); break;
    case 1: spin<1><<<grid, threads, 0, s>>>(out, cycles, iters, a, b); break;
    case 2: spin<2><<<grid, threads, 0, s>>>(out, cycles, iters, a, b); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
