// Shared helpers of the port's hand-written Hopper kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

namespace repro {

// largest lane count a superkey can have (512 bits)
constexpr int kMaxLanes = 16;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // valid in lane 0
}

// bit k set iff byte k of w is nonzero
__device__ __forceinline__ uint32_t nonzero_bytes(uint64_t w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;
  w &= 0x0101010101010101ull;
  return (uint32_t)((w * 0x0102040810204080ull) >> 56);
}

// streaming multiprocessors of the current device (cached per process)
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

}  // namespace repro
