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
