// The block-wide exclusive prefix sum, and the launch check every host
// entry uses. block_exclusive_scan serves the onesweep passes
// (onesweep.cuh), K14's overflow sum and K15's bin starts (posbucket.cu,
// count13.cu).
#pragma once

#include "dna13.cuh"

// Return the first CUDA error of the launches so far from an int-returning
// host function.
#define KERNEL_CHECK()                                    \
  do {                                                    \
    const cudaError_t e_ = cudaGetLastError();            \
    if (e_ != cudaSuccess) return static_cast<int>(e_);   \
  } while (0)

namespace scan {

// Exclusive scan of one value per thread across the block; writes the
// block's total. blockDim.x is a multiple of 32 and at most 1024.
template <typename T>
__device__ T block_exclusive_scan(T v, T* total) {
  __shared__ T warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T ws = lane < n_warps ? warp_sums[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, ws, o);
      if (lane >= o) ws += y;
    }
    if (lane < n_warps) warp_sums[lane] = ws;
  }
  __syncthreads();
  const T before = warp ? warp_sums[warp - 1] : T(0);
  *total = warp_sums[n_warps - 1];
  __syncthreads();
  return before + x - v;
}

}  // namespace scan
