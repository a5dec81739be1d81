// The digit histogram of an LSD radix pass over 64-bit keys, used by
// posbucket (K14) for the one 8-bit digit it ranks on (its destination
// shard): one warp per tile of WARP_TILE keys counts its digits in shared
// memory and writes them digit-major, [RADIX, tiles], so an exclusive scan
// of the histogram (scan.cuh) gives every (digit, tile) its first output
// position. The sorts of K5, K9, K13 and the K10/K11 fills are
// csrc/onesweep.cuh's. The key count lives on the device (n_ptr), so a
// caller never waits for the host.
#pragma once

#include "scan.cuh"

namespace radix {

constexpr int RADIX = 256;
constexpr int WARPS = 8;          // warps per block
constexpr int WARP_TILE = 1024;   // keys per warp tile

inline long long n_tiles(long long cap) { return (cap + WARP_TILE - 1) / WARP_TILE; }

__global__ void radix_hist(const unsigned long long* __restrict__ keys,
                           const int* __restrict__ n_ptr, int shift, long long n_tiles,
                           int* __restrict__ hist) {
  __shared__ int cnt[WARPS][RADIX];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (t >= n_tiles) return;
  for (int d = lane; d < RADIX; d += 32) cnt[warp][d] = 0;
  __syncwarp();
  const long long n = *n_ptr;
  const long long base = t * WARP_TILE;
  const long long end = base + WARP_TILE < n ? base + WARP_TILE : n;
  for (long long i = base + lane; i < end; i += 32)
    atomicAdd(&cnt[warp][static_cast<int>((keys[i] >> shift) & (RADIX - 1))], 1);
  __syncwarp();
  for (int d = lane; d < RADIX; d += 32) hist[static_cast<long long>(d) * n_tiles + t] = cnt[warp][d];
}

}  // namespace radix
