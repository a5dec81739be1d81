// Stable LSD radix sort of 64-bit keys, shared by spectrum23 (K5) and
// posfill (K9).
//
// Each pass sorts on one 8-bit digit: one warp per tile of WARP_TILE keys
// counts its digits in shared memory; an exclusive scan of the digit-major
// [RADIX, tiles] histogram gives every (digit, tile) its first output
// position; the warp then re-reads its tile in order and ranks equal digits
// with __match_any_sync, which keeps the pass stable. The key count lives
// on the device (n_ptr), so a caller that compacted its keys on the device
// never waits for the host.
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

// hist: the exclusive scan of radix_hist's counts, i.e. each (digit, tile)'s
// first output position. Stable: keys of one digit keep their order.
__global__ void radix_scatter(const unsigned long long* __restrict__ in,
                              const int* __restrict__ n_ptr, int shift, long long n_tiles,
                              const int* __restrict__ hist,
                              unsigned long long* __restrict__ out) {
  __shared__ int next[WARPS][RADIX];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (t >= n_tiles) return;
  const long long n = *n_ptr;
  const long long base = t * WARP_TILE;
  if (base >= n) return;
  for (int d = lane; d < RADIX; d += 32) next[warp][d] = hist[static_cast<long long>(d) * n_tiles + t];
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
  for (int j = 0; j < WARP_TILE && base + j < n; j += 32) {
    const long long i = base + j + lane;
    const bool ok = i < n;
    const unsigned long long key = ok ? in[i] : 0ull;
    // lanes past the end get a digit no real key has, so they match nobody
    const int d = ok ? static_cast<int>((key >> shift) & (RADIX - 1)) : RADIX + lane;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (ok) out[next[warp][d] + __popc(peers & lower)] = key;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) next[warp][d] += __popc(peers);
    __syncwarp();
  }
}

// Sort the first *n_ptr of cap keys in a on bits [lo, hi), 8 bits a pass,
// ping-ponging between a and b; *sorted is set to the buffer that holds
// the result. Keys equal on those bits keep their order. Scratch: hist
// int32[RADIX * n_tiles(cap)], sums int32[scan::tiles(RADIX * n_tiles(cap))].
inline int sort(unsigned long long* a, unsigned long long* b, const int* n_ptr, long long cap,
                int lo, int hi, int* hist, int* sums, cudaStream_t s,
                unsigned long long** sorted) {
  if (lo < 0 || hi > 64 || lo >= hi) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = n_tiles(cap);
  const unsigned grid = static_cast<unsigned>((tiles + WARPS - 1) / WARPS);
  unsigned long long* cur = a;
  unsigned long long* alt = b;
  for (int shift = lo; shift < hi; shift += 8) {
    radix_hist<<<grid, WARPS * 32, 0, s>>>(cur, n_ptr, shift, tiles, hist);
    KERNEL_CHECK();
    if (int e = scan::exclusive_scan<int, int>(hist, hist, RADIX * tiles, sums, nullptr, s))
      return e;
    radix_scatter<<<grid, WARPS * 32, 0, s>>>(cur, n_ptr, shift, tiles, hist, alt);
    KERNEL_CHECK();
    unsigned long long* t = cur;
    cur = alt;
    alt = t;
  }
  *sorted = cur;
  return 0;
}

}  // namespace radix
