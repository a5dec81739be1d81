// Device-wide exclusive prefix sums, shared by spectrum23 (K5), csr (K8)
// and posfill (K9).
//
// A scan of m items runs as three launches on one stream: each block of
// SCAN_BLOCK threads reduces a tile of SCAN_TILE items to one sum; one
// block scans the tile sums in steps of SUMS_BLOCK, carrying the running
// total; each block then re-reads its tile and writes the exclusive
// prefix of every item. The items are read twice and written once.
// Templated on the item type read and the sum type written, so the same
// code serves K5's in-place int scans and K8's uint32 -> int64 one.
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

constexpr int SCAN_BLOCK = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = SCAN_BLOCK * SCAN_ITEMS;  // items per scan block
constexpr int SUMS_BLOCK = 1024;

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

template <typename In, typename Sum>
__global__ void scan_reduce(const In* __restrict__ data, long long m, Sum* __restrict__ sums) {
  const long long base = static_cast<long long>(blockIdx.x) * SCAN_TILE;
  Sum s = 0;
  for (int j = threadIdx.x; j < SCAN_TILE; j += SCAN_BLOCK) {
    const long long i = base + j;
    if (i < m) s += static_cast<Sum>(data[i]);
  }
  Sum total;
  block_exclusive_scan(s, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

template <typename Sum>
__global__ void scan_sums(Sum* __restrict__ sums, long long n_blocks, Sum* __restrict__ total) {
  Sum carry = 0;
  for (long long base = 0; base < n_blocks; base += SUMS_BLOCK) {
    const long long i = base + threadIdx.x;
    const Sum v = i < n_blocks ? sums[i] : Sum(0);
    Sum chunk_total;
    const Sum before = block_exclusive_scan(v, &chunk_total);
    if (i < n_blocks) sums[i] = carry + before;
    carry += chunk_total;
  }
  if (threadIdx.x == 0 && total != nullptr) *total = carry;
}

// in and out may be the same array (an in-place scan), so neither is
// __restrict__.
template <typename In, typename Sum>
__global__ void scan_apply(const In* in, Sum* out, long long m, const Sum* __restrict__ sums) {
  const long long base = static_cast<long long>(blockIdx.x) * SCAN_TILE +
                         static_cast<long long>(threadIdx.x) * SCAN_ITEMS;
  Sum v[SCAN_ITEMS];
  Sum s = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    v[j] = base + j < m ? static_cast<Sum>(in[base + j]) : Sum(0);
    s += v[j];
  }
  Sum total;
  Sum run = block_exclusive_scan(s, &total) + sums[blockIdx.x];
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    if (base + j < m) out[base + j] = run;
    run += v[j];
  }
}

// Exclusive scan of in[0, m) into out[0, m) (in == out allowed); the sum of
// all m items goes to *total when it is not null. sums holds
// tiles(m) = ceil(m / SCAN_TILE) >= 1 values of the sum type.
inline long long tiles(long long m) { return (m + SCAN_TILE - 1) / SCAN_TILE; }

template <typename In, typename Sum>
int exclusive_scan(const In* in, Sum* out, long long m, Sum* sums, Sum* total, cudaStream_t s) {
  const long long n_blocks = tiles(m);
  if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  scan_reduce<In, Sum><<<static_cast<unsigned>(n_blocks), SCAN_BLOCK, 0, s>>>(in, m, sums);
  KERNEL_CHECK();
  scan_sums<Sum><<<1, SUMS_BLOCK, 0, s>>>(sums, n_blocks, total);
  KERNEL_CHECK();
  scan_apply<In, Sum><<<static_cast<unsigned>(n_blocks), SCAN_BLOCK, 0, s>>>(in, out, m, sums);
  KERNEL_CHECK();
  return 0;
}

// Stream compaction: idx is the exclusive scan of n keep-flags (idx[n] the
// total), and every kept in[p] goes to out[idx[p]], in order.
__global__ void compact(const unsigned long long* __restrict__ in, const int* __restrict__ idx,
                        long long n, unsigned long long* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < n;
       p += step) {
    const int at = idx[p];
    if (idx[p + 1] != at) out[at] = in[p];
  }
}

}  // namespace scan
