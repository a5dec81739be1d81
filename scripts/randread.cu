// Random-read cost by width, the measurement behind the bucket width of
// aindex_torch/csrc/probe.cuh's Buckets engine: n reads of W bytes (W = 16,
// 32, 64 or 128), one read a thread, each from a W-aligned block at a
// hashed address of a buffer of any number of blocks (the high 64 bits of
// the hash's product with the block count), as W / 16 uint4 loads (the
// engine's bucket read). A footprint swept across the L2's size gives what
// a table's size costs K3. The loaded words are folded and written only on a
// value the random buffer almost never holds, so the reads are kept and
// nearly nothing is written.
//
// And the read-modify-write cost by order, the measurement behind K16's
// design (aindex_torch/csrc/count13.cu): n 4-byte adds of 1 whose result is
// unused (so each compiles to a RED), one a thread, at the entries of a
// given index array (hashed_indices fills one, in the order of i; the
// caller reorders it), into a uint32 table.
//
// Built and run by chip_smoke.py (width_test, footprint_test, rmw_test), which
// scripts/lookup_profile.py also calls.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xFF51AFD7ED558CCDull;
  x ^= x >> 33;
  x *= 0xC4CEB9FE1A85EC53ull;
  x ^= x >> 33;
  return x;
}

template <int W>
__global__ void randread_kernel(const uint4* __restrict__ buf, uint64_t n_blocks, long long n,
                                uint64_t seed, unsigned* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint64_t h = mix64(static_cast<uint64_t>(i) ^ seed);
    const uint4* b = buf + __umul64hi(h, n_blocks) * (W / 16);
    unsigned acc = 0u;
#pragma unroll
    for (int j = 0; j < W / 16; ++j) {
      const uint4 v = b[j];
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
    if (acc == 0x9E3779B9u) out[0] = static_cast<unsigned>(i);
  }
}

__global__ void hashed_kernel(unsigned* __restrict__ out, long long n, int lb, uint64_t seed) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = static_cast<unsigned>((mix64(static_cast<uint64_t>(i) ^ seed) >> 1) >> (63 - lb));
}

__global__ void rmw_kernel(unsigned* __restrict__ table, const unsigned* __restrict__ idx,
                           long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    atomicAdd(table + idx[i], 1u);
}

inline unsigned grid_of(long long n, int block) {
  const long long blocks = (n + block - 1) / block;
  return static_cast<unsigned>(blocks < (1LL << 20) ? blocks : (1LL << 20));
}

}  // namespace

// out: uint32[n], out[i] the hashed entry of i in a table of 2^lb entries.
extern "C" int hashed_indices(void* out, long long n, int lb, unsigned long long seed,
                              void* stream) {
  if (n <= 0 || lb < 0 || lb > 32) return static_cast<int>(cudaErrorInvalidValue);
  hashed_kernel<<<grid_of(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(out), n, lb, seed);
  return static_cast<int>(cudaGetLastError());
}

// table: uint32, idx: uint32[n] entries of it; table[idx[i]] += 1 for each i.
extern "C" int randrmw(void* table, const void* idx, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  rmw_kernel<<<grid_of(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(table), static_cast<const unsigned*>(idx), n);
  return static_cast<int>(cudaGetLastError());
}

// buf: n_blocks >= 1 blocks of width bytes (16-byte aligned); n reads; out
// uint32[1].
extern "C" int randread(const void* buf, unsigned long long n_blocks, int width, long long n,
                        unsigned long long seed, void* out, void* stream) {
  if (n <= 0 || n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = grid_of(n, 256);
  const int block = 256;
  const auto* b = static_cast<const uint4*>(buf);
  auto* o = static_cast<unsigned*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 16: randread_kernel<16><<<grid, block, 0, s>>>(b, n_blocks, n, seed, o); break;
    case 32: randread_kernel<32><<<grid, block, 0, s>>>(b, n_blocks, n, seed, o); break;
    case 64: randread_kernel<64><<<grid, block, 0, s>>>(b, n_blocks, n, seed, o); break;
    case 128: randread_kernel<128><<<grid, block, 0, s>>>(b, n_blocks, n, seed, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
