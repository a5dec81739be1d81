// K5 spectrum23: the canonical k-mer spectrum of one chunk, sort included:
// packed ingest -> k-step windows in 64 bits -> canonical min(fwd, rc) ->
// drop invalid windows -> LSD radix sort -> run-length reduce -> (unique
// keys ascending, counts, n_unique), padded to the window count with the
// sentinel key 2^64 - 1 and count 0.
//
// Replaces aindex_tpu/kernels/spectrum.py:48 chunk_spectrum_packed and
// :121 sorted_spectrum (the keys-in mode below: a flat uint64 key array in
// which the sentinel means "ignore"), with encode.py:98,125,141 fused in.
//
// Bound: the sort. A 2^22-byte chunk gives 4.19M windows of 8-byte keys;
// each radix pass reads and writes every key once, and only the 2k = 46
// significant bits are sorted (six 8-bit passes), so the chunk moves about
// 6 x 2 x 32 MB plus the scans' flags. Design, all plain kernels on one
// stream:
//   1. one thread per window writes its canonical key and a valid flag;
//   2. an exclusive scan of the flags (three-kernel tile scan) gives each
//      valid key its place, and a compaction keeps only valid keys, in
//      window order;
//   3. each radix pass: one warp per tile of 1024 keys counts its digits in
//      shared memory; a scan of the digit-major [256, tiles] histogram gives
//      every (digit, tile) its output base; the warp then re-reads its tile
//      in order and ranks equal digits with __match_any_sync, which keeps
//      the pass stable;
//   4. a scan of the "new run" flags of the sorted keys numbers the unique
//      keys; each run start writes its key and position, and each count is
//      the distance to the next run start.
// The key count after compaction and the unique count stay on the device
// (counters[0], counters[1]); every kernel reads them there, so the host
// never waits inside the chunk.
#include "dna23.cuh"

namespace {

constexpr int SCAN_BLOCK = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = SCAN_BLOCK * SCAN_ITEMS;  // items per scan block
constexpr int SUMS_BLOCK = 1024;
constexpr int RADIX = 256;
constexpr int WARPS = 8;          // warps per block in the radix passes
constexpr int WARP_TILE = 1024;   // keys per warp tile
constexpr unsigned long long SENTINEL = ~0ull;

#define SPECTRUM_CHECK()                                  \
  do {                                                    \
    const cudaError_t e_ = cudaGetLastError();            \
    if (e_ != cudaSuccess) return static_cast<int>(e_);   \
  } while (0)

// Exclusive scan of one int per thread across the block; writes the block's
// total. blockDim.x is a multiple of 32 and at most 1024.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int ws = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, ws, o);
      if (lane >= o) ws += y;
    }
    if (lane < n_warps) warp_sums[lane] = ws;
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[n_warps - 1];
  __syncthreads();
  return before + x - v;
}

__global__ void scan_reduce(const int* __restrict__ data, long long m, int* __restrict__ sums) {
  const long long base = static_cast<long long>(blockIdx.x) * SCAN_TILE;
  int s = 0;
  for (int j = threadIdx.x; j < SCAN_TILE; j += SCAN_BLOCK) {
    const long long i = base + j;
    if (i < m) s += data[i];
  }
  int total;
  block_exclusive_scan(s, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void scan_sums(int* __restrict__ sums, long long n_blocks, int* __restrict__ total) {
  int carry = 0;
  for (long long base = 0; base < n_blocks; base += SUMS_BLOCK) {
    const long long i = base + threadIdx.x;
    const int v = i < n_blocks ? sums[i] : 0;
    int chunk_total;
    const int before = block_exclusive_scan(v, &chunk_total);
    if (i < n_blocks) sums[i] = carry + before;
    carry += chunk_total;
  }
  if (threadIdx.x == 0 && total != nullptr) *total = carry;
}

__global__ void scan_apply(int* __restrict__ data, long long m, const int* __restrict__ sums) {
  const long long base = static_cast<long long>(blockIdx.x) * SCAN_TILE +
                         static_cast<long long>(threadIdx.x) * SCAN_ITEMS;
  int v[SCAN_ITEMS];
  int s = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    v[j] = base + j < m ? data[base + j] : 0;
    s += v[j];
  }
  int total;
  int run = block_exclusive_scan(s, &total) + sums[blockIdx.x];
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    if (base + j < m) data[base + j] = run;
    run += v[j];
  }
}

// In-place exclusive scan of data[0, m); the sum of all m items goes to
// *total when it is not null. sums holds ceil(m / SCAN_TILE) ints.
int scan_exclusive(int* data, long long m, int* sums, int* total, cudaStream_t s) {
  const long long n_blocks = (m + SCAN_TILE - 1) / SCAN_TILE;
  scan_reduce<<<static_cast<unsigned>(n_blocks), SCAN_BLOCK, 0, s>>>(data, m, sums);
  SPECTRUM_CHECK();
  scan_sums<<<1, SUMS_BLOCK, 0, s>>>(sums, n_blocks, total);
  SPECTRUM_CHECK();
  scan_apply<<<static_cast<unsigned>(n_blocks), SCAN_BLOCK, 0, s>>>(data, m, sums);
  SPECTRUM_CHECK();
  return 0;
}

__global__ void windows_kernel(const unsigned* __restrict__ packed,
                               const unsigned char* __restrict__ vbits, long long n_words, int k,
                               long long n_win, unsigned long long* __restrict__ keys,
                               int* __restrict__ flags) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < n_win;
       p += step) {
    uint64_t code;
    const bool ok = dna23::packed_window64(packed, vbits, n_words, p, k, &code);
    keys[p] = dna23::canonical64(code, k);
    flags[p] = ok ? 1 : 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) flags[n_win] = 0;
}

__global__ void keys_kernel(const unsigned long long* __restrict__ in, long long n,
                            unsigned long long* __restrict__ keys, int* __restrict__ flags) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < n;
       p += step) {
    const unsigned long long key = in[p];
    keys[p] = key;
    flags[p] = key != SENTINEL ? 1 : 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) flags[n] = 0;
}

// idx: the exclusive scan of the valid flags, with idx[n] the total.
__global__ void compact_kernel(const unsigned long long* __restrict__ in,
                               const int* __restrict__ idx, long long n,
                               unsigned long long* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < n;
       p += step) {
    const int at = idx[p];
    if (idx[p + 1] != at) out[at] = in[p];
  }
}

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

__global__ void run_flags(const unsigned long long* __restrict__ s, const int* __restrict__ n_ptr,
                          long long cap, int* __restrict__ flags) {
  const long long n = *n_ptr;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < cap;
       i += step)
    flags[i] = (i < n && (i == 0 || s[i] != s[i - 1])) ? 1 : 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) flags[cap] = 0;
}

__global__ void run_write(const unsigned long long* __restrict__ s, const int* __restrict__ n_ptr,
                          const int* __restrict__ idx, unsigned long long* __restrict__ keys_out,
                          int* __restrict__ start) {
  const long long n = *n_ptr;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    if (i == 0 || s[i] != s[i - 1]) {
      const int u = idx[i];
      keys_out[u] = s[i];
      start[u] = static_cast<int>(i);
    }
  }
}

__global__ void run_count(const int* __restrict__ start, const int* __restrict__ counters,
                          long long cap, unsigned long long* __restrict__ keys_out,
                          unsigned* __restrict__ counts) {
  const long long n = counters[0];
  const long long n_unique = counters[1];
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long u = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; u < cap;
       u += step) {
    if (u < n_unique) {
      const long long end = u + 1 < n_unique ? start[u + 1] : n;
      counts[u] = static_cast<unsigned>(end - start[u]);
    } else {
      keys_out[u] = SENTINEL;
      counts[u] = 0u;
    }
  }
}

}  // namespace

DNA13_EXPORT_ERROR_STRING

// Two modes. Packed: packed uint32[n_words] + vbits uint8[2 * n_words], the
// k-mers (k <= 31) of every window, cap = 16 * n_words - k + 1 windows,
// sorted on their 2k significant bits. Keys: keys_in uint64[n_in] (packed
// null), cap = n_in, sentinel keys ignored, sorted on key_bits bits.
// Out: keys_out uint64[cap], counts_out uint32[cap], counters int32[2] =
// (valid keys, unique keys). Scratch, all device memory of the caller:
// keys_a, keys_b uint64[cap]; idx int32[cap + 1]; start int32[cap];
// hist int32[256 * ceil(cap / 1024)]; sums int32[ceil(max(cap + 1,
// 256 * ceil(cap / 1024)) / 2048)]. Returns the first CUDA error of the
// launches, or 0.
extern "C" int spectrum23(const void* packed, const void* vbits, long long n_words, int k,
                          const void* keys_in, long long n_in, int key_bits, void* keys_out,
                          void* counts_out, void* counters, void* keys_a, void* keys_b,
                          void* idx, void* start, void* hist, void* sums, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool from_packed = packed != nullptr;
  if (from_packed && (k < 1 || k > 31)) return static_cast<int>(cudaErrorInvalidValue);
  const long long cap = from_packed ? 16 * n_words - k + 1 : n_in;
  if (cap <= 0 || cap >= (1LL << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  const int bits = from_packed ? 2 * k : key_bits;
  if (bits < 1 || bits > 64) return static_cast<int>(cudaErrorInvalidValue);

  auto* ka = static_cast<unsigned long long*>(keys_a);
  auto* kb = static_cast<unsigned long long*>(keys_b);
  auto* ix = static_cast<int*>(idx);
  auto* cn = static_cast<int*>(counters);
  auto* hs = static_cast<int*>(hist);
  auto* sm = static_cast<int*>(sums);
  auto* ko = static_cast<unsigned long long*>(keys_out);
  const unsigned grid = dna13::grid_for(cap);

  if (from_packed)
    windows_kernel<<<grid, dna13::BLOCK, 0, s>>>(static_cast<const unsigned*>(packed),
                                                static_cast<const unsigned char*>(vbits),
                                                n_words, k, cap, kb, ix);
  else
    keys_kernel<<<grid, dna13::BLOCK, 0, s>>>(static_cast<const unsigned long long*>(keys_in),
                                             cap, kb, ix);
  SPECTRUM_CHECK();
  if (int e = scan_exclusive(ix, cap + 1, sm, cn, s)) return e;
  compact_kernel<<<grid, dna13::BLOCK, 0, s>>>(kb, ix, cap, ka);
  SPECTRUM_CHECK();

  const long long n_tiles = (cap + WARP_TILE - 1) / WARP_TILE;
  const unsigned radix_grid = static_cast<unsigned>((n_tiles + WARPS - 1) / WARPS);
  unsigned long long* cur = ka;
  unsigned long long* alt = kb;
  for (int shift = 0; shift < bits; shift += 8) {
    radix_hist<<<radix_grid, WARPS * 32, 0, s>>>(cur, cn, shift, n_tiles, hs);
    SPECTRUM_CHECK();
    if (int e = scan_exclusive(hs, RADIX * n_tiles, sm, nullptr, s)) return e;
    radix_scatter<<<radix_grid, WARPS * 32, 0, s>>>(cur, cn, shift, n_tiles, hs, alt);
    SPECTRUM_CHECK();
    unsigned long long* t = cur;
    cur = alt;
    alt = t;
  }

  run_flags<<<grid, dna13::BLOCK, 0, s>>>(cur, cn, cap, ix);
  SPECTRUM_CHECK();
  if (int e = scan_exclusive(ix, cap + 1, sm, cn + 1, s)) return e;
  run_write<<<grid, dna13::BLOCK, 0, s>>>(cur, cn, ix, ko, static_cast<int*>(start));
  SPECTRUM_CHECK();
  run_count<<<grid, dna13::BLOCK, 0, s>>>(static_cast<const int*>(start), cn, cap, ko,
                                          static_cast<unsigned*>(counts_out));
  SPECTRUM_CHECK();
  return 0;
}
