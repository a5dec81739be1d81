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
//   2. an exclusive scan of the flags (csrc/scan.cuh) gives each valid key
//      its place, and a compaction keeps only valid keys, in window order;
//   3. each radix pass (csrc/radix.cuh): one warp per tile of 1024 keys
//      counts its digits in shared memory; a scan of the digit-major
//      [256, tiles] histogram gives every (digit, tile) its output base; the
//      warp then re-reads its tile in order and ranks equal digits with
//      __match_any_sync, which keeps the pass stable;
//   4. a scan of the "new run" flags of the sorted keys numbers the unique
//      keys; each run start writes its key and position, and each count is
//      the distance to the next run start.
// The key count after compaction and the unique count stay on the device
// (counters[0], counters[1]); every kernel reads them there, so the host
// never waits inside the chunk.
#include "dna23.cuh"
#include "radix.cuh"
#include "scan.cuh"

namespace {

constexpr unsigned long long SENTINEL = ~0ull;

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
  KERNEL_CHECK();
  if (int e = scan::exclusive_scan<int, int>(ix, ix, cap + 1, sm, cn, s)) return e;
  scan::compact<<<grid, dna13::BLOCK, 0, s>>>(kb, ix, cap, ka);
  KERNEL_CHECK();

  unsigned long long* cur = nullptr;
  if (int e = radix::sort(ka, kb, cn, cap, 0, bits, hs, sm, s, &cur)) return e;

  run_flags<<<grid, dna13::BLOCK, 0, s>>>(cur, cn, cap, ix);
  KERNEL_CHECK();
  if (int e = scan::exclusive_scan<int, int>(ix, ix, cap + 1, sm, cn + 1, s)) return e;
  run_write<<<grid, dna13::BLOCK, 0, s>>>(cur, cn, ix, ko, static_cast<int*>(start));
  KERNEL_CHECK();
  run_count<<<grid, dna13::BLOCK, 0, s>>>(static_cast<const int*>(start), cn, cap, ko,
                                          static_cast<unsigned*>(counts_out));
  KERNEL_CHECK();
  return 0;
}
