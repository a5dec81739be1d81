// K13 spectrummerge: the weighted merge of partial spectra. Keys (uint64,
// the sentinel 2^64 - 1 ignored) carry weights; the keys in [lo, hi) are
// sorted, each run's weights are added (wrapping modulo 2^64), and the
// unique keys go to the front, ascending, with their sums and n_unique,
// padded to the input length with the sentinel key and count 0.
//
// Replaces aindex_tpu/kernels/spectrum.py:149 sorted_spectrum_weighted
// (whose TPU form is :81 _pair_sort_spectrum, chosen by :60) together with
// the key-range select of parallel/spectrum23.py:63-68: the merge step of
// the sharded spectrum, where a data shard reduces the gathered partial
// spectra of every shard to the keys of its own range. K5's keys mode
// (csrc/spectrum23.cu) is its unweighted case; the two share the radix
// sort, the scans and the run steps (radix.cuh, scan.cuh, runs.cuh).
//
// Bound: the sort. The input is up to n_data partial spectra of a 2^22-byte
// chunk (4.19M keys each, 8-byte keys and 4-byte counts); each radix pass
// reads and writes every live key and its weight once, on the 2k bits
// below hi (six 8-bit passes for k = 23). Design, all plain kernels on one
// stream:
//   1. one thread per entry writes the key, its weight widened to 64 bits
//      and a live flag (not the sentinel, inside [lo, hi));
//   2. a scan of the flags and two compactions keep the live keys and
//      weights in input order;
//   3. the LSD radix sort of radix.cuh orders the (key, weight) pairs;
//   4. the run steps of runs.cuh number the unique keys and write each
//      key and its run's first position; an exclusive scan of the sorted
//      weights in 64 bits gives every run's sum as a difference of two
//      prefix sums (no run is summed by one thread).
// The live and unique counts stay on the device (counters[0], counters[1]).
#include "dna23.cuh"
#include "radix.cuh"
#include "runs.cuh"
#include "scan.cuh"

namespace {

constexpr unsigned long long SENTINEL = ~0ull;

__global__ void pairs_kernel(const unsigned long long* __restrict__ keys_in,
                             const void* __restrict__ weights_in, int weight_bytes, long long n,
                             unsigned long long lo, unsigned long long hi,
                             unsigned long long* __restrict__ keys,
                             unsigned long long* __restrict__ vals, int* __restrict__ flags) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < n;
       p += step) {
    const unsigned long long key = keys_in[p];
    keys[p] = key;
    vals[p] = weight_bytes == 4 ? static_cast<unsigned long long>(
                                      static_cast<const unsigned*>(weights_in)[p])
                                : static_cast<const unsigned long long*>(weights_in)[p];
    flags[p] = (key != SENTINEL && key >= lo && key < hi) ? 1 : 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) flags[n] = 0;
}

__global__ void run_sums(const int* __restrict__ start, const int* __restrict__ counters,
                         const unsigned long long* __restrict__ csum, long long cap,
                         unsigned long long* __restrict__ keys_out,
                         unsigned long long* __restrict__ counts) {
  const long long n = counters[0];
  const long long n_unique = counters[1];
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long u = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; u < cap;
       u += step) {
    if (u < n_unique) {
      const long long end = u + 1 < n_unique ? start[u + 1] : n;
      counts[u] = csum[end] - csum[start[u]];
    } else {
      keys_out[u] = SENTINEL;
      counts[u] = 0ull;
    }
  }
}

}  // namespace

DNA13_EXPORT_ERROR_STRING

// keys_in uint64[n]; weights_in uint32[n] (weight_bytes 4) or uint64[n]
// (8); the live keys are those in [lo, hi) other than the sentinel, and
// all of them lie below 2^key_bits. Out: keys_out uint64[n], counts_out
// uint64[n], counters int32[2] = (live keys, unique keys). Scratch, all
// device memory of the caller: keys_a, keys_b uint64[n]; vals_a, vals_b
// uint64[n + 1]; idx int32[n + 1]; start int32[n]; hist int32[256 *
// ceil(n / 1024)]; sums int32[ceil(max(n + 1, 256 * ceil(n / 1024)) /
// 2048)]; sums64 uint64[ceil((n + 1) / 2048)]. Returns the first CUDA
// error of the launches, or 0.
extern "C" int spectrummerge(const void* keys_in, const void* weights_in, int weight_bytes,
                             long long n, unsigned long long lo, unsigned long long hi,
                             int key_bits, void* keys_out, void* counts_out, void* counters,
                             void* keys_a, void* keys_b, void* vals_a, void* vals_b, void* idx,
                             void* start, void* hist, void* sums, void* sums64, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n >= (1LL << 31) - 1 || key_bits < 1 || key_bits > 64 ||
      (weight_bytes != 4 && weight_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* ka = static_cast<unsigned long long*>(keys_a);
  auto* kb = static_cast<unsigned long long*>(keys_b);
  auto* va = static_cast<unsigned long long*>(vals_a);
  auto* vb = static_cast<unsigned long long*>(vals_b);
  auto* ix = static_cast<int*>(idx);
  auto* cn = static_cast<int*>(counters);
  auto* sm = static_cast<int*>(sums);
  auto* ko = static_cast<unsigned long long*>(keys_out);
  const unsigned grid = dna13::grid_for(n);

  pairs_kernel<<<grid, dna13::BLOCK, 0, s>>>(static_cast<const unsigned long long*>(keys_in),
                                            weights_in, weight_bytes, n, lo, hi, kb, vb, ix);
  KERNEL_CHECK();
  if (int e = scan::exclusive_scan<int, int>(ix, ix, n + 1, sm, cn, s)) return e;
  scan::compact<<<grid, dna13::BLOCK, 0, s>>>(kb, ix, n, ka);
  KERNEL_CHECK();
  scan::compact<<<grid, dna13::BLOCK, 0, s>>>(vb, ix, n, va);
  KERNEL_CHECK();

  unsigned long long* cur = nullptr;
  unsigned long long* vcur = nullptr;
  if (int e = radix::sort_pairs(ka, kb, va, vb, cn, n, 0, key_bits, static_cast<int*>(hist), sm,
                                s, &cur, &vcur))
    return e;
  // the value buffer the sort did not end in holds the prefix sums
  unsigned long long* csum = vcur == va ? vb : va;
  if (int e = scan::exclusive_scan<unsigned long long, unsigned long long>(
          vcur, csum, n + 1, static_cast<unsigned long long*>(sums64), nullptr, s))
    return e;

  runs::run_flags<<<grid, dna13::BLOCK, 0, s>>>(cur, cn, n, ix);
  KERNEL_CHECK();
  if (int e = scan::exclusive_scan<int, int>(ix, ix, n + 1, sm, cn + 1, s)) return e;
  runs::run_write<<<grid, dna13::BLOCK, 0, s>>>(cur, cn, ix, ko, static_cast<int*>(start));
  KERNEL_CHECK();
  run_sums<<<grid, dna13::BLOCK, 0, s>>>(static_cast<const int*>(start), cn, csum, n, ko,
                                         static_cast<unsigned long long*>(counts_out));
  KERNEL_CHECK();
  return 0;
}
