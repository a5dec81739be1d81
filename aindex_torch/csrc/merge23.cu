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
// (csrc/spectrum23.cu) is its unweighted case; the two share the onesweep
// compaction, sort and run reduce of csrc/onesweep.cuh.
//
// Bound: the sort. The input is up to n_data partial spectra of a 2^22-byte
// chunk (4.19M keys each, 8-byte keys and 4-byte counts); each onesweep
// pass reads and writes every live key and its weight once, on the 2k bits
// below hi (six 8-bit passes for k = 23). uint32 weights ride the passes as
// uint32 (12-byte pairs) and are widened only where a run's sum is taken.
// Design, 3 + passes launches on one stream (9 for k = 23):
//   0. one memset zeroes the sort's counters and look-back words;
//   1. compaction: the live entries (not the sentinel, inside [lo, hi)),
//      ranked with ballots and placed by decoupled look-back, in input
//      order, their digits of every pass counted; the outputs are cleared
//      to the sentinel and 0;
//   2. one onesweep pass per 8-bit digit moves the (key, weight) pairs;
//   3. the runs launch numbers the unique keys by look-back, writes each
//      key, and each run's weights summed in 64 bits (wrapping modulo
//      2^64; a run split between threads adds its pieces atomically).
// The live and unique counts stay on the device (counters[0], counters[1]).
#include "onesweep.cuh"

namespace {

constexpr unsigned long long SENTINEL = ~0ull;

// Entry p of the compaction: live when its key is in [lo, hi) and not the
// sentinel; its weight rides with it.
template <typename W>
struct KeyRange {
  const unsigned long long* keys;
  const W* weights;
  unsigned long long lo, hi;
  __device__ bool operator()(long long p, unsigned long long& key, W& weight) const {
    key = keys[p];
    weight = weights[p];
    return key != SENTINEL && key >= lo && key < hi;
  }
};

template <int WB>
int merge(const void* keys_in, const void* weights_in, long long n, unsigned long long lo,
          unsigned long long hi, int key_bits, void* keys_out, void* counts_out, void* counters,
          void* scratch, void* stream) {
  using W = typename onesweep::ValueOf<WB>::type;
  return onesweep::reduce<WB>(
      KeyRange<W>{static_cast<const unsigned long long*>(keys_in),
                  static_cast<const W*>(weights_in), lo, hi},
      n, key_bits, scratch, static_cast<unsigned long long*>(keys_out),
      static_cast<unsigned long long*>(counts_out), static_cast<int*>(counters),
      static_cast<cudaStream_t>(stream));
}

}  // namespace

DNA13_EXPORT_ERROR_STRING

// keys_in uint64[n]; weights_in uint32[n] (weight_bytes 4) or uint64[n]
// (8); the live keys are those in [lo, hi) other than the sentinel, and
// all of them lie below 2^key_bits. Out: keys_out uint64[n], counts_out
// uint64[n], counters int32[2] = (live keys, unique keys). scratch:
// onesweep::scratch_bytes(n, passes, weight_bytes) bytes of device memory
// of the caller. Returns the first CUDA error of the launches, or 0.
extern "C" int spectrummerge(const void* keys_in, const void* weights_in, int weight_bytes,
                             long long n, unsigned long long lo, unsigned long long hi,
                             int key_bits, void* keys_out, void* counts_out, void* counters,
                             void* scratch, void* stream) {
  if (weight_bytes == 4)
    return merge<4>(keys_in, weights_in, n, lo, hi, key_bits, keys_out, counts_out, counters,
                    scratch, stream);
  if (weight_bytes == 8)
    return merge<8>(keys_in, weights_in, n, lo, hi, key_bits, keys_out, counts_out, counters,
                    scratch, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
