// K5 spectrum23: the canonical k-mer spectrum of one chunk, sort included:
// packed ingest -> k-step windows in 64 bits -> canonical min(fwd, rc) ->
// drop invalid windows -> onesweep radix sort -> run-length reduce -> (unique
// keys ascending, counts, n_unique), padded to the window count with the
// sentinel key 2^64 - 1 and count 0.
//
// Replaces aindex_tpu/kernels/spectrum.py:48 chunk_spectrum_packed and
// :121 sorted_spectrum (the keys-in mode below: a flat uint64 key array in
// which the sentinel means "ignore"), with encode.py:98,125,141 fused in.
// Its entry spectrum23_ascii replaces :33 chunk_spectrum, the same steps
// from ASCII bytes (1-D, or [B, L] rows whose windows stay in their row),
// and canonical23_ascii replaces index/sparse23.py:38 _extract_canonical:
// the windows of step 1 alone, every window's canonical code and its
// valid flag out.
//
// Bound: the sort. A 2^22-byte chunk gives 4.19M windows of 8-byte keys
// (about 3.5M valid on the corpus); only the 2k = 46 significant bits are
// sorted (six 8-bit passes), and each onesweep pass reads and writes every
// valid key once, so the chunk moves about 6 x 2 x 28 MB, plus the chunk
// read once, the valid keys written once by the compaction, and the
// outputs written twice (cleared, then filled). Design (csrc/onesweep.cuh),
// 3 + passes launches on one stream, 9 for k = 23 and 11 for 64-bit keys:
//   0. one memset zeroes the sort's counters and look-back words;
//   1. compaction: one thread per window (or key) computes its canonical
//      key and valid flag, the block ranks the valid ones with ballots and
//      finds its output base by decoupled look-back, writes them in window
//      order, and counts their digits of every pass; it also clears the
//      outputs to the sentinel and count 0;
//   2. one onesweep pass per 8-bit digit: a tile of 4096 keys ranked
//      stably in registers, its digit offsets by look-back, the keys
//      written from shared memory in digit order;
//   3. the runs launch numbers the unique keys by look-back and writes each
//      key and its count (a run cut by a warp's edge adds its pieces
//      atomically).
// The valid and unique counts stay on the device (counters[0],
// counters[1]); every launch reads them there, so the host never waits
// inside the chunk.
#include "dna23.cuh"
#include "onesweep.cuh"

namespace {

constexpr unsigned long long SENTINEL = ~0ull;

// The sources of the compaction: item p -> (live, key).
//
// A packed window's bases hold base j in field j, so its reverse
// complement is their complement and its forward code their fields
// reversed (revcomp64 of the complement): no loop over the k bases.
struct PackedWindows {
  const unsigned* packed;
  const unsigned char* vbits;
  long long n_words;
  int k;
  __device__ bool operator()(long long p, unsigned long long& key, unsigned&) const {
    const uint64_t bases = dna23::packed_bases64(packed, n_words, p);
    const uint64_t fwd = dna23::revcomp64(~bases, k);
    const uint64_t rc = ~bases & ((1ull << (2 * k)) - 1ull);
    key = fwd < rc ? fwd : rc;
    return dna23::packed_valid64(vbits, n_words, p, k);
  }
};

// One window of ASCII rows of len bytes, width = len - k + 1 windows a row
// (dna23::ascii_window64 reads its k bytes; neighbouring threads share them
// through L1).
struct AsciiWindows {
  const unsigned char* ascii;
  long long len;
  long long width;
  int k;
  __device__ bool operator()(long long p, unsigned long long& key, unsigned&) const {
    // p < 2^31: a 32-bit division
    const long long r = static_cast<unsigned>(p) / static_cast<unsigned>(width);
    uint64_t code;
    const bool ok = dna23::ascii_window64(ascii + r * len + (p - r * width), k, &code);
    key = dna23::canonical64(code, k);
    return ok;
  }
};

struct Keys {
  const unsigned long long* in;
  __device__ bool operator()(long long p, unsigned long long& key, unsigned&) const {
    key = in[p];
    return key != SENTINEL;
  }
};

// canonical23_ascii: every window's canonical code and valid flag.
__global__ void ascii_windows_kernel(const unsigned char* __restrict__ ascii, long long len,
                                     int k, long long n_win,
                                     unsigned long long* __restrict__ keys,
                                     bool* __restrict__ flags) {
  const AsciiWindows src{ascii, len, len - k + 1, k};
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < n_win;
       p += step) {
    unsigned long long key;
    unsigned unused;
    flags[p] = src(p, key, unused);
    keys[p] = key;
  }
}

template <class Src>
int reduce_keys(Src src, long long cap, int bits, void* keys_out, void* counts_out,
                void* counters, void* scratch, void* stream) {
  return onesweep::reduce<0>(src, cap, bits, scratch, static_cast<unsigned long long*>(keys_out),
                             static_cast<unsigned*>(counts_out), static_cast<int*>(counters),
                             static_cast<cudaStream_t>(stream));
}

bool bad_rows(long long rows, long long len, int k) {
  return k < 1 || k > 31 || rows < 1 || len < k || rows * (len - k + 1) >= (1LL << 31) - 1;
}

}  // namespace

DNA13_EXPORT_ERROR_STRING

// Two modes. Packed: packed uint32[n_words] + vbits uint8[2 * n_words], the
// k-mers (k <= 31) of every window, cap = 16 * n_words - k + 1 windows,
// sorted on their 2k significant bits. Keys: keys_in uint64[n_in] (packed
// null), cap = n_in, sentinel keys ignored, sorted on key_bits bits.
// Out: keys_out uint64[cap], counts_out uint32[cap], counters int32[2] =
// (valid keys, unique keys). scratch: onesweep::scratch_bytes(cap,
// passes, 0) bytes of device memory of the caller. Returns the first CUDA
// error of the launches, or 0.
extern "C" int spectrum23(const void* packed, const void* vbits, long long n_words, int k,
                          const void* keys_in, long long n_in, int key_bits, void* keys_out,
                          void* counts_out, void* counters, void* scratch, void* stream) {
  if (packed == nullptr)
    return reduce_keys(Keys{static_cast<const unsigned long long*>(keys_in)}, n_in, key_bits,
                       keys_out, counts_out, counters, scratch, stream);
  if (k < 1 || k > 31) return static_cast<int>(cudaErrorInvalidValue);
  return reduce_keys(PackedWindows{static_cast<const unsigned*>(packed),
                                   static_cast<const unsigned char*>(vbits), n_words, k},
                     16 * n_words - k + 1, 2 * k, keys_out, counts_out, counters, scratch,
                     stream);
}

// ASCII rows: ascii uint8[rows, len] (a 1-D chunk is one row), the k-mers
// (1 <= k <= 31) of each row's len - k + 1 windows, cap = rows * (len - k +
// 1) < 2^31 - 1, sorted on their 2k significant bits. Outputs, counters and
// scratch as spectrum23's. Returns the first CUDA error of the launches,
// or 0.
extern "C" int spectrum23_ascii(const void* ascii, long long rows, long long len, int k,
                                void* keys_out, void* counts_out, void* counters, void* scratch,
                                void* stream) {
  if (bad_rows(rows, len, k)) return static_cast<int>(cudaErrorInvalidValue);
  return reduce_keys(AsciiWindows{static_cast<const unsigned char*>(ascii), len, len - k + 1, k},
                     rows * (len - k + 1), 2 * k, keys_out, counts_out, counters, scratch,
                     stream);
}

// ASCII rows as spectrum23_ascii takes them -> keys_out uint64[rows, len -
// k + 1], the canonical code of every window (invalid ones included), and
// valid_out bool[rows, len - k + 1]. Returns cudaGetLastError().
extern "C" int canonical23_ascii(const void* ascii, long long rows, long long len, int k,
                                 void* keys_out, void* valid_out, void* stream) {
  if (bad_rows(rows, len, k)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = rows * (len - k + 1);
  ascii_windows_kernel<<<dna13::grid_for(n), dna13::BLOCK, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(ascii), len, k, n,
      static_cast<unsigned long long*>(keys_out), static_cast<bool*>(valid_out));
  return static_cast<int>(cudaGetLastError());
}
