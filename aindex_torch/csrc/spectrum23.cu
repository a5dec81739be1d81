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
// valid flag out. Its bound is bytes (the chunk in, 9 bytes a window out:
// 41.9 MB for a 2^22-byte chunk), so it runs on the staged ASCII front end
// (dna23.cuh tile_run on an AsciiSource): a warp stages a tile's bytes in
// shared memory with 16-byte loads, coding each byte once, and each thread
// rolls CANONICAL_RUN windows along it and writes their keys with 16-byte
// and their flags with one CANONICAL_RUN-byte streaming store.
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

// Windows a thread of canonical23_ascii rolls: each tile's fixed cost
// (finding its rows, staging and coding its bytes, building each run's
// first window) shared by more windows (PERF.md section 6: 2, 4 and 8
// measured, 8 fastest).
constexpr int CANONICAL_RUN = 8;

// Stores a run of canonical23_ascii: its keys with 16-byte and its flags
// with one RUN-byte store where the run is whole and aligned, else one
// store an output; streamed past L2.
template <int RUN>
__device__ __forceinline__ void store_keys(unsigned long long* __restrict__ keys,
                                           bool* __restrict__ flags, long long first, int count,
                                           const unsigned long long (&key)[RUN],
                                           const bool (&ok)[RUN]) {
  if (RUN % 2 == 0 && count == RUN && (reinterpret_cast<uintptr_t>(keys) & 15) == 0) {
    ulonglong2* o = reinterpret_cast<ulonglong2*>(keys + first);
#pragma unroll
    for (int j = 0; j < RUN / 2; ++j) __stcs(o + j, make_ulonglong2(key[2 * j], key[2 * j + 1]));
  } else {
#pragma unroll
    for (int j = 0; j < RUN; ++j)
      if (j < count) __stcs(keys + first + j, key[j]);
  }
  unsigned long long bytes = 0;
#pragma unroll
  for (int j = 0; j < RUN; ++j) bytes |= static_cast<unsigned long long>(ok[j]) << (8 * j);
  unsigned char* f = reinterpret_cast<unsigned char*>(flags + first);
  const bool whole = count == RUN && (reinterpret_cast<uintptr_t>(f) & (RUN - 1)) == 0;
  if (RUN == 8 && whole) {
    __stcs(reinterpret_cast<unsigned long long*>(f), bytes);
  } else if (RUN == 4 && whole) {
    __stcs(reinterpret_cast<unsigned*>(f), static_cast<unsigned>(bytes));
  } else if (RUN == 2 && whole) {
    __stcs(reinterpret_cast<unsigned short*>(f), static_cast<unsigned short>(bytes));
  } else {
#pragma unroll
    for (int j = 0; j < RUN; ++j)
      if (j < count) __stcs(f + j, static_cast<unsigned char>(ok[j]));
  }
}

// canonical23_ascii: every window's canonical code min(fwd, rc) and valid
// flag, a warp a tile of 32 * RUN windows rolled along its staged bytes
// (dna23::tile_run on dna23::AsciiSource).
template <int RUN>
__global__ void __launch_bounds__(dna13::BLOCK)
    canonical_kernel(dna23::AsciiSource src, long long rows, long long n_stage,
                     unsigned long long recip, unsigned long long* __restrict__ keys,
                     bool* __restrict__ flags) {
  extern __shared__ uint4 stage[];
  dna23::Run<RUN> w;
  dna23::tile_run(reinterpret_cast<unsigned*>(stage), n_stage, src, rows, recip, &w);
  if (!w.count) return;
  unsigned long long key[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) key[j] = w.rc[j] < w.fwd[j] ? w.rc[j] : w.fwd[j];
  store_keys(keys, flags, w.first, w.count, key, w.ok);
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
// k + 1], the canonical code of every window (invalid ones included, a
// byte outside ACGT/acgt read as 3), and valid_out bool[rows, len - k + 1].
// Returns cudaGetLastError().
extern "C" int canonical23_ascii(const void* ascii, long long rows, long long len, int k,
                                 void* keys_out, void* valid_out, void* stream) {
  if (bad_rows(rows, len, k)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int RUN = CANONICAL_RUN;
  constexpr long long TILE = dna23::tile_outputs<RUN>();
  const dna23::AsciiSource src{static_cast<const unsigned char*>(ascii), rows * len, len, k};
  const long long width = src.width();
  const long long n_stage = dna23::stage_words<RUN>(width, k);
  canonical_kernel<RUN><<<static_cast<unsigned>((rows * width + TILE - 1) / TILE), dna13::BLOCK,
                          dna23::stage_bytes(n_stage), static_cast<cudaStream_t>(stream)>>>(
      src, rows, n_stage, dna23::reciprocal(width), static_cast<unsigned long long*>(keys_out),
      static_cast<bool*>(valid_out));
  return static_cast<int>(cudaGetLastError());
}
