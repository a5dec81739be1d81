// K6 quot23: verified k-mer queries in the quotient cuckoo table, one thread
// per query: optional ASCII -> code, revcomp + canonical, the two 8-byte
// (fingerprint, tf) row probes, optional slot-column gather and strand.
//
// Replaces, as one kernel with compile-time modes:
//   aindex_tpu/index/quotcuckoo.py:310 quot_tf_canonical (codes, canonical, tf)
//   aindex_tpu/index/quotcuckoo.py:296 quot_query_tf     (keys, tf)
//   aindex_tpu/index/quotcuckoo.py:378 quot_query        (keys, tf + slot)
//   aindex_tpu/index/sparse23.py:553   _resolve_device   (codes, canonical,
//                                                          tf + slot + strand)
//   aindex_tpu/index/sparse23.py:45    _extract_windows  (ASCII [B, k] rows in)
// Template parameters: ASCII rows or codes in, canonicalise or take the keys
// as they are, a valid mask or none, and the slot and strand outputs.
//
// Bound: random reads of device memory. Each query reads one or two 8-byte
// rows (plus a 4-byte slot) at addresses unrelated to its neighbours', from
// halves of 2^24 rows (128 MB each) at E. coli scale, far beyond the 50 MB
// L2; codes and outputs move coalesced. Design: one thread per query; an
// invalid query reads no row, the second row is read only when the first
// misses, and the slot column only on a hit; the 64-bit arithmetic
// (revcomp, two bijections) is cheap beside the memory latency.
#include "dna23.cuh"

namespace {

template <bool ASCII, bool CANON, bool MASK, bool SLOT, bool STRAND>
__global__ void quot23_kernel(dna23::QuotTable t, const long long* __restrict__ codes,
                              const unsigned char* __restrict__ valid,
                              const unsigned char* __restrict__ ascii, int k, long long n,
                              unsigned* __restrict__ tf_out, int* __restrict__ slot_out,
                              int* __restrict__ strand_out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint64_t code = 0;
    bool ok = true;
    if (ASCII) {
      const unsigned char* row = ascii + i * k;
      for (int j = 0; j < k; ++j) {
        const unsigned b = dna13::ascii_code(row[j]);
        ok &= b < 4u;
        code = (code << 2) | (b & 3u);
      }
    } else {
      code = static_cast<uint64_t>(codes[i]);
      if (MASK) ok = valid[i] != 0;
    }
    uint64_t key = code;
    uint64_t rc = 0;
    if (CANON) {
      rc = dna23::revcomp64(code, k);
      key = code < rc ? code : rc;
    }
    unsigned tf = 0;
    int half = 0;
    long long row = 0;
    // masked-off queries and rows with a non-ACGT base read no table row
    const bool hit = ok && dna23::quot_probe(t, key, &tf, &half, &row);
    tf_out[i] = hit ? tf : 0u;
    if (SLOT) slot_out[i] = hit ? dna23::quot_slot(t, half, row) : -1;
    if (STRAND) strand_out[i] = hit ? (code <= rc ? 1 : 2) : 0;
  }
}

template <bool ASCII, bool CANON, bool MASK, bool SLOT, bool STRAND>
void launch(const dna23::QuotTable& t, const void* codes, const void* valid, const void* ascii,
            int k, long long n, void* tf, void* slot, void* strand, cudaStream_t s) {
  quot23_kernel<ASCII, CANON, MASK, SLOT, STRAND><<<dna13::grid_for(n), dna13::BLOCK, 0, s>>>(
      t, static_cast<const long long*>(codes), static_cast<const unsigned char*>(valid),
      static_cast<const unsigned char*>(ascii), k, n, static_cast<unsigned*>(tf),
      static_cast<int*>(slot), static_cast<int*>(strand));
}

// The modes the wrappers use: (ascii | codes [+ mask]) x canonical x
// (tf | tf + slot | tf + slot + strand). Strand needs the canonical rule.
template <bool ASCII, bool MASK>
int dispatch_out(const dna23::QuotTable& t, const void* codes, const void* valid,
                 const void* ascii, int k, long long n, int canon, void* tf, void* slot,
                 void* strand, cudaStream_t s) {
  const bool want_slot = slot != nullptr;
  const bool want_strand = strand != nullptr;
  if (want_strand && !(canon && want_slot)) return static_cast<int>(cudaErrorInvalidValue);
  if (canon) {
    if (want_strand) launch<ASCII, true, MASK, true, true>(t, codes, valid, ascii, k, n, tf, slot, strand, s);
    else if (want_slot) launch<ASCII, true, MASK, true, false>(t, codes, valid, ascii, k, n, tf, slot, strand, s);
    else launch<ASCII, true, MASK, false, false>(t, codes, valid, ascii, k, n, tf, slot, strand, s);
  } else {
    if (want_slot) launch<ASCII, false, MASK, true, false>(t, codes, valid, ascii, k, n, tf, slot, strand, s);
    else launch<ASCII, false, MASK, false, false>(t, codes, valid, ascii, k, n, tf, slot, strand, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

DNA13_EXPORT_ERROR_STRING

// half0/half1: int32[m, 2] (fingerprint, tf) rows; slot0/slot1: int32[m]
// (may be null when slot is null). Either ascii (uint8[n, k]) is given, or
// codes (int64[n], uint64 bit patterns) with an optional valid (bool[n]).
// canon: 1 to probe min(code, revcomp), 0 to probe the codes as they are.
// tf: uint32[n]; slot, strand: int32[n] or null. Returns cudaGetLastError().
extern "C" int quot23(const void* half0, const void* half1, const void* slot0,
                      const void* slot1, long long m, int lb, int w, unsigned long long m1a,
                      unsigned long long m1b, unsigned long long m2a, unsigned long long m2b,
                      const void* codes, const void* valid, const void* ascii, int k,
                      long long n, int canon, void* tf, void* slot, void* strand,
                      void* stream) {
  if (n <= 0) return cudaSuccess;
  if (k < 1 || k > 31 || m <= 0 || (m & (m - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dna23::QuotTable t{static_cast<const uint2*>(half0), static_cast<const uint2*>(half1),
                           static_cast<const int*>(slot0), static_cast<const int*>(slot1),
                           static_cast<uint64_t>(m - 1), lb, w, m1a, m1b, m2a, m2b};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ascii != nullptr)
    return dispatch_out<true, false>(t, codes, valid, ascii, k, n, canon, tf, slot, strand, s);
  if (valid != nullptr)
    return dispatch_out<false, true>(t, codes, valid, ascii, k, n, canon, tf, slot, strand, s);
  return dispatch_out<false, false>(t, codes, valid, ascii, k, n, canon, tf, slot, strand, s);
}
