// K7 quotcov23: per-position canonical k-mer coverage of many rows of
// packed ingest at once: unpack -> window -> canonical -> both quotient
// cuckoo probes -> valid mask -> cutoff, uint32[rows, stride - k] out.
//
// Replaces aindex_tpu/index/quotcuckoo.py:353 quot_tf_windows_packed, the
// fused coverage kernel of the sparse index (and the cutoff that
// aindex_tpu/index/sparse23.py:449-451 applies to its result).
//
// Bound: random reads of the 8-byte table rows, as in quot23; the packed
// input is 0.375 bytes a base and read coalesced. Design: one thread per
// (row, window), with quot23's probe (dna23::quot_probe) and the window
// arithmetic of the dense coverage kernel widened to 64-bit codes
// (dna23::packed_window64). Row r holds its sequence from base r * stride,
// padded with invalid bases to stride, so the stride - k windows written
// per row never cross into the next row.
#include "dna23.cuh"

namespace {

__global__ void quotcov23_kernel(dna23::QuotTable t, const unsigned* __restrict__ packed,
                                 const unsigned char* __restrict__ vbits, long long n_words,
                                 long long rows, long long stride, int k, unsigned cutoff,
                                 unsigned* __restrict__ out) {
  const long long width = stride - k;
  const long long n = rows * width;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const long long r = i / width;
    const long long p = r * stride + (i - r * width);
    uint64_t code;
    unsigned tf = 0u;
    if (dna23::packed_window64(packed, vbits, n_words, p, k, &code)) {
      int half;
      long long row;
      dna23::quot_probe(t, dna23::canonical64(code, k), &tf, &half, &row);
    }
    out[i] = tf >= cutoff ? tf : 0u;
  }
}

}  // namespace

DNA13_EXPORT_ERROR_STRING

// half0/half1: int32[m, 2] (fingerprint, tf) rows. packed: uint32[n_words]
// and vbits: uint8[2 * n_words] hold rows * stride bases. out:
// uint32[rows, stride - k]. Returns cudaGetLastError() after the launch.
extern "C" int quotcov23(const void* half0, const void* half1, long long m, int lb, int w,
                         unsigned long long m1a, unsigned long long m1b,
                         unsigned long long m2a, unsigned long long m2b, const void* packed,
                         const void* vbits, long long n_words, long long rows,
                         long long stride, int k, unsigned cutoff, void* out, void* stream) {
  if (rows <= 0 || stride <= k) return cudaSuccess;
  if (k < 1 || k > 31 || m <= 0 || (m & (m - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dna23::QuotTable t{static_cast<const uint2*>(half0), static_cast<const uint2*>(half1),
                           nullptr, nullptr, static_cast<uint64_t>(m - 1), lb, w,
                           m1a, m1b, m2a, m2b};
  const long long n = rows * (stride - k);
  quotcov23_kernel<<<dna13::grid_for(n), dna13::BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const unsigned*>(packed), static_cast<const unsigned char*>(vbits), n_words,
      rows, stride, k, cutoff, static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
