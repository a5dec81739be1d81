// K4 coverage13_packed: per-position forward 13-mer coverage of many rows
// of packed ingest at once: unpack -> window -> table gather -> valid mask
// -> cutoff, uint32[rows, stride - 13] out.
//
// Replaces aindex_tpu/kernels/coverage.py:32 _coverage_dense_packed (the
// batch path) and :22 _coverage_dense_kernel (the single-sequence path,
// which the port serves with one packed row through this same kernel).
//
// Bound: random table reads, as in gather13; the packed input is 0.375
// bytes a base and read coalesced. Design: one thread per (row, window).
// Row r holds its sequence from base r * stride, padded with invalid bases
// to stride, so the stride - 13 windows written per row never cross into
// the next row and the window arithmetic is the count kernel's.
#include "dna13.cuh"

namespace {

template <typename T>
__global__ void coverage13_kernel(const T* __restrict__ table, const unsigned* __restrict__ packed,
                                  const unsigned char* __restrict__ vbits, long long n_words,
                                  long long rows, long long stride, unsigned cutoff,
                                  unsigned* __restrict__ out) {
  const long long width = stride - dna13::K;
  const long long n = rows * width;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < n;
       t += step) {
    const long long r = t / width;
    const long long p = r * stride + (t - r * width);
    unsigned code;
    const bool ok = dna13::packed_window(packed, vbits, n_words, p, &code);
    const unsigned tf = ok ? static_cast<unsigned>(table[code]) : 0u;
    out[t] = tf >= cutoff ? tf : 0u;
  }
}

template <typename T>
void launch(const void* table, const void* packed, const void* vbits, long long n_words,
            long long rows, long long stride, unsigned cutoff, void* out, cudaStream_t s) {
  const long long n = rows * (stride - dna13::K);
  coverage13_kernel<T><<<dna13::grid_for(n), dna13::BLOCK, 0, s>>>(
      static_cast<const T*>(table), static_cast<const unsigned*>(packed),
      static_cast<const unsigned char*>(vbits), n_words, rows, stride, cutoff,
      static_cast<unsigned*>(out));
}

}  // namespace

DNA13_EXPORT_ERROR_STRING

// table: uint8/uint16/uint32[4^13] (width = 8, 16 or 32). packed:
// uint32[n_words] and vbits: uint8[2 * n_words] hold rows * stride bases
// (n_words * 16 >= rows * stride). out: uint32[rows, stride - 13].
// Returns cudaGetLastError() after the launch.
extern "C" int coverage13_packed(const void* table, int width, const void* packed,
                                 const void* vbits, long long n_words, long long rows,
                                 long long stride, unsigned cutoff, void* out, void* stream) {
  if (rows <= 0 || stride <= dna13::K) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 8: launch<uint8_t>(table, packed, vbits, n_words, rows, stride, cutoff, out, s); break;
    case 16: launch<uint16_t>(table, packed, vbits, n_words, rows, stride, cutoff, out, s); break;
    case 32: launch<uint32_t>(table, packed, vbits, n_words, rows, stride, cutoff, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
