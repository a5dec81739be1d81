// K3 gather13: batched lookups in a dense 13-mer table, uint32 out.
//
// Replaces, as one kernel with compile-time modes:
//   aindex_tpu/kernels/lookup.py:32 gather_tf_valid      (codes, mask, fwd)
//   aindex_tpu/kernels/lookup.py:49 gather_tf_both_13    (codes, mask, fwd + rc)
//   aindex_tpu/index/dense13.py:103 _gather_total        (codes, mask, fwd on tf_total)
//   aindex_tpu/index/dense13.py:109 _gather_codes_u32    (codes, no mask)
//   aindex_tpu/index/dense13.py:115 _gather_codes_valid_u32 (codes, mask)
//   aindex_tpu/index/dense13.py:92  _encode_batch_dev    (ASCII [B, 13] rows in)
// Template parameters: the table's width (8, 16 or 32 bits), ASCII rows or
// codes in, a valid mask or none, and the reverse-complement second output.
//
// Bound: random reads of device memory. Each query reads one (or two)
// table entries at an address unrelated to its neighbours', so a warp
// touches 32 sectors for 32 useful entries of 1-4 bytes. The narrowed
// uint8 table (64 MB) mostly fits in the 50 MB L2, which is why queries go
// to the narrowest exact table. Design: one thread per query; codes are
// read and outputs written coalesced; ASCII rows are decoded in registers.
//
// Codes out of range read what JAX's gather reads (see dna13::jax_index),
// never outside the table. Invalid queries give 0.
#include "dna13.cuh"

namespace {

template <typename T, bool ASCII, bool MASK, bool BOTH>
__global__ void gather13_kernel(const T* __restrict__ table, const int* __restrict__ codes,
                                const unsigned char* __restrict__ valid,
                                const unsigned char* __restrict__ ascii, long long n,
                                unsigned* __restrict__ out, unsigned* __restrict__ out_rc) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    unsigned code = 0;
    bool ok = true;
    if (ASCII) {
      const unsigned char* row = ascii + i * dna13::K;
#pragma unroll
      for (int j = 0; j < dna13::K; ++j) {
        const unsigned b = dna13::ascii_code(row[j]);
        ok &= b < 4u;
        code = (code << 2) | (b & 3u);
      }
    } else {
      code = static_cast<unsigned>(codes[i]);
      if (MASK) ok = valid[i] != 0;
    }
    out[i] = ok ? static_cast<unsigned>(table[dna13::jax_index(code)]) : 0u;
    if (BOTH) out_rc[i] = ok ? static_cast<unsigned>(table[dna13::revcomp13(code)]) : 0u;
  }
}

template <typename T, bool ASCII, bool MASK, bool BOTH>
void launch(const void* table, const void* codes, const void* valid, const void* ascii,
            long long n, void* out, void* out_rc, cudaStream_t stream) {
  gather13_kernel<T, ASCII, MASK, BOTH><<<dna13::grid_for(n), dna13::BLOCK, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(codes),
      static_cast<const unsigned char*>(valid), static_cast<const unsigned char*>(ascii), n,
      static_cast<unsigned*>(out), static_cast<unsigned*>(out_rc));
}

template <typename T>
void dispatch(const void* table, const void* codes, const void* valid, const void* ascii,
              long long n, void* out, void* out_rc, cudaStream_t s) {
  const bool both = out_rc != nullptr;
  if (ascii != nullptr) {
    if (both) launch<T, true, false, true>(table, codes, valid, ascii, n, out, out_rc, s);
    else launch<T, true, false, false>(table, codes, valid, ascii, n, out, out_rc, s);
  } else if (valid != nullptr) {
    if (both) launch<T, false, true, true>(table, codes, valid, ascii, n, out, out_rc, s);
    else launch<T, false, true, false>(table, codes, valid, ascii, n, out, out_rc, s);
  } else {
    if (both) launch<T, false, false, true>(table, codes, valid, ascii, n, out, out_rc, s);
    else launch<T, false, false, false>(table, codes, valid, ascii, n, out, out_rc, s);
  }
}

}  // namespace

DNA13_EXPORT_ERROR_STRING

// table: uint8/uint16/uint32[4^13] (width = 8, 16 or 32). Either ascii
// (uint8[n, 13]) is given, or codes (int32[n], uint32 bit patterns) with an
// optional valid (bool/uint8[n]). out: uint32[n]; out_rc: uint32[n] or null.
// Returns cudaGetLastError() after the launch.
extern "C" int gather13(const void* table, int width, const void* codes, const void* valid,
                        const void* ascii, long long n, void* out, void* out_rc,
                        void* stream) {
  if (n <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 8: dispatch<uint8_t>(table, codes, valid, ascii, n, out, out_rc, s); break;
    case 16: dispatch<uint16_t>(table, codes, valid, ascii, n, out, out_rc, s); break;
    case 32: dispatch<uint32_t>(table, codes, valid, ascii, n, out, out_rc, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
