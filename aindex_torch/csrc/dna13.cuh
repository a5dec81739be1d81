// Shared device helpers of the dense 13-mer kernels (count13, total13,
// gather13, coverage13).
//
// They are the CUDA counterparts of aindex_tpu/kernels/encode.py:
//   ascii_code    <- ascii_to_base_codes    (encode.py:25)
//   packed_window <- unpack_base_codes + window_codes (encode.py:46,63,98)
//   revcomp13     <- revcomp_code13         (encode.py:106)
// plus jax_index, the index rule of a JAX gather. The plain PyTorch versions
// live in aindex_torch/kernels/encode.py.
//
// Every table is indexed by a 13-mer's 2-bit code (A=0 C=1 G=2 T=3, first
// base in the most significant field), so a table holds 4^13 entries.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dna13 {

constexpr int K = 13;
constexpr int SPACE = 1 << (2 * K);  // 4^13 = 67,108,864
constexpr int BLOCK = 256;

// ASCII byte -> 2-bit base code, 4 for anything outside ACGT/acgt. Bits 1-2
// of 'A','C','G','T' read 0,1,3,2; x ^ (x >> 1) swaps 3 and 2.
__device__ __forceinline__ unsigned ascii_code(unsigned char c) {
  const unsigned up = c & 0xDFu;
  const bool ok = up == 'A' || up == 'C' || up == 'G' || up == 'T';
  const unsigned x = (c >> 1) & 3u;
  return ok ? (x ^ (x >> 1)) : 4u;
}

// Reverse complement of a 13-mer code held in 32 bits: complement every
// 2-bit field, mirror the 16 fields, shift down to the low 26 bits. Only the
// low 26 bits of x reach the result, so it is always a valid table index.
__device__ __forceinline__ unsigned revcomp13(unsigned x) {
  x = ~x;
  x = ((x >> 2) & 0x33333333u) | ((x & 0x33333333u) << 2);
  x = ((x >> 4) & 0x0F0F0F0Fu) | ((x & 0x0F0F0F0Fu) << 4);
  x = ((x >> 8) & 0x00FF00FFu) | ((x & 0x00FF00FFu) << 8);
  x = (x >> 16) | (x << 16);
  return x >> (32 - 2 * K);
}

// The index a JAX gather `table[code.astype(int32)]` reads for a uint32
// code: the cast wraps to int32, a negative index gains the table length,
// and the result is clamped into the table. So 4^13 and 2^31 - 1 read the
// last entry, 2^32 - 1 (= -1) reads the last entry, 2^31 reads entry 0.
__device__ __forceinline__ int jax_index(unsigned code) {
  int i = static_cast<int>(code);
  if (i < 0) i += SPACE;
  if (i < 0) i = 0;
  if (i >= SPACE) i = SPACE - 1;
  return i;
}

// The 13-mer starting at base p of the packed ingest format
// (aindex_tpu/core/codec.py pack_ascii_chunk): base i sits at bits
// 2*(i%16) of word i/16, its validity at bit i%8 of byte i/8. The window
// spans at most two words and three validity bytes; reads past the end of
// either array see zeros, i.e. invalid bases. Returns whether all 13 bases
// are valid and writes the window's code.
__device__ __forceinline__ bool packed_window(const unsigned* __restrict__ packed,
                                              const unsigned char* __restrict__ vbits,
                                              long long n_words, long long p,
                                              unsigned* code) {
  const long long w = p >> 4;
  const unsigned long long lo = packed[w];
  const unsigned long long hi = (w + 1 < n_words) ? packed[w + 1] : 0ull;
  const unsigned long long bases = (lo | (hi << 32)) >> (2 * (p & 15));
  unsigned c = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) c = (c << 2) | static_cast<unsigned>((bases >> (2 * j)) & 3ull);
  *code = c;

  const long long n_bytes = 2 * n_words;
  const long long b = p >> 3;
  unsigned v = vbits[b];
  if (b + 1 < n_bytes) v |= static_cast<unsigned>(vbits[b + 1]) << 8;
  if (b + 2 < n_bytes) v |= static_cast<unsigned>(vbits[b + 2]) << 16;
  const unsigned need = (1u << K) - 1u;
  return ((v >> (p & 7)) & need) == need;
}

// Blocks for a grid-stride loop over n items.
inline unsigned grid_for(long long n) {
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  return static_cast<unsigned>(blocks < (1LL << 20) ? blocks : (1LL << 20));
}

}  // namespace dna13

// Every library exports the CUDA runtime's text for its error codes, so
// the Python wrapper can name the error a launch returned.
#define DNA13_EXPORT_ERROR_STRING                                 \
  extern "C" const char* dna13_error_string(int code) {           \
    return cudaGetErrorString(static_cast<cudaError_t>(code));    \
  }
