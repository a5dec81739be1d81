// Shared device helpers of the dense 13-mer kernels (count13, total13,
// gather13, coverage13).
//
// They are the CUDA counterparts of aindex_tpu/kernels/encode.py:
//   ascii_code    <- ascii_to_base_codes    (encode.py:25)
//   packed_window <- unpack_base_codes + window_codes (encode.py:46,63,98)
//   revcomp13     <- revcomp_code13         (encode.py:106)
// plus jax_index, the index rule of a JAX gather, and half_index, the slot
// of a code in the port's half total table (half_index13). The plain
// PyTorch versions live in aindex_torch/kernels/encode.py.
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

// Reverse complement of a k-mer code (k <= 16; 13 unless given) held in 32
// bits: complement every 2-bit field, mirror the 16 fields, shift down to
// the low 2k bits. Only the low 2k bits of x reach the result, so for k = 13
// it is always a valid table index.
__device__ __forceinline__ unsigned revcomp13(unsigned x, int k = K) {
  x = ~x;
  x = ((x >> 2) & 0x33333333u) | ((x & 0x33333333u) << 2);
  x = ((x >> 4) & 0x0F0F0F0Fu) | ((x & 0x0F0F0F0Fu) << 4);
  x = ((x >> 8) & 0x00FF00FFu) | ((x & 0x00FF00FFu) << 8);
  x = (x >> 16) | (x << 16);
  return x >> (32 - 2 * k);
}

// The index a JAX gather `table[code.astype(int32)]` reads for a uint32
// code in a table of n >= 1 entries: the cast wraps to int32, a negative
// index gains n, and the result is clamped into the table. So in the 4^13
// table (jax_index) 4^13 and 2^31 - 1 read the last entry, 2^32 - 1 (= -1)
// reads the last entry, 2^31 reads entry 0.
__device__ __forceinline__ long long jax_index_n(unsigned code, long long n) {
  long long i = static_cast<int>(code);
  if (i < 0) i += n;
  if (i < 0) i = 0;
  if (i >= n) i = n - 1;
  return i;
}

__device__ __forceinline__ int jax_index(unsigned code) {
  return static_cast<int>(jax_index_n(code, SPACE));
}

// The slot of a code c in [0, 4^13) in the half total table (2^25 entries):
// of c and revcomp13(c), the one whose middle base is A or C (bit 13 clear;
// for odd k exactly one of the two), with that bit dropped. A total table
// holds the same value at c and revcomp13(c), so half[half_index(c)] is
// total[c].
__device__ __forceinline__ int half_index(unsigned c) {
  if (c & (1u << 13)) c = revcomp13(c);
  return static_cast<int>(((c >> 14) << 13) | (c & 0x1FFFu));
}

// The index a JAX scatter `counts.at[code.astype(int32)].add(w,
// mode="drop")` writes for a uint32 code into a table of `space` entries:
// the cast wraps to int32 and a negative index gains `space`; whatever then
// lies outside [0, space) is dropped (returns false).
__device__ __forceinline__ bool scatter_index(unsigned code, long long space, long long* i) {
  long long j = static_cast<int>(code);
  if (j < 0) j += space;
  *i = j;
  return j >= 0 && j < space;
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
