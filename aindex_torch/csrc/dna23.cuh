// Shared device helpers of the sparse k-mer kernels (spectrum23 and the
// probe kernels of probe.cuh), for k <= 31 bases in 64-bit codes.
//
// They are the CUDA counterparts of aindex_tpu/kernels/encode.py:
//   revcomp64       <- revcomp_code64               (encode.py:125)
//   canonical64     <- canonical_code64             (encode.py:141)
//   packed_window64 <- unpack_base_codes + window_codes, uint64 out
//                      (encode.py:46,63,98); dna13::packed_window for k <= 31
//   ascii_window64  <- ascii_to_base_codes + window_codes, uint64 out
//                      (encode.py:25,63), one window of ASCII bytes
// The plain PyTorch versions live in aindex_torch/kernels/encode.py.
//
// All codes are uint64_t: shifts are logical and multiplies wrap modulo
// 2^64, as JAX's uint64 arithmetic does.
#pragma once

#include "dna13.cuh"

namespace dna23 {

// Reverse complement of a k-mer code held in 64 bits: complement every
// 2-bit field, mirror the 32 fields, shift down to the low 2k bits. Only the
// low 2k bits of x reach the result.
__device__ __forceinline__ uint64_t revcomp64(uint64_t x, int k) {
  x = ~x;
  x = ((x >> 2) & 0x3333333333333333ull) | ((x & 0x3333333333333333ull) << 2);
  x = ((x >> 4) & 0x0F0F0F0F0F0F0F0Full) | ((x & 0x0F0F0F0F0F0F0F0Full) << 4);
  x = ((x >> 8) & 0x00FF00FF00FF00FFull) | ((x & 0x00FF00FF00FF00FFull) << 8);
  x = ((x >> 16) & 0x0000FFFF0000FFFFull) | ((x & 0x0000FFFF0000FFFFull) << 16);
  x = (x >> 32) | (x << 32);
  return x >> (64 - 2 * k);
}

__device__ __forceinline__ uint64_t canonical64(uint64_t x, int k) {
  const uint64_t rc = revcomp64(x, k);
  return x < rc ? x : rc;
}

// The 32 bases from base p of the packed ingest format (see
// dna13::packed_window), base p + j in bits 2j and 2j + 1. They span at most
// three words; reads past the end see zeros.
__device__ __forceinline__ uint64_t packed_bases64(const unsigned* __restrict__ packed,
                                                   long long n_words, long long p) {
  const long long w = p >> 4;
  const uint64_t w0 = w < n_words ? packed[w] : 0ull;
  const uint64_t w1 = w + 1 < n_words ? packed[w + 1] : 0ull;
  const uint64_t w2 = w + 2 < n_words ? packed[w + 2] : 0ull;
  const int s = 2 * static_cast<int>(p & 15);
  const uint64_t lo = w0 | (w1 << 32);
  // 64 - s >= 34 bits come from w0:w1, the rest of the 2k <= 62 from w2
  return s ? ((lo >> s) | (w2 << (64 - s))) : lo;
}

// Whether the k bases from base p are all valid: at most five validity
// bytes; reads past the end see zeros, i.e. invalid bases.
__device__ __forceinline__ bool packed_valid64(const unsigned char* __restrict__ vbits,
                                               long long n_words, long long p, int k) {
  const long long n_bytes = 2 * n_words;
  const long long b = p >> 3;
  uint64_t v = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i)
    if (b + i < n_bytes) v |= static_cast<uint64_t>(vbits[b + i]) << (8 * i);
  const uint64_t need = (1ull << k) - 1ull;
  return ((v >> (p & 7)) & need) == need;
}

// The k-mer (k <= 31) starting at base p of the packed ingest format.
// Returns whether all k bases are valid and writes the code.
__device__ __forceinline__ bool packed_window64(const unsigned* __restrict__ packed,
                                                const unsigned char* __restrict__ vbits,
                                                long long n_words, long long p, int k,
                                                uint64_t* code) {
  const uint64_t bases = packed_bases64(packed, n_words, p);
  uint64_t c = 0;
  for (int j = 0; j < k; ++j) c = (c << 2) | ((bases >> (2 * j)) & 3ull);
  *code = c;
  return packed_valid64(vbits, n_words, p, k);
}

// The k-mer (k <= 31) of the k ASCII bytes at s. Returns whether all k
// bytes are ACGT/acgt and writes the code, in which a byte outside ACGT
// reads 3, as INVALID_CODE & 3 does in window_codes: the codes of invalid
// windows (which _extract_canonical returns beside their mask) are JAX's.
__device__ __forceinline__ bool ascii_window64(const unsigned char* __restrict__ s, int k,
                                               uint64_t* code) {
  uint64_t c = 0;
  bool ok = true;
  for (int j = 0; j < k; ++j) {
    const unsigned b = dna13::ascii_code(s[j]);
    ok &= b < 4u;
    c = (c << 2) | (b < 4u ? b : 3u);
  }
  *code = c;
  return ok;
}

}  // namespace dna23
