// Shared device helpers of the sparse canonical k-mer kernels (spectrum23,
// quot23, quotcov23), for k <= 31 bases in 64-bit codes.
//
// They are the CUDA counterparts of aindex_tpu/kernels/encode.py and
// aindex_tpu/index/quotcuckoo.py:
//   revcomp64       <- revcomp_code64               (encode.py:125)
//   canonical64     <- canonical_code64             (encode.py:141)
//   packed_window64 <- unpack_base_codes + window_codes, uint64 out
//                      (encode.py:46,63,98); dna13::packed_window for k <= 31
//   quot_bij        <- _bij_jnp                     (quotcuckoo.py:103)
//   quot_probe      <- _probe                       (quotcuckoo.py:281)
// The plain PyTorch versions live in aindex_torch/kernels/encode.py and
// aindex_torch/index/quotcuckoo.py.
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

// The k-mer (k <= 31) starting at base p of the packed ingest format (see
// dna13::packed_window). The window spans at most three words and five
// validity bytes; reads past the end of either array see zeros, i.e.
// invalid bases. Returns whether all k bases are valid and writes the code.
__device__ __forceinline__ bool packed_window64(const unsigned* __restrict__ packed,
                                                const unsigned char* __restrict__ vbits,
                                                long long n_words, long long p, int k,
                                                uint64_t* code) {
  const long long w = p >> 4;
  const uint64_t w0 = w < n_words ? packed[w] : 0ull;
  const uint64_t w1 = w + 1 < n_words ? packed[w + 1] : 0ull;
  const uint64_t w2 = w + 2 < n_words ? packed[w + 2] : 0ull;
  const int s = 2 * static_cast<int>(p & 15);
  const uint64_t lo = w0 | (w1 << 32);
  // 64 - s >= 34 bits come from w0:w1, the rest of the 2k <= 62 from w2
  const uint64_t bases = s ? ((lo >> s) | (w2 << (64 - s))) : lo;
  uint64_t c = 0;
  for (int j = 0; j < k; ++j) c = (c << 2) | ((bases >> (2 * j)) & 3ull);
  *code = c;

  const long long n_bytes = 2 * n_words;
  const long long b = p >> 3;
  uint64_t v = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i)
    if (b + i < n_bytes) v |= static_cast<uint64_t>(vbits[b + i]) << (8 * i);
  const uint64_t need = (1ull << k) - 1ull;
  return ((v >> (p & 7)) & need) == need;
}

// The quotient cuckoo table on the device (index/quotcuckoo.py): two halves
// of m rows of 8-byte (fingerprint, tf) pairs, each in its own array, and
// the two parallel slot columns. Row and fingerprint of a key in half h come
// from the xorshift-multiply bijection with that half's multipliers.
struct QuotTable {
  const uint2* half0;
  const uint2* half1;
  const int* slot0;
  const int* slot1;
  uint64_t row_mask;  // m - 1
  int lb;             // log2 m
  int w;              // 2k, the code width the bijection works on
  uint64_t m1a, m1b, m2a, m2b;
};

// xorshift-multiply bijection on the low w bits (_bij_jnp): each multiply
// wraps modulo 2^64 and is masked back to w bits, so the low bits are exact.
__device__ __forceinline__ uint64_t quot_bij(uint64_t x, uint64_t ma, uint64_t mb, int w) {
  const uint64_t mask = w >= 64 ? ~0ull : ((1ull << w) - 1ull);
  const int s = (w + 1) / 2;
  x &= mask;
  x ^= x >> s;
  x = (x * ma) & mask;
  x ^= x >> s;
  x = (x * mb) & mask;
  x ^= x >> s;
  return x;
}

// Verified probe of both halves. A fingerprint match is an exact key match
// (row + fingerprint invert the bijection); the empty marker 0xFFFFFFFF
// never equals a fingerprint of <= 31 bits. On a hit writes the tf, the
// half and the row (for the slot column) and returns true.
__device__ __forceinline__ bool quot_probe(const QuotTable& t, uint64_t key, unsigned* tf,
                                           int* half, long long* row) {
  uint64_t h = quot_bij(key, t.m1a, t.m1b, t.w);
  long long r = static_cast<long long>(h & t.row_mask);
  uint2 c = t.half0[r];
  if (c.x == static_cast<unsigned>(h >> t.lb)) {
    *tf = c.y;
    *half = 0;
    *row = r;
    return true;
  }
  h = quot_bij(key, t.m2a, t.m2b, t.w);
  r = static_cast<long long>(h & t.row_mask);
  c = t.half1[r];
  if (c.x == static_cast<unsigned>(h >> t.lb)) {
    *tf = c.y;
    *half = 1;
    *row = r;
    return true;
  }
  *tf = 0u;
  return false;
}

__device__ __forceinline__ int quot_slot(const QuotTable& t, int half, long long row) {
  return half ? t.slot1[row] : t.slot0[row];
}

}  // namespace dna23
