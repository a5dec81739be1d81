// Shared device helpers of the sparse k-mer kernels (spectrum23 and the
// probe kernels of probe.cuh), for k <= 31 bases in 64-bit codes.
//
// They are the CUDA counterparts of aindex_tpu/kernels/encode.py:
//   revcomp64       <- revcomp_code64               (encode.py:125)
//   canonical64     <- canonical_code64             (encode.py:141)
//   packed_window64 <- unpack_base_codes + window_codes, uint64 out
//                      (encode.py:46,63,98); dna13::packed_window for k <= 31
//   ascii_window64  <- ascii_to_base_codes + window_codes, uint64 out
//                      (encode.py:25,63), one window of ASCII bytes (the
//                      ASCII [n, k] query rows of probe.cuh query_kernel,
//                      spectrum23_ascii's windows)
//   AsciiSource     <- ascii_to_base_codes (encode.py:25) for the tiled
//                      front end: bytes coded once a tile as they are staged
// The plain PyTorch versions live in aindex_torch/kernels/encode.py. The
// tiled front end below (tile_run over a PackedSource or an AsciiSource,
// Window, store_run) serves the engines' packed coverage entries and K7's
// ASCII-rows entry (probe.cuh coverage_kernel) and K5's canonical23_ascii
// (spectrum23.cu canonical_kernel).
//
// All codes are uint64_t: shifts are logical and multiplies wrap modulo
// 2^64, as JAX's uint64 arithmetic does.
#pragma once

#include "dna13.cuh"

namespace dna23 {

// The 32 2-bit fields of x in mirrored order (field j to field 31 - j): the
// bits reversed, then the two bits of each field swapped back.
__device__ __forceinline__ uint64_t mirror64(uint64_t x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
}

// Reverse complement of a k-mer code held in 64 bits: complement every
// 2-bit field, mirror the 32 fields, shift down to the low 2k bits. Only the
// low 2k bits of x reach the result.
__device__ __forceinline__ uint64_t revcomp64(uint64_t x, int k) {
  return mirror64(~x) >> (64 - 2 * k);
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

// -- the tiled front end ---------------------------------------------
//
// A tiled launch writes out[rows, width]: one output a window, the window
// at base r * stride + c for each column c < width of row r. Two sources
// hold the bases:
//   PackedSource: packed ingest (probe.cuh coverage_kernel: K7, K10's and
//     K11's packed coverage), rows of stride bases padded with invalid
//     ones, width = stride - k;
//   AsciiSource: ASCII rows of stride = len bytes with nothing between
//     them (K7's quotcov23_rows, K5's canonical23_ascii), width = len - k
//     + 1.
// Each warp takes a tile of 32 * RUN consecutive outputs of the flat index,
// RUN to a thread (a block its warps' tiles in turn): it finds the tile's
// first and last (row, column) (row_col: a multiply by the host's
// reciprocal of the row width, no division), and stages the bases the tile
// spans in its own slice of shared memory, 16 bases to a word of 2-bit
// codes and a validity bit a base, with 16-byte loads (zeros past the end)
// and no block barrier. The packed source copies its words and validity
// bits from an 8-word aligned start. The ASCII source codes the bytes as it
// stages them, from a 16-byte aligned address: each lane loads 16 bytes,
// codes them four to a 32-bit register (ACGT/acgt to 0-3, any other byte to
// 3 and invalid, as ascii_window64 reads it) and writes one word of codes
// and 16 validity bits; a load that would cross the buffer's start or end
// is made a byte at a time. After one warp barrier each thread rolls its
// run of windows along the stage: the first window built whole (a 64-bit
// cut of three words, its 2-bit fields mirrored for the forward code and
// complemented for the reverse complement), each next one by one base
// shifted in, or stride - width + 1 bases on (k + 1 packed, k ASCII) where
// the run crosses into the next row, whose skipped positions it rolls
// through and writes nothing for. A window is valid when its last k bases
// are (a count of the valid bases since the last invalid one). So each
// byte or packed word is loaded and coded once a tile, not k times. The
// kernel then uses its run (probes, keys) and stores it (store_run).

// Outputs a block takes.
template <int RUN>
constexpr long long tile_outputs() {
  return static_cast<long long>(dna13::BLOCK) * RUN;
}

// Stage words (16 bases each) a warp's slice takes for rows of `width`
// windows of k bases (1 <= k <= 31), stride - width <= k: from a start up
// to 127 bases before the tile's first window to 4 words past the last
// window's last base, rounded to 8. A tile's outputs cross at most (32 RUN
// - 1) / width + 1 row ends, each skipping at most k bases.
template <int RUN>
inline long long stage_words(long long width, int k) {
  const long long span = 32 * RUN + static_cast<long long>(k) * ((32 * RUN - 1) / width + 2);
  return ((span + 127 + 15) / 16 + 4 + 7) / 8 * 8;
}

// Shared-memory bytes of a block: each warp's words and half as many
// words of validity bits.
inline size_t stage_bytes(long long words) {
  return static_cast<size_t>(words) * 6 * (dna13::BLOCK / 32);
}

// The reciprocal row_col divides by: floor((2^64 - 1) / width).
inline unsigned long long reciprocal(long long width) {
  return ~0ull / static_cast<unsigned long long>(width);
}

// Packed ingest: packed uint32[n_words] (16 bases a word, base 16 w + i in
// bits 2i, 2i + 1 of word w) and vbits uint8[2 n_words] (a validity bit a
// base); rows of stride bases.
struct PackedSource {
  const unsigned* packed;
  const unsigned char* vbits;
  long long n_words;
  long long stride;
  int k;

  __host__ __device__ long long width() const { return stride - k; }

  // The stage's first base for a tile whose first window starts at base p.
  __device__ __forceinline__ long long stage_base(long long p) const {
    return 16 * ((p >> 4) & ~7LL);
  }

  // The `words` packed words from base `base` and their validity bits
  // (words a multiple of 8), a warp's lanes taking 16 bytes each in turn.
  __device__ __forceinline__ void stage(unsigned* words_s, unsigned* valid, long long base,
                                        int words, int lane) const {
    const long long w0 = base >> 4;
    const bool whole_p = (reinterpret_cast<uintptr_t>(packed) & 15) == 0;
    for (int j = lane; j < words / 4; j += 32) {
      const long long w = w0 + 4 * j;
      uint4 v;
      if (whole_p && w + 4 <= n_words) {
        v = *reinterpret_cast<const uint4*>(packed + w);
      } else {
        v.x = w < n_words ? packed[w] : 0u;
        v.y = w + 1 < n_words ? packed[w + 1] : 0u;
        v.z = w + 2 < n_words ? packed[w + 2] : 0u;
        v.w = w + 3 < n_words ? packed[w + 3] : 0u;
      }
      reinterpret_cast<uint4*>(words_s)[j] = v;
    }
    const long long n_bytes = 2 * n_words;
    const bool whole_v = (reinterpret_cast<uintptr_t>(vbits) & 15) == 0;
    for (int j = lane; j < words / 8; j += 32) {
      const long long b = 2 * w0 + 16 * j;
      uint4 v;
      if (whole_v && b + 16 <= n_bytes) {
        v = *reinterpret_cast<const uint4*>(vbits + b);
      } else {
        uint64_t lo = 0, hi = 0;
        for (int i = 0; i < 16 && b + i < n_bytes; ++i) {
          const uint64_t byte = vbits[b + i];
          if (i < 8)
            lo |= byte << (8 * i);
          else
            hi |= byte << (8 * (i - 8));
        }
        v = make_uint4(static_cast<unsigned>(lo), static_cast<unsigned>(lo >> 32),
                       static_cast<unsigned>(hi), static_cast<unsigned>(hi >> 32));
      }
      reinterpret_cast<uint4*>(valid)[j] = v;
    }
  }
};

// 0x80 in each byte of x that is 0, 0 in the others (no borrow crosses a
// byte).
__device__ __forceinline__ unsigned zero_bytes(unsigned x) {
  return ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x | 0x7F7F7F7Fu);
}

// The four ASCII bytes of x (the first in the low byte) coded: returns
// their 2-bit codes, byte i in bits 2i, 2i + 1 (A/a 0, C/c 1, G/g 2, T/t 3,
// any other byte 3), and writes their validity bits, byte i in bit i.
__device__ __forceinline__ unsigned code_bytes4(unsigned x, unsigned* ok) {
  const unsigned low = x | 0x20202020u;  // only A and a reach 'a', and so on
  const unsigned hit = zero_bytes(low ^ 0x61616161u) | zero_bytes(low ^ 0x63636363u) |
                       zero_bytes(low ^ 0x67676767u) | zero_bytes(low ^ 0x74747474u);
  const unsigned one = hit >> 7;  // 1 in each valid byte
  // bits 1-3 of a, c, g, t: ((x >> 1) ^ (x >> 2)) & 3 reads 0, 1, 2, 3
  const unsigned c = (((x >> 1) ^ (x >> 2)) & 0x03030303u) | ((one ^ 0x01010101u) * 3u);
  const unsigned two = c | (c >> 6);
  const unsigned bits = one | (one >> 7);
  *ok = (bits | (bits >> 14)) & 0xFu;
  return (two | (two >> 12)) & 0xFFu;
}

// ASCII rows: ascii uint8[n_bytes], rows of stride bytes back to back.
struct AsciiSource {
  const unsigned char* ascii;
  long long n_bytes;
  long long stride;
  int k;

  __host__ __device__ long long width() const { return stride - k + 1; }

  // The stage's first byte for a tile whose first window starts at byte p:
  // the byte at the 16-byte aligned address at or before p's (it may lie
  // up to 15 bytes before the buffer).
  __device__ __forceinline__ long long stage_base(long long p) const {
    return p - static_cast<long long>((reinterpret_cast<uintptr_t>(ascii) + p) & 15);
  }

  // The `words` words of 16 bytes from byte `base`, coded, and their
  // validity bits; a lane a word, each lane's 16 bytes one aligned load
  // where they lie in the buffer.
  __device__ __forceinline__ void stage(unsigned* words_s, unsigned* valid, long long base,
                                        int words, int lane) const {
    unsigned short* valid16 = reinterpret_cast<unsigned short*>(valid);
    for (int j = lane; j < words; j += 32) {
      const long long b = base + 16LL * j;
      uint4 v;
      if (b >= 0 && b + 16 <= n_bytes) {
        v = *reinterpret_cast<const uint4*>(ascii + b);
      } else {
        unsigned x[4] = {0u, 0u, 0u, 0u};
        for (int i = 0; i < 16; ++i)
          if (b + i >= 0 && b + i < n_bytes)
            x[i >> 2] |= static_cast<unsigned>(ascii[b + i]) << (8 * (i & 3));
        v = make_uint4(x[0], x[1], x[2], x[3]);
      }
      unsigned o0, o1, o2, o3;
      const unsigned c0 = code_bytes4(v.x, &o0), c1 = code_bytes4(v.y, &o1);
      const unsigned c2 = code_bytes4(v.z, &o2), c3 = code_bytes4(v.w, &o3);
      words_s[j] = c0 | (c1 << 8) | (c2 << 16) | (c3 << 24);
      valid16[j] = static_cast<unsigned short>(o0 | (o1 << 4) | (o2 << 8) | (o3 << 12));
    }
  }
};

// One thread's run: outputs [first, first + count) of the flat index, and
// their windows' forward codes, reverse-complement codes and validity.
template <int RUN>
struct Run {
  long long first;
  int count;
  uint64_t fwd[RUN];
  uint64_t rc[RUN];
  bool ok[RUN];
};

// A k-mer window rolled along the stage: words holds 16 bases a word,
// valid a validity bit a base, from the stage's first base.
struct Window {
  uint64_t fwd, rc;
  int run;  // valid bases since the last invalid one, up to the window's last base

  // The window of the k bases from stage base q, built whole.
  __device__ __forceinline__ Window(const unsigned* words, const unsigned* valid, int q, int k) {
    const int w = q >> 4, s = 2 * (q & 15);
    const uint64_t lo = words[w] | (static_cast<uint64_t>(words[w + 1]) << 32);
    const uint64_t bases = s ? (lo >> s) | (static_cast<uint64_t>(words[w + 2]) << (64 - s)) : lo;
    fwd = mirror64(bases) >> (64 - 2 * k);
    rc = ~bases & ((1ull << (2 * k)) - 1ull);
    const int v = q >> 5;
    const uint64_t bits =
        (valid[v] | (static_cast<uint64_t>(valid[v + 1]) << 32)) >> (q & 31);
    const uint64_t bad = ~bits & ((1ull << k) - 1ull);
    run = bad ? k - 1 - (63 - __clzll(bad)) : k;
  }

  // One base on: stage base p becomes the window's last.
  __device__ __forceinline__ void roll(const unsigned* words, const unsigned* valid, int p, int k) {
    const uint64_t b = (words[p >> 4] >> (2 * (p & 15))) & 3u;
    fwd = ((fwd << 2) | b) & ((1ull << (2 * k)) - 1ull);
    rc = (rc >> 2) | ((b ^ 3ull) << (2 * k - 2));
    run = ((valid[p >> 5] >> (p & 31)) & 1u) ? run + 1 : 0;
  }
};

// (row, column) of output i < 2^63 of the flat [rows, width] index:
// mulhi(i, recip) with recip = reciprocal(width) is i / width or one less,
// so one correction makes it exact.
__device__ __forceinline__ void row_col(long long i, long long width, unsigned long long recip,
                                        long long* r, long long* c) {
  long long q = static_cast<long long>(__umul64hi(static_cast<unsigned long long>(i), recip));
  long long m = i - q * width;
  if (m >= width) {
    ++q;
    m -= width;
  }
  *r = q;
  *c = m;
}

// Stages the warp's tile of src's rows in its slice of `stage` (n_stage =
// stage_words<RUN>(src.width(), src.k) words of codes, then n_stage / 2
// words of validity bits, a slice a warp) and fills this thread's run.
// Every lane of the warp calls it (one warp barrier).
template <int RUN, class Src>
__device__ __forceinline__ void tile_run(unsigned* stage, long long n_stage, const Src& src,
                                         long long rows, unsigned long long recip,
                                         Run<RUN>* out) {
  const int k = src.k;
  const long long stride = src.stride;
  const long long width = src.width();
  const long long n = rows * width;
  const int lane = threadIdx.x & 31;
  const long long t0 =
      (static_cast<long long>(blockIdx.x) * dna13::BLOCK + (threadIdx.x & ~31)) * RUN;
  out->count = 0;
  if (t0 >= n) return;
  unsigned* words_s = stage + (threadIdx.x >> 5) * (n_stage + n_stage / 2);
  unsigned* valid = words_s + n_stage;
  // the tile's first and last outputs' (row, column), its first staged
  // base and its words
  long long r0, c0, r1, c1;
  row_col(t0, width, recip, &r0, &c0);
  row_col((t0 + 32 * RUN < n ? t0 + 32 * RUN : n) - 1, width, recip, &r1, &c1);
  const long long base = src.stage_base(r0 * stride + c0);
  const long long end = r1 * stride + c1 + k - base;
  const int words = static_cast<int>(((end + 15) / 16 + 4 + 7) / 8 * 8);
  src.stage(words_s, valid, base, words, lane);
  __syncwarp();

  out->first = t0 + static_cast<long long>(lane) * RUN;
  const long long left = n - out->first;
  out->count = left <= 0 ? 0 : (left < RUN ? static_cast<int>(left) : RUN);
  if (!out->count) return;
  long long r = r0, c = c0 + static_cast<long long>(lane) * RUN;
  if (c >= width) {  // c < width + 32 RUN: one row on, or a 32-bit division
    if (width > 32 * RUN) {
      r += 1;
      c -= width;
    } else {
      const unsigned d = static_cast<unsigned>(c) / static_cast<unsigned>(width);
      r += d;
      c -= static_cast<long long>(d) * width;
    }
  }
  const int cross = static_cast<int>(stride - width) + 1;  // bases from a row's last window on
  int q = static_cast<int>(r * stride + c - base);
  Window win(words_s, valid, q, k);
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    if (j > 0 && j < out->count) {
      int steps = 1;
      if (++c == width) {
        c = 0;
        steps = cross;
      }
      for (int s = 0; s < steps; ++s, ++q) win.roll(words_s, valid, q + k, k);
    }
    out->fwd[j] = win.fwd;
    out->rc[j] = win.rc;
    out->ok[j] = j < out->count && win.run >= k;
  }
}

// Stores a run's values: 8-byte stores when it is whole and RUN even
// (first is a multiple of RUN), else one 4-byte store an output; streamed
// past L2.
template <int RUN>
__device__ __forceinline__ void store_run(unsigned* __restrict__ out, long long first, int count,
                                          const unsigned (&v)[RUN]) {
  if (RUN % 2 == 0 && count == RUN && (reinterpret_cast<uintptr_t>(out) & 7) == 0) {
    uint2* o = reinterpret_cast<uint2*>(out + first);
#pragma unroll
    for (int j = 0; j < RUN / 2; ++j) __stcs(o + j, make_uint2(v[2 * j], v[2 * j + 1]));
  } else {
#pragma unroll
    for (int j = 0; j < RUN; ++j)
      if (j < count) __stcs(out + first + j, v[j]);
  }
}

}  // namespace dna23
