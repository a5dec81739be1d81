// K2 total13: the fused forward + reverse-complement table,
// out[c] = tf[c] + tf[revcomp13(c)] over all 4^13 codes, wrapping modulo
// 2^32 as JAX's uint32 add does.
//
// Replaces aindex_tpu/index/dense13.py:83 _build_total_table (JAX: arange,
// revcomp_code13, one full-table permutation gather, add).
//
// Bound: device memory. It reads 256 MB and writes 256 MB at the least.
// Read one thread a code, the revcomp read of a warp falls on 32 distant
// sectors (reverse complement moves low digits into high ones), so the
// design pairs tiles. Write a code c as five digit fields from the top:
// Hh (3 digits), Hl (3), M (1), Lh (3), Ll (3). Then revcomp13(c) has the
// fields rc3(Ll), rc3(Lh), 3 - M, rc3(Hl), rc3(Hh), where rc3 is the
// reverse complement of three digits. A tile T(Hl, M, Lh)
// is 64 rows (Hh) of 64 contiguous codes (Ll, 256 bytes); the revcomp of
// its row h, column l lies in the partner tile T(rc3(Lh), 3 - M, rc3(Hl)) at
// row rc3(l), column rc3(h). Since M != 3 - M the pairs are disjoint: the
// tile with M < 2 leads, one block a pair, 8192 blocks. A block loads both
// tiles with coalesced row reads into shared memory, each row r stored at
// row rc3(r) of a 65-word stride, so that
//   out_X[r][c] = sX[rc3(r)][c] + sY[c][rc3(r)]
// for the tile X and its partner Y alike: a row read and a column read of
// shared memory, each on 32 distinct banks (the padding word). Every input
// byte is read once and every output byte written once, the bound's count.
// Rows are read and written as 4-byte words, 128 bytes a warp: a 16-byte
// load would store four words a lane into the padded rows, on colliding
// banks.
//
// The half mode (C entry total13_half) writes the leading tiles alone: the
// totals of the codes with M < 2, which hold every value of the table once
// (out[revcomp13(c)] = out[c]), at dna13::half_index(c) = (Hh, Hl, M, Lh, Ll)
// with M's high bit dropped, a uint32[2^25] table that gather13_half reads.
// A leading tile's row Hh is then 64 contiguous words at
// (Hh << 19) | (Hl << 13) | (M << 12) | (Lh << 6). It reads as much and
// writes half as much.
#include "dna13.cuh"

namespace {

constexpr int T = 64;                    // rows and columns of a tile
constexpr int STRIDE = T + 1;            // shared words a tile row
constexpr int TOTAL_BLOCK = 256;
constexpr int ROWS = T / (TOTAL_BLOCK / 32);   // tile rows a warp moves
constexpr int PAIRS = T * 2 * T;         // leading tiles: Hl, M < 2, Lh

// Reverse complement of a 3-digit field: digits reversed, each complemented.
__device__ __forceinline__ unsigned rc3(unsigned x) {
  return (((x & 3u) << 4) | (x & 12u) | (x >> 4)) ^ 63u;
}

template <bool HALF>
__global__ void __launch_bounds__(TOTAL_BLOCK)
    total13_kernel(const unsigned* __restrict__ tf, unsigned* __restrict__ out) {
  __shared__ unsigned s[2][T * STRIDE];
  const unsigned lh = blockIdx.x & 63u, m = (blockIdx.x >> 6) & 1u, hl = blockIdx.x >> 7;
  // a tile's first code (row Hh = 0, column Ll = 0): the leader, its partner
  const unsigned base[2] = {(hl << 14) | (m << 12) | (lh << 6),
                            (rc3(lh) << 14) | ((3u - m) << 12) | (rc3(hl) << 6)};
  // where the leading tile's rows go in the half table, 2^19 words apart
  const unsigned half_base = (hl << 13) | (m << 12) | (lh << 6);
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * ROWS;
  unsigned v[2][ROWS][2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        v[t][r][h] = tf[base[t] + (static_cast<unsigned>(row0 + r) << 20) + h * 32 + lane];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        s[t][rc3(row0 + r) * STRIDE + h * 32 + lane] = v[t][r][h];
  __syncthreads();
#pragma unroll
  for (int t = 0; t < (HALF ? 1 : 2); ++t)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const unsigned rr = rc3(row0 + r);
      const unsigned dst = HALF ? half_base + (static_cast<unsigned>(row0 + r) << 19)
                                : base[t] + (static_cast<unsigned>(row0 + r) << 20);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = h * 32 + lane;
        out[dst + c] = s[t][rr * STRIDE + c] + s[1 - t][c * STRIDE + rr];
      }
    }
}

template <bool HALF>
int launch(const void* tf, void* out, void* stream) {
  total13_kernel<HALF><<<PAIRS, TOTAL_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(tf), static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

DNA13_EXPORT_ERROR_STRING

// tf, out: uint32[4^13], distinct buffers. Returns cudaGetLastError().
extern "C" int total13(const void* tf, void* out, void* stream) {
  return launch<false>(tf, out, stream);
}

// tf: uint32[4^13]; out: uint32[2^25], the half table. Returns
// cudaGetLastError().
extern "C" int total13_half(const void* tf, void* out, void* stream) {
  return launch<true>(tf, out, stream);
}
