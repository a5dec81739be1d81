// The dense count kernels: K1 count13_packed, K15 scatter_count and K16
// count13_rows, each a scatter-add into a uint32 count table.
//
// K1 count13_packed: fused unpack -> 13-mer windows -> scatter-add into the
// dense uint32[4^13] count table, one packed ingest chunk per launch.
// Replaces aindex_tpu/kernels/count.py:69 count_batch_13_packed (with
// scatter_count_into, :45), which JAX lowers to a masked scatter-add.
//
// K15 scatter_count: given codes and a valid mask -> a fresh table.
// Replaces aindex_tpu/kernels/count.py:31 scatter_count.
//
// K16 count13_rows: ASCII rows -> forward k-mer windows (k <= 16) ->
// scatter-add into the table in place. Replaces
// aindex_tpu/kernels/count.py:54 count_batch_13 (jitted with donation as
// index/dense13.py:29 _count_step).
//
// Bound: the atomics. A 2^22-base chunk reads 1.5 MB of packed input (4 MB
// as ASCII rows), but its 4M windows each do one 4-byte atomicAdd at a
// random address of a 256 MB table, far beyond the 50 MB L2. Design: K1
// takes one thread per window position, rebuilt from at most two packed
// words and three validity bytes (neighbouring threads share them through
// L1); K15 one thread per code; K16 one thread per segment of SEG windows
// of a row, which rolls the code one byte at a time and counts the run of
// valid bases, so a window is counted once the run reaches k and no
// [B, L] window tensor exists. Invalid windows issue no atomic at all. The
// sum does not depend on the order of the atomics, so the result is exact;
// uint32 wraps as JAX's add does.
//
// K15 and K16 index as JAX's scatter with mode="drop" does
// (dna13::scatter_index): a code is cast to int32, a negative index gains
// the table length, anything outside the table is dropped. So with k = 16
// a code >= 2^31 lands at code - 2^32 + space when that is >= 0.
#include "dna13.cuh"

namespace {

// windows of one row a K16 thread counts
constexpr int SEG = 64;

__global__ void count13_packed_kernel(unsigned* __restrict__ counts,
                                      const unsigned* __restrict__ packed,
                                      const unsigned char* __restrict__ vbits,
                                      long long n_words) {
  const long long n_win = 16 * n_words - (dna13::K - 1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < n_win; p += stride) {
    unsigned code;
    if (dna13::packed_window(packed, vbits, n_words, p, &code)) atomicAdd(counts + code, 1u);
  }
}

__global__ void scatter_count_kernel(unsigned* __restrict__ counts, const int* __restrict__ codes,
                                     const unsigned char* __restrict__ valid, long long n,
                                     long long space) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const unsigned w = valid[i];
    long long at;
    if (w != 0u && dna13::scatter_index(static_cast<unsigned>(codes[i]), space, &at))
      atomicAdd(counts + at, w);
  }
}

__global__ void count13_rows_kernel(unsigned* __restrict__ counts,
                                    const unsigned char* __restrict__ ascii, long long rows,
                                    long long len, int k, long long space) {
  const long long n_win = len - k + 1;
  const long long segs = (n_win + SEG - 1) / SEG;
  const unsigned mask = k >= 16 ? 0xFFFFFFFFu : (1u << (2 * k)) - 1u;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < rows * segs; t += stride) {
    const long long r = t / segs;
    const long long w0 = (t - r * segs) * SEG;
    const long long end = (w0 + SEG < n_win ? w0 + SEG : n_win) + k - 1;
    const unsigned char* row = ascii + r * len;
    unsigned code = 0u;
    int run = 0;  // valid bases read so far that end at p, at most k counted
    for (long long p = w0; p < end; ++p) {
      const unsigned b = dna13::ascii_code(row[p]);
      code = ((code << 2) | (b & 3u)) & mask;
      run = b < 4u ? (run < k ? run + 1 : k) : 0;
      long long at;
      if (run == k && dna13::scatter_index(code, space, &at)) atomicAdd(counts + at, 1u);
    }
  }
}

}  // namespace

DNA13_EXPORT_ERROR_STRING

// counts: uint32[4^13], updated in place. packed: uint32[n_words].
// vbits: uint8[2 * n_words]. Returns cudaGetLastError() after the launch.
extern "C" int count13_packed(void* counts, const void* packed, const void* vbits,
                              long long n_words, void* stream) {
  const long long n_win = 16 * n_words - (dna13::K - 1);
  if (n_win <= 0) return cudaSuccess;
  count13_packed_kernel<<<dna13::grid_for(n_win), dna13::BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(counts), static_cast<const unsigned*>(packed),
      static_cast<const unsigned char*>(vbits), n_words);
  return static_cast<int>(cudaGetLastError());
}

// counts: uint32[space], zeroed by the caller, 1 <= space < 2^31. codes:
// int32[n] (uint32 bit patterns). valid: bool or uint8[n], each adding its
// value. Returns cudaGetLastError() after the launch.
extern "C" int scatter_count(void* counts, const void* codes, const void* valid, long long n,
                             long long space, void* stream) {
  if (space < 1 || space >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return cudaSuccess;
  scatter_count_kernel<<<dna13::grid_for(n), dna13::BLOCK, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(counts), static_cast<const int*>(codes),
      static_cast<const unsigned char*>(valid), n, space);
  return static_cast<int>(cudaGetLastError());
}

// counts: uint32[space], updated in place, 1 <= space < 2^31. ascii:
// uint8[rows, len], row-major; 1 <= k <= 16. Returns cudaGetLastError()
// after the launch.
extern "C" int count13_rows(void* counts, const void* ascii, long long rows, long long len,
                            int k, long long space, void* stream) {
  if (k < 1 || k > 16 || space < 1 || space >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || len < k) return cudaSuccess;
  const long long threads = rows * ((len - k + 1 + SEG - 1) / SEG);
  count13_rows_kernel<<<dna13::grid_for(threads), dna13::BLOCK, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(counts), static_cast<const unsigned char*>(ascii), rows, len, k,
      space);
  return static_cast<int>(cudaGetLastError());
}
