// K1 count13_packed: fused unpack -> 13-mer windows -> scatter-add into the
// dense uint32[4^13] count table, one packed ingest chunk per launch.
//
// Replaces aindex_tpu/kernels/count.py:69 count_batch_13_packed (with
// scatter_count_into, :45), which JAX lowers to a masked scatter-add.
//
// Bound: the atomics. A 2^22-base chunk reads 1.5 MB of packed input, but
// its 4M windows each do one 4-byte atomicAdd at a random address of a
// 256 MB table, far beyond the 50 MB L2. Design: one thread per window
// position; the window is rebuilt from at most two packed words and three
// validity bytes (neighbouring threads share them through L1), and invalid
// windows issue no atomic at all. The sum does not depend on the order of
// the atomics, so the result is exact; uint32 wraps as JAX's add does.
#include "dna13.cuh"

namespace {

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
