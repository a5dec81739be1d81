// K2 total13: the fused forward + reverse-complement table,
// out[c] = tf[c] + tf[revcomp13(c)] over all 4^13 codes, wrapping modulo
// 2^32 as JAX's uint32 add does.
//
// Replaces aindex_tpu/index/dense13.py:83 _build_total_table (JAX: arange,
// revcomp_code13, one full-table permutation gather, add).
//
// Bound: device memory. It reads 256 MB in order, 256 MB by the revcomp
// permutation, and writes 256 MB. Design: one thread per code; the
// coalesced read and write are full rate, and the permuted read of a warp
// touches 32 codes whose low fields differ, which after the mirror are
// high fields: 32 distant sectors. That gather is the cost; a tiled
// transpose through shared memory is the known fix, left for later.
#include "dna13.cuh"

namespace {

__global__ void total13_kernel(const unsigned* __restrict__ tf, unsigned* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       c < dna13::SPACE; c += stride) {
    out[c] = tf[c] + tf[dna13::revcomp13(static_cast<unsigned>(c))];
  }
}

}  // namespace

DNA13_EXPORT_ERROR_STRING

// tf, out: uint32[4^13], distinct buffers. Returns cudaGetLastError().
extern "C" int total13(const void* tf, void* out, void* stream) {
  total13_kernel<<<dna13::grid_for(dna13::SPACE), dna13::BLOCK, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(tf), static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
