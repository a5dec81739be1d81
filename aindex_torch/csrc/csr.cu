// K8 csr_offsets: the CSR offsets of the positional index, the exclusive
// int64 prefix sum of a uint32 per-slot occurrence table:
// offsets[0] = 0, offsets[i + 1] = offsets[i] + tf[i], offsets[n] = total.
//
// Replaces aindex_tpu/index/positional.py:39 _csr_offsets.
//
// Bound: bytes. The function reads 4n bytes and writes 8(n + 1); for the
// dense 13-mer table (n = 4^13) that is 805 MB, 0.24 ms at 3.35 TB/s. The
// design is csrc/scan.cuh's three-launch tile scan widened to int64 sums:
// it reads the table twice (tile sums, then the apply pass), 16n bytes
// against the bound's 12n, and writes the total from the sums pass
// straight into offsets[n].
#include "scan.cuh"

DNA13_EXPORT_ERROR_STRING

// tf: uint32[n]; offsets: int64[n + 1]; sums: int64[ceil(n / 2048)] of
// scratch (unused when n is 0). Returns the first CUDA error of the
// launches, or 0.
extern "C" int csr_offsets(const void* tf, long long n, void* offsets, void* sums,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto* out = static_cast<long long*>(offsets);
  if (n == 0) return static_cast<int>(cudaMemsetAsync(out, 0, sizeof(long long), s));
  return scan::exclusive_scan<unsigned, long long>(static_cast<const unsigned*>(tf), out, n,
                                                   static_cast<long long*>(sums), out + n, s);
}
