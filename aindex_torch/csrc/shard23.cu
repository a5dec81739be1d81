// K12 shardresolve: one index shard's part of a verified query against the
// slot-sharded sparse index, in two entries around the two sums over the
// index axis (all_reduce; parallel/query23.py):
//   shardowner  for each key, the owner node of the MPHF walk from the
//               replicated g-values (probe.cuh Mphf::owner: fmix64 triple
//               hash, three 2-bit g-values, sum % 3), then this shard's
//               slot of the node when the node lies in its node range
//               [node_lo, node_lo + n_nodes), else 0;
//   shardverify for each summed slot in this shard's slot range [slot_lo,
//               slot_lo + n_slots), the checker verify (checker == key and
//               valid) and the tf, else 0, with a found flag.
// The keys are codes (int64, optionally masked), made canonical (min of
// code and reverse complement) in the kernel when asked, or the windows of
// packed rows (coverage: row r of stride bases holds its windows at r *
// stride + j, j < stride - k).
//
// Replaces aindex_tpu/kernels/lookup.py:124 mphf_owner_node and the local
// body of parallel/query23.py:62 resolve23_sharded (its node-range slot
// read, its slot-range verify), with the canonicalisation of :138-140 and,
// for coverage, the windows of index/sparse23.py:45 _extract_windows fused
// in. Node ids stay 64-bit (aindex_tpu casts them to int32; the two agree
// below 2^31 nodes).
//
// Bound: random reads of device memory. The owner reads three g-words of a
// ~10 MB g-vector (L2 holds it) and, on the shard that owns the node, one
// 4-byte slot; the verify reads one 8-byte checker word and one 4-byte tf
// on the shard that owns the slot. Each random read costs a 32-byte
// sector. Design: one thread per key; a shard reads its tables only for
// the keys it owns, so the table reads per key do not grow with the shard
// count; the 64-bit remainders hide under the memory latency.
#include "probe.cuh"

namespace {

__global__ void owner_kernel(probe::Mphf e, const int* __restrict__ slots_local, long long node_lo,
                             long long n_nodes, const long long* __restrict__ codes,
                             const unsigned* __restrict__ packed,
                             const unsigned char* __restrict__ vbits, long long n_words,
                             long long stride, int k, bool canonical, long long n,
                             long long* __restrict__ key_out, unsigned char* __restrict__ fwd_out,
                             unsigned char* __restrict__ valid_out, int* __restrict__ slot_part) {
  const long long width = stride - k;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    uint64_t code;
    if (codes != nullptr) {
      code = static_cast<uint64_t>(codes[i]);
    } else {
      const long long r = i / width;
      const bool ok = dna23::packed_window64(packed, vbits, n_words, r * stride + (i - r * width),
                                             k, &code);
      valid_out[i] = ok ? 1 : 0;
    }
    uint64_t key = code;
    if (canonical) {
      const uint64_t rc = dna23::revcomp64(code, k);
      key = code < rc ? code : rc;
      if (fwd_out != nullptr) fwd_out[i] = code <= rc ? 1 : 0;
    }
    if (key_out != nullptr) key_out[i] = static_cast<long long>(key);
    const long long local = static_cast<long long>(e.owner(key)) - node_lo;
    slot_part[i] = (local >= 0 && local < n_nodes) ? slots_local[local] : 0;
  }
}

__global__ void verify_kernel(const int* __restrict__ slot, const unsigned* __restrict__ tf_local,
                              const unsigned long long* __restrict__ checker_local,
                              long long slot_lo, long long n_slots,
                              const long long* __restrict__ key,
                              const unsigned char* __restrict__ valid, long long n,
                              unsigned* __restrict__ tf_part, int* __restrict__ found_part) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const long long s = static_cast<long long>(slot[i]) - slot_lo;
    const bool ok = s >= 0 && s < n_slots && (valid == nullptr || valid[i] != 0) &&
                    checker_local[s] == static_cast<unsigned long long>(key[i]);
    tf_part[i] = ok ? tf_local[s] : 0u;
    found_part[i] = ok ? 1 : 0;
  }
}

}  // namespace

DNA13_EXPORT_ERROR_STRING

// g uint32[ceil(3 domain / 16)], the replicated g-values; slots_local
// int32[n_nodes], this shard's node -> slot range from node_lo. Keys:
// codes int64[n] (uint64 bits) or, codes null, the n = rows * (stride - k)
// windows of packed uint32[n_words] / vbits uint8[2 n_words] (valid_out
// uint8[n] then receives each window's validity). canonical: probe
// min(code, revcomp) (fwd_out uint8[n], if not null, receives code <=
// revcomp). key_out int64[n], if not null, receives the probed key.
// slot_part int32[n]. Returns cudaGetLastError() after the launch.
extern "C" int shardowner(const void* g, const void* slots_local, long long node_lo,
                          long long n_nodes, unsigned long long domain, unsigned long long seed,
                          const void* codes, const void* packed, const void* vbits,
                          long long n_words, long long stride, int k, int canonical, long long n,
                          void* key_out, void* fwd_out, void* valid_out, void* slot_part,
                          void* stream) {
  if (n <= 0) return 0;
  if (domain == 0 || k < 1 || k > 31 || (codes == nullptr && (packed == nullptr ||
                                                               valid_out == nullptr ||
                                                               stride <= k)))
    return probe::BAD;
  probe::Mphf e{static_cast<const unsigned*>(g), nullptr, 0, domain, seed};
  owner_kernel<<<dna13::grid_for(n), dna13::BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      e, static_cast<const int*>(slots_local), node_lo, n_nodes,
      static_cast<const long long*>(codes), static_cast<const unsigned*>(packed),
      static_cast<const unsigned char*>(vbits), n_words, stride, k, canonical != 0, n,
      static_cast<long long*>(key_out), static_cast<unsigned char*>(fwd_out),
      static_cast<unsigned char*>(valid_out), static_cast<int*>(slot_part));
  return static_cast<int>(cudaGetLastError());
}

// slot int32[n], the slots summed over the index axis; tf_local
// uint32[n_slots] and checker_local uint64[n_slots], this shard's slot
// range from slot_lo; key int64[n]; valid uint8[n] or null. Out:
// tf_part uint32[n], found_part int32[n]. Returns cudaGetLastError().
extern "C" int shardverify(const void* slot, const void* tf_local, const void* checker_local,
                           long long slot_lo, long long n_slots, const void* key,
                           const void* valid, long long n, void* tf_part, void* found_part,
                           void* stream) {
  if (n <= 0) return 0;
  verify_kernel<<<dna13::grid_for(n), dna13::BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(slot), static_cast<const unsigned*>(tf_local),
      static_cast<const unsigned long long*>(checker_local), slot_lo, n_slots,
      static_cast<const long long*>(key), static_cast<const unsigned char*>(valid), n,
      static_cast<unsigned*>(tf_part), static_cast<int*>(found_part));
  return static_cast<int>(cudaGetLastError());
}
