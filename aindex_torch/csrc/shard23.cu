// K12 shardwalk: one index shard's part of a verified query against the
// node-sharded sparse index (parallel/query23.py), in one launch before the
// one sum over the index axis (all_reduce). Each shard holds the node
// records (kernels/lookup.py walk_records: checker key, tf and slot of the
// node's slot) of its node range [node_lo, node_lo + n_nodes) and the
// replicated g-values. For each key: the owner node of the MPHF walk
// (probe.cuh Mphf::owner: fmix64 triple hash, three 2-bit g-values, sum %
// 3); when the node lies in this shard's range, its one 16-byte record
// gives the raw slot, and the checker compare (with the mask and n > 0)
// gives the tf and a found flag; else all three are 0. The owner lies in
// exactly one shard's range, so the sum over the shards is that shard's
// answer. The keys are codes (int64, optionally masked), made canonical
// (min of code and reverse complement) in the kernel when asked, or the
// windows of packed rows (coverage: row r of stride bases holds its
// windows at r * stride + j, j < stride - k; an invalid window is
// masked).
//
// Replaces aindex_tpu/kernels/lookup.py:124 mphf_owner_node and the local
// body of parallel/query23.py:62 resolve23_sharded (its node-range slot
// read, its slot-range verify), with the canonicalisation of :138-140 and,
// for coverage, the windows of index/sparse23.py:45 _extract_windows fused
// in. The shard that owns a node holds its slot's checker and tf in the
// node's record, so the slot does not cross between the shards before
// the verify: one launch and one sum in place of JAX's three. Node ids
// stay 64-bit (aindex_tpu casts them to int32; the two agree below 2^31
// nodes).
//
// Bound: random reads of device memory. The walk reads three g-words of a
// ~3 MB g-vector (L2 holds it) and, on the shard that owns the node, one
// 16-byte record, one sector at the card's random-read rate (chip_smoke's
// width test: 16 and 64 bytes cost the same). Design: one thread per key
// as in mphfwalk; a shard reads its records only for the keys it owns, so
// the table reads per key do not grow with the shard count; codes, mask
// and answers stream past L2 (__ldcs / __stcs); the 64-bit remainders
// hide under the memory latency.
#include "probe.cuh"

namespace {

__global__ void walk_kernel(probe::Mphf e, long long node_lo, long long n_nodes,
                            const long long* __restrict__ codes,
                            const unsigned char* __restrict__ valid,
                            const unsigned* __restrict__ packed,
                            const unsigned char* __restrict__ vbits, long long n_words,
                            long long stride, int k, bool canonical, long long n,
                            unsigned char* __restrict__ fwd_out, int* __restrict__ out) {
  const long long width = stride - k;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    uint64_t code;
    bool ok = true;
    if (codes != nullptr) {
      code = static_cast<uint64_t>(__ldcs(codes + i));
      if (valid != nullptr) ok = __ldcs(valid + i) != 0;
    } else {
      const long long r = i / width;
      ok = dna23::packed_window64(packed, vbits, n_words, r * stride + (i - r * width), k,
                                  &code);
    }
    uint64_t key = code;
    if (canonical) {
      const uint64_t rc = dna23::revcomp64(code, k);
      key = code < rc ? code : rc;
      if (fwd_out != nullptr) fwd_out[i] = code <= rc ? 1 : 0;
    }
    const long long local = static_cast<long long>(e.owner(key)) - node_lo;
    unsigned tf = 0u;
    int slot = 0, found = 0;
    if (local >= 0 && local < n_nodes) {
      const uint4 rec = e.records[local];
      slot = static_cast<int>(rec.w);
      if (ok && e.n != 0 && probe::Mphf::holds(rec, key)) {
        tf = rec.z;
        found = 1;
      }
    }
    __stcs(out + i, static_cast<int>(tf));
    __stcs(out + n + i, slot);
    __stcs(out + 2 * n + i, found);
  }
}

}  // namespace

DNA13_EXPORT_ERROR_STRING

// g uint32[ceil(3 domain / 16)], the replicated g-values; records
// int32[n_nodes, 4], this shard's node records from node_lo; n_keys, the
// index's key count (0: every key absent). Keys: codes int64[n] (uint64
// bits) with valid uint8[n] or null, or, codes null, the n = rows * (stride
// - k) windows of packed uint32[n_words] / vbits uint8[2 n_words].
// canonical: probe min(code, revcomp) (fwd_out uint8[n], if not null,
// receives code <= revcomp). out int32[3, n]: the tf (uint32 bits), the raw
// slot and the found flag of this shard's part. Returns cudaGetLastError()
// after the launch.
extern "C" int shardwalk(const void* g, const void* records, long long node_lo, long long n_nodes,
                         unsigned long long n_keys, unsigned long long domain,
                         unsigned long long seed, const void* codes, const void* valid,
                         const void* packed, const void* vbits, long long n_words,
                         long long stride, int k, int canonical, long long n, void* fwd_out,
                         void* out, void* stream) {
  if (n <= 0) return 0;
  if (domain == 0 || k < 1 || k > 31 || n_nodes < 1 || out == nullptr ||
      (codes == nullptr && (packed == nullptr || vbits == nullptr || stride <= k)))
    return probe::BAD;
  probe::Mphf e{static_cast<const unsigned*>(g), static_cast<const uint4*>(records), n_keys,
                domain, seed};
  walk_kernel<<<dna13::grid_for(n), dna13::BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      e, node_lo, n_nodes, static_cast<const long long*>(codes),
      static_cast<const unsigned char*>(valid), static_cast<const unsigned*>(packed),
      static_cast<const unsigned char*>(vbits), n_words, stride, k, canonical != 0, n,
      static_cast<unsigned char*>(fwd_out), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
