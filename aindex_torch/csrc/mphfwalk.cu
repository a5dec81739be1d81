// K11 mphfwalk: the MPHF walk, the sparse index's engine for k = 31 (and
// any (n, k) the cuckoo tables do not take): per key the fmix64 triple
// hash with unsigned % domain, three 2-bit g-value reads, the owner node
// by (sum % 3), the node's slot, the checker verify and the tf gather
// (probe.cuh probe::Mphf), with three entries on it: the query (mphfwalk),
// the coverage (mphfcov) and the positional fill (mphffill, fill.cuh).
//
// Replaces aindex_tpu/kernels/lookup.py:100 mphf_lookup (with :70 mix64
// and :83 hash_triple) and index/sparse23.py:51 _query_kernel, with the
// rules of :553 _resolve_device, the windows of :45 _extract_windows ->
// :172 SharedQueryOps._coverage_ascii, and the window -> slot step of
// index/positional.py:205-216 on this engine. Node ids stay 64-bit, where
// lookup.py:115-121 casts them to int32.
//
// Bound: random reads of device memory: three 4-byte g-words (a 40 MB
// g-vector at E. coli scale), a 4-byte slot, an 8-byte checker word and a
// 4-byte tf per key, each in its own sector, in a chain of two dependent
// rounds (g-values, then slot, then checker and tf). Design: one thread
// per key or window; the 64-bit remainders (a few dozen instructions
// each) hide under the memory latency.
#include "fill.cuh"

DNA13_EXPORT_ERROR_STRING

// p = {g_packed, slots, checker, tf}: uint32[ceil(3 domain / 16)],
// int32[3 domain], uint64[n], uint32[n]; u = {n, domain, seed}.
PROBE_QUERY_ENTRY(mphfwalk, probe::Mphf)
PROBE_COVERAGE_ENTRY(mphfcov, probe::Mphf)
FILL_ENTRY(mphffill, probe::Mphf)
