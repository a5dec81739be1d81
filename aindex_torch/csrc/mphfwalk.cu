// K11 mphfwalk: the MPHF walk, the sparse index's engine for k = 31 (and
// any (n, k) the cuckoo tables do not take): per key the fmix64 triple
// hash with unsigned % domain, three 2-bit g-value reads, the owner node
// by (sum % 3), then the owner node's record: the checker verify, the tf
// and the slot (probe.cuh probe::Mphf), with three entries on it: the
// query (mphfwalk), the coverage (mphfcov) and the positional fill
// (mphffill, fill.cuh).
//
// Replaces aindex_tpu/kernels/lookup.py:100 mphf_lookup (with :70 mix64
// and :83 hash_triple) and index/sparse23.py:51 _query_kernel, with the
// rules of :553 _resolve_device, the windows of :45 _extract_windows ->
// :172 SharedQueryOps._coverage_ascii, and the window -> slot step of
// index/positional.py:205-216 on this engine. Node ids stay 64-bit, where
// lookup.py:115-121 casts them to int32.
//
// Bound: random reads of device memory. At E. coli scale (k = 31: n =
// 10,861,460 keys, a domain of ~4.45M, ~13.36M nodes) the g-vector is 3.3 MB
// and L2 holds it; the node records (probe::Mphf, 16 bytes a node, 214 MB)
// do not fit. Design: one thread per key or window; the three g-words,
// then one 16-byte record of the owner node (checker key, tf, slot; one
// 32-byte sector) in place of JAX's node -> slot read (53 MB) followed by
// the checker (87 MB) and tf (43 MB) reads: one random DRAM sector a key
// in one dependent round, not ~2.5 in three. The three 64-bit remainders
// (a few dozen instructions each) hide under the record's latency: taken
// by a multiply with a reciprocal instead, the E. coli-scale walk measured
// within 0.3% (PERF.md §6).
#include "fill.cuh"

DNA13_EXPORT_ERROR_STRING

// p = {g_packed, records}: uint32[ceil(3 domain / 16)], int32[3 domain,
// 4] (kernels/lookup.py walk_records); u = {n, domain, seed}.
PROBE_QUERY_ENTRY(mphfwalk, probe::Mphf)
PROBE_COVERAGE_ENTRY(mphfcov, probe::Mphf)
FILL_ENTRY(mphffill, probe::Mphf)
