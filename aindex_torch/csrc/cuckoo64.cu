// K10 cuckoo64: the wide cuckoo engine of the sparse index, for (n, k)
// that the quotient table does not take (k <= 30): verified key -> (tf,
// slot) on the wide table's rows as bucketed records (probe.cuh
// probe::Buckets, kernels/cuckoo.py CuckooTables.from_host), with three
// entries on it: the query (cuckoo64), the coverage (cuckoocov64) and the
// positional fill (cuckoofill64, fill.cuh).
//
// Replaces aindex_tpu/index/cuckoo.py:142 cuckoo_query, with the rules of
// index/sparse23.py:553 _resolve_device, the windows of :45
// _extract_windows -> :172 SharedQueryOps._coverage_ascii, and the
// window -> slot step of index/positional.py:205-216 on this engine.
//
// JAX reads one or two 16-byte (key_lo, key_hi, tf, slot) rows a key at
// mix64(key ^ seed) & (m - 1) of each half, the second on a first miss:
// 1.26 random sectors a present key and 2 an absent one, from a table of
// 2^25 rows (512 MiB) at E. coli scale (k = 29, 10,568,899 keys). Bound:
// random reads of device memory. Each probe here reads one aligned 64-byte
// bucket (2^23 buckets, 512 MiB), and a second only for a key whose bucket
// overflowed, about 1% at that scale; the record holds the slot. Design:
// one thread per key or window (probe.cuh).
#include "fill.cuh"

DNA13_EXPORT_ERROR_STRING

// p = {records}: int32[n_buckets * 4, 4]; u: probe.cuh Buckets.
PROBE_QUERY_ENTRY(cuckoo64, probe::Buckets)
PROBE_COVERAGE_ENTRY(cuckoocov64, probe::Buckets)
FILL_ENTRY(cuckoofill64, probe::Buckets)
