// K6 quot23: verified k-mer queries in the quotient cuckoo table, one thread
// per query (probe.cuh query_kernel on probe::Buckets): optional ASCII ->
// code, the query rule (keys as they are, canonical, or forward-else-
// reverse-complement), the bucket probe of the key masked to 2k bits, and
// optional slot and strand.
//
// Replaces, as one kernel with compile-time modes:
//   aindex_tpu/index/quotcuckoo.py:310 quot_tf_canonical (codes, canonical, tf)
//   aindex_tpu/index/quotcuckoo.py:296 quot_query_tf     (keys, tf)
//   aindex_tpu/index/quotcuckoo.py:378 quot_query        (keys, tf + slot)
//   aindex_tpu/index/sparse23.py:553   _resolve_device   (codes, canonical or
//                                                          forward-else-revcomp,
//                                                          tf + slot + strand)
//   aindex_tpu/index/sparse23.py:45    _extract_windows  (ASCII [B, k] rows in)
//
// The table is the quotient table's rows as bucketed records (key, tf,
// slot), each key recovered at upload by inverting its half's bijection
// (kernels/quot.py QuotTables.from_host). JAX reads one or two 8-byte
// (fingerprint, tf) rows a key, the second on a first miss, and a 4-byte
// slot column beside them: 1.24 random sectors a present key, 2 an absent
// one, and one more with the slot. Bound: random reads of device memory.
// Each query here reads one aligned 64-byte bucket (the slot in it), and a
// second only for a key whose bucket overflowed, about 1% at E. coli scale
// (9,602,528 keys: 2^23 buckets, 512 MiB, far beyond the 50 MB L2); codes
// and outputs move coalesced. Design: see probe.cuh.
#include "probe.cuh"

DNA13_EXPORT_ERROR_STRING

// p = {records}: int32[n_buckets * 4, 4]; u: probe.cuh Buckets.
PROBE_QUERY_ENTRY(quot23, probe::Buckets)
