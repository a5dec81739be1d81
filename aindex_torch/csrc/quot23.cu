// K6 quot23: verified k-mer queries in the quotient cuckoo table, one thread
// per query (probe.cuh query_kernel on probe::Quot): optional ASCII ->
// code, the query rule (keys as they are, canonical, or forward-else-
// reverse-complement), the two 8-byte (fingerprint, tf) row probes,
// optional slot-column gather and strand.
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
// Bound: random reads of device memory. Each query reads one or two 8-byte
// rows (plus a 4-byte slot) at addresses unrelated to its neighbours', from
// halves of 2^24 rows (128 MB each) at E. coli scale, far beyond the 50 MB
// L2; codes and outputs move coalesced. Design: see probe.cuh.
#include "probe.cuh"

DNA13_EXPORT_ERROR_STRING

// p = {half0, half1, slot0, slot1}: int32[m, 2] (fingerprint, tf) rows and
// int32[m] slot columns; u = {m, lb, w, m1a, m1b, m2a, m2b}.
PROBE_QUERY_ENTRY(quot23, probe::Quot)
