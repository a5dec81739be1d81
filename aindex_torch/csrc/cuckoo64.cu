// K10 cuckoo64: the wide cuckoo engine of the sparse index, for (n, k)
// that the quotient table does not take (k <= 30): verified key -> (tf,
// slot) in two 16-byte (key_lo, key_hi, tf, slot) row reads per key, rows
// mix64(key ^ seed) & (m - 1) (probe.cuh probe::Cuckoo), with three
// entries on it: the query (cuckoo64), the coverage (cuckoocov64) and the
// positional fill (cuckoofill64, fill.cuh).
//
// Replaces aindex_tpu/index/cuckoo.py:142 cuckoo_query, with the rules of
// index/sparse23.py:553 _resolve_device, the windows of :45
// _extract_windows -> :172 SharedQueryOps._coverage_ascii, and the
// window -> slot step of index/positional.py:205-216 on this engine.
//
// Bound: random reads of device memory: each probe reads one or two
// 16-byte rows, each in its own 32-byte sector, of a table of 2^24 rows
// (268 MB) at E. coli scale. Design: one thread per key or window; the
// second row only on a first miss; the row holds the slot, so the slot
// costs nothing more.
#include "fill.cuh"

DNA13_EXPORT_ERROR_STRING

// p = {table}: int32[2m, 4] rows; u = {m, seed1, seed2} (the seeds' uint64
// bits).
PROBE_QUERY_ENTRY(cuckoo64, probe::Cuckoo)
PROBE_COVERAGE_ENTRY(cuckoocov64, probe::Cuckoo)
FILL_ENTRY(cuckoofill64, probe::Cuckoo)
