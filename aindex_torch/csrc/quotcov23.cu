// K7 quotcov23: per-position k-mer coverage of many rows of packed ingest
// at once in the quotient cuckoo table: unpack -> window -> the query rule
// -> the bucket probe -> valid mask -> cutoff, uint32[rows, stride - k]
// out (probe.cuh coverage_kernel on probe::Buckets).
//
// Replaces aindex_tpu/index/quotcuckoo.py:353 quot_tf_windows_packed, the
// fused coverage kernel of the sparse index (and the cutoff that
// aindex_tpu/index/sparse23.py:449-451 applies to its result), and, for
// reference-keyed indexes, the windows -> _resolve_tf_device -> cutoff of
// SharedQueryOps._coverage_ascii (sparse23.py:172-182).
//
// Its entry quotcov23_rows replaces aindex_tpu/index/quotcuckoo.py:329
// quot_tf_windows: the same coverage from ASCII rows (uint8[B, L] ->
// uint32[B, L - k + 1]), canonical probes, no cutoff (probe.cuh
// coverage_kernel on a dna23::AsciiSource).
//
// Bound: random reads of the table, as in quot23: one aligned 64-byte
// bucket a window (a second for the ~1% of keys whose bucket overflowed);
// the packed input is 0.375 bytes a base (ASCII rows 1 byte) and read
// coalesced. Design (both entries): a warp a tile of 32 x 2 consecutive
// windows (Buckets::RUN), its bases staged in shared memory with 16-byte
// loads (ASCII bytes coded to 2-bit codes and validity bits as they are
// staged), each thread's two windows rolled along the stage and their
// buckets loaded together, the bucket matched by selects in registers.
#include "probe.cuh"

DNA13_EXPORT_ERROR_STRING

PROBE_COVERAGE_ENTRY(quotcov23, probe::Buckets)
PROBE_COVERAGE_ROWS_ENTRY(quotcov23_rows, probe::Buckets)
