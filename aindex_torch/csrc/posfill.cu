// K9 posfill: one chunk of the positional index's fill (fill.cuh), dense
// or on the quotient cuckoo table.
//
// Replaces aindex_tpu/index/positional.py:47 _scatter_chunk (and :77, its
// donated jit) with the window -> slot step of its callers fused in:
// dense, the forward code of the window (positional.py:171-177,
// kernels/encode.py:98), read by csrc/dna23.cuh's packed_window64, the
// window of csrc/dna13.cuh widened to any k <= 31; sparse, the verified
// slot of the quotient cuckoo table under the index's query rule
// (positional.py:208-216, index/sparse23.py:371 _resolve ->
// index/quotcuckoo.py:378 quot_query), K6's bucket probe (probe.cuh).
//
// The second entry, posfill_pairs, is the receive side of the mesh build's
// exchange (fill.cuh pairs()): it replaces the _scatter_chunk calls of
// aindex_tpu/parallel/positional.py:119-182 on the records a data shard
// receives (alltoall) or gathers (allgather).
//
// Bound: bytes. The chunk comes in packed (0.375 bytes a base), each valid
// window writes one 8-byte position, and each distinct slot reads its
// 8-byte offset and reads and writes its 4-byte cursor; the sparse probe
// adds one 64-byte bucket of the quotient table's records per window. The
// design (fill.cuh, on csrc/onesweep.cuh) spends most of its time in the
// sort: each pass reads and writes every live key once (16 bytes a valid
// window, four passes for the dense 13-mer slots, three for a sparse
// index's), and the fill reads each sorted key once, reads an offset and a
// cursor a run and writes the cursor back: 7 launches a dense chunk and 6
// a sparse one. On the dense table (512 MB of offsets, 256 MB of cursors)
// each of those and each position is a random 32-byte sector.
#include "fill.cuh"

DNA13_EXPORT_ERROR_STRING

// p null: dense mode, slot = the forward code of the k-mer (k <= 16; u and
// rule unused). Otherwise the quotient table (probe::Buckets' p and u) under
// rule CANON or FWD_RC. The other arguments as fill::run takes them.
extern "C" int posfill(const void* const* p, const unsigned long long* u, const void* packed,
                       const void* vbits, long long n_words, int k, long long off, int rule,
                       long long n_slots, int slot_bits, int idx_bits, const void* offsets,
                       void* cursor, void* positions, long long total, void* scratch,
                       void* stream) {
  if (p == nullptr)
    return fill::run<probe::Dense, probe::KEYS>(probe::Dense{}, 16, packed, vbits, n_words, k,
                                                off, n_slots, slot_bits, idx_bits, offsets,
                                                cursor, positions, total, scratch,
                                                static_cast<cudaStream_t>(stream));
  return fill::sparse<probe::Buckets>(p, u, packed, vbits, n_words, k, off, rule, n_slots,
                                   slot_bits, idx_bits, offsets, cursor, positions, total,
                                   scratch, stream);
}

// rec int64[n_src, cols]: packed records ((slot + 1) << 24) | delta (packed
// != 0) or slot ids (-1 for none); roff int64[n_src], each source's first
// window position; this shard's slots are [lo, lo + n_slots), offsets and
// cursor indexed from lo. The other arguments as fill::run takes them, for
// n_src * cols items.
extern "C" int posfill_pairs(const void* rec, long long n_src, long long cols, int packed,
                             const void* roff, long long lo, long long n_slots, int slot_bits,
                             int idx_bits, const void* offsets, void* cursor, void* positions,
                             long long total, void* scratch, void* stream) {
  return fill::pairs(rec, n_src, cols, packed, roff, lo, n_slots, slot_bits, idx_bits, offsets,
                     cursor, positions, total, scratch, static_cast<cudaStream_t>(stream));
}
