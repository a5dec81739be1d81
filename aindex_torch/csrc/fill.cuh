// The positional fill of one packed chunk (K9, and the fill entries of
// K10 and K11): every valid window i, at blob position p = off + i, with
// slot s, writes p + 1 to positions[offsets[s] + cursor[s] + rank], where
// rank is the window's order among the chunk's windows of slot s,
// ascending by position; then cursor[s] advances by the number of those
// windows. Positions within a slot therefore ascend across chunks, bit for
// bit as aindex_tpu's (aindex_tpu/index/positional.py:47 _scatter_chunk).
//
// The window -> slot step is the engine's (probe.cuh): the forward code
// of a k <= 16 window (Dense), or the verified slot of the sparse index's
// query rule (Quot, Cuckoo, Mphf). The steps, all plain kernels on one
// stream:
//   1. one thread per window computes its slot and writes the 64-bit key
//      (slot << idx_bits) | i and a valid flag; invalid and absent windows
//      are flagged off;
//   2. a scan of the flags and a compaction keep the valid keys in window
//      order (csrc/scan.cuh);
//   3. the LSD radix sort of csrc/radix.cuh orders them on the slot bits
//      only: it is stable, so within a slot the window order, and with it
//      the position order, is kept. The keys are unique, so the sorted key
//      alone carries slot, position and order;
//   4. each sorted key finds its run's head by a binary search for
//      slot << idx_bits, takes rank = its index - the head's, and writes
//      its position; cells outside [0, total) are dropped, as JAX's
//      mode="drop" scatter drops them;
//   5. a second launch, after every write of the chunk, has each run's
//      last key add the run's length to cursor[slot] (a wrapping int32
//      add, as JAX's). No thread reads a cursor that another thread of the
//      same launch writes.
// The valid count stays on the device (counters[0]); the host never waits
// inside the chunk.
//
// pairs() is the same fill over the records the mesh build exchanges
// (aindex_tpu/parallel/positional.py:133-182): step 1 reads a record's
// slot instead of a window's, only the slots of this shard's range are
// kept, and a record's position comes from its source's first window and
// its in-chunk offset. Records are indexed in (source, offset) order, so
// the stable sort keeps the single-device order.
#pragma once

#include "probe.cuh"
#include "radix.cuh"
#include "scan.cuh"

namespace fill {

template <class E, int RULE>
__global__ void window_keys(const unsigned* __restrict__ packed,
                            const unsigned char* __restrict__ vbits, long long n_words, int k,
                            long long n_win, E e, long long n_slots, int idx_bits,
                            unsigned long long* __restrict__ keys, int* __restrict__ flags) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < n_win;
       p += step) {
    long long slot = -1;
    uint64_t code;
    if (dna23::packed_window64(packed, vbits, n_words, p, k, &code)) {
      unsigned tf;
      long long ref;
      int strand;
      if (probe::resolve<E, RULE>(e, code, k, &tf, &ref, &strand)) slot = e.slot(ref);
    }
    const bool ok = slot >= 0 && slot < n_slots;
    keys[p] = ok ? (static_cast<unsigned long long>(slot) << idx_bits) |
                       static_cast<unsigned long long>(p)
                 : 0ull;
    flags[p] = ok ? 1 : 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) flags[n_win] = 0;
}

// Index of the first of s[0, hi) that is >= key (s ascending).
__device__ __forceinline__ long long lower_bound(const unsigned long long* __restrict__ s,
                                                 long long hi, unsigned long long key) {
  long long lo = 0;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (s[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The blob position of sorted key i's original index: a chunk's window i
// lies at off + i.
struct ChunkPos {
  long long off;
  __device__ __forceinline__ long long operator()(long long i) const { return off + i; }
};

// The records of the positional exchange (parallel/positional.py), rows of
// cols entries, row r from source r, whose windows start at roff[r]:
// packed records ((slot + 1) << DELTA_BITS) | delta, a window at roff[r] +
// delta; or, unpacked, slot ids in window order, column j at roff[r] + j.
constexpr int DELTA_BITS = 24;
struct PairPos {
  const long long* rec;
  const long long* roff;
  long long cols;
  bool packed;
  __device__ __forceinline__ long long operator()(long long i) const {
    const long long r = i / cols;
    return roff[r] + (packed ? (rec[i] & ((1LL << DELTA_BITS) - 1)) : i - r * cols);
  }
};

template <class Pos>
__global__ void fill_kernel(const unsigned long long* __restrict__ s, const int* __restrict__ n_ptr,
                            int idx_bits, Pos pos, const long long* __restrict__ offsets,
                            const int* __restrict__ cursor, long long total,
                            long long* __restrict__ positions) {
  const long long n = *n_ptr;
  const unsigned long long idx_mask = (1ull << idx_bits) - 1ull;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const unsigned long long key = s[i];
    const long long slot = static_cast<long long>(key >> idx_bits);
    const long long head = lower_bound(s, i, key & ~idx_mask);
    const long long cell = offsets[slot] + static_cast<long long>(cursor[slot]) + (i - head);
    if (cell >= 0 && cell < total)
      positions[cell] = pos(static_cast<long long>(key & idx_mask)) + 1;
  }
}

// The keys of exchanged records (see PairPos): record i with slot s in
// [lo, lo + n_slots) gets the key ((s - lo) << idx_bits) | i; others
// (empty records, slot -1, other shards' slots) are flagged off.
template <bool PACKED>
__global__ void pair_keys(const long long* __restrict__ rec, long long n, long long lo,
                          long long n_slots, int idx_bits, unsigned long long* __restrict__ keys,
                          int* __restrict__ flags) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const long long r = rec[i];
    const long long slot = PACKED ? (r >> DELTA_BITS) - 1 : r;
    const long long local = slot - lo;
    const bool ok = slot >= 0 && local >= 0 && local < n_slots;
    keys[i] = ok ? (static_cast<unsigned long long>(local) << idx_bits) |
                       static_cast<unsigned long long>(i)
                 : 0ull;
    flags[i] = ok ? 1 : 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) flags[n] = 0;
}

__global__ void advance_kernel(const unsigned long long* __restrict__ s,
                               const int* __restrict__ n_ptr, int idx_bits,
                               int* __restrict__ cursor) {
  const long long n = *n_ptr;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const unsigned long long slot = s[i] >> idx_bits;
    if (i + 1 < n && (s[i + 1] >> idx_bits) == slot) continue;
    const long long head = lower_bound(s, i, slot << idx_bits);
    const unsigned run = static_cast<unsigned>(i - head + 1);
    cursor[slot] = static_cast<int>(static_cast<unsigned>(cursor[slot]) + run);
  }
}


// packed uint32[n_words] + vbits uint8[2 * n_words]: the chunk, whose
// n_win = 16 * n_words - k + 1 windows start at blob positions off + i.
// Slots run over [0, n_slots), slot_bits = bits of n_slots - 1, idx_bits =
// bits of n_win - 1, and slot_bits + idx_bits <= 64. offsets:
// int64[n_slots]; cursor: int32[n_slots], advanced in place; positions:
// int64[total], written in place. Scratch, all device memory of the
// caller: counters int32[1]; keys_a, keys_b uint64[n_win]; idx
// int32[n_win + 1]; hist int32[256 * ceil(n_win / 1024)]; sums
// int32[ceil(max(n_win + 1, 256 * ceil(n_win / 1024)) / 2048)]. Returns
// the first CUDA error of the launches, or 0.
// Steps 2-5 over the n keys in kb flagged in ix (idx int32[n + 1]): the
// compaction, the sort on the slot bits and the fill at pos(index).
template <class Pos>
int sort_and_fill(unsigned long long* ka, unsigned long long* kb, int* ix, int* cn, long long n,
                  int slot_bits, int idx_bits, Pos pos, const void* offsets, void* cursor,
                  void* positions, long long total, void* hist, void* sums, cudaStream_t s) {
  const unsigned grid = dna13::grid_for(n);
  auto* sm = static_cast<int*>(sums);
  if (int err = scan::exclusive_scan<int, int>(ix, ix, n + 1, sm, cn, s)) return err;
  scan::compact<<<grid, dna13::BLOCK, 0, s>>>(kb, ix, n, ka);
  KERNEL_CHECK();

  unsigned long long* sorted = nullptr;
  if (int err = radix::sort(ka, kb, cn, n, idx_bits, idx_bits + slot_bits,
                            static_cast<int*>(hist), sm, s, &sorted))
    return err;
  fill_kernel<Pos><<<grid, dna13::BLOCK, 0, s>>>(sorted, cn, idx_bits, pos,
                                                static_cast<const long long*>(offsets),
                                                static_cast<const int*>(cursor), total,
                                                static_cast<long long*>(positions));
  KERNEL_CHECK();
  advance_kernel<<<grid, dna13::BLOCK, 0, s>>>(sorted, cn, idx_bits, static_cast<int*>(cursor));
  KERNEL_CHECK();
  return 0;
}

// packed uint32[n_words] + vbits uint8[2 * n_words]: the chunk, whose
// n_win = 16 * n_words - k + 1 windows start at blob positions off + i.
// Slots run over [0, n_slots), slot_bits = bits of n_slots - 1, idx_bits =
// bits of n_win - 1, and slot_bits + idx_bits <= 64. offsets:
// int64[n_slots]; cursor: int32[n_slots], advanced in place; positions:
// int64[total], written in place. Scratch, all device memory of the
// caller: counters int32[1]; keys_a, keys_b uint64[n_win]; idx
// int32[n_win + 1]; hist int32[256 * ceil(n_win / 1024)]; sums
// int32[ceil(max(n_win + 1, 256 * ceil(n_win / 1024)) / 2048)]. Returns
// the first CUDA error of the launches, or 0.
template <class E, int RULE>
int run(const E& e, int max_k, const void* packed, const void* vbits, long long n_words, int k,
        long long off, long long n_slots, int slot_bits, int idx_bits, const void* offsets,
        void* cursor, void* positions, long long total, void* counters, void* keys_a,
        void* keys_b, void* idx, void* hist, void* sums, cudaStream_t s) {
  const long long n_win = 16 * n_words - k + 1;
  if (k < 1 || k > max_k || n_win <= 0 || n_win >= (1LL << 31) - 1 || n_slots <= 0 ||
      slot_bits < 1 || idx_bits < 1 || slot_bits + idx_bits > 64 ||
      (n_slots - 1) >> slot_bits != 0 || (n_win - 1) >> idx_bits != 0)
    return probe::BAD;
  auto* kb = static_cast<unsigned long long*>(keys_b);
  auto* ix = static_cast<int*>(idx);
  window_keys<E, RULE><<<dna13::grid_for(n_win), dna13::BLOCK, 0, s>>>(
      static_cast<const unsigned*>(packed), static_cast<const unsigned char*>(vbits), n_words, k,
      n_win, e, n_slots, idx_bits, kb, ix);
  KERNEL_CHECK();
  return sort_and_fill(static_cast<unsigned long long*>(keys_a), kb, ix,
                       static_cast<int*>(counters), n_win, slot_bits, idx_bits, ChunkPos{off},
                       offsets, cursor, positions, total, hist, sums, s);
}

// The receive side of the positional exchange (K9's pairs-in entry): rec
// int64[n_src, cols] as PairPos describes (packed != 0: packed records;
// else slot ids), roff int64[n_src]; the slots of [lo, lo + n_slots) are
// filled in (source, column) order, the order of the single-device fill.
// slot_bits and idx_bits as in run(), idx_bits for n_src * cols records;
// the scratch of run() for n_src * cols keys.
inline int pairs(const void* rec, long long n_src, long long cols, int packed, const void* roff,
                 long long lo, long long n_slots, int slot_bits, int idx_bits,
                 const void* offsets, void* cursor, void* positions, long long total,
                 void* counters, void* keys_a, void* keys_b, void* idx, void* hist, void* sums,
                 cudaStream_t s) {
  const long long n = n_src * cols;
  if (n_src <= 0 || cols <= 0 || n >= (1LL << 31) - 1 || n_slots <= 0 || slot_bits < 1 ||
      idx_bits < 1 || slot_bits + idx_bits > 64 || (n_slots - 1) >> slot_bits != 0 ||
      (n - 1) >> idx_bits != 0)
    return probe::BAD;
  const auto* r = static_cast<const long long*>(rec);
  auto* kb = static_cast<unsigned long long*>(keys_b);
  auto* ix = static_cast<int*>(idx);
  if (packed)
    pair_keys<true><<<dna13::grid_for(n), dna13::BLOCK, 0, s>>>(r, n, lo, n_slots, idx_bits, kb,
                                                               ix);
  else
    pair_keys<false><<<dna13::grid_for(n), dna13::BLOCK, 0, s>>>(r, n, lo, n_slots, idx_bits, kb,
                                                                ix);
  KERNEL_CHECK();
  return sort_and_fill(static_cast<unsigned long long*>(keys_a), kb, ix,
                       static_cast<int*>(counters), n, slot_bits, idx_bits,
                       PairPos{r, static_cast<const long long*>(roff), cols, packed != 0}, offsets,
                       cursor, positions, total, hist, sums, s);
}

// The sparse fill entry of an engine: rule CANON or FWD_RC.
template <class E>
int sparse(const void* const* p, const unsigned long long* u, const void* packed,
           const void* vbits, long long n_words, int k, long long off, int rule,
           long long n_slots, int slot_bits, int idx_bits, const void* offsets, void* cursor,
           void* positions, long long total, void* counters, void* keys_a, void* keys_b,
           void* idx, void* hist, void* sums, void* stream) {
  E e;
  if (E::make(p, u, &e) != 0) return probe::BAD;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rule == probe::CANON)
    return run<E, probe::CANON>(e, 31, packed, vbits, n_words, k, off, n_slots, slot_bits,
                                idx_bits, offsets, cursor, positions, total, counters, keys_a,
                                keys_b, idx, hist, sums, s);
  if (rule == probe::FWD_RC)
    return run<E, probe::FWD_RC>(e, 31, packed, vbits, n_words, k, off, n_slots, slot_bits,
                                 idx_bits, offsets, cursor, positions, total, counters, keys_a,
                                 keys_b, idx, hist, sums, s);
  return probe::BAD;
}

}  // namespace fill

#define FILL_ENTRY(NAME, ENGINE)                                                            \
  extern "C" int NAME(const void* const* p, const unsigned long long* u, const void* packed,  \
                      const void* vbits, long long n_words, int k, long long off, int rule,   \
                      long long n_slots, int slot_bits, int idx_bits, const void* offsets,    \
                      void* cursor, void* positions, long long total, void* counters,         \
                      void* keys_a, void* keys_b, void* idx, void* hist, void* sums,          \
                      void* stream) {                                                         \
    return fill::sparse<ENGINE>(p, u, packed, vbits, n_words, k, off, rule, n_slots,          \
                                slot_bits, idx_bits, offsets, cursor, positions, total,       \
                                counters, keys_a, keys_b, idx, hist, sums, stream);           \
  }
