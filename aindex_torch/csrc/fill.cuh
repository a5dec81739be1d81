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
// query rule (Buckets, Mphf). Design, on csrc/onesweep.cuh, 2 +
// passes launches on one stream (7 for the dense k = 13 table's 26 slot
// bits, 6 for a sparse index of up to 2^24 slots):
//   0. one memset zeroes the sort's counters and look-back words;
//   1. the onesweep compaction with the window -> slot step as its source:
//      each window is probed once, and only the live ones leave the
//      block, as the key (slot << idx_bits) | i, in window order, their
//      slot digits counted;
//   2. one onesweep pass per 8-bit digit of the slot bits [idx_bits,
//      idx_bits + slot_bits): the sort is stable, so within a slot the
//      window order, and with it the position order, is kept; the keys
//      are unique, so the sorted key alone carries slot, position and
//      order;
//   3. the fill (fill_kernel): a tile of sorted keys in warp rows of 32
//      flags the run starts (where the slot changes); each run's head
//      reads its slot's offset and cursor, and its base goes to the run's
//      later keys (shuffles in a row, a running value along the warp, a
//      block step across warps, a look-back across tiles); each key writes
//      its position at base + its rank in the run, cells outside [0,
//      total) dropped, as JAX's mode="drop" scatter drops them, and each
//      run's last key advances its slot's cursor by the run's length (a
//      wrapping int32 add, as JAX's).
// The live count stays on the device; the host never waits inside the
// chunk.
//
// pairs() is the same fill over the records the mesh build exchanges
// (aindex_tpu/parallel/positional.py:133-182): the compaction reads a
// record's slot instead of probing a window, keeps only the slots of this
// shard's range, and a record's position comes from its source's first
// window and its in-chunk offset. Records are indexed in (source, offset)
// order, so the stable sort keeps the single-device order.
#pragma once

#include "onesweep.cuh"
#include "probe.cuh"

namespace fill {

// The compaction's sources: item i -> (live, key (slot << idx_bits) | i).

// Window p of a packed chunk, its slot by the engine's probe.
template <class E, int RULE>
struct Windows {
  const unsigned* packed;
  const unsigned char* vbits;
  long long n_words;
  int k;
  E e;
  long long n_slots;
  int idx_bits;
  __device__ bool operator()(long long p, unsigned long long& key, unsigned&) const {
    uint64_t code;
    unsigned tf;
    long long ref;
    int strand;
    if (!dna23::packed_window64(packed, vbits, n_words, p, k, &code) ||
        !probe::resolve<E, RULE>(e, code, k, &tf, &ref, &strand))
      return false;
    const long long slot = e.slot(ref);
    key = (static_cast<unsigned long long>(slot) << idx_bits) | static_cast<unsigned long long>(p);
    return slot >= 0 && slot < n_slots;
  }
};

// The records of the positional exchange (parallel/positional.py), rows of
// cols entries, row r from source r, whose windows start at roff[r]:
// packed records ((slot + 1) << DELTA_BITS) | delta, a window at roff[r] +
// delta; or, unpacked, slot ids in window order, column j at roff[r] + j.
// Record i lives when its slot lies in [lo, lo + n_slots) (not for empty
// records, slot -1, or other shards' slots); its key holds the slot less lo.
constexpr int DELTA_BITS = 24;
template <bool PACKED>
struct Records {
  const long long* rec;
  long long lo;
  long long n_slots;
  int idx_bits;
  __device__ bool operator()(long long i, unsigned long long& key, unsigned&) const {
    const long long r = rec[i];
    const long long slot = PACKED ? (r >> DELTA_BITS) - 1 : r;
    const long long local = slot - lo;
    key = (static_cast<unsigned long long>(local) << idx_bits) | static_cast<unsigned long long>(i);
    return slot >= 0 && local >= 0 && local < n_slots;
  }
};

// The blob position of sorted key i's original index: a chunk's window i
// lies at off + i.
struct ChunkPos {
  long long off;
  __device__ __forceinline__ long long operator()(long long i) const { return off + i; }
};

// A record's position (see Records).
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

// Step 3 over the first *n_ptr sorted keys s. Key i's slot is its bits
// above idx_bits; a run is the keys of one slot, its head its first key.
// Only a run's head reads offsets[slot] and cursor[slot]; each key of the
// run writes pos(its index bits) + 1 to cell x + i, x = offsets[slot] +
// cursor[slot] - head, when the cell lies in [0, total); the run's last
// key writes cursor[slot] = x + i + 1 - offsets[slot], the old cursor plus
// the run's length (a wrapping int32 add). x goes from the head to the
// run's later keys along a warp row by shuffles, along the warp's rows in
// a register, across warps by a block step, and across tiles by look-back
// in a status column whose sums are x + BIAS: a tile holding a run start
// publishes its last run's x at once as an inclusive word (no earlier tile
// can change it), a tile without one an empty aggregate, and after its
// look-back the x it carries. Tile 0 starts with key 0, so every key finds
// its run's x, however many tiles one slot's run spans.
//
// No read of a cursor follows its write: the head reads it, the last key
// writes it. In one tile a block barrier lies between the two; across
// tiles the last key's block has x only from a status word published
// after the head's block had x, which it computed from the value its read
// returned. Offsets lie in [0, 2^60) (as any CSR's do), so x + BIAS fits a
// status word's 62 bits. Grid: tiles(cap).
constexpr long long BIAS = 1LL << 61;
template <class Pos>
__global__ void __launch_bounds__(onesweep::BLOCK)
    fill_kernel(const unsigned long long* __restrict__ s, const int* __restrict__ n_ptr,
                int idx_bits, Pos pos, const long long* __restrict__ offsets,
                int* __restrict__ cursor, long long total, long long* __restrict__ positions,
                unsigned* counter, unsigned long long* status) {
  using namespace onesweep;
  __shared__ long long s_x[WARPS];
  __shared__ int s_has[WARPS];
  __shared__ long long s_tile;
  __shared__ long long s_carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile = take_tile(counter, &s_tile);
  const long long n = *n_ptr;
  const long long tile_base = tile * TILE;
  if (tile_base >= n) return;
  const long long base = tile_base + warp * WARP_ITEMS;
  const unsigned all = 0xffffffffu;
  const unsigned upto = all >> (31 - lane);

  // every row's keys and run starts first, then the heads' reads, all in
  // flight together
  unsigned long long key[ITEMS];
  unsigned starts[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long p = base + j * 32 + lane;
    key[j] = p < n ? s[p] : 0ull;
  }
  unsigned long long before = base > 0 && base <= n ? s[base - 1] : 0ull;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long p = base + j * 32 + lane;
    const unsigned long long up = __shfl_up_sync(all, key[j], 1);
    const unsigned long long prev = lane ? up : before;
    before = __shfl_sync(all, key[j], 31);
    starts[j] =
        __ballot_sync(all, p < n && (p == 0 || (key[j] >> idx_bits) != (prev >> idx_bits)));
  }
  long long x[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    x[j] = 0;
    if (starts[j] >> lane & 1u) {
      const long long slot = static_cast<long long>(key[j] >> idx_bits);
      x[j] = offsets[slot] + static_cast<long long>(cursor[slot]) - (base + j * 32 + lane);
    }
  }
  // each key's x from the last run start at or before it in the warp; the
  // keys before the warp's first start take the carry (below)
  int first = WARP_ITEMS;
  long long run_x = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const unsigned mine = starts[j] & upto;
    const long long from = __shfl_sync(all, x[j], mine ? 31 - __clz(mine) : 0);
    const long long last = __shfl_sync(all, x[j], starts[j] ? 31 - __clz(starts[j]) : 0);
    x[j] = mine ? from : run_x;
    if (starts[j]) {
      run_x = last;
      if (first == WARP_ITEMS) first = j * 32 + __ffs(starts[j]) - 1;
    }
  }
  if (lane == 0) {
    s_x[warp] = run_x;
    s_has[warp] = first < WARP_ITEMS;
  }
  __syncthreads();
  if (warp == 0) {
    // s_x[w] becomes the x of the last run begun in the warps before w,
    // s_has[w] whether there is one
    long long tile_x = 0;
    int tile_has = 0;
    for (int w = 0; w < WARPS; ++w) {
      const long long v = s_x[w];
      const int h = s_has[w];
      __syncwarp();
      if (lane == 0) {
        s_x[w] = tile_x;
        s_has[w] = tile_has;
      }
      if (h) {
        tile_x = v;
        tile_has = 1;
      }
    }
    if (lane == 0)
      publish(status + tile, tile_has ? INCLUSIVE | static_cast<unsigned long long>(tile_x + BIAS)
                                      : AGGREGATE);
    long long carry = 0;
    if (tile > 0) {
      carry = static_cast<long long>(warp_look_back(status, tile)) - BIAS;
      if (lane == 0 && !tile_has)
        publish(status + tile, INCLUSIVE | static_cast<unsigned long long>(carry + BIAS));
    }
    if (lane == 0) s_carry = carry;
  }
  __syncthreads();
  if (base >= n) return;
  const long long carry = s_has[warp] ? s_x[warp] : s_carry;
  const unsigned long long idx_mask = (1ull << idx_bits) - 1ull;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long p = base + j * 32 + lane;
    const unsigned long long down = __shfl_down_sync(all, key[j], 1);
    unsigned long long after;  // the key after the row
    if (j + 1 < ITEMS)
      after = __shfl_sync(all, key[j + 1], 0);
    else
      after = lane == 31 && p + 1 < n ? s[p + 1] : 0ull;
    if (p >= n) continue;
    const unsigned long long next = lane < 31 ? down : after;
    const long long xk = j * 32 + lane < first ? carry : x[j];
    const long long cell = xk + p;
    if (cell >= 0 && cell < total)
      positions[cell] = pos(static_cast<long long>(key[j] & idx_mask)) + 1;
    if (p + 1 == n || (next >> idx_bits) != (key[j] >> idx_bits)) {
      const long long slot = static_cast<long long>(key[j] >> idx_bits);
      cursor[slot] = static_cast<int>(static_cast<unsigned>(xk + p + 1 - offsets[slot]));
    }
  }
}

// Steps 0-3 over cap items of src, slots of slot_bits bits, indices of
// idx_bits (slot_bits + idx_bits <= 64). offsets: int64[n_slots], in [0,
// 2^60); cursor:
// int32[n_slots], advanced in place; positions: int64[total], written in
// place; scratch: onesweep::scratch_bytes(cap, ceil(slot_bits / 8), 0)
// bytes of device memory of the caller (aindex_torch/kernels/positional.py
// fill_scratch_bytes). Returns the first CUDA error of the launches, or 0.
template <class Src, class Pos>
int sort_and_fill(Src src, long long cap, int slot_bits, int idx_bits, Pos pos,
                  const void* offsets, void* cursor, void* positions, long long total,
                  void* scratch, cudaStream_t s) {
  const int np = onesweep::passes(idx_bits, idx_bits + slot_bits);
  const onesweep::Scratch sc = onesweep::carve(scratch, cap, np, 0);
  unsigned long long* sorted;
  if (int err = onesweep::sort(src, cap, idx_bits, idx_bits + slot_bits, sc, s, &sorted))
    return err;
  fill_kernel<Pos><<<static_cast<unsigned>(onesweep::tiles(cap)), onesweep::BLOCK, 0, s>>>(
      sorted, sc.live, idx_bits, pos, static_cast<const long long*>(offsets),
      static_cast<int*>(cursor), total, static_cast<long long*>(positions),
      sc.counters + 1 + np, sc.st_runs);
  KERNEL_CHECK();
  return 0;
}

// packed uint32[n_words] + vbits uint8[2 * n_words]: the chunk, whose
// n_win = 16 * n_words - k + 1 windows start at blob positions off + i.
// Slots run over [0, n_slots), slot_bits = bits of n_slots - 1, idx_bits =
// bits of n_win - 1, and slot_bits + idx_bits <= 64. The other arguments as
// sort_and_fill takes them, for n_win items.
template <class E, int RULE>
int run(const E& e, int max_k, const void* packed, const void* vbits, long long n_words, int k,
        long long off, long long n_slots, int slot_bits, int idx_bits, const void* offsets,
        void* cursor, void* positions, long long total, void* scratch, cudaStream_t s) {
  const long long n_win = 16 * n_words - k + 1;
  if (k < 1 || k > max_k || n_win <= 0 || n_win >= (1LL << 31) - 1 || n_slots <= 0 ||
      slot_bits < 1 || idx_bits < 1 || slot_bits + idx_bits > 64 ||
      (n_slots - 1) >> slot_bits != 0 || (n_win - 1) >> idx_bits != 0)
    return probe::BAD;
  const Windows<E, RULE> src{static_cast<const unsigned*>(packed),
                             static_cast<const unsigned char*>(vbits), n_words, k, e, n_slots,
                             idx_bits};
  return sort_and_fill(src, n_win, slot_bits, idx_bits, ChunkPos{off}, offsets, cursor, positions,
                       total, scratch, s);
}

// The receive side of the positional exchange (K9's pairs-in entry): rec
// int64[n_src, cols] as Records describes (packed != 0: packed records;
// else slot ids), roff int64[n_src]; the slots of [lo, lo + n_slots) are
// filled in (source, column) order, the order of the single-device fill.
// slot_bits and idx_bits as in run(), idx_bits for n_src * cols records;
// the scratch of run() for n_src * cols items.
inline int pairs(const void* rec, long long n_src, long long cols, int packed, const void* roff,
                 long long lo, long long n_slots, int slot_bits, int idx_bits,
                 const void* offsets, void* cursor, void* positions, long long total,
                 void* scratch, cudaStream_t s) {
  const long long n = n_src * cols;
  if (n_src <= 0 || cols <= 0 || n >= (1LL << 31) - 1 || n_slots <= 0 || slot_bits < 1 ||
      idx_bits < 1 || slot_bits + idx_bits > 64 || (n_slots - 1) >> slot_bits != 0 ||
      (n - 1) >> idx_bits != 0)
    return probe::BAD;
  const auto* r = static_cast<const long long*>(rec);
  const PairPos pos{r, static_cast<const long long*>(roff), cols, packed != 0};
  if (packed)
    return sort_and_fill(Records<true>{r, lo, n_slots, idx_bits}, n, slot_bits, idx_bits, pos,
                         offsets, cursor, positions, total, scratch, s);
  return sort_and_fill(Records<false>{r, lo, n_slots, idx_bits}, n, slot_bits, idx_bits, pos,
                       offsets, cursor, positions, total, scratch, s);
}

// The sparse fill entry of an engine: rule CANON or FWD_RC.
template <class E>
int sparse(const void* const* p, const unsigned long long* u, const void* packed,
           const void* vbits, long long n_words, int k, long long off, int rule,
           long long n_slots, int slot_bits, int idx_bits, const void* offsets, void* cursor,
           void* positions, long long total, void* scratch, void* stream) {
  E e;
  if (E::make(p, u, &e) != 0) return probe::BAD;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rule == probe::CANON)
    return run<E, probe::CANON>(e, 31, packed, vbits, n_words, k, off, n_slots, slot_bits,
                                idx_bits, offsets, cursor, positions, total, scratch, s);
  if (rule == probe::FWD_RC)
    return run<E, probe::FWD_RC>(e, 31, packed, vbits, n_words, k, off, n_slots, slot_bits,
                                 idx_bits, offsets, cursor, positions, total, scratch, s);
  return probe::BAD;
}

}  // namespace fill

#define FILL_ENTRY(NAME, ENGINE)                                                            \
  extern "C" int NAME(const void* const* p, const unsigned long long* u, const void* packed,  \
                      const void* vbits, long long n_words, int k, long long off, int rule,   \
                      long long n_slots, int slot_bits, int idx_bits, const void* offsets,    \
                      void* cursor, void* positions, long long total, void* scratch,          \
                      void* stream) {                                                         \
    return fill::sparse<ENGINE>(p, u, packed, vbits, n_words, k, off, rule, n_slots,          \
                                slot_bits, idx_bits, offsets, cursor, positions, total,       \
                                scratch, stream);                                             \
  }
