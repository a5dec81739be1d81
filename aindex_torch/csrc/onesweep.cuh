// Stable LSD radix sort of 64-bit keys, with an optional 4- or 8-byte value
// riding each key, in the onesweep design (Adinets & Merrill, "Onesweep: A
// Faster Least Significant Digit Radix Sort for GPUs", 2022), and the two
// steps around it that share its decoupled look-back: a stream compaction
// that also counts the sort's digit histograms, and a run-length reduce of
// the sorted keys. Used by spectrum23 (K5) and spectrummerge (K13); the
// positional fills (fill.cuh: K9, the K10/K11 fills) sort with it, and K8
// (csr.cu), K14 (posbucket.cu) and K15 (count13.cu) take its tiles and
// look-back.
//
// A sort of n keys on bits [lo, hi) takes 8-bit digits, passes = ceil((hi -
// lo) / 8) of them, and reduce() runs it as 2 + passes launches on one
// stream, after one cudaMemsetAsync that zeroes every counter and status
// word (9 in all for 46-bit keys, 11 for 64-bit ones):
//   compact  each block takes a tile of TILE items and asks the caller's
//            source functor, for every item first, which live and with
//            what key (and value); it counts the live keys' digits of every
//            pass at once in shared memory (passes x 256 counters, added to
//            device memory at the end), ranks the live items in order with
//            ballots, finds the tile's output base by a warp's look-back
//            over the tiles before it, and writes the live keys in input
//            order. The last tile writes the live count n (n_ptr).
//   pass     one launch per digit: a tile of TILE keys (BLOCK threads x
//            ITEMS, warp rows of 32) is ranked stably in registers, warp by
//            warp (warp-level multi-split: eight ballots give each key the
//            lanes that share its digit, the lowest of them moves a per-warp
//            shared counter); a sum over the warps gives the tile's count
//            of each digit, which it publishes at once as an aggregate;
//            thread d then looks back over the earlier tiles' words of digit
//            d for the digit's exclusive prefix and publishes the inclusive
//            one. The digit's global base is the exclusive scan of the
//            pass's histogram, which every block takes itself. The keys go
//            through shared memory in digit order, so each digit's run of
//            the tile lands as one contiguous span; values follow through
//            the same buffer. A pass reads and writes each key (and value)
//            once.
//   runs     each warp takes WARP_ITEMS sorted keys in rows of 32; ballots
//            flag the run starts, and a sum over the warps and a warp's
//            look-back number them; each run's key goes to its number, and
//            its count (or value sum) is a difference of two prefix sums of
//            the warp's keys, stored by the lane that ends a run the warp
//            began, or added atomically in pieces where a warp's edge cuts
//            the run. The last tile writes the unique count.
//
// Tile order: a block takes its tile from an atomic counter, never from
// blockIdx, so a tile's predecessors have all started and none waits on a
// block that is not yet resident. A status word is 64 bits: bit 62 marks an
// aggregate, bit 63 an inclusive prefix, the low 62 bits the count (counts
// reach 2^31); zero means "not yet" (see publish for the memory order).
// Tiles at or past n return at once: no live tile looks back at them. The
// live count stays on the device, so the host never waits inside a sort;
// the grids are sized from the cap. A sort's look-back counts reach 2^31; a
// caller's own sums may use all 62 bits.
//
// Bound: bytes. A pass moves 16 bytes a key (24 or 32 with a value), so a
// 2^22-byte chunk's ~3.5M valid 23-mers cost ~57 MB a pass, 17 us at 3.35
// TB/s. Shared memory stays under the 48 KB static limit (a 32 KB staging
// buffer of keys or values, the per-warp digit counters and the digit
// offsets), so no dynamic shared memory attribute is needed; the passes are
// held to 64 registers, four blocks an SM. Stability: the compaction keeps
// input order, and each pass keeps the order of equal digits (lane order
// within a warp row, rows in order, warps in order, tiles in order), which
// the positional fill (K9) needs: its keys are equal on the sorted bits
// exactly where two windows share a slot.
#pragma once

#include "scan.cuh"

namespace onesweep {

constexpr int DIGIT_BITS = 8;
constexpr int RADIX = 1 << DIGIT_BITS;
constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int ITEMS = 16;
constexpr int WARP_ITEMS = 32 * ITEMS;
constexpr int TILE = BLOCK * ITEMS;  // 4096 items a tile
constexpr int MAX_PASSES = 8;
// counter words: the tile counters of the compaction, each pass and the
// runs (or the launch after sort()), and, last, sort()'s live count
constexpr int COUNTERS = 16;
static_assert(BLOCK == RADIX, "one thread per digit");
static_assert(MAX_PASSES + 2 < COUNTERS, "a tile counter per launch and the live count");

constexpr unsigned long long AGGREGATE = 1ull << 62;
constexpr unsigned long long INCLUSIVE = 1ull << 63;
constexpr unsigned long long COUNT_MASK = AGGREGATE - 1;

template <int VB> struct ValueOf { using type = unsigned long long; };
template <> struct ValueOf<4> { using type = unsigned; };
template <> struct ValueOf<0> { using type = unsigned; };  // no value: never read

inline long long tiles(long long n) { return (n + TILE - 1) / TILE; }
inline int passes(int lo, int hi) { return (hi - lo + DIGIT_BITS - 1) / DIGIT_BITS; }

// The sort's scratch, carved from one caller buffer of scratch_bytes(cap,
// passes, value_bytes) bytes (aindex_torch/kernels/spectrum.py
// onesweep_scratch computes the same size): two key buffers of cap uint64,
// two value buffers of cap values, then the words that one memset zeroes:
// the digit histograms (passes x RADIX uint32), the counter words and the
// status words of the compaction, the runs and each pass (tiles x RADIX).
struct Scratch {
  unsigned long long* keys[2];
  void* vals[2];
  unsigned* hist;
  unsigned* counters;
  int* live;  // sort()'s live count: the last counter word
  unsigned long long* st_compact;
  unsigned long long* st_runs;
  unsigned long long* st_pass;
  long long zero_bytes;
};

inline long long status_words(long long cap, int np) {
  return np * RADIX / 2 + COUNTERS / 2 + 2 * tiles(cap) + np * tiles(cap) * RADIX;
}

inline long long value_words(long long cap, int value_bytes) {
  return (cap * value_bytes + 7) / 8;
}

inline long long scratch_bytes(long long cap, int np, int value_bytes) {
  return 8 * (2 * cap + 2 * value_words(cap, value_bytes) + status_words(cap, np));
}

inline Scratch carve(void* base, long long cap, int np, int value_bytes) {
  auto* w = static_cast<unsigned long long*>(base);
  Scratch sc;
  sc.keys[0] = w;
  sc.keys[1] = w + cap;
  w += 2 * cap;
  sc.vals[0] = w;
  sc.vals[1] = w + value_words(cap, value_bytes);
  w += 2 * value_words(cap, value_bytes);
  sc.hist = reinterpret_cast<unsigned*>(w);
  sc.counters = sc.hist + np * RADIX;
  sc.live = reinterpret_cast<int*>(sc.counters + COUNTERS - 1);
  sc.st_compact = w + np * RADIX / 2 + COUNTERS / 2;
  sc.st_runs = sc.st_compact + tiles(cap);
  sc.st_pass = sc.st_runs + tiles(cap);
  sc.zero_bytes = 8 * status_words(cap, np);
  return sc;
}

// A status word carries its own count, and no block reads anything else
// that another block of the same launch wrote, so relaxed GPU-scope
// accesses suffice: they go to L2 (L1 is not coherent) without the cost of
// an acquire, which would also drop the reader's L1 lines.
__device__ __forceinline__ void publish(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long peek(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// The exclusive prefix of tile `tile` > 0 in a status column whose tile t
// word is status[t * stride]: add the earlier tiles' counts back to the
// first inclusive one, waiting on words not yet published. (Reading eight
// words a round measured slower: most walks end at the first word.)
__device__ unsigned long long look_back(const unsigned long long* status, long long tile,
                                        long long stride) {
  unsigned long long excl = 0;
  for (long long p = tile - 1;; --p) {
    unsigned long long w;
    do {
      w = peek(status + p * stride);
    } while (w == 0);
    excl += w & COUNT_MASK;
    if (w & INCLUSIVE) return excl;
  }
}

// The exclusive prefix of tile `tile` > 0 in a status column of one word a
// tile, read by the whole warp, 32 words a round: the sum of the counts
// back to the first inclusive word. Every lane gets it.
__device__ unsigned long long warp_look_back(const unsigned long long* status, long long tile) {
  const int lane = threadIdx.x & 31;
  unsigned long long excl = 0;
  for (long long newest = tile - 1;; newest -= 32) {
    // lane i reads tile newest - i; tiles below 0 read as an empty prefix
    const long long p = newest - lane;
    unsigned long long w = p >= 0 ? peek(status + p) : INCLUSIVE;
    while (__any_sync(0xffffffffu, w == 0))
      if (w == 0) w = peek(status + p);
    const unsigned incl = __ballot_sync(0xffffffffu, (w & INCLUSIVE) != 0);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    unsigned long long c = lane <= stop ? w & COUNT_MASK : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    excl += c;
    if (incl) return excl;
  }
}

// Publish a tile's count in a status column of one word a tile, look back
// with the whole warp, publish the inclusive prefix; every lane of the
// calling warp gets the exclusive prefix.
__device__ unsigned long long warp_prefix(unsigned long long* status, long long tile,
                                          unsigned long long count) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) publish(status, INCLUSIVE | count);
    return 0;
  }
  if (lane == 0) publish(status + tile, AGGREGATE | count);
  const unsigned long long excl = warp_look_back(status, tile);
  if (lane == 0) publish(status + tile, INCLUSIVE | (excl + count));
  return excl;
}

__device__ __forceinline__ int digit(unsigned long long key, int shift, int hi) {
  const int width = hi - shift < DIGIT_BITS ? hi - shift : DIGIT_BITS;
  return static_cast<int>((key >> shift) & ((1u << width) - 1u));
}

__device__ __forceinline__ long long take_tile(unsigned* counter, long long* slot) {
  if (threadIdx.x == 0) *slot = atomicAdd(counter, 1u);
  __syncthreads();
  return *slot;
}

// Compaction of cap items: src(p, key, value) says whether item p lives and
// gives its key (and value). The live keys go to sc.keys[0] (values to
// sc.vals[0]) in input order, their count to *n_out, and their digits of
// the np passes on bits [lo, hi) to sc.hist. Given reduce()'s outputs
// (keys_out not null), each block also clears its tile's range of them
// (sentinel keys, zero sums), which the runs launch fills. Grid:
// tiles(cap).
template <int VB, typename S, class Src>
__global__ void __launch_bounds__(BLOCK)
    compact_kernel(Src src, long long cap, int lo, int hi, int np, Scratch sc, int* n_out,
                   unsigned long long* __restrict__ keys_out, S* __restrict__ sums_out) {
  using V = typename ValueOf<VB>::type;
  __shared__ unsigned s_hist[MAX_PASSES * RADIX];
  __shared__ unsigned long long s_warp[WARPS];
  __shared__ long long s_tile;
  __shared__ unsigned long long s_base;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < np * RADIX; i += BLOCK) s_hist[i] = 0;
  const long long tile = take_tile(sc.counters, &s_tile);
  const long long base = tile * TILE + warp * WARP_ITEMS;
  const unsigned lower = (1u << lane) - 1u;

  // every row's source first (their loads in flight together), then the
  // ranks
  unsigned long long key[ITEMS];
  V val[ITEMS];
  int rank[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long p = base + j * 32 + lane;
    rank[j] = p < cap && src(p, key[j], val[j]);
  }
  int count = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const bool ok = rank[j];
    const unsigned live = __ballot_sync(0xffffffffu, ok);
    rank[j] = ok ? count + __popc(live & lower) : -1;
    count += __popc(live);
    if (ok)
      for (int q = 0; q < np; ++q)
        atomicAdd(&s_hist[q * RADIX + digit(key[j], lo + q * DIGIT_BITS, hi)], 1u);
  }
  if (lane == 0) s_warp[warp] = count;
  if (keys_out != nullptr) {
    const long long end = tile * TILE + TILE < cap ? tile * TILE + TILE : cap;
    for (long long i = tile * TILE + threadIdx.x; i < end; i += BLOCK) {
      keys_out[i] = ~0ull;
      sums_out[i] = S(0);
    }
  }
  __syncthreads();
  if (warp == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < WARPS; ++w) total += s_warp[w];
    const unsigned long long excl = warp_prefix(sc.st_compact, tile, total);
    if (lane == 0) {
      for (int w = 0, run = 0; w < WARPS; ++w) {
        const int c = static_cast<int>(s_warp[w]);
        s_warp[w] = run;
        run += c;
      }
      s_base = excl;
      if (tile == gridDim.x - 1) *n_out = static_cast<int>(excl + total);
    }
  }
  __syncthreads();
  const unsigned long long at0 = s_base + s_warp[warp];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (rank[j] < 0) continue;
    sc.keys[0][at0 + rank[j]] = key[j];
    if constexpr (VB != 0) static_cast<V*>(sc.vals[0])[at0 + rank[j]] = val[j];
  }
  for (int i = threadIdx.x; i < np * RADIX; i += BLOCK)
    if (s_hist[i] != 0) atomicAdd(&sc.hist[i], s_hist[i]);
}

// One pass: the first *n_ptr keys of in (values of vin) sorted stably on
// the digit at `shift` (below hi) into out (vout). hist: the pass's RADIX
// digit counts; counter: its tile counter; status: its tiles x RADIX
// words. Grid: tiles(cap).
template <int VB>
__global__ void __launch_bounds__(BLOCK, 4)
    pass_kernel(const unsigned long long* __restrict__ in, unsigned long long* __restrict__ out,
                const void* vin_, void* vout_, const int* __restrict__ n_ptr, int shift, int hi,
                const unsigned* __restrict__ hist, unsigned* counter,
                unsigned long long* status) {
  using V = typename ValueOf<VB>::type;
  __shared__ unsigned long long s_stage[TILE];
  __shared__ int s_count[WARPS][RADIX];
  __shared__ int s_start[RADIX];
  __shared__ int s_off[RADIX];
  __shared__ long long s_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < WARPS * RADIX; i += BLOCK) (&s_count[0][0])[i] = 0;
  const long long tile = take_tile(counter, &s_tile);
  const long long n = *n_ptr;
  const long long tile_base = tile * TILE;
  if (tile_base >= n) return;
  const long long base = tile_base + warp * WARP_ITEMS;
  const unsigned lower = (1u << lane) - 1u;

  // rank each warp row's keys among the warp's earlier keys of their digit
  unsigned long long key[ITEMS];
  int rank[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long p = base + j * 32 + lane;
    key[j] = p < n ? in[p] : 0ull;
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const bool ok = base + j * 32 + lane < n;
    const int d = digit(key[j], shift, hi);
    unsigned peers = __ballot_sync(0xffffffffu, ok);
#pragma unroll
    for (int b = 0; b < DIGIT_BITS; ++b) {
      const unsigned m = __ballot_sync(0xffffffffu, (d >> b) & 1);
      peers &= ((d >> b) & 1) ? m : ~m;
    }
    // the lowest lane of each digit's peers moves the digit's counter
    const int leader = ok ? __ffs(peers) - 1 : lane;
    int before = 0;
    if (ok && lane == leader) {
      before = s_count[warp][d];
      s_count[warp][d] = before + __popc(peers);
    }
    before = __shfl_sync(0xffffffffu, before, leader);
    __syncwarp();
    rank[j] = ok ? before + __popc(peers & lower) : -1;
  }
  __syncthreads();

  // thread d: the tile's count of digit d, its offset per warp, the
  // digit's prefix over the earlier tiles and its global base
  const int d = threadIdx.x;
  int total = 0;
  for (int w = 0; w < WARPS; ++w) {
    const int c = s_count[w][d];
    s_count[w][d] = total;
    total += c;
  }
  unsigned long long* own = status + tile * RADIX + d;
  publish(own, (tile == 0 ? INCLUSIVE : AGGREGATE) | static_cast<unsigned long long>(total));
  int tile_n, n_all;
  const int start = scan::block_exclusive_scan(total, &tile_n);
  const int global = scan::block_exclusive_scan(static_cast<int>(hist[d]), &n_all);
  long long excl = 0;
  if (tile > 0) {
    excl = static_cast<long long>(look_back(status + d, tile, RADIX));
    publish(own, INCLUSIVE | static_cast<unsigned long long>(excl + total));
  }
  s_start[d] = start;
  s_off[d] = static_cast<int>(global + excl - start);
  __syncthreads();

  // stage the keys in digit order; rank[] becomes each key's tile position
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (rank[j] < 0) continue;
    const int dj = digit(key[j], shift, hi);
    rank[j] += s_start[dj] + s_count[warp][dj];
    s_stage[rank[j]] = key[j];
  }
  __syncthreads();
  int dst[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = j * BLOCK + threadIdx.x;
    if (i >= tile_n) break;
    const unsigned long long k = s_stage[i];
    dst[j] = s_off[digit(k, shift, hi)] + i;
    out[dst[j]] = k;
  }
  if constexpr (VB != 0) {
    const V* vin = static_cast<const V*>(vin_);
    V* vout = static_cast<V*>(vout_);
    V* s_val = reinterpret_cast<V*>(s_stage);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (rank[j] >= 0) s_val[rank[j]] = vin[base + j * 32 + lane];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = j * BLOCK + threadIdx.x;
      if (i >= tile_n) break;
      vout[dst[j]] = s_val[i];
    }
  }
}

// The run-length reduce of the first *n_ptr sorted keys s (values v): run
// u's key to keys_out[u], its length (VB 0) or its values' sum (wrapping in
// S) to sums_out[u], which the compaction zeroed; the run count to
// *n_unique. Each warp takes a segment of WARP_ITEMS keys in rows of 32
// (coalesced): ballots flag the run starts, a block scan and a look-back
// number them. A run's sum is the difference of two prefix sums of the
// segment, taken at its end; the lane that ends a run begun in the segment
// stores it, and a run cut by a segment edge is added in pieces
// atomically. Grid: tiles(cap).
template <int VB, typename S>
__global__ void __launch_bounds__(BLOCK)
    runs_kernel(const unsigned long long* __restrict__ s, const void* v_,
                const int* __restrict__ n_ptr, unsigned* counter, unsigned long long* status,
                unsigned long long* __restrict__ keys_out, S* __restrict__ sums_out,
                int* __restrict__ n_unique) {
  using V = typename ValueOf<VB>::type;
  __shared__ int s_warp[WARPS];
  __shared__ long long s_tile;
  __shared__ unsigned long long s_excl;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile = take_tile(counter, &s_tile);
  const long long n = *n_ptr;
  const long long tile_base = tile * TILE;
  if (tile_base >= n) {
    if (tile == 0 && threadIdx.x == 0) *n_unique = 0;
    return;
  }
  const long long base = tile_base + warp * WARP_ITEMS;
  const long long seg_end = base + WARP_ITEMS < n ? base + WARP_ITEMS : n;
  const unsigned all = 0xffffffffu;

  unsigned long long key[ITEMS];
  unsigned starts[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long p = base + j * 32 + lane;
    key[j] = p < n ? s[p] : 0ull;
  }
  unsigned long long before = base > 0 && base <= n ? s[base - 1] : 0ull;
  int count = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long p = base + j * 32 + lane;
    const unsigned long long up = __shfl_up_sync(all, key[j], 1);
    const unsigned long long prev = lane ? up : before;
    before = __shfl_sync(all, key[j], 31);
    starts[j] = __ballot_sync(all, p < n && (p == 0 || key[j] != prev));
    count += __popc(starts[j]);
  }
  if (lane == 0) s_warp[warp] = count;
  __syncthreads();
  if (warp == 0) {
    int total = 0;
    for (int w = 0; w < WARPS; ++w) total += s_warp[w];
    const unsigned long long excl =
        warp_prefix(status, tile, static_cast<unsigned long long>(total));
    if (lane == 0) {
      for (int w = 0, run = 0; w < WARPS; ++w) {
        const int c = s_warp[w];
        s_warp[w] = run;
        run += c;
      }
      s_excl = excl;
      if (tile_base + TILE >= n) *n_unique = static_cast<int>(excl + total);
    }
  }
  __syncthreads();
  if (base >= n) return;

  // per row: the segment's prefix sum W through each key, and of the run
  // that holds it the number u, the prefix before its first key (or before
  // the segment) and whether it began in the segment
  long long u = static_cast<long long>(s_excl) + s_warp[warp] - 1;
  S row_sum = 0;          // the segment's sum before this row
  S run_from = 0;         // the prefix before the last run begun so far
  bool run_whole = false; // that run began in the segment
  const unsigned upto = all >> (31 - lane);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long p = base + j * 32 + lane;
    const bool ok = p < n;
    S w = S(0), incl;
    if constexpr (VB != 0) {
      w = ok ? static_cast<S>(static_cast<const V*>(v_)[p]) : S(0);
      incl = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const S y = __shfl_up_sync(all, incl, o);
        if (lane >= o) incl += y;
      }
    } else {
      w = ok ? S(1) : S(0);
      incl = static_cast<S>(lane + 1);
    }
    const S at = row_sum + incl;         // the prefix through key p
    const unsigned mine = starts[j] & upto;
    const int src = mine ? 31 - __clz(mine) : lane;
    const S from_row = __shfl_sync(all, at - w, src);
    const S from = mine ? from_row : run_from;
    const bool whole = mine ? true : run_whole;
    const long long my_u = u + __popc(mine);
    if (ok && (starts[j] >> lane & 1u)) keys_out[my_u] = key[j];
    const unsigned long long down = __shfl_down_sync(all, key[j], 1);
    unsigned long long after;  // the key after the row
    if (j + 1 < ITEMS)
      after = __shfl_sync(all, key[j + 1], 0);
    else
      after = lane == 31 && p + 1 < n ? s[p + 1] : 0ull;
    const unsigned long long next = lane < 31 ? down : after;
    const bool run_end = ok && (p + 1 == n || next != key[j]);
    if (run_end && whole)
      sums_out[my_u] = at - from;
    else if (run_end || (ok && p + 1 == seg_end))
      atomicAdd(&sums_out[my_u], at - from);
    if (starts[j]) {
      const int last = 31 - __clz(starts[j]);
      run_from = __shfl_sync(all, at - w, last);
      run_whole = true;
    }
    u += __popc(starts[j]);
    row_sum = __shfl_sync(all, at, 31);
  }
}

// The passes of a sort on bits [lo, lo + DIGIT_BITS * np) below hi of the
// *n_ptr keys in sc.keys[0] (values in sc.vals[0]), whose digit counts the
// compaction left in sc.hist. *cur_out: the index of the buffer that holds
// the sorted keys (and values). Returns the first CUDA error, or 0.
template <int VB>
int run_passes(const Scratch& sc, long long cap, int lo, int hi, int np, const int* n_ptr,
               cudaStream_t s, int* cur_out) {
  const unsigned grid = static_cast<unsigned>(tiles(cap));
  int cur = 0;
  for (int q = 0; q < np; ++q, cur ^= 1) {
    pass_kernel<VB><<<grid, BLOCK, 0, s>>>(sc.keys[cur], sc.keys[cur ^ 1], sc.vals[cur],
                                           sc.vals[cur ^ 1], n_ptr, lo + q * DIGIT_BITS, hi,
                                           sc.hist + q * RADIX, sc.counters + 1 + q,
                                           sc.st_pass + q * tiles(cap) * RADIX);
    KERNEL_CHECK();
  }
  *cur_out = cur;
  return 0;
}

// Compact cap items of src (keys alone) and sort the live ones stably on
// bits [lo, hi): the live count goes to *sc.live, the sorted keys to
// *sorted (sc.keys[passes % 2]), the other key buffer is free. sc: carve(.,
// cap, passes(lo, hi), 0). 2 + passes launches, the memset included. The
// runs launch's tile counter (sc.counters[1 + passes]) and status column
// (sc.st_runs) are left zeroed for the caller's next launch.
template <class Src>
int sort(Src src, long long cap, int lo, int hi, const Scratch& sc, cudaStream_t s,
         unsigned long long** sorted) {
  if (cap <= 0 || cap >= (1LL << 31) - 1 || lo < 0 || lo >= hi || hi > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int np = passes(lo, hi);
  if (cudaError_t e = cudaMemsetAsync(sc.hist, 0, sc.zero_bytes, s)) return static_cast<int>(e);
  compact_kernel<0, unsigned, Src><<<static_cast<unsigned>(tiles(cap)), BLOCK, 0, s>>>(
      src, cap, lo, hi, np, sc, sc.live, nullptr, nullptr);
  KERNEL_CHECK();
  int cur;
  if (int e = run_passes<0>(sc, cap, lo, hi, np, sc.live, s, &cur)) return e;
  *sorted = sc.keys[cur];
  return 0;
}

// Compact, sort on bits [0, bits) and run-length reduce cap items of src:
// keys_out[cap] (unique keys ascending, then the sentinel), sums_out[cap]
// (their counts or value sums, then 0), counters[0] the live count,
// counters[1] the unique count. scratch: scratch_bytes(cap, passes(0,
// bits), VB) bytes. 3 + passes launches, the memset included.
template <int VB, typename S, class Src>
int reduce(Src src, long long cap, int bits, void* scratch, unsigned long long* keys_out,
           S* sums_out, int* counters, cudaStream_t s) {
  if (cap <= 0 || cap >= (1LL << 31) - 1 || bits < 1 || bits > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int np = passes(0, bits);
  const Scratch sc = carve(scratch, cap, np, VB);
  const unsigned grid = static_cast<unsigned>(tiles(cap));
  if (cudaError_t e = cudaMemsetAsync(sc.hist, 0, sc.zero_bytes, s)) return static_cast<int>(e);
  compact_kernel<VB, S, Src><<<grid, BLOCK, 0, s>>>(src, cap, 0, bits, np, sc, counters,
                                                     keys_out, sums_out);
  KERNEL_CHECK();
  int cur;
  if (int e = run_passes<VB>(sc, cap, 0, bits, np, counters, s, &cur)) return e;
  runs_kernel<VB, S><<<grid, BLOCK, 0, s>>>(sc.keys[cur], sc.vals[cur], counters,
                                            sc.counters + 1 + np, sc.st_runs, keys_out,
                                            sums_out, counters + 1);
  KERNEL_CHECK();
  return 0;
}

}  // namespace onesweep
