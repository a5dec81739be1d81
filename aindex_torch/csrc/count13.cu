// The dense count kernels: K1 count13_packed, K15 scatter_count and K16
// count13_rows, each adding into a uint32 count table.
//
// K1 count13_packed: packed ingest chunks -> 13-mer windows -> the dense
// uint32[4^13] count table, in place. Replaces
// aindex_tpu/kernels/count.py:69 count_batch_13_packed (with
// scatter_count_into, :45), which JAX lowers to a masked scatter-add. A
// build's chunks are gathered into one buffer (aindex_torch/kernels/count.py
// PackedCounter) and counted at once, on K15's partition below.
//
// K15 scatter_count: given codes and a weight (valid) per code -> a fresh
// table. Replaces aindex_tpu/kernels/count.py:31 scatter_count.
//
// K16 count13_rows: ASCII rows -> forward k-mer windows (k <= 16) ->
// scatter-add into the table in place. Replaces
// aindex_tpu/kernels/count.py:54 count_batch_13 (jitted with donation as
// index/dense13.py:29 _count_step).
//
// K16, bound: the table's read-modify-writes. A batch's ~3.9M valid windows
// each add 1 at a random entry of a 256 MB table, 5x the 50 MB L2: a
// sector read and later written back an add. In random order such adds
// (REDs) run at 14.7 G a second, less than half the card's random-read
// rate; grouped by bins of the table in bin order, 1.7x that; sorted, 2x
// (scripts/randread.cu randrmw; PERF.md section 6). Design: the windows
// come from bins::RowsSource (a thread the 16 windows that start at 16
// consecutive bytes of the flattened rows, read as aligned 16-byte loads,
// coded without a table, rolled in registers; weight 0 past a row's last
// window or over a byte outside ACGT/acgt), and each block of
// bins::rows_sweep ranks a tile of them by slice of the table in shared
// memory and makes their adds in slice order, all blocks together, so the
// adds in flight fall in a moving part of the table. (K15's partition with
// its records' adds in bin order measured slower: the partition costs more
// than the order saves at a batch's size.) Tables of at most RED_SPACE
// entries, which L2 holds, take the windows' REDs straight from the source
// (bins::rows_red); tables of at most 2^15 entries, small_count's shared
// histogram. The sum does not depend on the order of the adds, so the
// result is exact; uint32 wraps as JAX's add does.
//
// K15 and K1, bound: bytes. Their codes are many (every window of a read
// set: 107M at E. coli scale) and the table is written whole, so one random
// atomic per code in device memory (18 G a second: a random sector read and
// written back) costs many times what the bytes do. Design: partition, then
// count in shared memory. The table is cut into bins of W = 2^15
// consecutive entries (128 KB of counters); codes of weight 0 or outside the
// table drop out. The codes come from a source (bins::CodeSource: K15's
// codes and weights; bins::PackedSource: K1's windows, each rebuilt from at
// most two packed words and two 16-bit validity words, a thread the 16
// windows of one word, weight 1 where all 13 bases are valid, else 0). Four
// launches, per round of up to 2^28 entries and piece of up to 2^27 codes:
//   bin_hist     the codes cut into at most 128 contiguous ranges, one
//                block each: each counts its range's codes by bin in
//                shared memory, equal bins of a warp row combined first.
//   bin_prefix   thread b scans bin b's column of range counts into each
//                range's prefix, and writes the bin's total. (A decoupled
//                look-back measured slower here: the ranges all finish
//                counting at once, so each walks back to the first.)
//   bin_scatter  each range again, a tile of 16,384 codes at a time: every
//                block scans the bin totals into the bins' starts; the
//                tile's codes are ranked by bin in shared memory, staged in
//                bin order as 4-byte records (offset in the bin << 8 |
//                weight), and each bin's run is written to the bin's next
//                positions in the range's share. Records end up grouped by
//                bin, written as runs (one scattered 4-byte store a code
//                measured slower: as slow as the atomics it replaces).
//   bin_count    one block of 128 KB of dynamic shared memory a bin: the
//                bin's records are summed into shared uint32 counters
//                (equal offsets of a warp row combined first, then one
//                shared atomic each), and the bin's slice of the table is
//                written once with coalesced stores: K15's first piece
//                stores the counts, zeros included; every later piece, and
//                every piece of K1 (which adds into the table it is given),
//                reads the slice and adds to it; a bin of fewer than
//                SPARSE records (W / 8: a lone chunk's bins) adds its nonzero
//                counters with atomics instead, and a bin with none is left
//                as it is. A bin of more than CAP records (a skewed input:
//                poly-A reads make code 0 common) is split over ceil(n /
//                CAP) blocks, whose partial slices are added with atomics
//                into the slice (which bin_scatter zeroes on K15's first
//                piece, and leaves as it is when adding).
// So no code does an atomic of its own in device memory (a split or sparse
// bin adds each nonzero counter with one), K15's table needs no memset,
// and a code costs what its source reads (5 bytes for K15, 0.375 for K1)
// twice, a 4-byte record written and read, and the table 4 bytes an entry
// (8 when added to). Equal keys of a warp row are combined by two
// rounds of one ballot each (group_of), which catch a skewed row's common
// key; a full multi-split (a ballot a key bit) measured slower. Spaces of
// at most W entries take no partition: each block counts into a shared
// histogram of the whole table and adds its nonzero entries to the zeroed
// table. K1 pays the sweep of the table once a count, so a whole build's
// chunks are counted at once; a lone chunk's bins (~2,000 records each)
// fall below SPARSE and touch only their sectors.
//
// K15 and K16 index as JAX's scatter with mode="drop" does
// (dna13::scatter_index): a code is cast to int32, a negative index gains
// the table length, anything outside the table is dropped. So with k = 16
// a code >= 2^31 lands at code - 2^32 + space when that is >= 0.
#include "dna23.cuh"
#include "scan.cuh"

namespace {

// -- K15 ----------------------------------------------------------------------

namespace bins {

constexpr int BIN_BITS = 15;
constexpr long long W = 1LL << BIN_BITS;     // table entries a bin
constexpr int MAX_BINS = 1 << 13;            // bins a round
constexpr long long ROUND = W * MAX_BINS;    // table entries a round
constexpr long long PIECE = 1LL << 27;       // codes a round partitions at once
constexpr long long CAP = 1LL << 18;         // records a bin_count block takes
// records below which an adding bin_count block adds its nonzero counters
// with atomics, touching only their sectors, and does not sweep the slice
constexpr unsigned SPARSE = W / 8;
constexpr int WEIGHT_BITS = 8;
constexpr int HIST_BLOCK = 1024;             // threads of bin_hist
constexpr int PART_BLOCK = 1024;             // threads of bin_scatter
constexpr int UNROLL = 16;                   // codes a bin_hist thread loads at once
// codes a bin_scatter thread stages a tile: a bin's run in a tile grows
// with the tile, and shorter runs (8 a thread, even at two blocks an SM)
// measured slower
constexpr int ITEMS = 16;
constexpr int STILE = PART_BLOCK * ITEMS;    // codes a bin_scatter tile
constexpr int MAX_RANGES = 128;
constexpr long long MIN_RANGE = 1LL << 14;
constexpr int COUNT_BLOCK = 1024;
constexpr int SMALL_GRID = 264;              // blocks of the no-partition count
// K16's routes by table entries, each the fastest on 27,962 x 150 reads
// (scripts/count_profile.py; device ms a call, NVIDIA H100 80GB HBM3,
// PERF.md section 6): at most SMALL_SPACE, small_count's shared histogram
// of the rows (k = 7 into 4^7 entries: 0.0313, the rows' REDs 0.0620); at
// most RED_SPACE (16 MB, which L2 holds), each window's RED straight from
// the rows (rows_red; k = 16 into 2^22 entries: 0.0160, the sweep
// 0.0208); more, rows_sweep (k = 13 into 4^13 entries: 0.2173, the rows'
// REDs 0.2456, K15's partition with its adds in bin order 0.2885)
constexpr long long SMALL_SPACE = 1LL << 15;
constexpr long long RED_SPACE = 1LL << 22;
// 2^8 slices of the table rank a rows_sweep tile (64 and 1024 measured
// within 1%); 264 blocks of 1024 threads, two an SM, a tile their 16,384
// windows (one block an SM measured the same; blocks of 512 and 256
// threads, at the same threads an SM, 8-13% slower)
constexpr int SWEEP_BITS = 8;
constexpr int SWEEP_BINS = 1 << SWEEP_BITS;
constexpr int SWEEP_BLOCK = 1024;
constexpr int SWEEP_GRID = 264;
constexpr int SWEEP_TILE = SWEEP_BLOCK * ITEMS;
static_assert(SWEEP_BINS <= SWEEP_BLOCK, "rows_sweep scans a slice a thread");

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The ranges of a piece of n codes: at most MAX_RANGES, each of range_len
// codes (a multiple of 128), the last shorter.
inline long long max_ranges(long long n) {
  const long long r = cdiv(n, MIN_RANGE);
  return r < MAX_RANGES ? r : MAX_RANGES;
}
inline long long range_len(long long n) { return cdiv(cdiv(n, max_ranges(n)), 128) * 128; }
inline long long ranges(long long n) { return cdiv(n, range_len(n)); }
// bin_scatter's dynamic shared memory for nb bins
inline int scatter_smem(int nb) { return 12 * nb + 6 * STILE; }

// The scratch of scatter_count(n, space > W) and of count13_packed (n
// windows), carved from one buffer
// (aindex_torch/kernels/count.py scatter_scratch_bytes computes its size):
// the records of a piece, the counts of each (range, bin), turned in place
// into each range's prefix, the bins' totals and their starts.
struct Scratch {
  unsigned* records;
  unsigned* pre;
  unsigned* tot;
  unsigned* start;
};

inline Scratch carve(void* base, long long n, long long space) {
  const long long piece = n < PIECE ? n : PIECE;
  const long long nb = cdiv(space, W) < MAX_BINS ? cdiv(space, W) : MAX_BINS;
  Scratch sc;
  sc.records = static_cast<unsigned*>(base);
  sc.pre = sc.records + piece;
  sc.tot = sc.pre + max_ranges(piece) * nb;
  sc.start = sc.tot + nb;
  return sc;
}

// Where the codes of a count come from. A thread takes N codes at once
// (items): those of [first, first + N * lanes) that are its own, t of
// lanes threads, each with its weight; codes at or past last weigh 0.
// K15: given codes (uint32 bit patterns) and a weight each; a thread's
// code j is first + j * lanes + t, so neighbouring threads read
// neighbouring codes.
struct CodeSource {
  const int* codes;
  const unsigned char* valid;
  template <int N>
  __device__ __forceinline__ void items(long long first, int t, int lanes, long long last,
                                        int* code, unsigned* w) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const long long i = first + static_cast<long long>(j) * lanes + t;
      code[j] = i < last ? __ldg(codes + i) : 0;
      w[j] = i < last ? __ldg(valid + i) : 0u;
    }
  }
  CodeSource at(long long first) const { return {codes + first, valid + first}; }
};

// A packed word's 16 bases in code order (the first base in the top
// field): its 2-bit fields reversed. __brev reverses the bits, which swaps
// the two bits of each field too; the mask swaps them back.
__device__ __forceinline__ unsigned fields_reversed(unsigned x) {
  x = __brev(x);
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// K1: the 13-mer window starting at each base of a packed buffer, weight 1
// where all its bases are valid, else 0 (dna13::packed_window's result).
// A thread takes the 16 windows that start in one word, first + 16 t + j
// (first, and every piece's base, a multiple of 16): two words put in code
// order once, each window cut out with one shift, and the validity bits
// read as two 16-bit words; neighbouring threads read neighbouring words.
// Chunks in one buffer are kept apart by a word whose validity bits are
// all 0 (PackedCounter). vbits is 2-byte aligned.
struct PackedSource {
  const unsigned* packed;
  const unsigned short* vbits;
  long long n_words;
  long long base;   // the piece's first window
  template <int N>
  __device__ __forceinline__ void items(long long first, int t, int, long long last, int* code,
                                        unsigned* w) const {
    static_assert(N == 16, "a thread takes one word's windows");
    const long long i = first + 16LL * t;
    const long long at = (base + i) >> 4;
    const long long left = last - i;   // of the word's windows, those in range
    unsigned lo = 0u, hi = 0u, v = 0u;
    if (left > 0) {
      lo = __ldg(packed + at);
      v = __ldg(vbits + at);
      if (at + 1 < n_words) {
        hi = __ldg(packed + at + 1);
        v |= static_cast<unsigned>(__ldg(vbits + at + 1)) << 16;
      }
    }
    const unsigned long long r =
        (static_cast<unsigned long long>(fields_reversed(lo)) << 32) | fields_reversed(hi);
    constexpr unsigned ALL = (1u << dna13::K) - 1u;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      code[j] = static_cast<int>(static_cast<unsigned>(r >> (38 - 2 * j)) &
                                 ((1u << (2 * dna13::K)) - 1u));
      w[j] = j < left && ((v >> j) & ALL) == ALL ? 1u : 0u;
    }
  }
  PackedSource at(long long first) const { return {packed, vbits, n_words, base + first}; }
};

// K16: the window that starts at each byte of ASCII rows (uint8[rows, len],
// row-major, at any byte offset), weight 1 where its k bases are ACGT/acgt
// and it ends in its row (its column at most len - k), else 0; its code the
// k bases' 2-bit codes, the first in the top field. A thread takes the 16
// windows that start at first + 16 t + j, so neighbouring threads read
// neighbouring bytes:
// the 16 + k - 1 bytes from the first, read as two or three 16-byte loads
// from the 16-byte aligned address at or before it (a load that would
// cross the buffer's start or end read byte by byte), coded without a table
// (dna23::code_bytes4), the first window cut out of the 32 bases that
// follow and the other 15 rolled on in registers; one row_col for the
// column, no divide.
struct RowsSource {
  const unsigned char* ascii;
  long long n_bytes;           // rows * len
  long long len;
  unsigned long long recip;    // dna23::reciprocal(len)
  int k;

  // The 16 bytes from ascii + b (a 16-byte aligned address) coded: their
  // 2-bit codes, byte i in bits 2i and 2i + 1, and their validity bits.
  __device__ __forceinline__ void block16(long long b, unsigned* code, unsigned* ok) const {
    uint4 v;
    if (b >= 0 && b + 16 <= n_bytes) {
      v = __ldg(reinterpret_cast<const uint4*>(ascii + b));
    } else {
      unsigned x[4] = {0u, 0u, 0u, 0u};
      for (int i = 0; i < 16; ++i)
        if (b + i >= 0 && b + i < n_bytes)
          x[i >> 2] |= static_cast<unsigned>(ascii[b + i]) << (8 * (i & 3));
      v = make_uint4(x[0], x[1], x[2], x[3]);
    }
    unsigned o0, o1, o2, o3;
    const unsigned c0 = dna23::code_bytes4(v.x, &o0), c1 = dna23::code_bytes4(v.y, &o1);
    const unsigned c2 = dna23::code_bytes4(v.z, &o2), c3 = dna23::code_bytes4(v.w, &o3);
    *code = c0 | (c1 << 8) | (c2 << 16) | (c3 << 24);
    *ok = o0 | (o1 << 4) | (o2 << 8) | (o3 << 12);
  }

  template <int N>
  __device__ __forceinline__ void items(long long first, int t, int, long long last, int* code,
                                        unsigned* w) const {
    static_assert(N == 16, "a thread takes 16 windows");
    const long long p = first + 16LL * t;
    const long long left = last - p;   // of the thread's windows, those in range
    if (left <= 0) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        code[j] = 0;
        w[j] = 0u;
      }
      return;
    }
    const int d = static_cast<int>((reinterpret_cast<uintptr_t>(ascii) + p) & 15);
    unsigned c0, v0, c1, v1, c2 = 0u, v2 = 0u;
    block16(p - d, &c0, &v0);
    block16(p - d + 16, &c1, &v1);
    if (d + k >= 18) block16(p - d + 32, &c2, &v2);   // the bytes reach d + 14 + k
    const uint64_t lo = c0 | (static_cast<uint64_t>(c1) << 32);
    // bases p .. p + 31, base p + j in bits 2j and 2j + 1; validity bit j
    const uint64_t x = d ? (lo >> (2 * d)) | (static_cast<uint64_t>(c2) << (64 - 2 * d)) : lo;
    const uint64_t ok =
        (v0 | (static_cast<uint64_t>(v1) << 16) | (static_cast<uint64_t>(v2) << 32)) >> d;
    const uint64_t all = (1ull << k) - 1ull;
    const unsigned mask = k >= 16 ? 0xFFFFFFFFu : (1u << (2 * k)) - 1u;
    unsigned fwd = static_cast<unsigned>(dna23::mirror64(x) >> (64 - 2 * k));
    long long r, c;
    dna23::row_col(p, len, recip, &r, &c);
    const long long last_col = len - k;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j > 0) {
        fwd = ((fwd << 2) | static_cast<unsigned>((x >> (2 * (j + k - 1))) & 3u)) & mask;
        if (++c == len) c = 0;
      }
      code[j] = static_cast<int>(fwd);
      w[j] = j < left && c <= last_col && ((ok >> j) & all) == all ? 1u : 0u;
    }
  }
};

// A code's bin in the round [lo, lo + len) of the table and its record
// (offset in the bin << 8 | weight); -1 when it drops out: weight 0, the
// JAX scatter drops it, or it lies in another round.
__device__ __forceinline__ int bin_of(int code, unsigned w, long long space, long long lo,
                                      long long len, unsigned* rec) {
  long long at;
  if (w == 0u || !dna13::scatter_index(static_cast<unsigned>(code), space, &at)) return -1;
  at -= lo;
  if (at < 0 || at >= len) return -1;
  *rec = (static_cast<unsigned>(at & (W - 1)) << WEIGHT_BITS) | w;
  return static_cast<int>(at >> BIN_BITS);
}

// The warp's equal keys combined before their add: up to ROUNDS groups,
// each of the lanes that share the key of the lowest lane not yet grouped
// (so a skewed row's common key lands in one), every other lane alone.
// Returns this lane's group (itself where ok fails) and, in *sum, the sum
// of v over it. One shuffle, one ballot and one full-warp add a round (a
// multi-split of one ballot a key bit measured slower).
constexpr int ROUNDS = 2;
__device__ __forceinline__ unsigned group_of(bool ok, unsigned key, unsigned v, unsigned* sum) {
  const int lane = threadIdx.x & 31;
  unsigned left = __ballot_sync(0xffffffffu, ok);
  unsigned mine = 1u << lane;
  *sum = v;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    if (left == 0u) break;
    const unsigned k = __shfl_sync(0xffffffffu, key, __ffs(left) - 1);
    const bool in = (left >> lane & 1u) && key == k;
    const unsigned g = __ballot_sync(0xffffffffu, in);
    const unsigned s = __reduce_add_sync(0xffffffffu, in ? v : 0u);
    if (in) {
      mine = g;
      *sum = s;
    }
    left &= ~g;
  }
  return mine;
}

// Launch 1: each range's codes counted by bin into cnt[range, bin], a
// warp's 32 x UNROLL codes loaded at once. Grid: the ranges.
template <class Src>
__global__ void __launch_bounds__(HIST_BLOCK)
    bin_hist(Src src, long long n, long long space, long long lo, long long len, int nb,
             long long range, unsigned* __restrict__ cnt) {
  __shared__ unsigned s_cnt[MAX_BINS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int b = threadIdx.x; b < nb; b += HIST_BLOCK) s_cnt[b] = 0u;
  __syncthreads();
  const long long first = blockIdx.x * range;
  const long long last = first + range < n ? first + range : n;
  for (long long i0 = first + warp * 32 * UNROLL; i0 < last; i0 += HIST_BLOCK * UNROLL) {
    int code[UNROLL];
    unsigned w[UNROLL];
    src.template items<UNROLL>(i0, lane, 32, last, code, w);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      unsigned rec, c;
      const int bin = bin_of(code[u], w[u], space, lo, len, &rec);
      const unsigned peers = group_of(bin >= 0, static_cast<unsigned>(bin), 1u, &c);
      if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&s_cnt[bin], c);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += HIST_BLOCK)
    cnt[static_cast<long long>(blockIdx.x) * nb + b] = s_cnt[b];
}

// Launch 2: thread b turns bin b's column of counts into each range's
// exclusive prefix, in place, and writes the bin's total. The ranges all
// finish counting at once, so a decoupled look-back here would walk back
// to the first range (quadratic in the ranges); a column scan is not.
__global__ void bin_prefix(unsigned* __restrict__ pre, long long n_ranges, int nb,
                           unsigned* __restrict__ tot) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  unsigned run = 0;
  for (long long j0 = 0; j0 < n_ranges; j0 += 16) {   // 16 loads in flight
    unsigned c[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) c[u] = j0 + u < n_ranges ? pre[(j0 + u) * nb + b] : 0u;
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (j0 + u < n_ranges) {
        pre[(j0 + u) * nb + b] = run;
        run += c[u];
      }
  }
  tot[b] = run;
}

// Launch 3: each range's codes as records grouped by bin, a tile of STILE
// codes at a time: the tile's codes ranked by bin in shared memory, staged
// in bin order, and each bin's run written to the bin's next positions in
// the range's share, so the writes are runs and not one sector a code.
// Block 0 writes the bins' starts (start[nb] = the records); on a fresh
// table's first piece (fresh) the slices of bins bin_count splits are
// zeroed here. Grid: the ranges. Dynamic shared memory: scatter_smem(nb)
// bytes.
template <class Src>
__global__ void __launch_bounds__(PART_BLOCK)
    bin_scatter(Src src, long long n, long long space, long long lo, long long len, int nb,
                long long range, const unsigned* __restrict__ pre,
                const unsigned* __restrict__ tot, unsigned* __restrict__ start,
                unsigned* __restrict__ records, unsigned* __restrict__ table, int fresh) {
  extern __shared__ unsigned s_dyn[];
  unsigned* s_cur = s_dyn;          // each bin's next record position of the range
  unsigned* s_cnt = s_cur + nb;     // the tile's count of each bin, then its run's start
  unsigned* s_off = s_cnt + nb;     // a staged record's position, less its stage index
  unsigned* s_stage = s_off + nb;   // the tile's records in bin order
  auto* s_bin = reinterpret_cast<unsigned short*>(s_stage + STILE);
  const int lane = threadIdx.x & 31;
  const long long tile = blockIdx.x;
  // the bins' starts: a scan of the totals, a run of `per` bins a thread
  const int per = (nb + PART_BLOCK - 1) / PART_BLOCK;
  const int b0 = threadIdx.x * per;
  const int b1 = b0 + per < nb ? b0 + per : nb;
  unsigned sum = 0;
  for (int b = b0; b < b1; ++b) sum += tot[b];
  unsigned all;
  unsigned run = scan::block_exclusive_scan(sum, &all);
  for (int b = b0; b < b1; ++b) {
    if (tile == 0) start[b] = run;
    s_cur[b] = run + pre[tile * nb + b];
    run += tot[b];
  }
  if (tile == 0 && threadIdx.x == 0) start[nb] = all;
  if (fresh)
    for (int b = blockIdx.x; b < nb; b += gridDim.x) {
      if (tot[b] <= CAP) continue;
      const long long end = len - b * W < W ? len - b * W : W;
      for (long long o = threadIdx.x; o < end; o += PART_BLOCK) table[lo + b * W + o] = 0u;
    }
  const unsigned lower = (1u << lane) - 1u;
  const long long first = tile * range;
  const long long last = first + range < n ? first + range : n;
  for (long long t0 = first; t0 < last; t0 += STILE) {
    for (int b = threadIdx.x; b < nb; b += PART_BLOCK) s_cnt[b] = 0u;
    __syncthreads();
    // per code: its record, then (rank in the tile's codes of its bin << 13)
    // | bin, or ~0 for none
    unsigned rec[ITEMS], rb[ITEMS];
    {
      int c[ITEMS];
      src.template items<ITEMS>(t0, threadIdx.x, PART_BLOCK, last, c, rb);
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) rec[j] = static_cast<unsigned>(c[j]);
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      unsigned r = 0, c;
      const int bin = bin_of(static_cast<int>(rec[j]), rb[j], space, lo, len, &r);
      const unsigned peers = group_of(bin >= 0, static_cast<unsigned>(bin), 1u, &c);
      const int leader = __ffs(peers) - 1;
      unsigned at = 0;
      if (bin >= 0 && lane == leader) at = atomicAdd(&s_cnt[bin], __popc(peers));
      at = __shfl_sync(0xffffffffu, at, leader);
      rec[j] = r;
      rb[j] = bin >= 0 ? ((at + __popc(peers & lower)) << 13) | static_cast<unsigned>(bin) : ~0u;
    }
    __syncthreads();
    unsigned tile_n;
    unsigned r0 = 0;
    for (int b = b0; b < b1; ++b) r0 += s_cnt[b];
    r0 = scan::block_exclusive_scan(r0, &tile_n);
    for (int b = b0; b < b1; ++b) {
      const unsigned c = s_cnt[b];
      s_off[b] = s_cur[b] - r0;
      s_cur[b] += c;
      s_cnt[b] = r0;
      r0 += c;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (rb[j] == ~0u) continue;
      const unsigned bin = rb[j] & ((1u << 13) - 1u);
      const unsigned at = s_cnt[bin] + (rb[j] >> 13);
      s_stage[at] = rec[j];
      s_bin[at] = static_cast<unsigned short>(bin);
    }
    __syncthreads();
    for (unsigned i = threadIdx.x; i < tile_n; i += PART_BLOCK)
      records[s_off[s_bin[i]] + i] = s_stage[i];
    __syncthreads();
  }
}

// Pieces a bin of t records takes beyond its first.
__device__ __forceinline__ unsigned extra_pieces(unsigned t) {
  return t > CAP ? static_cast<unsigned>((t + CAP - 1) / CAP) - 1u : 0u;
}

// Launch 4: block b < nb counts bin b's records (its first CAP), block nb
// + e the e-th extra piece of the split bins in bin order; a block with no
// piece returns. fresh: the slice is stored (a fresh table's first piece),
// else added to, and a bin with no records is left as it is. Dynamic
// shared memory: W uint32 counters.
__global__ void __launch_bounds__(COUNT_BLOCK)
    bin_count(const unsigned* __restrict__ records, const unsigned* __restrict__ tot,
              const unsigned* __restrict__ start, int nb, long long lo, long long len,
              unsigned* __restrict__ table, int fresh) {
  extern __shared__ unsigned s_hist[];
  __shared__ int s_bin, s_piece;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int bin = static_cast<int>(blockIdx.x), piece = 0;
  if (bin >= nb) {
    const unsigned e = blockIdx.x - nb;
    const int per = (nb + COUNT_BLOCK - 1) / COUNT_BLOCK;
    const int b0 = threadIdx.x * per;
    const int b1 = b0 + per < nb ? b0 + per : nb;
    unsigned sum = 0;
    for (int b = b0; b < b1; ++b) sum += extra_pieces(tot[b]);
    if (threadIdx.x == 0) s_bin = -1;
    unsigned all;
    unsigned run = scan::block_exclusive_scan(sum, &all);
    for (int b = b0; b < b1; ++b) {
      const unsigned x = extra_pieces(tot[b]);
      if (e >= run && e < run + x) {
        s_bin = b;
        s_piece = static_cast<int>(e - run) + 1;
      }
      run += x;
    }
    __syncthreads();
    bin = s_bin;
    piece = s_piece;
    if (bin < 0) return;
  }
  const unsigned t = tot[bin];
  if (t == 0u && !fresh) return;
  const long long first = start[bin] + static_cast<long long>(piece) * CAP;
  const long long end = static_cast<long long>(start[bin]) + t;
  const long long last = first + CAP < end ? first + CAP : end;
  const int entries = static_cast<int>(len - bin * W < W ? len - bin * W : W);
  for (int o = threadIdx.x; o < entries; o += COUNT_BLOCK) s_hist[o] = 0u;
  __syncthreads();
  for (long long i0 = first + warp * 32 * UNROLL; i0 < last; i0 += COUNT_BLOCK * UNROLL) {
    unsigned r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = i0 + u * 32 + lane;
      r[u] = i < last ? records[i] : 0u;   // weight 0: no record
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool ok = (r[u] & ((1u << WEIGHT_BITS) - 1u)) != 0u;
      const unsigned off = r[u] >> WEIGHT_BITS;
      unsigned w;
      const unsigned peers = group_of(ok, off, r[u] & ((1u << WEIGHT_BITS) - 1u), &w);
      if (ok && lane == __ffs(peers) - 1) atomicAdd(&s_hist[off], w);
    }
  }
  __syncthreads();
  unsigned* slice = table + lo + bin * W;
  if (t > CAP || (!fresh && t < SPARSE)) {
    for (int o = threadIdx.x; o < entries; o += COUNT_BLOCK)
      if (s_hist[o] != 0u) atomicAdd(slice + o, s_hist[o]);
  } else if (entries % 4 == 0 && reinterpret_cast<uintptr_t>(slice) % 16 == 0) {
    auto* v = reinterpret_cast<uint4*>(slice);
    const auto* h = reinterpret_cast<const uint4*>(s_hist);
    for (int o = threadIdx.x; o < entries / 4; o += COUNT_BLOCK) {
      uint4 x = h[o];
      if (!fresh) {
        const uint4 y = v[o];
        x.x += y.x;
        x.y += y.y;
        x.z += y.z;
        x.w += y.w;
      }
      v[o] = x;
    }
  } else {
    for (int o = threadIdx.x; o < entries; o += COUNT_BLOCK)
      slice[o] = fresh ? s_hist[o] : slice[o] + s_hist[o];
  }
}

// Spaces of at most W entries: each block counts its codes into a shared
// histogram of the whole table (dynamic shared memory) and adds the
// nonzero entries into the table (K15 zeroes it first; K16 adds into it).
template <class Src>
__global__ void __launch_bounds__(COUNT_BLOCK)
    small_count(Src src, long long n, long long space, unsigned* __restrict__ table) {
  extern __shared__ unsigned s_hist[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = threadIdx.x; o < space; o += COUNT_BLOCK) s_hist[o] = 0u;
  __syncthreads();
  const long long step = static_cast<long long>(gridDim.x) * COUNT_BLOCK * UNROLL;
  for (long long i0 = (static_cast<long long>(blockIdx.x) * COUNT_BLOCK + warp * 32) * UNROLL;
       i0 < n; i0 += step) {
    int code[UNROLL];
    unsigned w[UNROLL];
    src.template items<UNROLL>(i0, lane, 32, n, code, w);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      unsigned rec = 0;
      const bool ok = bin_of(code[u], w[u], space, 0, space, &rec) >= 0;
      const unsigned off = rec >> WEIGHT_BITS;
      unsigned sum;
      const unsigned peers = group_of(ok, off, w[u], &sum);
      if (ok && lane == __ffs(peers) - 1) atomicAdd(&s_hist[off], sum);
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < space; o += COUNT_BLOCK)
    if (s_hist[o] != 0u) atomicAdd(table + o, s_hist[o]);
}

// Launches of small_count over n codes of src into a table of space <= W
// entries.
template <class Src>
int small_count_launch(Src src, long long n, long long space, unsigned* table, cudaStream_t s) {
  const int smem = static_cast<int>(space * 4);
  if (cudaError_t e = cudaFuncSetAttribute(small_count<Src>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return static_cast<int>(e);
  const long long grid = cdiv(n, COUNT_BLOCK * UNROLL);
  small_count<<<static_cast<unsigned>(grid < SMALL_GRID ? grid : SMALL_GRID), COUNT_BLOCK, smem,
                s>>>(src, n, space, table);
  return static_cast<int>(cudaGetLastError());
}

// K16 on a table larger than RED_SPACE entries: one launch of SWEEP_GRID
// blocks, each taking tiles of SWEEP_TILE windows in turn. A tile's windows are
// ranked by slice of the table (SWEEP_BINS slices of 2^shift entries) in
// shared memory, equal slices of a warp row combined first; their table
// offsets are staged in slice order, and the block makes their adds as
// REDs in stage order, a warp row at a time, equal offsets combined first
// (a poly-A batch's code 0 fills whole rows). The blocks start together on
// equal tiles, so they sweep the table together: the adds in flight fall
// in a moving part of it, not all over it. Dynamic shared memory:
// SWEEP_TILE uint32.
__global__ void __launch_bounds__(SWEEP_BLOCK)
    rows_sweep(RowsSource src, long long n, long long space, int shift,
               unsigned* __restrict__ table) {
  extern __shared__ unsigned s_stage[];
  __shared__ unsigned s_cnt[SWEEP_BINS];   // a slice's count in the tile, then its start
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  for (long long t0 = static_cast<long long>(blockIdx.x) * SWEEP_TILE; t0 < n;
       t0 += static_cast<long long>(gridDim.x) * SWEEP_TILE) {
    if (threadIdx.x < SWEEP_BINS) s_cnt[threadIdx.x] = 0u;
    __syncthreads();
    // per window: its table offset and its rank among the tile's windows of
    // its slice, or ~0 for none
    int code[ITEMS];
    unsigned w[ITEMS], rank[ITEMS];
    src.items<ITEMS>(t0, threadIdx.x, SWEEP_BLOCK, n, code, w);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      long long at = 0;
      const bool ok =
          w[j] != 0u && dna13::scatter_index(static_cast<unsigned>(code[j]), space, &at);
      const unsigned slice = static_cast<unsigned>(at >> shift);
      unsigned c;
      const unsigned peers = group_of(ok, slice, 1u, &c);
      const int leader = __ffs(peers) - 1;
      unsigned base = 0;
      if (ok && lane == leader) base = atomicAdd(&s_cnt[slice], __popc(peers));
      base = __shfl_sync(0xffffffffu, base, leader);
      code[j] = static_cast<int>(at);
      rank[j] = ok ? base + __popc(peers & lower) : ~0u;
    }
    __syncthreads();
    unsigned tile_n;
    const unsigned start =
        scan::block_exclusive_scan(threadIdx.x < SWEEP_BINS ? s_cnt[threadIdx.x] : 0u, &tile_n);
    if (threadIdx.x < SWEEP_BINS) s_cnt[threadIdx.x] = start;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (rank[j] != ~0u) {
        const unsigned at = static_cast<unsigned>(code[j]);
        s_stage[s_cnt[at >> shift] + rank[j]] = at;
      }
    __syncthreads();
    for (unsigned i0 = warp * 32; i0 < tile_n; i0 += SWEEP_BLOCK) {
      const unsigned i = i0 + lane;
      const bool ok = i < tile_n;
      const unsigned at = ok ? s_stage[i] : 0u;
      unsigned c;
      const unsigned peers = group_of(ok, at, 1u, &c);
      if (ok && lane == __ffs(peers) - 1) atomicAdd(table + at, c);
    }
    __syncthreads();
  }
}

// K16 on a table of at most RED_SPACE entries: each window's add a RED as
// the source makes it, a warp's 32 x 16 windows at once, equal entries of
// a warp row combined first. Grid: n over BLOCK x 16.
__global__ void __launch_bounds__(dna13::BLOCK)
    rows_red(RowsSource src, long long n, long long space, unsigned* __restrict__ table) {
  const int lane = threadIdx.x & 31;
  const long long first =
      (static_cast<long long>(blockIdx.x) * dna13::BLOCK + (threadIdx.x & ~31)) * 16;
  if (first >= n) return;   // the whole warp
  int code[16];
  unsigned w[16];
  src.items<16>(first, lane, 32, n, code, w);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    long long at = 0;
    const bool ok =
        w[j] != 0u && dna13::scatter_index(static_cast<unsigned>(code[j]), space, &at);
    unsigned c;
    const unsigned peers = group_of(ok, static_cast<unsigned>(at), 1u, &c);
    if (ok && lane == __ffs(peers) - 1) atomicAdd(table + at, c);
  }
}

// The four launches over every round of the table and piece of the n
// codes of src. fresh: the table holds nothing yet (its every entry is
// written on the first piece); else every piece adds into it.
template <class Src>
int partition_count(Src src, long long n, long long space, void* scratch, bool fresh,
                    unsigned* table, cudaStream_t s) {
  const Scratch sc = carve(scratch, n, space);
  if (cudaError_t e = cudaFuncSetAttribute(
          bin_count, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(W * 4)))
    return static_cast<int>(e);
  const long long nb_max = cdiv(space, W) < MAX_BINS ? cdiv(space, W) : MAX_BINS;
  if (cudaError_t e = cudaFuncSetAttribute(bin_scatter<Src>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           scatter_smem(static_cast<int>(nb_max))))
    return static_cast<int>(e);
  for (long long lo = 0; lo < space; lo += ROUND) {
    const long long len = space - lo < ROUND ? space - lo : ROUND;
    const int nb = static_cast<int>(cdiv(len, W));
    for (long long first = 0; first < n; first += PIECE) {
      const long long pn = n - first < PIECE ? n - first : PIECE;
      const long long n_ranges = ranges(pn);
      const int store = fresh && first == 0;
      bin_hist<<<static_cast<unsigned>(n_ranges), HIST_BLOCK, 0, s>>>(
          src.at(first), pn, space, lo, len, nb, range_len(pn), sc.pre);
      KERNEL_CHECK();
      bin_prefix<<<static_cast<unsigned>(cdiv(nb, 256)), 256, 0, s>>>(sc.pre, n_ranges, nb,
                                                                      sc.tot);
      KERNEL_CHECK();
      bin_scatter<<<static_cast<unsigned>(n_ranges), PART_BLOCK, scatter_smem(nb), s>>>(
          src.at(first), pn, space, lo, len, nb, range_len(pn), sc.pre, sc.tot, sc.start,
          sc.records, table, store);
      KERNEL_CHECK();
      bin_count<<<static_cast<unsigned>(nb + pn / CAP), COUNT_BLOCK, W * 4, s>>>(
          sc.records, sc.tot, sc.start, nb, lo, len, table, store);
      KERNEL_CHECK();
    }
  }
  return 0;
}

}  // namespace bins

}  // namespace

DNA13_EXPORT_ERROR_STRING

// counts: uint32[4^13], updated in place: every valid 13-mer window of the
// packed buffer adds 1. packed: uint32[n_words]; vbits: uint8[2 * n_words],
// 2-byte aligned
// (a window never crosses a word whose validity bits are all 0, so chunks
// apart by one such word count as if counted one by one). scratch:
// scatter_scratch_bytes(16 * n_words - 12, 4^13) bytes. Returns the first
// CUDA error of the launches, or 0.
extern "C" int count13_packed(void* counts, const void* packed, const void* vbits,
                              long long n_words, void* scratch, void* stream) {
  const long long n_win = 16 * n_words - (dna13::K - 1);
  if (n_win <= 0) return cudaSuccess;
  const bins::PackedSource src{static_cast<const unsigned*>(packed),
                               static_cast<const unsigned short*>(vbits), n_words, 0};
  return bins::partition_count(src, n_win, dna13::SPACE, scratch, false,
                               static_cast<unsigned*>(counts), static_cast<cudaStream_t>(stream));
}

// counts: uint32[space], 1 <= space < 2^31, every entry written (no
// memset needed). codes: int32[n] (uint32 bit patterns). valid: bool or
// uint8[n], each adding its value. scratch: scatter_scratch_bytes(n, space)
// bytes (none for space <= 2^15). Returns the first CUDA error of the
// memsets and launches, or 0.
extern "C" int scatter_count(void* counts, const void* codes, const void* valid, long long n,
                             long long space, void* scratch, void* stream) {
  using namespace bins;
  if (space < 1 || space >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* table = static_cast<unsigned*>(counts);
  const auto* c = static_cast<const int*>(codes);
  const auto* v = static_cast<const unsigned char*>(valid);
  if (n <= 0 || space <= W) {
    if (cudaError_t e = cudaMemsetAsync(table, 0, static_cast<size_t>(space) * 4, s))
      return static_cast<int>(e);
    if (n <= 0) return cudaSuccess;
    return small_count_launch(CodeSource{c, v}, n, space, table, s);
  }
  return partition_count(CodeSource{c, v}, n, space, scratch, true, table, s);
}

// counts: uint32[space], updated in place, 1 <= space < 2^31. ascii:
// uint8[rows, len], row-major, at any byte offset; 1 <= k <= 16. Returns
// the first CUDA error of the launch, or 0.
extern "C" int count13_rows(void* counts, const void* ascii, long long rows, long long len,
                            int k, long long space, void* stream) {
  using namespace bins;
  if (k < 1 || k > 16 || space < 1 || space >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || len < k) return cudaSuccess;
  const long long n = rows * len;   // a window at every byte, weight 0 past a row's last
  const RowsSource src{static_cast<const unsigned char*>(ascii), n, len,
                       dna23::reciprocal(len), k};
  auto* table = static_cast<unsigned*>(counts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (space <= SMALL_SPACE) return small_count_launch(src, n, space, table, s);
  if (space <= RED_SPACE) {
    rows_red<<<static_cast<unsigned>(cdiv(n, dna13::BLOCK * 16)), dna13::BLOCK, 0, s>>>(
        src, n, space, table);
    return static_cast<int>(cudaGetLastError());
  }
  int bits = 0;   // a slice: the top SWEEP_BITS of a table offset
  while ((1LL << bits) < space) ++bits;
  const int smem = SWEEP_TILE * 4;
  if (cudaError_t e = cudaFuncSetAttribute(rows_sweep,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return static_cast<int>(e);
  const long long tiles = cdiv(n, SWEEP_TILE);
  rows_sweep<<<static_cast<unsigned>(tiles < SWEEP_GRID ? tiles : SWEEP_GRID), SWEEP_BLOCK,
               smem, s>>>(src, n, space, bits > SWEEP_BITS ? bits - SWEEP_BITS : 0, table);
  return static_cast<int>(cudaGetLastError());
}
