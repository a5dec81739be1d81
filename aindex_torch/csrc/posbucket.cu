// K14 posbucket: the send side of the mesh build's positional exchange,
// one launch per chunk of a data shard, after one memset:
//   each window's slot, by the same window -> slot step as the fill
//   (probe.cuh: the forward code of a k <= 16 window, Dense, or the
//   verified slot of the Buckets or Mphf engine under the CANON or FWD_RC
//   rule), -1 for invalid and absent windows; its destination shard is
//   slot / m (n_dest for none); its rank among the chunk's windows of that
//   destination, in window order; and the record ((slot + 1) << 24) |
//   window at buckets[dest, rank] while rank < cap, the rest counted as
//   overflow.
// Without buckets only the slots are written (one launch, no memset): the
// allgather exchange gathers them.
//
// Replaces the pre-exchange body of aindex_tpu/parallel/positional.py:133-172
// local_alltoall (with the window -> slot step :119-123 of its callers,
// index/positional.py:161-164 dense and :194-196 sparse): the argsort by
// destination, the searchsorted ranks, the packing and the bucket scatter.
//
// Bound: the probe's random reads (one 64-byte bucket or one node record a
// window, at the card's ~33 G random reads a second), then bytes: the
// chunk comes in packed (0.375 bytes a base), each window writes an 8-byte
// slot, each live window an 8-byte record, and the buckets' zeros (n_dest
// * cap * 8 bytes) are written once. Design: one launch in the shape of
// onesweep.cuh's pass. A block takes its tile of TILE = 2048 windows from
// an atomic counter (never from blockIdx, so every earlier tile has
// started), resolves every window's slot (eight a thread), writes the slots
// coalesced, ranks the tile's windows stably by destination digit with the
// warp multi-split (eight ballots), publishes each destination's tile count
// and looks back over the earlier tiles for its exclusive prefix
// (onesweep::look_back). Destination d owns buckets[d, :cap], so a
// window's place is d * cap + its rank: no global histogram, no scan, no
// sort. The memset zeroes the buckets and, right behind them, the tile
// counter and the status words (one a tile and destination); the last tile
// holds every destination's total and writes the overflow, sum over d of
// max(0, total_d - cap).
#include "onesweep.cuh"
#include "probe.cuh"

namespace {

// in-chunk window offsets in the low bits of a record (fill.cuh's Records
// reads them back on the receive side)
constexpr int DELTA_BITS = 24;
using onesweep::RADIX;
// windows a thread: eight. Sixteen held 110 registers (two blocks an SM,
// too few probes in flight); one, two and four made small tiles, and so
// many more look-backs; each measured slower on the card.
constexpr int ITEMS = 8;
constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int WARP_ITEMS = 32 * ITEMS;
constexpr int TILE = BLOCK * ITEMS;  // windows a tile

inline long long tiles(long long n_win) { return (n_win + TILE - 1) / TILE; }

// int64 words behind the n_dest * cap buckets: the tile counter, then one
// status word per (tile, destination)
inline long long status_words(long long n_win, int n_dest) { return 1 + tiles(n_win) * n_dest; }

// A window's slot: -1 when it is invalid, absent or not below n_slots.
template <class E, int RULE>
__device__ __forceinline__ long long window_slot(const E& e, const unsigned* __restrict__ packed,
                                                 const unsigned char* __restrict__ vbits,
                                                 long long n_words, long long p, int k,
                                                 long long n_slots) {
  long long slot = -1;
  uint64_t code;
  if (dna23::packed_window64(packed, vbits, n_words, p, k, &code)) {
    unsigned tf;
    long long ref;
    int strand;
    if (probe::resolve<E, RULE>(e, code, k, &tf, &ref, &strand)) slot = e.slot(ref);
  }
  return slot < n_slots ? slot : -1;
}

template <class E, int RULE>
__global__ void slots_kernel(const unsigned* __restrict__ packed,
                             const unsigned char* __restrict__ vbits, long long n_words, int k,
                             long long n_win, E e, long long n_slots, long long* __restrict__ slots,
                             int* __restrict__ counters) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < n_win;
       p += step)
    slots[p] = window_slot<E, RULE>(e, packed, vbits, n_words, p, k, n_slots);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    counters[0] = static_cast<int>(n_win);
    counters[1] = 0;
  }
}

// The fused pass. words: the tile counter (its low 32 bits), then the
// status words, tiles x n_dest, all zeroed. Grid: tiles(n_win).
template <class E, int RULE>
__global__ void __launch_bounds__(BLOCK)
    bucket_kernel(const unsigned* __restrict__ packed, const unsigned char* __restrict__ vbits,
                  long long n_words, int k, long long n_win, E e, long long n_slots, long long m,
                  int n_dest, long long cap, long long* __restrict__ slots,
                  long long* __restrict__ buckets, unsigned long long* words,
                  int* __restrict__ counters) {
  __shared__ int s_count[WARPS][RADIX];
  __shared__ long long s_base[RADIX];
  __shared__ long long s_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < WARPS * RADIX; i += BLOCK) (&s_count[0][0])[i] = 0;
  const long long tile = onesweep::take_tile(reinterpret_cast<unsigned*>(words), &s_tile);
  unsigned long long* status = words + 1;
  const long long base = tile * TILE + warp * WARP_ITEMS;
  const unsigned lower = (1u << lane) - 1u;

  // every window's slot first, written coalesced, one warp row at a time
  long long slot[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long p = base + j * 32 + lane;
    slot[j] = p < n_win ? window_slot<E, RULE>(e, packed, vbits, n_words, p, k, n_slots) : -1;
    if (p < n_win) slots[p] = slot[j];
  }

  // rank each row's windows among the warp's earlier windows of their
  // destination: rd = (rank << 8) | digit, -1 past the chunk
  int rd[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const bool ok = base + j * 32 + lane < n_win;
    const int d = !ok ? 0 : slot[j] >= 0 ? static_cast<int>(slot[j] / m) : n_dest;
    unsigned peers = __ballot_sync(0xffffffffu, ok);
#pragma unroll
    for (int b = 0; b < onesweep::DIGIT_BITS; ++b) {
      const unsigned bits = __ballot_sync(0xffffffffu, (d >> b) & 1);
      peers &= ((d >> b) & 1) ? bits : ~bits;
    }
    const int leader = ok ? __ffs(peers) - 1 : lane;
    int before = 0;
    if (ok && lane == leader) {
      before = s_count[warp][d];
      s_count[warp][d] = before + __popc(peers);
    }
    before = __shfl_sync(0xffffffffu, before, leader);
    __syncwarp();
    rd[j] = ok ? ((before + __popc(peers & lower)) << 8) | d : -1;
  }
  __syncthreads();

  // thread d < n_dest: the tile's count of destination d, each warp's
  // offset in it, and the destination's windows in the earlier tiles
  const int d = threadIdx.x;
  int total = 0;
  long long excl = 0;
  if (d < n_dest) {
    for (int w = 0; w < WARPS; ++w) {
      const int c = s_count[w][d];
      s_count[w][d] = total;
      total += c;
    }
    unsigned long long* own = status + tile * n_dest + d;
    onesweep::publish(own, (tile == 0 ? onesweep::INCLUSIVE : onesweep::AGGREGATE) |
                               static_cast<unsigned long long>(total));
    if (tile > 0) {
      excl = static_cast<long long>(onesweep::look_back(status + d, tile, n_dest));
      onesweep::publish(own, onesweep::INCLUSIVE | static_cast<unsigned long long>(excl + total));
    }
    s_base[d] = excl;
  }
  if (tile == gridDim.x - 1) {
    // the last tile holds every destination's total
    const long long over = d < n_dest && excl + total > cap ? excl + total - cap : 0;
    long long sum;
    scan::block_exclusive_scan(over, &sum);
    if (threadIdx.x == 0) {
      counters[0] = static_cast<int>(n_win);
      counters[1] = static_cast<int>(sum);
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (rd[j] < 0) continue;
    const int dj = rd[j] & (RADIX - 1);
    if (dj >= n_dest) continue;
    const long long rank = s_base[dj] + s_count[warp][dj] + (rd[j] >> 8);
    if (rank < cap)
      buckets[dj * cap + rank] =
          ((slot[j] + 1) << DELTA_BITS) | (base + j * 32 + lane);
  }
}

template <class E, int RULE>
int run(const E& e, const void* packed, const void* vbits, long long n_words, int k,
        long long n_slots, long long m, int n_dest, long long cap, void* slots, void* buckets,
        void* counters, cudaStream_t s) {
  const long long n_win = 16 * n_words - k + 1;
  const auto* pk = static_cast<const unsigned*>(packed);
  const auto* vb = static_cast<const unsigned char*>(vbits);
  auto* sl = static_cast<long long*>(slots);
  auto* cn = static_cast<int*>(counters);
  if (buckets == nullptr) {
    slots_kernel<E, RULE><<<dna13::grid_for(n_win), dna13::BLOCK, 0, s>>>(
        pk, vb, n_words, k, n_win, e, n_slots, sl, cn);
    return static_cast<int>(cudaGetLastError());
  }
  auto* b = static_cast<long long*>(buckets);
  const long long n_rec = static_cast<long long>(n_dest) * cap;
  if (cudaError_t err = cudaMemsetAsync(
          b, 0, static_cast<size_t>(n_rec + status_words(n_win, n_dest)) * sizeof(long long),
          s))
    return static_cast<int>(err);
  bucket_kernel<E, RULE><<<static_cast<unsigned>(tiles(n_win)), BLOCK, 0, s>>>(
      pk, vb, n_words, k, n_win, e, n_slots, m, n_dest, cap, sl, b,
      reinterpret_cast<unsigned long long*>(b + n_rec), cn);
  return static_cast<int>(cudaGetLastError());
}

template <class E>
int engine_rule(const void* const* p, const unsigned long long* u, int rule, const void* packed,
                const void* vbits, long long n_words, int k, long long n_slots, long long m,
                int n_dest, long long cap, void* slots, void* buckets, void* counters,
                cudaStream_t s) {
  E e;
  if (E::make(p, u, &e) != 0) return probe::BAD;
  if (rule == probe::CANON)
    return run<E, probe::CANON>(e, packed, vbits, n_words, k, n_slots, m, n_dest, cap, slots,
                                buckets, counters, s);
  if (rule == probe::FWD_RC)
    return run<E, probe::FWD_RC>(e, packed, vbits, n_words, k, n_slots, m, n_dest, cap, slots,
                                 buckets, counters, s);
  return probe::BAD;
}

}  // namespace

DNA13_EXPORT_ERROR_STRING

// engine: 0 dense (slot = the forward code, k <= 16; p, u and rule
// unused), 1 Buckets (the quotient or the wide table), 2 Mphf (probe.cuh's
// p and u, rule CANON or FWD_RC). packed uint32[n_words] + vbits uint8[2 *
// n_words]: the chunk's n_win = 16 * n_words - k + 1 windows (n_win <= 2^24
// with buckets). Slots run over [0, n_slots); destination shard d owns [d *
// m, (d + 1) * m). Out: slots int64[n_win]; buckets null (slots only) or an
// int64 buffer of n_dest * (cap + ceil(n_win / 2048)) + 1 words: the buckets
// [n_dest, cap], then the pass's tile counter and status words;
// counters int32[2] = (n_win, overflow). Returns the first CUDA error of
// the memset and the launch, or 0.
extern "C" int posbucket(int engine, const void* const* p, const unsigned long long* u, int rule,
                         const void* packed, const void* vbits, long long n_words, int k,
                         long long n_slots, long long m, int n_dest, long long cap, void* slots,
                         void* buckets, void* counters, void* stream) {
  const long long n_win = 16 * n_words - k + 1;
  if (k < 1 || k > 31 || n_win <= 0 || n_win >= (1LL << 31) - 1 || n_slots <= 0 || m <= 0 ||
      (buckets != nullptr && (n_dest < 1 || n_dest >= RADIX || cap <= 0 ||
                              n_win > (1LL << DELTA_BITS) ||
                              n_slots >= (1LL << (63 - DELTA_BITS)))))
    return probe::BAD;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (engine) {
    case 0:
      if (k > 16) return probe::BAD;
      return run<probe::Dense, probe::KEYS>(probe::Dense{}, packed, vbits, n_words, k, n_slots,
                                            m, n_dest, cap, slots, buckets, counters, s);
    case 1:
      return engine_rule<probe::Buckets>(p, u, rule, packed, vbits, n_words, k, n_slots, m,
                                         n_dest, cap, slots, buckets, counters, s);
    case 2:
      return engine_rule<probe::Mphf>(p, u, rule, packed, vbits, n_words, k, n_slots, m, n_dest,
                                      cap, slots, buckets, counters, s);
    default:
      return probe::BAD;
  }
}
