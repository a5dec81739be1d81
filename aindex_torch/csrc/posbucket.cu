// K14 posbucket: the send side of the mesh build's positional exchange,
// one launch sequence per chunk of a data shard:
//   1. each window's slot, by the same window -> slot step as the fill
//      (probe.cuh: the forward code of a k <= 16 window, Dense, or the
//      verified slot of the Buckets or Mphf engine under the CANON or
//      FWD_RC rule), -1 for invalid and absent windows; its destination
//      shard is slot / m (n_dest for none);
//   2. one radix pass on the destination digit (radix.cuh radix_hist and
//      the scan of its [digit, tile] histogram) gives each window its
//      rank among the chunk's windows of its destination, in window order;
//   3. each window writes the record ((slot + 1) << 24) | window to
//      buckets[dest, rank] while rank < cap, and counts the rest as
//      overflow.
// Without buckets only step 1 runs: the slots themselves, which the
// allgather exchange gathers.
//
// Replaces the pre-exchange body of aindex_tpu/parallel/positional.py:133-172
// local_alltoall (with the window -> slot step :119-123 of its callers,
// index/positional.py:161-164 dense and :194-196 sparse): the argsort by
// destination, the searchsorted ranks, the packing and the bucket scatter.
//
// Bound: bytes, plus the probe's random reads. The chunk comes in packed
// (0.375 bytes a base); each window writes an 8-byte slot, and the
// buckets (n_dest * cap * 8 bytes, zeroed first) take one 8-byte record a
// window; the sparse engines add their table reads (probe.cuh). Design:
// the destination digit takes radix.cuh's histogram and a stable in-tile
// ranking of its own, so a window's rank needs no sort at all.
#include "probe.cuh"
#include "radix.cuh"
#include "scan.cuh"

namespace {

// in-chunk window offsets in the low bits of a record (fill.cuh's Records
// reads them back on the receive side)
constexpr int DELTA_BITS = 24;

template <class E, int RULE>
__global__ void bucket_slots(const unsigned* __restrict__ packed,
                             const unsigned char* __restrict__ vbits, long long n_words, int k,
                             long long n_win, E e, long long n_slots, long long m, int n_dest,
                             long long* __restrict__ slots, unsigned long long* __restrict__ dest,
                             int* __restrict__ counters) {
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
    if (slot >= n_slots) slot = -1;
    slots[p] = slot;
    if (dest != nullptr)
      dest[p] = slot >= 0 ? static_cast<unsigned long long>(slot / m)
                          : static_cast<unsigned long long>(n_dest);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    counters[0] = static_cast<int>(n_win);
    counters[1] = 0;
  }
}

// A stable in-tile ranking on the destination digit, writing records:
// one warp a tile of radix::WARP_TILE windows, ranking equal digits with
// __match_any_sync. hist: the exclusive scan of radix_hist's [digit, tile]
// counts, so hist[d * n_tiles] is where destination d starts.
__global__ void bucket_scatter(const unsigned long long* __restrict__ dest,
                               const long long* __restrict__ slots,
                               const int* __restrict__ n_ptr, long long n_tiles,
                               const int* __restrict__ hist, int n_dest, long long cap,
                               long long* __restrict__ buckets, int* __restrict__ overflow) {
  __shared__ int next[radix::WARPS][radix::RADIX];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t = static_cast<long long>(blockIdx.x) * radix::WARPS + warp;
  if (t >= n_tiles) return;
  const long long n = *n_ptr;
  const long long base = t * radix::WARP_TILE;
  if (base >= n) return;
  for (int d = lane; d < radix::RADIX; d += 32)
    next[warp][d] = hist[static_cast<long long>(d) * n_tiles + t];
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
  for (int j = 0; j < radix::WARP_TILE && base + j < n; j += 32) {
    const long long i = base + j + lane;
    const bool ok = i < n;
    const int d = ok ? static_cast<int>(dest[i]) : radix::RADIX + lane;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (ok && d < n_dest) {
      const long long rank = static_cast<long long>(next[warp][d] + __popc(peers & lower)) -
                             hist[static_cast<long long>(d) * n_tiles];
      if (rank < cap)
        buckets[d * cap + rank] =
            ((slots[i] + 1) << DELTA_BITS) | static_cast<long long>(i);
      else
        atomicAdd(overflow, 1);
    }
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) next[warp][d] += __popc(peers);
    __syncwarp();
  }
}

template <class E, int RULE>
int run(const E& e, const void* packed, const void* vbits, long long n_words, int k,
        long long n_slots, long long m, int n_dest, long long cap, void* slots, void* buckets,
        void* counters, void* dest, void* hist, void* sums, cudaStream_t s) {
  const long long n_win = 16 * n_words - k + 1;
  auto* sl = static_cast<long long*>(slots);
  auto* ds = buckets != nullptr ? static_cast<unsigned long long*>(dest) : nullptr;
  auto* cn = static_cast<int*>(counters);
  bucket_slots<E, RULE><<<dna13::grid_for(n_win), dna13::BLOCK, 0, s>>>(
      static_cast<const unsigned*>(packed), static_cast<const unsigned char*>(vbits), n_words, k,
      n_win, e, n_slots, m, n_dest, sl, ds, cn);
  KERNEL_CHECK();
  if (buckets == nullptr) return 0;
  auto* b = static_cast<long long*>(buckets);
  if (cudaMemsetAsync(b, 0, static_cast<size_t>(n_dest) * cap * sizeof(long long), s) !=
      cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const long long tiles = radix::n_tiles(n_win);
  const unsigned grid = static_cast<unsigned>((tiles + radix::WARPS - 1) / radix::WARPS);
  auto* hs = static_cast<int*>(hist);
  radix::radix_hist<<<grid, radix::WARPS * 32, 0, s>>>(ds, cn, 0, tiles, hs);
  KERNEL_CHECK();
  if (int err = scan::exclusive_scan<int, int>(hs, hs, radix::RADIX * tiles,
                                               static_cast<int*>(sums), nullptr, s))
    return err;
  bucket_scatter<<<grid, radix::WARPS * 32, 0, s>>>(ds, sl, cn, tiles, hs, n_dest, cap, b, cn + 1);
  KERNEL_CHECK();
  return 0;
}

template <class E>
int engine_rule(const void* const* p, const unsigned long long* u, int rule, const void* packed,
                const void* vbits, long long n_words, int k, long long n_slots, long long m,
                int n_dest, long long cap, void* slots, void* buckets, void* counters,
                void* dest, void* hist, void* sums, cudaStream_t s) {
  E e;
  if (E::make(p, u, &e) != 0) return probe::BAD;
  if (rule == probe::CANON)
    return run<E, probe::CANON>(e, packed, vbits, n_words, k, n_slots, m, n_dest, cap, slots,
                                buckets, counters, dest, hist, sums, s);
  if (rule == probe::FWD_RC)
    return run<E, probe::FWD_RC>(e, packed, vbits, n_words, k, n_slots, m, n_dest, cap, slots,
                                 buckets, counters, dest, hist, sums, s);
  return probe::BAD;
}

}  // namespace

DNA13_EXPORT_ERROR_STRING

// engine: 0 dense (slot = the forward code, k <= 16; p, u and rule
// unused), 1 Buckets (the quotient or the wide table), 2 Mphf (probe.cuh's
// p and u, rule CANON or FWD_RC). packed uint32[n_words] + vbits uint8[2 * n_words]: the chunk's
// n_win = 16 * n_words - k + 1 windows (n_win <= 2^24 with buckets). Slots
// run over [0, n_slots); destination shard d owns [d * m, (d + 1) * m).
// Out: slots int64[n_win]; buckets int64[n_dest, cap] or null (slots only);
// counters int32[2] = (n_win, overflow). Scratch with buckets: dest
// uint64[n_win]; hist int32[256 * ceil(n_win / 1024)]; sums
// int32[ceil(256 * ceil(n_win / 1024) / 2048)]. Returns the first CUDA
// error of the launches, or 0.
extern "C" int posbucket(int engine, const void* const* p, const unsigned long long* u, int rule,
                         const void* packed, const void* vbits, long long n_words, int k,
                         long long n_slots, long long m, int n_dest, long long cap, void* slots,
                         void* buckets, void* counters, void* dest, void* hist, void* sums,
                         void* stream) {
  const long long n_win = 16 * n_words - k + 1;
  if (k < 1 || k > 31 || n_win <= 0 || n_win >= (1LL << 31) - 1 || n_slots <= 0 || m <= 0 ||
      (buckets != nullptr && (n_dest < 1 || n_dest >= radix::RADIX || cap <= 0 ||
                              n_win > (1LL << DELTA_BITS) ||
                              n_slots >= (1LL << (63 - DELTA_BITS)))))
    return probe::BAD;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (engine) {
    case 0:
      if (k > 16) return probe::BAD;
      return run<probe::Dense, probe::KEYS>(probe::Dense{}, packed, vbits, n_words, k, n_slots,
                                            m, n_dest, cap, slots, buckets, counters, dest, hist,
                                            sums, s);
    case 1:
      return engine_rule<probe::Buckets>(p, u, rule, packed, vbits, n_words, k, n_slots, m,
                                         n_dest, cap, slots, buckets, counters, dest, hist,
                                         sums, s);
    case 2:
      return engine_rule<probe::Mphf>(p, u, rule, packed, vbits, n_words, k, n_slots, m, n_dest,
                                      cap, slots, buckets, counters, dest, hist, sums, s);
    default:
      return probe::BAD;
  }
}
