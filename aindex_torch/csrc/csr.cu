// K8 csr_offsets: the CSR offsets of the positional index, the exclusive
// int64 prefix sum of a uint32 per-slot occurrence table:
// offsets[0] = 0, offsets[i + 1] = offsets[i] + tf[i], offsets[n] = total.
//
// Replaces aindex_tpu/index/positional.py:39 _csr_offsets.
//
// Bound: bytes. The function reads 4n bytes and writes 8(n + 1); for the
// dense 13-mer table (n = 4^13) that is 805 MB, 0.24 ms at 3.35 TB/s.
// Design: one scan launch after one memset, with the decoupled look-back
// of csrc/onesweep.cuh, so the table is read once and the offsets written
// once. Each block takes a tile of TILE items from an atomic counter; each
// warp loads its WARP_ITEMS in rows of 16-byte vectors (coalesced) into
// shared memory and reads back 16 consecutive items a lane (a pad word
// every 16 keeps both sides free of bank conflicts); lane sums, a warp
// scan and a block step give every item its prefix within the tile; warp
// 0 publishes the tile's int64 sum and looks back for the sum before it
// (onesweep::warp_prefix); the int64 prefixes go back through shared
// memory and out in coalesced rows. The last tile writes offsets[n].
//
// A status word holds 62 bits of count. A tile's sum is below 2^44 (4096
// items under 2^32), and a launch scans at most PIECE = 2^30 items, whose
// sum stays below 2^62 (the dense 4^13 table's is below 2^58). A larger
// table (4^15 or 4^16 slots) is scanned in pieces of 2^30 items, one
// launch each, each adding the total of the pieces before it, read on the
// device from the cell where the previous launch wrote it; the int64 sums
// wrap as JAX's do.
#include "onesweep.cuh"

namespace {

using onesweep::BLOCK;
using onesweep::ITEMS;
using onesweep::TILE;
using onesweep::WARP_ITEMS;
using onesweep::WARPS;

constexpr long long PIECE = 1LL << 30;
static_assert(PIECE % TILE == 0, "pieces of whole tiles");
constexpr int PADDED = WARP_ITEMS + WARP_ITEMS / 16;

// item w of a warp's segment in its padded shared row
__device__ __forceinline__ int pad(int w) { return w + (w >> 4); }

// The exclusive scan of tf[0, m) (m <= PIECE) plus *carry (0 if null) into
// out[0, m], out[m] the inclusive total. counter: the launch's tile
// counter; status: its tiles(m) look-back words, zeroed. Grid: tiles(m).
__global__ void __launch_bounds__(BLOCK)
    csr_kernel(const unsigned* __restrict__ tf, long long m, const long long* carry,
               long long* out, unsigned* counter, unsigned long long* status) {
  __shared__ unsigned long long s_buf[WARPS][PADDED];
  __shared__ unsigned long long s_warp[WARPS];
  __shared__ unsigned long long s_base;
  __shared__ long long s_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile = onesweep::take_tile(counter, &s_tile);
  const long long base = tile * TILE + warp * WARP_ITEMS;
  // the offsets before this launch's items; a benign race with tile 0,
  // which writes the same value back to out[0]
  const unsigned long long before =
      carry != nullptr ? static_cast<unsigned long long>(*carry) : 0ull;

  // rows of 16-byte vectors into the warp's padded shared row
  auto* row = reinterpret_cast<unsigned*>(s_buf[warp]);
#pragma unroll
  for (int r = 0; r < WARP_ITEMS / 128; ++r) {
    const int w = (r * 32 + lane) * 4;
    const long long v = base + w;
    uint4 x;
    if (v + 3 < m) {
      x = *reinterpret_cast<const uint4*>(tf + v);
    } else {
      x.x = v < m ? tf[v] : 0u;
      x.y = v + 1 < m ? tf[v + 1] : 0u;
      x.z = v + 2 < m ? tf[v + 2] : 0u;
      x.w = v + 3 < m ? tf[v + 3] : 0u;
    }
    row[pad(w)] = x.x;
    row[pad(w + 1)] = x.y;
    row[pad(w + 2)] = x.z;
    row[pad(w + 3)] = x.w;
  }
  __syncwarp();
  unsigned val[ITEMS];
  unsigned long long sum = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    val[i] = row[pad(lane * ITEMS + i)];
    sum += val[i];
  }
  // the lane's prefix within the warp
  unsigned long long incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < WARPS; ++w) total += s_warp[w];
    const unsigned long long excl = onesweep::warp_prefix(status, tile, total);
    if (lane == 0) {
      unsigned long long run = 0;
      for (int w = 0; w < WARPS; ++w) {
        const unsigned long long c = s_warp[w];
        s_warp[w] = run;
        run += c;
      }
      s_base = before + excl;
      if (tile == gridDim.x - 1) out[m] = static_cast<long long>(before + excl + total);
    }
  }
  __syncthreads();

  // the lane's exclusive prefixes back through the shared row, then out in
  // coalesced rows
  unsigned long long run = s_base + s_warp[warp] + incl - sum;
  auto* orow = s_buf[warp];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    orow[pad(lane * ITEMS + i)] = run;
    run += val[i];
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int w = r * 32 + lane;
    if (base + w < m) out[base + w] = static_cast<long long>(orow[pad(w)]);
  }
}

}  // namespace

DNA13_EXPORT_ERROR_STRING

// tf: uint32[n], 16-byte aligned; offsets: int64[n + 1]; scratch:
// csr_scratch_bytes(n) = 8 * (pieces + tiles) bytes of device memory of
// the caller, pieces = ceil(n / 2^30), tiles = ceil(n / 4096): a tile
// counter word per piece, then a look-back word per tile
// (aindex_torch/kernels/positional.py csr_scratch_bytes). One memset and
// one launch per piece. Returns the first CUDA error of the launches, or 0.
extern "C" int csr_offsets(const void* tf, long long n, void* offsets, void* scratch,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || reinterpret_cast<uintptr_t>(tf) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* out = static_cast<long long*>(offsets);
  if (n == 0) return static_cast<int>(cudaMemsetAsync(out, 0, sizeof(long long), s));
  const long long pieces = (n + PIECE - 1) / PIECE;
  auto* words = static_cast<unsigned long long*>(scratch);
  if (cudaError_t e = cudaMemsetAsync(words, 0, 8 * (pieces + onesweep::tiles(n)), s))
    return static_cast<int>(e);
  const auto* in = static_cast<const unsigned*>(tf);
  for (long long q = 0; q < pieces; ++q) {
    const long long lo = q * PIECE;
    const long long m = n - lo < PIECE ? n - lo : PIECE;
    csr_kernel<<<static_cast<unsigned>(onesweep::tiles(m)), BLOCK, 0, s>>>(
        in + lo, m, q ? out + lo : nullptr, out + lo, reinterpret_cast<unsigned*>(words + q),
        words + pieces + lo / TILE);
    KERNEL_CHECK();
  }
  return 0;
}
