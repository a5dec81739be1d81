// K9 posfill: one chunk of the positional index's fill. Every valid window
// of a packed chunk, with slot s at blob position p = off + i, writes p + 1
// to positions[offsets[s] + cursor[s] + rank], where rank is the window's
// order among the chunk's windows of slot s, ascending by position; then
// cursor[s] advances by the number of those windows. Positions within a
// slot therefore ascend across chunks, bit for bit as aindex_tpu's.
//
// Replaces aindex_tpu/index/positional.py:47 _scatter_chunk (and :77, its
// donated jit) with the window -> slot step of its callers fused in:
// dense, the forward code of the window (positional.py:171-177,
// kernels/encode.py:98), read by csrc/dna23.cuh's packed_window64, the
// window of csrc/dna13.cuh widened to any k <= 31; sparse, the verified
// canonical slot of the quotient cuckoo table (positional.py:208-216,
// index/sparse23.py:371 _resolve -> index/quotcuckoo.py:378 quot_query),
// K6's probe.
//
// Bound: bytes. The chunk comes in packed (0.375 bytes a base), each valid
// window writes one 8-byte position, and each distinct slot reads its
// 8-byte offset and reads and writes its 4-byte cursor; the sparse probe
// adds one or two 8-byte table rows and a 4-byte slot per window. The
// design spends about ten times that on its sort, all plain kernels on one
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
#include "dna23.cuh"
#include "radix.cuh"
#include "scan.cuh"

namespace {

template <bool SPARSE>
__global__ void window_keys(const unsigned* __restrict__ packed,
                            const unsigned char* __restrict__ vbits, long long n_words, int k,
                            long long n_win, dna23::QuotTable t, long long n_slots,
                            int idx_bits, unsigned long long* __restrict__ keys,
                            int* __restrict__ flags) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < n_win;
       p += step) {
    long long slot = -1;
    uint64_t code;
    if (dna23::packed_window64(packed, vbits, n_words, p, k, &code)) {
      if (!SPARSE) {
        slot = static_cast<long long>(code);
      } else {
        unsigned tf;
        int half;
        long long row;
        if (dna23::quot_probe(t, dna23::canonical64(code, k), &tf, &half, &row))
          slot = dna23::quot_slot(t, half, row);
      }
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

__global__ void fill_kernel(const unsigned long long* __restrict__ s, const int* __restrict__ n_ptr,
                            int idx_bits, long long off, const long long* __restrict__ offsets,
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
      positions[cell] = off + static_cast<long long>(key & idx_mask) + 1;
  }
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

}  // namespace

DNA13_EXPORT_ERROR_STRING

// packed uint32[n_words] + vbits uint8[2 * n_words]: the chunk, whose
// n_win = 16 * n_words - k + 1 windows start at blob positions off + i.
// half0 null: dense mode, slot = the forward code of the k-mer (k <= 16).
// Otherwise sparse mode: slot = the slot column of the verified canonical
// probe (the quot23 table arguments, see csrc/quot23.cu). Slots run over
// [0, n_slots), slot_bits = bits of n_slots - 1, idx_bits = bits of
// n_win - 1, and slot_bits + idx_bits <= 64. offsets: int64[n_slots];
// cursor: int32[n_slots], advanced in place; positions: int64[total],
// written in place. Scratch, all device memory of the caller: counters int32[1];
// keys_a, keys_b uint64[n_win]; idx int32[n_win + 1]; hist
// int32[256 * ceil(n_win / 1024)]; sums int32[ceil(max(n_win + 1,
// 256 * ceil(n_win / 1024)) / 2048)]. Returns the first CUDA error of the
// launches, or 0.
extern "C" int posfill(const void* packed, const void* vbits, long long n_words, int k,
                       long long off, const void* half0, const void* half1, const void* slot0,
                       const void* slot1, long long m, int lb, int w, unsigned long long m1a,
                       unsigned long long m1b, unsigned long long m2a, unsigned long long m2b,
                       long long n_slots, int slot_bits, int idx_bits, const void* offsets,
                       void* cursor, void* positions, long long total, void* counters,
                       void* keys_a, void* keys_b, void* idx, void* hist, void* sums,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sparse = half0 != nullptr;
  const long long n_win = 16 * n_words - k + 1;
  if (k < 1 || k > (sparse ? 31 : 16) || n_win <= 0 || n_win >= (1LL << 31) - 1 ||
      n_slots <= 0 || slot_bits < 1 || idx_bits < 1 || slot_bits + idx_bits > 64 ||
      (n_slots - 1) >> slot_bits != 0 || (n_win - 1) >> idx_bits != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (sparse && (m <= 0 || (m & (m - 1)) != 0)) return static_cast<int>(cudaErrorInvalidValue);
  const dna23::QuotTable t{static_cast<const uint2*>(half0), static_cast<const uint2*>(half1),
                           static_cast<const int*>(slot0), static_cast<const int*>(slot1),
                           static_cast<uint64_t>(sparse ? m - 1 : 0), lb, w, m1a, m1b, m2a, m2b};

  auto* ka = static_cast<unsigned long long*>(keys_a);
  auto* kb = static_cast<unsigned long long*>(keys_b);
  auto* ix = static_cast<int*>(idx);
  auto* cn = static_cast<int*>(counters);
  const auto* pk = static_cast<const unsigned*>(packed);
  const auto* vb = static_cast<const unsigned char*>(vbits);
  const unsigned grid = dna13::grid_for(n_win);

  if (sparse)
    window_keys<true><<<grid, dna13::BLOCK, 0, s>>>(pk, vb, n_words, k, n_win, t, n_slots,
                                                   idx_bits, kb, ix);
  else
    window_keys<false><<<grid, dna13::BLOCK, 0, s>>>(pk, vb, n_words, k, n_win, t, n_slots,
                                                    idx_bits, kb, ix);
  KERNEL_CHECK();
  auto* sm = static_cast<int*>(sums);
  if (int e = scan::exclusive_scan<int, int>(ix, ix, n_win + 1, sm, cn, s)) return e;
  scan::compact<<<grid, dna13::BLOCK, 0, s>>>(kb, ix, n_win, ka);
  KERNEL_CHECK();

  unsigned long long* sorted = nullptr;
  if (int e = radix::sort(ka, kb, cn, n_win, idx_bits, idx_bits + slot_bits,
                          static_cast<int*>(hist), sm, s, &sorted))
    return e;
  fill_kernel<<<grid, dna13::BLOCK, 0, s>>>(sorted, cn, idx_bits, off,
                                           static_cast<const long long*>(offsets),
                                           static_cast<const int*>(cursor), total,
                                           static_cast<long long*>(positions));
  KERNEL_CHECK();
  advance_kernel<<<grid, dna13::BLOCK, 0, s>>>(sorted, cn, idx_bits, static_cast<int*>(cursor));
  KERNEL_CHECK();
  return 0;
}
