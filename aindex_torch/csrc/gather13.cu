// K3 gather13: batched lookups in a dense 13-mer table, uint32 out.
//
// Replaces, as one kernel with compile-time modes:
//   aindex_tpu/kernels/lookup.py:32 gather_tf_valid      (codes, mask, fwd)
//   aindex_tpu/kernels/lookup.py:49 gather_tf_both_13    (codes, mask, fwd + rc)
//   aindex_tpu/index/dense13.py:103 _gather_total        (codes, mask, fwd on tf_total)
//   aindex_tpu/index/dense13.py:109 _gather_codes_u32    (codes, no mask)
//   aindex_tpu/index/dense13.py:115 _gather_codes_valid_u32 (codes, mask)
//   aindex_tpu/index/dense13.py:92  _encode_batch_dev    (ASCII [B, 13] rows in)
// Template parameters: the table's width (8, 16 or 32 bits), ASCII rows or
// codes in, a valid mask or none, the reverse-complement second output, and
// the half total table (HALF).
//
// The half total table: a total table holds tf[c] + tf[revcomp13(c)], the
// same value at c and at revcomp13(c), and no 13-mer is its own reverse
// complement (the middle base M would equal 3 - M). So the C entry
// gather13_half reads a table of 2^25 entries holding the totals of the
// codes with M < 2 (built by total13_half), at dna13::half_index of each
// code's jax_index: every answer of the full table, from half its bytes.
// The forward table is not symmetric and is always read whole.
//
// Two more C entries take a 1-D table of any length n and answer in the
// table's own type:
//   gather13_table <- aindex_tpu/kernels/lookup.py:22 gather_tf
//                     (table[code.astype(int32)], no mask);
//   gather13_total <- aindex_tpu/kernels/lookup.py:39 gather_tf_total_13
//                     (table[code] + table[revcomp_k(code)], summed in the
//                     table's type, masked): one pass, two reads, one
//                     write, with no total table.
//
// Bound: random reads of device memory. Each query reads one (or two)
// table entries at an address unrelated to its neighbours', so a warp
// touches 32 sectors for 32 useful entries of 1-4 bytes, and a read that
// misses L2 costs a DRAM sector. How many reads hit the 50 MB L2 depends
// on the table's footprint: the full uint8 table is 64 MiB, its half 32 MiB,
// the uint16 and uint32 tables twice and four times that (PERF.md §6 gives
// the card's random-read rate by footprint).
//
// Design: one thread per query. Codes, masks and answers are read and
// written coalesced with the evict-first streaming intrinsics (__ldcs /
// __stcs), the table with plain loads, so the 8+ bytes a query streams do
// not push the table's lines out of L2 ahead of its own. ASCII rows are
// decoded in registers. (Four codes a thread, and an evict_last L2 policy
// on part of the table, measured no faster on the H100: PERF.md §6.)
//
// Codes out of range read what JAX's gather reads (see dna13::jax_index,
// and jax_index_n for a table of n entries), never outside the table; the
// half table folds the index jax_index gives, so it reads what the full
// table reads. Invalid queries give 0.
#include "dna13.cuh"

namespace {

template <typename T, bool ASCII, bool MASK, bool BOTH, bool HALF>
__global__ void gather13_kernel(const T* __restrict__ table, const int* __restrict__ codes,
                                const unsigned char* __restrict__ valid,
                                const unsigned char* __restrict__ ascii, long long n,
                                unsigned* __restrict__ out, unsigned* __restrict__ out_rc) {
  static_assert(!(BOTH && HALF), "a half total table has no reverse-complement reads");
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    unsigned code = 0;
    bool ok = true;
    if (ASCII) {
      const unsigned char* row = ascii + i * dna13::K;
#pragma unroll
      for (int j = 0; j < dna13::K; ++j) {
        const unsigned b = dna13::ascii_code(row[j]);
        ok &= b < 4u;
        code = (code << 2) | (b & 3u);
      }
    } else {
      code = static_cast<unsigned>(__ldcs(codes + i));
      if (MASK) ok = __ldcs(valid + i) != 0;
    }
    const int slot = HALF ? dna13::half_index(dna13::jax_index(code)) : dna13::jax_index(code);
    __stcs(out + i, ok ? static_cast<unsigned>(table[slot]) : 0u);
    if (BOTH) __stcs(out_rc + i, ok ? static_cast<unsigned>(table[dna13::revcomp13(code)]) : 0u);
  }
}

template <typename T, bool ASCII, bool MASK, bool BOTH, bool HALF>
void launch(const void* table, const void* codes, const void* valid, const void* ascii,
            long long n, void* out, void* out_rc, cudaStream_t stream) {
  gather13_kernel<T, ASCII, MASK, BOTH, HALF><<<dna13::grid_for(n), dna13::BLOCK, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(codes),
      static_cast<const unsigned char*>(valid), static_cast<const unsigned char*>(ascii), n,
      static_cast<unsigned*>(out), static_cast<unsigned*>(out_rc));
}

template <typename T, bool BOTH, bool HALF>
void by_input(const void* table, const void* codes, const void* valid, const void* ascii,
              long long n, void* out, void* out_rc, cudaStream_t s) {
  if (ascii != nullptr)
    launch<T, true, false, BOTH, HALF>(table, codes, valid, ascii, n, out, out_rc, s);
  else if (valid != nullptr)
    launch<T, false, true, BOTH, HALF>(table, codes, valid, ascii, n, out, out_rc, s);
  else
    launch<T, false, false, BOTH, HALF>(table, codes, valid, ascii, n, out, out_rc, s);
}

template <bool BOTH, bool HALF>
int entry(const void* table, int width, const void* codes, const void* valid, const void* ascii,
          long long n, void* out, void* out_rc, void* stream) {
  if (n <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 8: by_input<uint8_t, BOTH, HALF>(table, codes, valid, ascii, n, out, out_rc, s); break;
    case 16: by_input<uint16_t, BOTH, HALF>(table, codes, valid, ascii, n, out, out_rc, s); break;
    case 32: by_input<uint32_t, BOTH, HALF>(table, codes, valid, ascii, n, out, out_rc, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
__global__ void gather_table_kernel(const T* __restrict__ table, long long n_table,
                                    const int* __restrict__ codes, long long n,
                                    T* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    __stcs(out + i, table[dna13::jax_index_n(static_cast<unsigned>(__ldcs(codes + i)), n_table)]);
}

template <typename T>
__global__ void gather_total_kernel(const T* __restrict__ table, long long n_table,
                                    const int* __restrict__ codes,
                                    const unsigned char* __restrict__ valid, int k, long long n,
                                    T* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    T v = 0;
    if (__ldcs(valid + i)) {
      const unsigned code = static_cast<unsigned>(__ldcs(codes + i));
      v = static_cast<T>(table[dna13::jax_index_n(code, n_table)] +
                         table[dna13::jax_index_n(dna13::revcomp13(code, k), n_table)]);
    }
    __stcs(out + i, v);
  }
}

template <typename T>
void launch_table(const void* table, long long n_table, const void* codes, const void* valid,
                  int k, long long n, void* out, bool total, cudaStream_t s) {
  const auto* t = static_cast<const T*>(table);
  const auto* c = static_cast<const int*>(codes);
  auto* o = static_cast<T*>(out);
  if (total)
    gather_total_kernel<T><<<dna13::grid_for(n), dna13::BLOCK, 0, s>>>(
        t, n_table, c, static_cast<const unsigned char*>(valid), k, n, o);
  else
    gather_table_kernel<T><<<dna13::grid_for(n), dna13::BLOCK, 0, s>>>(t, n_table, c, n, o);
}

int table_entry(const void* table, int width, long long n_table, const void* codes,
                const void* valid, int k, long long n, void* out, bool total, void* stream) {
  if (n_table < 1 || (total && (k < 1 || k > 16 || valid == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 8: launch_table<uint8_t>(table, n_table, codes, valid, k, n, out, total, s); break;
    case 16: launch_table<uint16_t>(table, n_table, codes, valid, k, n, out, total, s); break;
    case 32: launch_table<uint32_t>(table, n_table, codes, valid, k, n, out, total, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

DNA13_EXPORT_ERROR_STRING

// table: uint8/uint16/uint32[4^13] (width = 8, 16 or 32). Either ascii
// (uint8[n, 13]) is given, or codes (int32[n], uint32 bit patterns) with an
// optional valid (bool/uint8[n]). out: uint32[n]; out_rc: uint32[n] or null.
// Returns cudaGetLastError() after the launch.
extern "C" int gather13(const void* table, int width, const void* codes, const void* valid,
                        const void* ascii, long long n, void* out, void* out_rc,
                        void* stream) {
  return out_rc != nullptr
             ? entry<true, false>(table, width, codes, valid, ascii, n, out, out_rc, stream)
             : entry<false, false>(table, width, codes, valid, ascii, n, out, nullptr, stream);
}

// As gather13 with no out_rc, on a half total table: uint8/uint16/uint32
// [2^25], entry h the total of the code with M < 2 whose half_index is h.
// out[i] = total[code] for every query, as gather13 reads on the full table.
extern "C" int gather13_half(const void* table, int width, const void* codes, const void* valid,
                             const void* ascii, long long n, void* out, void* stream) {
  return entry<false, true>(table, width, codes, valid, ascii, n, out, nullptr, stream);
}

// table: uint8/uint16/uint32[n_table] (width = 8, 16 or 32), n_table >= 1.
// codes: int32[n] (uint32 bit patterns). out: the table's type, [n].
// Returns cudaGetLastError() after the launch.
extern "C" int gather13_table(const void* table, int width, long long n_table, const void* codes,
                              long long n, void* out, void* stream) {
  return table_entry(table, width, n_table, codes, nullptr, 0, n, out, false, stream);
}

// As gather13_table, plus valid (bool[n]) and 1 <= k <= 16: out[i] =
// table[code] + table[revcomp_k(code)] in the table's type where valid[i],
// else 0. Returns cudaGetLastError() after the launch.
extern "C" int gather13_total(const void* table, int width, long long n_table, const void* codes,
                              const void* valid, int k, long long n, void* out, void* stream) {
  return table_entry(table, width, n_table, codes, valid, k, n, out, true, stream);
}
