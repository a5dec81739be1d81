// The verified key -> (tf, slot) probes of the sparse index's three query
// engines, the two query rules, and the kernels built on them: the query
// kernel (K6, K10, K11), the coverage kernels (K7, K10, K11; and K7's
// ASCII-rows entry) and the window -> slot step of the positional fill
// (K9, K10, K11; fill.cuh).
//
// Engines (aindex_tpu/index/sparse23.py:313-369 chooses between them):
//   Quot   <- index/quotcuckoo.py:281 _probe: two 8-byte (fingerprint, tf)
//             rows of the quotient cuckoo table, a separate slot column;
//   Cuckoo <- index/cuckoo.py:142 cuckoo_query: two 16-byte (key_lo,
//             key_hi, tf, slot) rows at mix64(key ^ seed) & (m - 1);
//   Mphf   <- kernels/lookup.py:100 mphf_lookup with sparse23.py:51
//             _query_kernel: the MPHF walk (fmix64 triple hash, unsigned
//             % domain, three 2-bit g-values, owner node (sum % 3)), then
//             the owner node's 16-byte record (checker key, tf, slot) in
//             place of JAX's node -> slot, checker and tf reads.
// Rules (aindex_tpu/index/sparse23.py:553-578 _resolve_device):
//   KEYS   the codes are probed as they are (canonical keys given);
//   CANON  one probe of min(code, revcomp), strand from code <= revcomp
//          (indexes keyed by the true canonical code);
//   FWD_RC the forward code, else its reverse complement: strand 1 or 2
//          by the probe that hit (reference-keyed emphf indexes, whose
//          keys are kmer_counter's own canonical form).
//
// Each engine is a struct built on the host from a pointer array p and a
// parameter array u (both host memory; the layouts are under each make())
// and passed to the kernels by value. find() returns whether the key is
// present and writes its tf and a reference from which slot() gives its
// slot. Nothing is treated specially: an empty row matches only what its
// bits match, as in the JAX versions.
//
// Bound: random reads of device memory. A probe reads one or two rows (8
// or 16 bytes, each in its own 32-byte sector) or, for the walk, three
// g-words (a g-vector of a few MB, which L2 holds) and then one 16-byte
// node record, at addresses unrelated to its neighbours'; the tables of
// the E. coli-scale index (100-400 MB) are far beyond the 50 MB L2.
// Design: one thread per query or window; invalid inputs read nothing; the
// second row is read only on a first miss and the slot only when asked
// for; the 64-bit arithmetic (revcomp, the bijections, mix64 and the
// walk's 64-bit remainders) hides under the memory latency.
#pragma once

#include "dna23.cuh"

namespace probe {

enum Rule { KEYS = 0, CANON = 1, FWD_RC = 2 };

constexpr int BAD = static_cast<int>(cudaErrorInvalidValue);

// Murmur3 fmix64 (aindex_tpu/kernels/lookup.py:70 mix64).
__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xFF51AFD7ED558CCDull;
  x ^= x >> 33;
  x *= 0xC4CEB9FE1A85EC53ull;
  x ^= x >> 33;
  return x;
}

// xorshift-multiply bijection on the low w bits (quotcuckoo.py:103
// _bij_jnp): each multiply wraps modulo 2^64 and is masked back to w bits.
__device__ __forceinline__ uint64_t quot_bij(uint64_t x, uint64_t ma, uint64_t mb, int w) {
  const uint64_t mask = w >= 64 ? ~0ull : ((1ull << w) - 1ull);
  const int s = (w + 1) / 2;
  x &= mask;
  x ^= x >> s;
  x = (x * ma) & mask;
  x ^= x >> s;
  x = (x * mb) & mask;
  x ^= x >> s;
  return x;
}

// The quotient cuckoo table: two halves of m rows of (fingerprint, tf),
// each half its own array, and the two slot columns. A fingerprint match
// is an exact key match (row + fingerprint invert the bijection).
// p = {half0, half1, slot0, slot1}; u = {m, lb, w, m1a, m1b, m2a, m2b}.
struct Quot {
  const uint2* half0;
  const uint2* half1;
  const int* slot0;
  const int* slot1;
  uint64_t m;
  int lb;
  int w;
  uint64_t m1a, m1b, m2a, m2b;

  static int make(const void* const* p, const unsigned long long* u, Quot* e) {
    const uint64_t m = u[0];
    if (m == 0 || (m & (m - 1)) != 0 || (1ull << u[1]) != m || u[2] > 64) return BAD;
    *e = Quot{static_cast<const uint2*>(p[0]), static_cast<const uint2*>(p[1]),
              static_cast<const int*>(p[2]), static_cast<const int*>(p[3]), m,
              static_cast<int>(u[1]), static_cast<int>(u[2]), u[3], u[4], u[5], u[6]};
    return 0;
  }

  // ref: the row, plus m for the second half
  __device__ __forceinline__ bool find(uint64_t key, unsigned* tf, long long* ref) const {
    uint64_t h = quot_bij(key, m1a, m1b, w);
    long long r = static_cast<long long>(h & (m - 1));
    uint2 c = half0[r];
    if (c.x == static_cast<unsigned>(h >> lb)) {
      *tf = c.y;
      *ref = r;
      return true;
    }
    h = quot_bij(key, m2a, m2b, w);
    r = static_cast<long long>(h & (m - 1));
    c = half1[r];
    if (c.x == static_cast<unsigned>(h >> lb)) {
      *tf = c.y;
      *ref = r + static_cast<long long>(m);
      return true;
    }
    return false;
  }

  __device__ __forceinline__ long long slot(long long ref) const {
    const long long mm = static_cast<long long>(m);
    return ref < mm ? slot0[ref] : slot1[ref - mm];
  }
};

// The wide cuckoo table: 2m rows of (key_lo, key_hi, tf, slot), row
// mix64(key ^ seed1) & (m - 1) in the first half, mix64(key ^ seed2) &
// (m - 1) + m in the second. p = {table}; u = {m, seed1, seed2}.
struct Cuckoo {
  const uint4* table;
  uint64_t m;
  uint64_t seed1, seed2;

  static int make(const void* const* p, const unsigned long long* u, Cuckoo* e) {
    const uint64_t m = u[0];
    if (m == 0 || (m & (m - 1)) != 0) return BAD;
    *e = Cuckoo{static_cast<const uint4*>(p[0]), m, u[1], u[2]};
    return 0;
  }

  // ref: the row's slot
  __device__ __forceinline__ bool find(uint64_t key, unsigned* tf, long long* ref) const {
    const unsigned lo = static_cast<unsigned>(key);
    const unsigned hi = static_cast<unsigned>(key >> 32);
    uint4 c = table[mix64(key ^ seed1) & (m - 1)];
    if (c.x == lo && c.y == hi) {
      *tf = c.z;
      *ref = static_cast<int>(c.w);
      return true;
    }
    c = table[(mix64(key ^ seed2) & (m - 1)) + m];
    if (c.x == lo && c.y == hi) {
      *tf = c.z;
      *ref = static_cast<int>(c.w);
      return true;
    }
    return false;
  }

  __device__ __forceinline__ long long slot(long long ref) const { return ref; }
};

// The MPHF walk over the ATPF MPHF (index/mphf.py): the g-values packed 16
// to a uint32 word (3 = unassigned), and one 16-byte record a node, the
// (checker key's low and high words, tf, slot) of the node's slot
// (kernels/lookup.py walk_records; an unassigned node holds slot 0's, as
// the node -> slot table JAX walks reads 0 there). Node ids stay 64-bit.
// p = {g_packed, records}; u = {n, domain, seed}.
struct Mphf {
  const unsigned* g;
  const uint4* records;
  uint64_t n;
  uint64_t domain;
  uint64_t seed;

  static int make(const void* const* p, const unsigned long long* u, Mphf* e) {
    if (u[1] == 0) return BAD;
    *e = Mphf{static_cast<const unsigned*>(p[0]), static_cast<const uint4*>(p[1]), u[0], u[1],
              u[2]};
    return 0;
  }

  __device__ __forceinline__ unsigned gval(uint64_t node) const {
    return (g[node >> 4] >> (2 * static_cast<unsigned>(node & 15))) & 3u;
  }

  // The owner node of a key (lookup.py:124 mphf_owner_node): hash_triple
  // (lookup.py:83) puts node i in partition i; the sum of the three
  // g-values mod 3 picks one. Reads only the g-words.
  __device__ __forceinline__ uint64_t owner(uint64_t key) const {
    const uint64_t h = mix64(key ^ seed);
    const uint64_t n0 = h % domain;
    const uint64_t n1 = mix64(h ^ 0x9E3779B97F4A7C15ull) % domain + domain;
    const uint64_t n2 = mix64(h + 0x165667B19E3779F9ull) % domain + 2 * domain;
    const unsigned v = (gval(n0) + gval(n1) + gval(n2)) % 3u;
    return v == 0 ? n0 : (v == 1 ? n1 : n2);
  }

  // ref: the slot. One random 16-byte read a key, after the g-words it
  // depends on.
  __device__ __forceinline__ bool find(uint64_t key, unsigned* tf_out, long long* ref) const {
    if (n == 0) return false;
    const uint4 r = records[owner(key)];
    if (r.x != static_cast<unsigned>(key) || r.y != static_cast<unsigned>(key >> 32))
      return false;
    *tf_out = r.z;
    *ref = static_cast<int>(r.w);
    return true;
  }

  __device__ __forceinline__ long long slot(long long ref) const { return ref; }
};

// The dense positional fill's "engine": every valid k <= 16 window is its
// own slot, its forward code (fill.cuh, rule KEYS only).
struct Dense {
  __device__ __forceinline__ bool find(uint64_t key, unsigned* tf, long long* ref) const {
    *tf = 0u;
    *ref = static_cast<long long>(key);
    return true;
  }
  __device__ __forceinline__ long long slot(long long ref) const { return ref; }
};

// The query rule applied to a literal k-mer code; on a hit writes tf, ref
// and the strand (KEYS: 1).
template <class E, int RULE>
__device__ __forceinline__ bool resolve(const E& e, uint64_t code, int k, unsigned* tf,
                                        long long* ref, int* strand) {
  if (RULE == KEYS) {
    *strand = 1;
    return e.find(code, tf, ref);
  }
  const uint64_t rc = dna23::revcomp64(code, k);
  if (RULE == CANON) {
    *strand = code <= rc ? 1 : 2;
    return e.find(code < rc ? code : rc, tf, ref);
  }
  if (e.find(code, tf, ref)) {
    *strand = 1;
    return true;
  }
  *strand = 2;
  return e.find(rc, tf, ref);
}

// One thread per query: optional ASCII [n, k] rows -> code (a non-ACGT
// byte makes the row invalid), the rule's probes, tf (0 when absent or
// invalid), optional slot (-1) and strand (0).
template <class E, int RULE, bool ASCII, bool MASK, bool SLOT, bool STRAND>
__global__ void query_kernel(E e, const long long* __restrict__ codes,
                             const unsigned char* __restrict__ valid,
                             const unsigned char* __restrict__ ascii, int k, long long n,
                             unsigned* __restrict__ tf_out, int* __restrict__ slot_out,
                             int* __restrict__ strand_out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint64_t code = 0;
    bool ok = true;
    if (ASCII) {
      ok = dna23::ascii_window64(ascii + i * k, k, &code);
    } else {
      code = static_cast<uint64_t>(codes[i]);
      if (MASK) ok = valid[i] != 0;
    }
    unsigned tf = 0u;
    long long ref = 0;
    int strand = 0;
    const bool hit = ok && resolve<E, RULE>(e, code, k, &tf, &ref, &strand);
    tf_out[i] = hit ? tf : 0u;
    if (SLOT) slot_out[i] = hit ? static_cast<int>(e.slot(ref)) : -1;
    if (STRAND) strand_out[i] = hit ? strand : 0;
  }
}

template <class E, int RULE, bool ASCII, bool MASK>
int launch_query(const E& e, const void* codes, const void* valid, const void* ascii, int k,
                 long long n, void* tf, void* slot, void* strand, cudaStream_t s) {
  const auto* c = static_cast<const long long*>(codes);
  const auto* v = static_cast<const unsigned char*>(valid);
  const auto* a = static_cast<const unsigned char*>(ascii);
  auto* t = static_cast<unsigned*>(tf);
  auto* sl = static_cast<int*>(slot);
  auto* st = static_cast<int*>(strand);
  const unsigned grid = dna13::grid_for(n);
  if (strand != nullptr)
    query_kernel<E, RULE, ASCII, MASK, true, true><<<grid, dna13::BLOCK, 0, s>>>(
        e, c, v, a, k, n, t, sl, st);
  else if (slot != nullptr)
    query_kernel<E, RULE, ASCII, MASK, true, false><<<grid, dna13::BLOCK, 0, s>>>(
        e, c, v, a, k, n, t, sl, st);
  else
    query_kernel<E, RULE, ASCII, MASK, false, false><<<grid, dna13::BLOCK, 0, s>>>(
        e, c, v, a, k, n, t, sl, st);
  return static_cast<int>(cudaGetLastError());
}

template <class E, bool ASCII, bool MASK>
int query_rule(const E& e, const void* codes, const void* valid, const void* ascii, int k,
               long long n, int rule, void* tf, void* slot, void* strand, cudaStream_t s) {
  if (rule == CANON)
    return launch_query<E, CANON, ASCII, MASK>(e, codes, valid, ascii, k, n, tf, slot, strand, s);
  if (rule == FWD_RC)
    return launch_query<E, FWD_RC, ASCII, MASK>(e, codes, valid, ascii, k, n, tf, slot, strand, s);
  if (strand != nullptr) return BAD;  // no strand without a rule that sets one
  return launch_query<E, KEYS, ASCII, MASK>(e, codes, valid, ascii, k, n, tf, slot, strand, s);
}

// The query entry of an engine: ascii (uint8[n, k]) or codes (int64[n],
// uint64 bit patterns) with an optional valid (bool[n]); tf uint32[n];
// slot, strand int32[n] or null (strand needs slot).
template <class E>
int query(const void* const* p, const unsigned long long* u, const void* codes,
          const void* valid, const void* ascii, int k, long long n, int rule, void* tf,
          void* slot, void* strand, void* stream) {
  if (n <= 0) return 0;
  E e;
  if (k < 1 || k > 31 || rule < KEYS || rule > FWD_RC || tf == nullptr ||
      (strand != nullptr && slot == nullptr) || (ascii == nullptr && codes == nullptr) ||
      E::make(p, u, &e) != 0)
    return BAD;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ascii != nullptr)
    return query_rule<E, true, false>(e, codes, valid, ascii, k, n, rule, tf, slot, strand, s);
  if (valid != nullptr)
    return query_rule<E, false, true>(e, codes, valid, ascii, k, n, rule, tf, slot, strand, s);
  return query_rule<E, false, false>(e, codes, valid, ascii, k, n, rule, tf, slot, strand, s);
}

// Per-position coverage of many rows of packed ingest at once: one thread
// per (row, window) unpacks the window (dna23::packed_window64), applies
// the rule's probes and the cutoff. Row r holds its sequence from base
// r * stride, padded with invalid bases to stride, so the stride - k
// windows written per row never cross into the next row.
template <class E, int RULE>
__global__ void coverage_kernel(E e, const unsigned* __restrict__ packed,
                                const unsigned char* __restrict__ vbits, long long n_words,
                                long long rows, long long stride, int k, unsigned cutoff,
                                unsigned* __restrict__ out) {
  const long long width = stride - k;
  const long long n = rows * width;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const long long r = i / width;
    const long long pos = r * stride + (i - r * width);
    uint64_t code;
    unsigned tf = 0u;
    if (dna23::packed_window64(packed, vbits, n_words, pos, k, &code)) {
      long long ref;
      int strand;
      if (!resolve<E, RULE>(e, code, k, &tf, &ref, &strand)) tf = 0u;
    }
    out[i] = tf >= cutoff ? tf : 0u;
  }
}

// The coverage entry of an engine: packed uint32[n_words] and vbits
// uint8[2 * n_words] hold rows * stride bases; rule CANON or FWD_RC; out
// uint32[rows, stride - k].
template <class E>
int coverage(const void* const* p, const unsigned long long* u, const void* packed,
             const void* vbits, long long n_words, long long rows, long long stride, int k,
             int rule, unsigned cutoff, void* out, void* stream) {
  if (rows <= 0 || stride <= k) return 0;
  E e;
  if (k < 1 || k > 31 || (rule != CANON && rule != FWD_RC) || E::make(p, u, &e) != 0)
    return BAD;
  const long long n = rows * (stride - k);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pk = static_cast<const unsigned*>(packed);
  const auto* vb = static_cast<const unsigned char*>(vbits);
  auto* o = static_cast<unsigned*>(out);
  if (rule == CANON)
    coverage_kernel<E, CANON><<<dna13::grid_for(n), dna13::BLOCK, 0, s>>>(
        e, pk, vb, n_words, rows, stride, k, cutoff, o);
  else
    coverage_kernel<E, FWD_RC><<<dna13::grid_for(n), dna13::BLOCK, 0, s>>>(
        e, pk, vb, n_words, rows, stride, k, cutoff, o);
  return static_cast<int>(cudaGetLastError());
}

// Per-position coverage of ASCII rows: one thread per (row, window) reads
// the window's k bytes (dna23::ascii_window64), applies the rule's probes
// and writes the tf (0 for an invalid or absent window), uint32[rows, len -
// k + 1] out. No cutoff: quotcuckoo.py:329 quot_tf_windows has none.
template <class E, int RULE>
__global__ void coverage_rows_kernel(E e, const unsigned char* __restrict__ ascii,
                                     long long rows, long long len, int k,
                                     unsigned* __restrict__ out) {
  const long long width = len - k + 1;
  const long long n = rows * width;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const long long r = i / width;
    uint64_t code;
    unsigned tf = 0u;
    if (dna23::ascii_window64(ascii + r * len + (i - r * width), k, &code)) {
      long long ref;
      int strand;
      if (!resolve<E, RULE>(e, code, k, &tf, &ref, &strand)) tf = 0u;
    }
    out[i] = tf;
  }
}

// The ASCII-rows coverage entry of an engine, canonical rule: ascii
// uint8[rows, len] (row-major), out uint32[rows, len - k + 1].
template <class E>
int coverage_rows(const void* const* p, const unsigned long long* u, const void* ascii,
                  long long rows, long long len, int k, void* out, void* stream) {
  E e;
  if (k < 1 || k > 31 || E::make(p, u, &e) != 0) return BAD;
  if (rows <= 0 || len < k) return 0;
  const long long n = rows * (len - k + 1);
  coverage_rows_kernel<E, CANON><<<dna13::grid_for(n), dna13::BLOCK, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      e, static_cast<const unsigned char*>(ascii), rows, len, k, static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probe

// The C entries of one engine, each returning cudaGetLastError() after its
// launches (or cudaErrorInvalidValue for arguments it does not take).
#define PROBE_QUERY_ENTRY(NAME, ENGINE)                                                    \
  extern "C" int NAME(const void* const* p, const unsigned long long* u, const void* codes,  \
                      const void* valid, const void* ascii, int k, long long n, int rule,    \
                      void* tf, void* slot, void* strand, void* stream) {                    \
    return probe::query<ENGINE>(p, u, codes, valid, ascii, k, n, rule, tf, slot, strand,     \
                                stream);                                                     \
  }

#define PROBE_COVERAGE_ENTRY(NAME, ENGINE)                                                 \
  extern "C" int NAME(const void* const* p, const unsigned long long* u, const void* packed, \
                      const void* vbits, long long n_words, long long rows, long long stride, \
                      int k, int rule, unsigned cutoff, void* out, void* stream) {           \
    return probe::coverage<ENGINE>(p, u, packed, vbits, n_words, rows, stride, k, rule,      \
                                   cutoff, out, stream);                                     \
  }

#define PROBE_COVERAGE_ROWS_ENTRY(NAME, ENGINE)                                            \
  extern "C" int NAME(const void* const* p, const unsigned long long* u, const void* ascii,  \
                      long long rows, long long len, int k, void* out, void* stream) {       \
    return probe::coverage_rows<ENGINE>(p, u, ascii, rows, len, k, out, stream);             \
  }
