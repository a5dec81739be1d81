// The verified key -> (tf, slot) probes of the sparse index's two query
// engines, the two query rules, and the kernels built on them: the query
// kernel (K6, K10, K11), the coverage kernel (K7, K10, K11 on packed rows;
// K7's ASCII-rows entry on ASCII rows) and the window -> slot step of the
// positional fill
// (K9, K10, K11; fill.cuh).
//
// Engines (aindex_tpu/index/sparse23.py:313-369 chooses between the
// tables):
//   Buckets <- index/quotcuckoo.py:281 _probe (the quotient cuckoo table,
//              two rows of (fingerprint, tf) and a slot column) and
//              index/cuckoo.py:142 cuckoo_query (the wide cuckoo table, two
//              rows of (key_lo, key_hi, tf, slot)): both tables answer
//              whether a key is present and with which tf and slot, so on
//              the device both are one layout, the same keys, tf and slots
//              as bucketed 16-byte records (kernels/buckets.py builds them
//              from the host rows at upload);
//   Mphf    <- kernels/lookup.py:100 mphf_lookup with sparse23.py:51
//              _query_kernel: the MPHF walk (fmix64 triple hash, unsigned
//              % domain, three 2-bit g-values, owner node (sum % 3)), then
//              the owner node's 16-byte record (checker key, tf, slot) in
//              place of JAX's node -> slot, checker and tf reads.
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
// slot. The answers are bit for bit the JAX versions', the keys no host
// row holds included: the quotient probe masks a key to 2k bits, and an
// empty row of the wide table matches one key (Buckets below).
//
// Bound: random reads of device memory, about 33 G of them a second on an
// H100 whether a read is 16, 32 or 64 bytes from one aligned block, and
// half that at 128 (scripts/randread.cu, PERF.md section 6). A Buckets
// probe reads one 64-byte bucket, and a second only for the few keys whose
// bucket overflowed (about 1% at E. coli scale), present or absent; the
// walk reads three g-words (a g-vector of a few MB, which L2 holds) and
// then one 16-byte node record. The tables of the E. coli-scale index
// (200-520 MB) are far beyond the 50 MB L2. Design: one thread per query;
// a run of E::RUN windows a thread for the coverage of packed or ASCII
// rows, rolled along a tile staged in shared memory (dna23::tile_run on a
// PackedSource or an AsciiSource: each byte or word loaded and coded once
// a tile, not once a window), with its probes issued together (each
// engine's issue() and finish()); invalid inputs
// read nothing; the record carries the slot; the 64-bit arithmetic
// (revcomp, mix64 and the walk's 64-bit remainders) hides under the
// memory latency.
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

// The bucketed records of the quotient and the wide cuckoo tables
// (kernels/buckets.py, which builds them from the host tables at upload):
// 16-byte records (key_lo, key_hi, tf, slot), BUCKET to a 64-byte aligned
// bucket; level l has 2^lb[l] buckets from bucket first[l], a key's bucket
// the top lb[l] bits of h, with h = mix64(key ^ seed) at level 0 and
// mix64(h ^ LEVEL_SALT) at each next one. A bucket keeps its first BUCKET
// keys; the rest went on to the next level, and then its first record's
// key_hi carries MARK. An empty record's key_hi is EMPTY_HI (bit 30),
// which no key below 2^62 has. A key is first masked to the table's w bits
// (2k for the quotient table, whose bijection masks so; 64 for the wide
// table); a masked key at or above 2^62 is absent but for EMPTY_KEY, the
// key an empty row of the wide table matches, whose host answer comes in
// u. p = {records}; u = {BUCKET, w, seed, empty hit, empty tf, empty slot,
// levels, first[0], lb[0], first[1], lb[1], ...}.
constexpr int BUCKET = 4;
constexpr int MAX_LEVELS = 8;
constexpr unsigned MARK = 0x80000000u;
constexpr uint64_t LEVEL_SALT = 0x2545F4914F6CDD1Dull;
constexpr uint64_t EMPTY_KEY = 0xFFFFFFFF00000000ull;

struct Buckets {
  // windows a thread of the packed coverage kernel takes, their buckets in
  // flight together (PERF.md section 6, PR 15: 1, 2, 4 and 8 measured; 2
  // within 2% of 1, 4 and 8 slower)
  static constexpr int RUN = 2;

  const uint4* records;
  uint64_t mask;
  uint64_t seed;
  unsigned empty_tf;
  int empty_slot;
  bool empty_hit;
  int levels;
  long long first[MAX_LEVELS];
  int shift[MAX_LEVELS];  // 63 - lb: (h >> 1) >> shift is the top lb bits

  static int make(const void* const* p, const unsigned long long* u, Buckets* e) {
    const int levels = static_cast<int>(u[6]);
    if (u[0] != BUCKET || u[1] < 1 || u[1] > 64 || levels < 1 || levels > MAX_LEVELS)
      return BAD;
    *e = Buckets{static_cast<const uint4*>(p[0]), u[1] == 64 ? ~0ull : (1ull << u[1]) - 1ull,
                 u[2], static_cast<unsigned>(u[4]), static_cast<int>(u[5]), u[3] != 0, levels,
                 {}, {}};
    for (int l = 0; l < levels; ++l) {
      if (u[8 + 2 * l] > 62) return BAD;
      e->first[l] = static_cast<long long>(u[7 + 2 * l]);
      e->shift[l] = 63 - static_cast<int>(u[8 + 2 * l]);
    }
    return 0;
  }

  // A probe in two steps, so that a thread can have several in flight:
  // issue() loads the key's level-0 bucket (nothing for a masked key at or
  // above 2^62), finish() answers from it, and reads the next levels only
  // when the bucket is marked. ref: the record's slot.
  struct Pending {
    uint4 r[BUCKET];
  };

  __device__ __forceinline__ void issue(uint64_t key, Pending* p) const {
    key &= mask;
    if (key >> 62) return;
    const uint4* b =
        records + (first[0] + static_cast<long long>((mix64(key ^ seed) >> 1) >> shift[0])) * BUCKET;
#pragma unroll
    for (int j = 0; j < BUCKET; ++j) p->r[j] = b[j];
  }

  // Whether a bucket's records hold the key, and its tf and slot: selects
  // over the four records (a bucket's keys are distinct), so the bucket
  // stays in registers; a loop that returned at the first match made the
  // compiler read the match back by index from a copy in local memory.
  __device__ static __forceinline__ bool match(const uint4 (&r)[BUCKET], unsigned lo, unsigned hi,
                                               unsigned* tf, long long* ref) {
    bool hit = false;
    unsigned t = 0u, s = 0u;
#pragma unroll
    for (int j = BUCKET - 1; j >= 0; --j) {
      const bool m = r[j].x == lo && (r[j].y & ~MARK) == hi;
      t = m ? r[j].z : t;
      s = m ? r[j].w : s;
      hit |= m;
    }
    if (hit) {
      *tf = t;
      *ref = static_cast<int>(s);
    }
    return hit;
  }

  __device__ __forceinline__ bool finish(uint64_t key, const Pending& p, unsigned* tf,
                                         long long* ref) const {
    key &= mask;
    if (key >> 62) {
      if (key != EMPTY_KEY || !empty_hit) return false;
      *tf = empty_tf;
      *ref = empty_slot;
      return true;
    }
    const unsigned lo = static_cast<unsigned>(key);
    const unsigned hi = static_cast<unsigned>(key >> 32);
    if (match(p.r, lo, hi, tf, ref)) return true;
    if (!(p.r[0].y & MARK)) return false;
    uint64_t h = mix64(key ^ seed);
#pragma unroll
    for (int l = 1; l < MAX_LEVELS; ++l) {  // unrolled: first[] and shift[] stay in registers
      if (l == levels) break;
      h = mix64(h ^ LEVEL_SALT);
      const uint4* b = records + (first[l] + static_cast<long long>((h >> 1) >> shift[l])) * BUCKET;
      uint4 r[BUCKET];
#pragma unroll
      for (int j = 0; j < BUCKET; ++j) r[j] = b[j];
      if (match(r, lo, hi, tf, ref)) return true;
      if (!(r[0].y & MARK)) return false;
    }
    return false;
  }

  // One aligned 64-byte bucket a level, the next level only when the
  // bucket is marked.
  __device__ __forceinline__ bool find(uint64_t key, unsigned* tf, long long* ref) const {
    Pending p;
    issue(key, &p);
    return finish(key, p, tf, ref);
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
  // windows a thread of the packed coverage kernel takes: one, since each
  // window's three 64-bit remainders, not its one record read, bound the
  // walk (PERF.md section 6, PR 15: 2, 4 and 8 a thread measured slower)
  static constexpr int RUN = 1;

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

  // Whether a node record holds the key as its checker key.
  __device__ static __forceinline__ bool holds(const uint4& r, uint64_t key) {
    return r.x == static_cast<unsigned>(key) && r.y == static_cast<unsigned>(key >> 32);
  }

  // The probe in two steps, as Buckets': issue() walks to the owner node
  // and loads its record (nothing when n = 0), finish() answers from it.
  // ref: the slot. One random 16-byte read a key, after the g-words it
  // depends on.
  struct Pending {
    uint4 r;
  };

  __device__ __forceinline__ void issue(uint64_t key, Pending* p) const {
    if (n != 0) p->r = records[owner(key)];
  }

  __device__ __forceinline__ bool finish(uint64_t key, const Pending& p, unsigned* tf_out,
                                         long long* ref) const {
    if (n == 0 || !holds(p.r, key)) return false;
    *tf_out = p.r.z;
    *ref = static_cast<int>(p.r.w);
    return true;
  }

  __device__ __forceinline__ bool find(uint64_t key, unsigned* tf_out, long long* ref) const {
    Pending p;
    issue(key, &p);
    return finish(key, p, tf_out, ref);
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
// invalid), optional slot (-1) and strand (0). Codes, mask and answers
// stream past L2 (__ldcs / __stcs: each is touched once), leaving it to
// the table.
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
      code = static_cast<uint64_t>(__ldcs(codes + i));
      if (MASK) ok = __ldcs(valid + i) != 0;
    }
    unsigned tf = 0u;
    long long ref = 0;
    int strand = 0;
    const bool hit = ok && resolve<E, RULE>(e, code, k, &tf, &ref, &strand);
    __stcs(tf_out + i, hit ? tf : 0u);
    if (SLOT) __stcs(slot_out + i, hit ? static_cast<int>(e.slot(ref)) : -1);
    if (STRAND) __stcs(strand_out + i, hit ? strand : 0);
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

// Per-position coverage of many rows at once, a warp a tile of 32 * E::RUN
// outputs (dna23::tile_run: the tile's bases staged in shared memory, a run
// of E::RUN windows rolled a thread) from either source: packed ingest, row
// r's sequence from base r * stride padded with invalid bases to stride,
// its stride - k windows written; or ASCII rows of stride bytes, their
// stride - k + 1 windows written. Each thread issues its valid windows'
// probes under the rule together (FWD_RC: the forward codes, then the
// reverse complements of the misses, again together), then applies the
// cutoff and stores its run.
template <class E, int RULE, class Src>
__global__ void __launch_bounds__(dna13::BLOCK)
    coverage_kernel(E e, Src src, long long rows, long long n_stage, unsigned long long recip,
                    unsigned cutoff, unsigned* __restrict__ out) {
  constexpr int RUN = E::RUN;
  extern __shared__ uint4 stage[];
  dna23::Run<RUN> w;
  dna23::tile_run(reinterpret_cast<unsigned*>(stage), n_stage, src, rows, recip, &w);
  if (!w.count) return;
  uint64_t key[RUN];
  typename E::Pending pend[RUN];
  unsigned tf[RUN];
  bool hit[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    key[j] = RULE == CANON && w.rc[j] < w.fwd[j] ? w.rc[j] : w.fwd[j];
    if (w.ok[j]) e.issue(key[j], &pend[j]);
  }
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    long long ref;
    tf[j] = 0u;
    hit[j] = w.ok[j] && e.finish(key[j], pend[j], &tf[j], &ref);
  }
  if (RULE == FWD_RC) {
#pragma unroll
    for (int j = 0; j < RUN; ++j)
      if (w.ok[j] && !hit[j]) e.issue(w.rc[j], &pend[j]);
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      long long ref;
      if (w.ok[j] && !hit[j]) hit[j] = e.finish(w.rc[j], pend[j], &tf[j], &ref);
    }
  }
#pragma unroll
  for (int j = 0; j < RUN; ++j) tf[j] = hit[j] && tf[j] >= cutoff ? tf[j] : 0u;
  dna23::store_run(out, w.first, w.count, tf);
}

// One coverage launch of the rows of src (rows >= 1, width >= 1): a block
// a tile of E::RUN * BLOCK outputs; refuses more than 2^31 - 1 tiles or
// rows * stride at or above 2^52.
template <class E, int RULE, class Src>
int launch_coverage(const E& e, const Src& src, long long rows, unsigned cutoff, void* out,
                    void* stream) {
  constexpr long long TILE = dna23::tile_outputs<E::RUN>();
  const long long width = src.width();
  const long long tiles = (rows * width + TILE - 1) / TILE;
  if (tiles > 0x7FFFFFFFLL || rows * src.stride >= (1LL << 52)) return BAD;
  const long long n_stage = dna23::stage_words<E::RUN>(width, src.k);
  coverage_kernel<E, RULE, Src><<<static_cast<unsigned>(tiles), dna13::BLOCK,
                                  dna23::stage_bytes(n_stage), static_cast<cudaStream_t>(stream)>>>(
      e, src, rows, n_stage, dna23::reciprocal(width), cutoff, static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The coverage entry of an engine: packed uint32[n_words] and vbits
// uint8[2 * n_words] hold rows * stride bases (below 2^52); rule CANON or
// FWD_RC; out uint32[rows, stride - k].
template <class E>
int coverage(const void* const* p, const unsigned long long* u, const void* packed,
             const void* vbits, long long n_words, long long rows, long long stride, int k,
             int rule, unsigned cutoff, void* out, void* stream) {
  if (rows <= 0 || stride <= k) return 0;
  E e;
  if (k < 1 || k > 31 || (rule != CANON && rule != FWD_RC) || E::make(p, u, &e) != 0)
    return BAD;
  const dna23::PackedSource src{static_cast<const unsigned*>(packed),
                                static_cast<const unsigned char*>(vbits), n_words, stride, k};
  if (rule == CANON) return launch_coverage<E, CANON>(e, src, rows, cutoff, out, stream);
  return launch_coverage<E, FWD_RC>(e, src, rows, cutoff, out, stream);
}

// The ASCII-rows coverage entry of an engine, canonical rule, no cutoff
// (quotcuckoo.py:329 quot_tf_windows has none): ascii uint8[rows, len]
// (row-major), out uint32[rows, len - k + 1], the tf of each window (0 for
// an invalid or absent one), on the same tiles as the packed entry.
template <class E>
int coverage_rows(const void* const* p, const unsigned long long* u, const void* ascii,
                  long long rows, long long len, int k, void* out, void* stream) {
  E e;
  if (k < 1 || k > 31 || E::make(p, u, &e) != 0) return BAD;
  if (rows <= 0 || len < k) return 0;
  const dna23::AsciiSource src{static_cast<const unsigned char*>(ascii), rows * len, len, k};
  return launch_coverage<E, CANON>(e, src, rows, 0u, out, stream);
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
