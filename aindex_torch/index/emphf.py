"""Reference-format MPHF (`.pf`) interop: load, query, build, and save the
emphf binary layout used by ad3002/aindex, so index artifact sets built by
the reference C++ pipeline load directly into aindex_torch (and vice versa).
A host numpy copy of aindex_tpu/index/emphf.py: nothing here runs on the
device, and the results are bit for bit aindex_tpu's.

Format (little-endian, reference: src/emphf/mphf.hpp:99-113):

    uint64 n                      number of keys
    uint64 hash_domain            nodes per partition (3 partitions)
    uint64 seed                   jenkins64_hasher seed
    uint64 m_size                 bitpair vector length (= 3*hash_domain)
    uint64 words[ceil(m_size/32)] 2-bit values, LSB-first within each word
                                  (reference: src/emphf/bitpair_vector.hpp:46-58)
    uint64 block_ranks[ceil(m_size/512)]
                                  nonzero-pair count before each 512-pair block
                                  (reference: src/emphf/ranked_bitpair_vector.hpp:17-30)

Lookup semantics (reference: src/emphf/mphf.hpp:79-89): hash the k-mer's
ASCII text with Jenkins lookup8 (reference: src/emphf/base_hash.hpp:38-91)
to a triple (h0,h1,h2); nodes ni = i*domain + hi % domain; the 2-bit values at
the three nodes sum (mod 3) to the index of the "owner" node; the slot is the
rank of that node among nonzero values.

Everything here is vectorised numpy over whole key batches; the rank
directory is expanded once at load into a flat node->rank table so lookups
are plain gathers (the same trade as index/mphf.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from aindex_torch import native
from aindex_torch.constants import ALPHABET

_GOLDEN = np.uint64(0x9E3779B97F4A7C13)  # base_hash.hpp:40
_PAIRS_PER_BLOCK = 512                   # ranked_bitpair_vector.hpp:87
_U64 = np.uint64

# ASCII byte per 2-bit base code (A=65, C=67, G=71, T=84).
_BASE_ASCII = np.frombuffer(ALPHABET.encode("ascii"), dtype=np.uint8) \
    .astype(np.uint64)


def _mix(a: np.ndarray, b: np.ndarray, c: np.ndarray):
    """Jenkins lookup8 avalanche (base_hash.hpp:127-145), mod-2^64."""
    a -= b; a -= c; a ^= c >> _U64(43)
    b -= c; b -= a; b ^= a << _U64(9)
    c -= a; c -= b; c ^= b >> _U64(8)
    a -= b; a -= c; a ^= c >> _U64(38)
    b -= c; b -= a; b ^= a << _U64(23)
    c -= a; c -= b; c ^= b >> _U64(5)
    a -= b; a -= c; a ^= c >> _U64(35)
    b -= c; b -= a; b ^= a << _U64(49)
    c -= a; c -= b; c ^= b >> _U64(11)
    a -= b; a -= c; a ^= c >> _U64(12)
    b -= c; b -= a; b ^= a << _U64(18)
    c -= a; c -= b; c ^= b >> _U64(22)
    return a, b, c


def _kmer_text_words(codes: np.ndarray, k: int) -> np.ndarray:
    """Little-endian uint64 words of each k-mer's ASCII text.

    Word w, byte j holds character index 8*w + j, exactly as
    unaligned_load64 sees the string (base_hash.hpp:11-17). Returns
    uint64[len(codes), ceil(k/8)] with bytes beyond k left zero.
    """
    codes = np.asarray(codes, dtype=np.uint64).reshape(-1, 1)
    # character i (0-based from the left) = base at bit offset 2*(k-1-i)
    shifts = (_U64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64))[None, :]
    bases = ((codes >> shifts) & _U64(3)).astype(np.int64)
    ascii_chars = _BASE_ASCII[bases]                       # [n, k] uint64
    n_words = (k + 7) // 8
    words = np.zeros((len(codes), n_words), dtype=np.uint64)
    for i in range(k):
        words[:, i // 8] |= ascii_chars[:, i] << _U64(8 * (i % 8))
    return words


def jenkins_triple_codes(codes: np.ndarray, k: int, seed: int):
    """(h0, h1, h2) of each k-mer's ASCII text, bit-identical to
    jenkins64_hasher::operator()(byte_range_t) for lengths <= 32
    (base_hash.hpp:38-91). Vectorised over the batch; large batches route
    to the scalar C version (native.jenkins_triple_codes, same bits; the
    numpy path's [batch, k] broadcast temporaries are memory-bound)."""
    if k > 32:
        raise ValueError("jenkins_triple_codes supports k <= 32")
    codes = np.asarray(codes, dtype=np.uint64)
    if codes.size >= (1 << 16):
        if native.available():
            return native.jenkins_triple_codes(codes, k, int(seed))
    words = _kmer_text_words(codes, k)
    n = words.shape[0]
    a = np.full(n, seed, dtype=np.uint64)
    b = a.copy()
    c = np.full(n, _GOLDEN, dtype=np.uint64)
    with np.errstate(over="ignore"):
        rem = k
        col = 0
        if k >= 24:  # one full 24-byte block
            a += words[:, 0]
            b += words[:, 1]
            c += words[:, 2]
            a, b, c = _mix(a, b, c)
            rem -= 24
            col = 3
        c += _U64(k)
        # tail: bytes [0,8) -> a, [8,16) -> b, [16,23) -> c<<8
        # (the low byte of c is reserved for the length, base_hash.hpp:59-86)
        if rem > 0:
            a += words[:, col]
        if rem > 8:
            b += words[:, col + 1]
        if rem > 16:
            c += words[:, col + 2] << _U64(8)
        a, b, c = _mix(a, b, c)
    return a, b, c


def _nonzero_pairs_per_word(words: np.ndarray) -> np.ndarray:
    """Number of nonzero 2-bit fields in each uint64 word
    (ranked_bitpair_vector.hpp:92-107)."""
    ones4 = _U64(0x1111111111111111)
    x = (words | (words >> _U64(1))) & (_U64(0x5) * ones4)
    x = (x & _U64(3) * ones4) + ((x >> _U64(2)) & _U64(3) * ones4)
    x = (x + (x >> _U64(4))) & _U64(0x0F) * _U64(0x0101010101010101)
    with np.errstate(over="ignore"):
        return (x * _U64(0x0101010101010101)) >> _U64(56)


@dataclasses.dataclass
class EmphfPF:
    """A reference-format MPHF, expanded for batched lookups.

    ``values`` is the unpacked 2-bit vector (one uint8 per node);
    ``ranks[node]`` = number of nonzero values before ``node`` — the
    materialised form of the reference's blocked rank directory
    (ranked_bitpair_vector.hpp:47-62), so a lookup is three value gathers
    plus one rank gather.
    """

    n: int
    domain: int
    seed: int
    values: np.ndarray   # uint8[3*domain]
    ranks: np.ndarray    # int64[3*domain], exclusive prefix count of nonzero

    @property
    def n_nodes(self) -> int:
        return 3 * self.domain

    # -- queries -----------------------------------------------------------

    def lookup_codes(self, codes: np.ndarray, k: int) -> np.ndarray:
        """Slot ids of 2-bit k-mer codes — identical to the reference's
        hasher.lookup over the k-mer strings (mphf.hpp:79-89)."""
        h0, h1, h2 = jenkins_triple_codes(codes, k, self.seed)
        d = _U64(self.domain)
        n0 = (h0 % d).astype(np.int64)
        n1 = (h1 % d).astype(np.int64) + self.domain
        n2 = (h2 % d).astype(np.int64) + 2 * self.domain
        v = (self.values[n0].astype(np.int64) + self.values[n1]
             + self.values[n2]) % 3
        node = np.where(v == 0, n0, np.where(v == 1, n1, n2))
        return self.ranks[node]

    def lookup_strings(self, kmers: list[str], k: int) -> np.ndarray:
        from aindex_torch.core import codec
        codes, _ = codec.encode_kmers(kmers, k)
        return self.lookup_codes(codes, k)

    # -- serialisation (exact reference layout) -----------------------------

    @classmethod
    def load(cls, path: str) -> "EmphfPF":
        with open(path, "rb") as f:
            head = np.fromfile(f, dtype=np.uint64, count=4)
            if head.size != 4:
                raise ValueError(f"{path}: truncated emphf .pf header")
            n, domain, seed, m_size = (int(x) for x in head)
            if m_size != 3 * domain:
                raise ValueError(
                    f"{path}: bitpair size {m_size} != 3*hash_domain {3*domain} "
                    "(not an emphf .pf file?)")
            n_words = (m_size + 31) // 32
            words = np.fromfile(f, dtype=np.uint64, count=n_words)
            if words.size != n_words:
                raise ValueError(f"{path}: truncated bitpair vector")
            # The trailing block ranks are recomputed from the words.
        return cls._from_words(n, domain, seed, words)

    #: byte -> its four 2-bit fields (little-endian), so unpacking a word
    #: is one uint8 LUT gather instead of a [words, 32] uint64 broadcast
    #: shift (measured 45x faster on the 82M-node 13-mer vector)
    _BITPAIR_LUT = np.array([[(v >> (2 * i)) & 3 for i in range(4)]
                             for v in range(256)], dtype=np.uint8)

    @classmethod
    def _from_words(cls, n: int, domain: int, seed: int,
                    words: np.ndarray) -> "EmphfPF":
        m_size = 3 * domain
        # uint64 little-endian: byte j of a word holds values 4j..4j+3
        values = cls._BITPAIR_LUT[words.view(np.uint8)].reshape(-1)[:m_size]
        nonzero = values != 0
        ranks = np.zeros(m_size, dtype=np.int64)
        np.cumsum(nonzero[:-1], out=ranks[1:])
        return cls(n, domain, seed, values, ranks)

    def save(self, path: str) -> None:
        """Write the exact reference layout (loadable by the reference C++)."""
        m_size = self.n_nodes
        n_words = (m_size + 31) // 32
        padded = np.zeros(n_words * 32, dtype=np.uint64)
        padded[:m_size] = self.values
        shifts = (np.arange(32, dtype=np.uint64) * _U64(2))[None, :]
        words = np.bitwise_or.reduce(
            padded.reshape(-1, 32) << shifts, axis=1).astype(np.uint64)
        per_word = _nonzero_pairs_per_word(words)
        words_per_block = _PAIRS_PER_BLOCK // 32
        n_blocks = (m_size + _PAIRS_PER_BLOCK - 1) // _PAIRS_PER_BLOCK
        block_tot = np.zeros(n_blocks, dtype=np.uint64)
        wsum = np.add.reduceat(per_word,
                               np.arange(0, n_words, words_per_block))
        block_tot[:len(wsum)] = wsum
        block_ranks = np.zeros(n_blocks, dtype=np.uint64)
        np.cumsum(block_tot[:-1], out=block_ranks[1:])
        with open(path, "wb") as f:
            np.array([self.n, self.domain, self.seed, m_size],
                     dtype=np.uint64).tofile(f)
            words.tofile(f)
            block_ranks.tofile(f)

    # -- construction (reference-compatible build) --------------------------

    @classmethod
    def build(cls, codes: np.ndarray, k: int, max_trials: int = 64,
              rng_seed: int = 37) -> "EmphfPF":
        """Build a reference-format MPHF over distinct k-mer codes.

        Same 3-hypergraph peel as the reference (hypergraph_sorter_seq.hpp:
        29-102) with the emphf assignment convention: assigned values are
        nonzero in {1,2,3} with 3 === 0 (mod 3) (mphf.hpp:57-64), so rank
        over nonzero values yields the slot. The seed-trial RNG is mt19937_64
        in the reference; any seed that peels is valid (the seed is stored in
        the file), so a numpy RNG is used here.
        """
        codes = np.asarray(codes, dtype=np.uint64)
        n = len(codes)
        if n == 0:
            return cls(0, 1, 0, np.zeros(3, np.uint8), np.zeros(3, np.int64))
        if len(np.unique(codes)) != n:
            raise ValueError("MPHF keys must be distinct")
        domain = (int(np.ceil(1.23 * n)) + 2) // 3  # mphf.hpp:26
        domain = max(domain, 1)
        rng = np.random.default_rng(rng_seed)
        for trial in range(max_trials):
            seed = int(rng.integers(0, 1 << 63, dtype=np.int64))
            values = cls._try_build(codes, k, n, domain, seed)
            if values is not None:
                nonzero = values != 0
                ranks = np.zeros(3 * domain, dtype=np.int64)
                np.cumsum(nonzero[:-1], out=ranks[1:])
                return cls(n, domain, seed, values, ranks)
            if trial >= 2:
                domain = int(domain * 1.05) + 1
        raise RuntimeError(f"emphf peeling failed after {max_trials} trials (n={n})")

    @classmethod
    def build_exact(cls, codes: np.ndarray, k: int,
                    max_trials: int = 64) -> "EmphfPF":
        """Bit-exact twin of the reference builder (compute_mphf_seq).

        Reproduces the reference construction end to end: the same
        mt19937_64(37) seed sequence (mphf.hpp:45-50), the same sequential
        peel order (hypergraph_sorter_seq.hpp:63-91 — node-scan + FIFO
        over each peeled edge's v1/v2), and the same reverse assignment
        (mphf.hpp:57-64). Given the same key SET, ``save`` then emits a
        .pf byte-identical to the reference's (construction depends only
        on the set: the XOR adjacency is insertion-order-independent).
        Verified against reference-built golden artifacts in
        tests/test_torch_emphf.py.

        The peel itself is the native sequential pass
        (native.emphf_peel_assign); without a C++ compiler the pure-Python
        version, exact too but slow, runs (small key sets only).
        """
        codes = np.asarray(codes, dtype=np.uint64)
        n = len(codes)
        if n == 0:
            return cls(0, 1, 0, np.zeros(3, np.uint8), np.zeros(3, np.int64))
        if len(np.unique(codes)) != n:
            raise ValueError("MPHF keys must be distinct")
        domain = (int(np.ceil(1.23 * n)) + 2) // 3  # mphf.hpp:26
        if 3 * domain >= (1 << 32):
            raise ValueError("key set too large for uint32 node ids")
        rng = _MT19937_64(37)                       # mphf.hpp:45
        for _trial in range(max_trials):
            seed = rng.next()
            d = _U64(domain)
            # chunked hashing: the [batch, k] broadcast temporaries of the
            # jenkins kernel are ~100 bytes/key — chunking bounds them
            n0 = np.empty(n, np.uint32)
            n1 = np.empty(n, np.uint32)
            n2 = np.empty(n, np.uint32)
            step = 1 << 21
            for s in range(0, n, step):
                h0, h1, h2 = jenkins_triple_codes(codes[s:s + step], k,
                                                  _U64(seed))
                n0[s:s + step] = h0 % d
                n1[s:s + step] = (h1 % d) + d
                n2[s:s + step] = (h2 % d) + _U64(2) * d
            if native.available():
                g = native.emphf_peel_assign(n0, n1, n2, domain)
            else:
                g = _peel_assign_py(n0, n1, n2, domain)
            if g is not None:
                nonzero = g != 0
                ranks = np.zeros(3 * domain, dtype=np.int64)
                np.cumsum(nonzero[:-1], out=ranks[1:])
                return cls(n, domain, seed, g, ranks)
        raise RuntimeError(
            f"emphf-exact peeling failed after {max_trials} trials (n={n})")

    @staticmethod
    def is_emphf_file(path: str) -> bool:
        """Cheap layout sniff: header sanity + exact expected file size."""
        import os
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                head = np.fromfile(f, dtype=np.uint64, count=4)
        except OSError:
            return False
        if head.size != 4:
            return False
        n, domain, _seed, m_size = (int(x) for x in head)
        if m_size != 3 * domain or n > m_size or domain == 0:
            return False
        n_words = (m_size + 31) // 32
        n_blocks = (m_size + _PAIRS_PER_BLOCK - 1) // _PAIRS_PER_BLOCK
        return size == 8 * (4 + n_words + n_blocks)

    @staticmethod
    def _try_build(codes, k, n, domain, seed):
        h0, h1, h2 = jenkins_triple_codes(codes, k, seed)
        d = _U64(domain)
        edge_nodes = np.stack([
            (h0 % d).astype(np.int64),
            (h1 % d).astype(np.int64) + domain,
            (h2 % d).astype(np.int64) + 2 * domain,
        ], axis=1)
        n_nodes = 3 * domain

        deg = np.zeros(n_nodes, dtype=np.int64)
        xor_edge = np.zeros(n_nodes, dtype=np.int64)
        eids = np.arange(n, dtype=np.int64)
        for j in range(3):
            np.add.at(deg, edge_nodes[:, j], 1)
            np.bitwise_xor.at(xor_edge, edge_nodes[:, j], eids)

        # Round-synchronous vectorised peel (order-independent; the reference
        # peels one node at a time but the peelability outcome is the same).
        peel_edges, peel_free = [], []
        alive = np.ones(n, dtype=bool)
        n_peeled = 0
        frontier = np.flatnonzero(deg == 1)
        while frontier.size:
            cand_edges = xor_edge[frontier]
            order = np.argsort(cand_edges, kind="stable")
            ce, cn = cand_edges[order], frontier[order]
            first = np.ones(ce.size, dtype=bool)
            first[1:] = ce[1:] != ce[:-1]
            edges, free_nodes = ce[first], cn[first]
            keep = alive[edges]
            edges, free_nodes = edges[keep], free_nodes[keep]
            if edges.size == 0:
                break
            alive[edges] = False
            n_peeled += edges.size
            peel_edges.append(edges)
            peel_free.append(free_nodes)
            touched = edge_nodes[edges].reshape(-1)
            np.add.at(deg, touched, -1)
            np.bitwise_xor.at(xor_edge, touched, np.repeat(edges, 3))
            frontier = np.unique(touched[deg[touched] == 1])
        if n_peeled != n:
            return None

        # Reverse assignment with the emphf convention (mphf.hpp:57-64):
        # value(free) = (target - sum(other two)) mod 3, stored as 3 if 0.
        values = np.zeros(n_nodes, dtype=np.uint8)
        for edges, free_nodes in zip(reversed(peel_edges), reversed(peel_free)):
            nodes3 = edge_nodes[edges]
            target = np.argmax(nodes3 == free_nodes[:, None], axis=1)
            vsum = (values[nodes3[:, 0]].astype(np.int64)
                    + values[nodes3[:, 1]] + values[nodes3[:, 2]])
            v_free = values[free_nodes].astype(np.int64)  # 0 (unassigned)
            assigned = ((target - (vsum - v_free)) % 3).astype(np.uint8)
            values[free_nodes] = np.where(assigned == 0, 3, assigned)
        return values


class _MT19937_64:
    """std::mt19937_64, exactly (the reference builder's trial RNG,
    mphf.hpp:45). Standard public algorithm (Matsumoto & Nishimura
    parameters for the 64-bit variant); only ``next()`` is needed."""

    _N, _M = 312, 156
    _MATRIX_A = 0xB5026F5AA96619E9
    _UM, _LM = 0xFFFFFFFF80000000, 0x7FFFFFFF
    _MASK = 0xFFFFFFFFFFFFFFFF

    def __init__(self, seed: int):
        mt = [0] * self._N
        mt[0] = seed & self._MASK
        for i in range(1, self._N):
            mt[i] = (6364136223846793005
                     * (mt[i - 1] ^ (mt[i - 1] >> 62)) + i) & self._MASK
        self._mt = mt
        self._idx = self._N

    def next(self) -> int:
        if self._idx >= self._N:
            mt, N, M = self._mt, self._N, self._M
            for i in range(N):
                x = (mt[i] & self._UM) | (mt[(i + 1) % N] & self._LM)
                y = mt[(i + M) % N] ^ (x >> 1)
                mt[i] = y ^ self._MATRIX_A if x & 1 else y
            self._idx = 0
        x = self._mt[self._idx]
        self._idx += 1
        x ^= (x >> 29) & 0x5555555555555555
        x ^= (x << 17) & 0x71D67FFFEDA60000 & self._MASK
        x ^= (x << 37) & 0xFFF7EEE000000000 & self._MASK
        x ^= x >> 43
        return x & self._MASK


def _peel_assign_py(n0: np.ndarray, n1: np.ndarray, n2: np.ndarray,
                    domain: int) -> np.ndarray | None:
    """Pure-Python version of native.emphf_peel_assign (exact order; slow —
    for small key sets and native-less environments)."""
    m = 3 * domain
    deg = np.zeros(m, np.int64)
    v1s = np.zeros(m, np.int64)
    v2s = np.zeros(m, np.int64)
    for a_arr, b_arr, c_arr in ((n0, n1, n2),):
        np.add.at(deg, a_arr, 1)
        np.add.at(deg, b_arr, 1)
        np.add.at(deg, c_arr, 1)
        np.bitwise_xor.at(v1s, a_arr, b_arr.astype(np.int64))
        np.bitwise_xor.at(v2s, a_arr, c_arr.astype(np.int64))
        np.bitwise_xor.at(v1s, b_arr, a_arr.astype(np.int64))
        np.bitwise_xor.at(v2s, b_arr, c_arr.astype(np.int64))
        np.bitwise_xor.at(v1s, c_arr, a_arr.astype(np.int64))
        np.bitwise_xor.at(v2s, c_arr, b_arr.astype(np.int64))
    order: list[tuple[int, int, int]] = []

    def visit(v: int) -> None:
        if deg[v] != 1:
            return
        e1, e2 = int(v1s[v]), int(v2s[v])
        order.append((v, e1, e2))
        x0, x1, x2 = sorted((v, e1, e2))
        for me, oa, ob in ((x0, x1, x2), (x1, x0, x2), (x2, x0, x1)):
            deg[me] -= 1
            v1s[me] ^= oa
            v2s[me] ^= ob

    qp = 0
    for v in range(m):
        visit(v)
        while qp < len(order):
            _, a, b = order[qp]
            visit(a)
            visit(b)
            qp += 1
    if len(order) < len(n0):
        return None
    g = np.zeros(m, np.uint8)
    for v0, v1, v2 in reversed(order):
        target = (v0 > v1) + (v0 > v2)
        val = (target - int(g[v1]) - int(g[v2])) % 3
        g[v0] = val if val else 3
    return g


class EmphfMPHFAdapter:
    """Duck-typed stand-in for index.mphf.MPHF backed by an EmphfPF, so a
    Sparse23Index can run directly on reference-built `.pf` files with the
    reference's own slot ids. Device queries go through the quotient or
    wide cuckoo table (both keep the slot ids), so no device version of the
    Jenkins walk is needed."""

    def __init__(self, pf: EmphfPF, k: int):
        self.pf = pf
        self.k = k

    @property
    def n(self) -> int:
        return self.pf.n

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        return self.pf.lookup_codes(np.asarray(keys, dtype=np.uint64), self.k)

    def save(self, path: str) -> None:
        self.pf.save(path)

    @classmethod
    def load(cls, path: str, k: int) -> "EmphfMPHFAdapter":
        return cls(EmphfPF.load(path), k)

    @classmethod
    def build(cls, keys: np.ndarray, k: int) -> "EmphfMPHFAdapter":
        return cls(EmphfPF.build(np.asarray(keys, dtype=np.uint64), k), k)


_PERM_CACHE: dict = {}


def clear_perm_cache() -> None:
    """Release the cached dense slot permutation (512 MB at k=13).

    The cache makes a table load and its positional re-key share one 4^k
    hashing pass, but it deliberately survives the index objects — a
    long-lived process that is done with reference-format loads can call
    this to give the memory back."""
    _PERM_CACHE.clear()


def dense_slot_permutation(pf: EmphfPF, k: int, chunk: int = 1 << 22
                           ) -> np.ndarray:
    """int64[4^k]: MPHF slot of every k-mer code, in code order — the
    permutation between the reference's dense slot-ordered tables and our
    code-ordered ones.

    The last result is cached by (n, domain, seed, k) — those four values
    fully determine the lookup function — so loading a table and its
    positional index against the same .pf hashes the 4^k space once."""
    space = 4 ** k
    if pf.n != space:
        raise ValueError(f"pf covers {pf.n} keys, expected the full 4^{k}")
    key = (pf.n, pf.domain, pf.seed, k)
    hit = _PERM_CACHE.get(key)
    if hit is not None:
        return hit
    out = np.empty(space, dtype=np.int64)
    for start in range(0, space, chunk):
        codes = np.arange(start, min(start + chunk, space), dtype=np.uint64)
        out[start:start + len(codes)] = pf.lookup_codes(codes, k)
    _PERM_CACHE.clear()   # hold exactly one (512 MB at k=13)
    _PERM_CACHE[key] = out
    return out


def unpermute_dense_tf(tf_slot: np.ndarray, pf: EmphfPF, k: int,
                       chunk: int = 1 << 22) -> np.ndarray:
    """Reorder a reference dense k-mer table from MPHF-slot order to k-mer
    code order (the dense layout of this package).

    The reference's count_kmers13 counts into hasher.lookup(kmer) slots
    (reference: src/count_kmers13.cpp:141-160); the dense table here is
    indexed by the 2-bit code itself. tf_code[c] = tf_slot[lookup(c)].
    """
    if len(tf_slot) != 4 ** k:
        raise ValueError(
            f"expected a complete 4^{k} table (got tf={len(tf_slot)})")
    return tf_slot[dense_slot_permutation(pf, k, chunk)]
