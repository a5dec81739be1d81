"""Minimal perfect hash function over uint64 k-mer codes (host numpy +
native peeler).

Copied from aindex_tpu/index/mphf.py (:54-254), so that both packages
build the same MPHF for the same keys: the same seed trials
(``default_rng(37)``), domain, ``g_packed`` and slots, and the same ATPF
``.pf`` bytes.

Construction as in the reference's emphf (reference:
src/emphf/mphf.hpp:21-67): a random 3-partite hypergraph, peel degree-1
nodes, assign 2-bit g-values so that the sum of the three node values mod
3 selects the owner node; slot = rank of the owner among assigned nodes,
materialised in ``slots``. The hash is a Murmur-style 64-bit mixer.

g-value convention: 3 = unassigned (and 3 === 0 mod 3), {0,1,2} = assigned.

The sparse index walks this MPHF on the device where neither cuckoo
table serves (k = 31: K11, ``csrc/mphfwalk.cu``), and the sharded engine
walks its owner step on every rank (K12, ``csrc/shard23.cu``); otherwise
it queries through the quotient cuckoo table (index/quotcuckoo.py) or the
wide cuckoo table (index/cuckoo.py). The host ``lookup`` serves
``get_hash_values`` of the single-device index.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from aindex_torch import native

_GAMMA = 1.23  # hash-domain expansion factor, as in emphf (mphf.hpp:45-46)

_M1 = np.uint64(0xFF51AFD7ED558CCD)
_M2 = np.uint64(0xC4CEB9FE1A85EC53)
_C1 = np.uint64(0x9E3779B97F4A7C15)
_C2 = np.uint64(0x165667B19E3779F9)

#: Largest key count the pure-numpy peel takes when the native library
#: cannot be built; beyond it the build raises instead of running for hours.
PURE_MAX_KEYS = 1 << 17


def _mix64_tmp(x: np.ndarray) -> np.ndarray:
    """Murmur3 fmix64 on a freshly-allocated temporary: mutates ``x`` in
    place, so callers pass an array they own."""
    x ^= x >> np.uint64(33)
    x *= _M1
    x ^= x >> np.uint64(33)
    x *= _M2
    x ^= x >> np.uint64(33)
    return x


def hash_triple_np(keys: np.ndarray, seed: int, domain: int):
    """Three node ids per key, one in each third of [0, 3*domain)."""
    d = np.uint64(domain)
    h = _mix64_tmp(keys ^ np.uint64(seed))   # ^ allocates; safe to mutate
    h0 = h % d
    h1 = _mix64_tmp(h ^ _C1) % d + d
    h2 = _mix64_tmp(h + _C2) % d + np.uint64(2) * d
    return h0, h1, h2


@dataclasses.dataclass
class MPHF:
    n: int
    domain: int
    seed: int
    g_packed: np.ndarray  # uint32[ceil(3*domain/16)], 2-bit fields, 3=unassigned
    slots: np.ndarray     # int32[3*domain], owner node -> slot id (0 elsewhere)

    @property
    def n_nodes(self) -> int:
        return 3 * self.domain

    def g_value(self, nodes: np.ndarray) -> np.ndarray:
        word = self.g_packed[(nodes >> np.uint64(4)).astype(np.int64)]
        shift = ((nodes & np.uint64(15)) * np.uint64(2)).astype(np.uint32)
        return (word >> shift) & np.uint32(3)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Batched host-side lookup -> int32 slot ids in [0, n). Node ids
        are int64 throughout (no int32 cast of a node id)."""
        keys = np.asarray(keys, dtype=np.uint64)
        n0, n1, n2 = hash_triple_np(keys, self.seed, self.domain)
        v = (self.g_value(n0) + self.g_value(n1) + self.g_value(n2)) % 3
        node = np.where(v == 0, n0, np.where(v == 1, n1, n2))
        return self.slots[node.astype(np.int64)]

    # -- serialisation (ATPF .pf format, shared with aindex_tpu) -------------

    MAGIC = b"ATPF0001"

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.MAGIC)
            np.array([self.n, self.domain, self.seed], dtype=np.uint64).tofile(f)
            self.g_packed.tofile(f)
            self.slots.tofile(f)

    @classmethod
    def load(cls, path: str) -> "MPHF":
        with open(path, "rb") as f:
            magic = f.read(8)
            if magic != cls.MAGIC:
                raise ValueError(f"bad .pf magic in {path}: {magic!r}")
            n, domain, seed = np.fromfile(f, dtype=np.uint64, count=3)
            n_nodes = 3 * int(domain)
            n_words = (n_nodes + 15) // 16
            g_packed = np.fromfile(f, dtype=np.uint32, count=n_words)
            slots = np.fromfile(f, dtype=np.int32, count=n_nodes)
        return cls(int(n), int(domain), int(seed), g_packed, slots)

    @classmethod
    def build(cls, keys: np.ndarray, max_trials: int = 64, rng_seed: int = 37,
              use_native: bool | None = None) -> "MPHF":
        """Construct over a set of distinct uint64 keys (see
        ``build_with_slots``)."""
        return cls.build_with_slots(keys, max_trials, rng_seed, use_native)[0]

    @classmethod
    def build_with_slots(cls, keys: np.ndarray, max_trials: int = 64,
                         rng_seed: int = 37, use_native: bool | None = None,
                         assume_unique: bool = False
                         ) -> tuple["MPHF", np.ndarray]:
        """``build`` plus the slot id of every input key.

        Seed-trial loop as in the reference (deterministic base rng seed,
        reference: src/emphf/mphf.hpp:45); each trial attempts a full peel
        in the native peeler (sequential stack walk) or the vectorised
        round-synchronous numpy peel. Both use the same hash triple, so they
        succeed on the same (seed, domain); the owner nodes may differ.
        ``use_native=None`` takes the native peeler when it can be built,
        and requires it above ``PURE_MAX_KEYS`` keys (a missing compiler
        then raises). The peel determines each key's owner node, so the
        per-key slots come out without a second lookup pass.
        """
        keys = np.asarray(keys, dtype=np.uint64)
        n = len(keys)
        if n == 0:
            return (cls(0, 1, 0, np.full(1, 0xFFFFFFFF, np.uint32),
                        np.zeros(3, np.int32)), np.zeros(0, np.int32))
        if not assume_unique and len(np.unique(keys)) != n:
            raise ValueError("MPHF keys must be distinct")
        if use_native is None:
            use_native = n > PURE_MAX_KEYS or native.available()
        domain = max(1, int(np.ceil(np.ceil(_GAMMA * n) / 3.0)))
        rng = np.random.default_rng(rng_seed)
        for _ in range(max_trials):
            seed = int(rng.integers(0, 2**63, dtype=np.int64))
            if use_native:
                # the native peeler's packed adjacency holds uint32 node and
                # edge ids; past that it would fail every trial
                if n >= 2**32 or 3 * domain >= 2**32:
                    raise ValueError(
                        f"key set too large for the native peeler's uint32 "
                        f"node ids (n={n}, nodes={3 * domain})")
                out = native.mphf_try_build(keys, seed, domain)
            else:
                out = cls._try_build(keys, n, domain, seed)
            if out is not None:
                g, owner = out
                mphf = cls._from_g(n, domain, seed, g)
                return mphf, mphf.slots[owner]
            domain = int(domain * 1.05) + 1  # grow slightly on failure
        raise RuntimeError(f"MPHF peeling failed after {max_trials} trials (n={n})")

    @classmethod
    def _from_g(cls, n: int, domain: int, seed: int, g: np.ndarray) -> "MPHF":
        """Finish construction from peeler output: rank the assigned nodes
        into slot ids and pack g 16 values per uint32 word."""
        n_nodes = 3 * domain
        assigned = g != 3
        slots = np.zeros(n_nodes, dtype=np.int32)
        slots[assigned] = np.arange(n, dtype=np.int32)
        n_words = (n_nodes + 15) // 16
        gp = np.full(n_words * 16, 3, dtype=np.uint32)
        gp[:n_nodes] = g
        gp = gp.reshape(-1, 16)
        shifts = (np.arange(16, dtype=np.uint32) * 2)
        g_packed = np.bitwise_or.reduce(gp << shifts, axis=1).astype(np.uint32)
        return cls(n, domain, seed, g_packed, slots)

    @classmethod
    def _try_build(cls, keys, n, domain, seed):
        """One numpy peel trial: (g, owner) or None."""
        n_nodes = 3 * domain
        h = hash_triple_np(keys, seed, domain)
        edge_nodes = np.stack([a.astype(np.int64) for a in h], axis=1)  # (n, 3)

        deg = np.zeros(n_nodes, dtype=np.int64)
        xor_edge = np.zeros(n_nodes, dtype=np.int64)
        eids = np.arange(n, dtype=np.int64)
        for j in range(3):
            np.add.at(deg, edge_nodes[:, j], 1)
            np.bitwise_xor.at(xor_edge, edge_nodes[:, j], eids)

        peel_edges = []   # per-round arrays of edge ids
        peel_free = []    # per-round arrays of free node ids
        alive = np.ones(n, dtype=bool)
        n_peeled = 0
        frontier = np.flatnonzero(deg == 1)
        while frontier.size:
            cand_edges = xor_edge[frontier]
            # a dead edge can't appear: deg == 1 means exactly one live edge
            order = np.argsort(cand_edges, kind="stable")
            ce = cand_edges[order]
            cn = frontier[order]
            first = np.ones(ce.size, dtype=bool)
            first[1:] = ce[1:] != ce[:-1]
            edges = ce[first]
            free_nodes = cn[first]
            if not np.all(alive[edges]):
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

        # reverse-order assignment, one vectorised pass per round
        g = np.full(n_nodes, 3, dtype=np.uint8)
        owner = np.empty(n, dtype=np.int64)
        for edges, free_nodes in zip(reversed(peel_edges), reversed(peel_free)):
            nodes3 = edge_nodes[edges]  # (m, 3)
            owner[edges] = free_nodes
            j = np.argmax(nodes3 == free_nodes[:, None], axis=1)
            vsum = g[nodes3[:, 0]].astype(np.int64) + g[nodes3[:, 1]] + g[nodes3[:, 2]]
            v_free = g[free_nodes].astype(np.int64)  # currently 3
            g[free_nodes] = ((j - (vsum - v_free)) % 3).astype(np.uint8)

        return g, owner
