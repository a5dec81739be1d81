"""The sparse index's wide engines: K10 (the wide cuckoo table) and K11 (the
MPHF walk) on the CPU (their plain versions) against aindex_tpu's
``cuckoo_query`` and ``_query_kernel``, and aindex_torch.Sparse23Index at
k = 27 (quotient-ineligible at these n: the wide cuckoo serves) and k = 31
(the walk serves) against aindex_tpu's on the conftest reads and
tests/data/*. Everything compared is an integer table or array: equality
is exact, the tolerance 0."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aindex_tpu.core import codec as jcodec
from aindex_tpu.core.reads import ReadsStore
from aindex_tpu.index.cuckoo import cuckoo_query
from aindex_tpu.index.positional import PositionalIndex as JPos
from aindex_tpu.index.sparse23 import Sparse23Index as JIndex, _query_kernel
from aindex_tpu.io.fastq import read_sequences
from aindex_tpu.kernels import lookup as jlookup
from aindex_torch import PositionalIndex as TPos, Sparse23Index as TIndex
from aindex_torch.kernels import lookup as tlookup, probe
from test_torch_coverage import EDGE_SHAPES, edge_matrix
from test_torch_host import jax_native  # noqa: F401 (a fixture)

#: aindex_tpu's native library loads before anything here builds through it
pytestmark = pytest.mark.usefixtures("jax_native")

HERE = os.path.dirname(__file__)
DATA = sorted(p for p in glob.glob(os.path.join(HERE, "data", "*"))
              if not p.endswith("test_unknown.txt"))
SOURCES = ["reads"] + [os.path.basename(p) for p in DATA]


def _eq(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _u32(x: torch.Tensor) -> np.ndarray:
    assert x.dtype == torch.uint32
    return x.view(torch.int32).numpy().view(np.uint32)


def _i64(codes: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(codes, dtype=np.uint64).view(np.int64))


_CACHE: dict = {}


def _sequences(source: str, random_reads) -> list[str]:
    if source == "reads":
        return random_reads
    return read_sequences(os.path.join(HERE, "data", source))


def _built(k: int, source: str, random_reads):
    """(port index, JAX index, blob) for one k and one read source, built
    once per test module."""
    if (k, source) not in _CACHE:
        blob = ReadsStore.from_sequences(_sequences(source, random_reads)).blob
        _CACHE[k, source] = (TIndex.build_from_blob(blob, k=k, device="cpu"),
                             JIndex.build_from_blob(blob, k=k), blob)
    return _CACHE[k, source]


@pytest.fixture(scope="module", autouse=True)
def _clear_cache(jax_native):
    """aindex_tpu's native library is loaded before _CACHE fills, and
    _CACHE is emptied after the module."""
    yield
    _CACHE.clear()


def _probe_codes(index, rng) -> tuple[np.ndarray, np.ndarray]:
    """Stored keys, their reverse complements, random and above-2k codes,
    all-A and all-T; and a mask that drops a fifth of them."""
    k = index.k
    keys = index.checker_host
    codes = np.concatenate([
        keys, jcodec.revcomp_code(keys, k),
        rng.integers(0, 4 ** k, 3000, dtype=np.uint64),
        rng.integers(0, 2 ** 64 - 1, 300, dtype=np.uint64),
        np.array([0, 4 ** k - 1, 2 ** 64 - 1, 2 ** 63], dtype=np.uint64)])
    return codes, rng.random(codes.size) < 0.8


# -- the plain versions against the JAX kernels -------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_cuckoo_plain_matches_cuckoo_query(random_reads, masked):
    """K10's plain probe (rule KEYS, tf and slot) == cuckoo_query."""
    t, j, _ = _built(27, "reads", random_reads)
    assert t.engine == "cuckoo" and j.quot is None
    codes, valid = _probe_codes(j, np.random.default_rng(27))
    ck = j.cuckoo
    want_tf, want_slot = cuckoo_query(ck.device, jnp.asarray(codes),
                                      jnp.asarray(valid) if masked else None,
                                      ck.seed1, ck.seed2, m=ck.m)
    tf, slot = probe.query_plain(t.tables, _i64(codes),
                                 torch.from_numpy(valid) if masked else None,
                                 k=27, rule=probe.KEYS, slot=True)
    _eq(_u32(tf), want_tf)
    _eq(slot.numpy(), want_slot)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_walk_plain_matches_query_kernel(random_reads, masked):
    """K11's plain walk (rule KEYS, tf and slot) == _query_kernel."""
    t, j, _ = _built(31, "reads", random_reads)
    assert t.engine == "walk"
    codes, valid = _probe_codes(j, np.random.default_rng(31))
    v = valid if masked else np.ones(codes.size, bool)
    want_tf, want_slot = _query_kernel(j.g_packed, j.slots, j.checker, j.tf, j.seed,
                                       j.domain, jnp.asarray(codes), jnp.asarray(v))
    tf, slot = probe.query_plain(t.tables, _i64(codes),
                                 torch.from_numpy(valid) if masked else None,
                                 k=31, rule=probe.KEYS, slot=True)
    _eq(_u32(tf), want_tf)
    _eq(slot.numpy(), want_slot)


@pytest.mark.parametrize("fn", ["mix64", "hash_triple", "mphf_lookup"])
def test_walk_steps_match_jax(random_reads, fn):
    """mix64, hash_triple (unsigned % domain by the 32-bit split) and the
    unverified walk on full 64-bit inputs == aindex_tpu/kernels/lookup.py."""
    _, j, _ = _built(31, "reads", random_reads)
    x = np.random.default_rng(5).integers(0, 2 ** 64 - 1, 5000, dtype=np.uint64)
    x[:3] = (0, 2 ** 63, 2 ** 64 - 1)
    m = j.mphf
    if fn == "mix64":
        _eq(tlookup.mix64(_i64(x)).numpy().view(np.uint64), jlookup.mix64(jnp.asarray(x)))
    elif fn == "hash_triple":
        got = tlookup.hash_triple(_i64(x), m.seed, m.domain)
        want = jlookup.hash_triple(jnp.asarray(x), m.seed, m.domain)
        for a, b in zip(got, want):
            _eq(a.numpy().view(np.uint64), b)
    else:
        got = tlookup.mphf_lookup(torch.from_numpy(m.g_packed.view(np.int32)),
                                  torch.from_numpy(m.slots), _i64(x), m.seed, m.domain)
        want = jlookup.mphf_lookup(jnp.asarray(m.g_packed), jnp.asarray(m.slots),
                                   jnp.asarray(x), jnp.uint64(m.seed), jnp.uint64(m.domain))
        _eq(got.numpy().astype(np.int32), want)


@pytest.mark.parametrize("k", [27, 31])
@pytest.mark.parametrize("rule", ["canon", "fwd_rc"])
def test_rules_match_resolve_device(random_reads, k, rule):
    """Both query rules with strand, on each wide engine, == aindex_tpu's
    _resolve_device with canonical_keys set accordingly."""
    t, j, _ = _built(k, "reads", random_reads)
    codes, valid = _probe_codes(j, np.random.default_rng(k))
    codes = codes[codes < 4 ** k]
    valid = valid[:codes.size]
    j.canonical_keys = rule == "canon"
    try:
        want = j._resolve_device(jnp.asarray(codes), jnp.asarray(valid))
    finally:
        j.canonical_keys = True
    got = probe.query_plain(t.tables, _i64(codes), torch.from_numpy(valid), k=k,
                            rule=probe.CANON if rule == "canon" else probe.FWD_RC,
                            slot=True, strand=True)
    _eq(_u32(got[0]), np.asarray(want[0]).astype(np.uint32))
    _eq(got[1].numpy(), want[1])
    _eq(got[2].numpy(), want[2])


def test_cuckoo_table_bytes_equal_aindex_tpu(random_reads):
    t, j, _ = _built(27, "reads", random_reads)
    assert (t.cuckoo.m, t.cuckoo.seed1, t.cuckoo.seed2) == \
        (j.cuckoo.m, int(j.cuckoo.seed1), int(j.cuckoo.seed2))
    assert t.cuckoo.table_host.tobytes() == j.cuckoo.table_host.tobytes()


def test_engine_choice_matches_aindex_tpu(random_reads):
    """quot for k = 23, the wide cuckoo for k = 27, the walk for k = 31, as
    aindex_tpu's _query chooses."""
    for k, want in ((23, "quot"), (27, "cuckoo"), (31, "walk")):
        t, j, _ = _built(k, "reads", random_reads)
        assert t.engine == want
        assert (j.quot is not None) == (want == "quot")
        assert (j.cuckoo is not None) == (want != "walk")


# -- coverage at the tiled kernel's edge shapes ------------------------------------

@pytest.mark.parametrize("rule", ["canon", "fwd_rc"])
@pytest.mark.parametrize("shape", list(EDGE_SHAPES))
@pytest.mark.parametrize("k", [27, 31])
def test_coverage_edges_match_aindex_tpu(random_reads, k, shape, rule):
    """sequence_coverage_batch on the wide table (k = 27) and the walk (k =
    31) at the tiled coverage kernel's edge shapes, rows cut from the reads
    the index holds, against aindex_tpu's, at cutoffs 0, 10 and 2^32 - 1;
    under the forward-else-reverse-complement rule of reference-keyed
    indexes too (both indexes told their keys are not canonical)."""
    t, j, _ = _built(k, "reads", random_reads)
    mat = edge_matrix(shape, k, 11, "".join(random_reads).encode())
    seqs = [row[:-1].tobytes().decode() for row in mat]
    keyed = t.canonical_keys, j.canonical_keys
    t.canonical_keys = j.canonical_keys = rule == "canon"
    try:
        assert t.rule == (probe.CANON if rule == "canon" else probe.FWD_RC)
        for cutoff in (0, 10, 2**32 - 1):
            got = t.sequence_coverage_batch(seqs, cutoff)
            want = j.sequence_coverage_batch(seqs, cutoff)
            assert len(got) == len(want) == len(seqs)
            for a, b in zip(got, want):
                _eq(a, b)
    finally:
        t.canonical_keys, j.canonical_keys = keyed


# -- the whole index on each engine ------------------------------------------------

def _kmers(seqs: list[str], k: int) -> list[str]:
    out = [s[i:i + k] for s in seqs[:60] for i in range(0, max(len(s) - k + 1, 0), 3)]
    out += [jcodec.revcomp(km) for km in out[:100] if set(km) <= set("ACGT")]
    return out + ["A" * k, "T" * k, "ACGTN" * (k // 5) + "A" * (k % 5), "acgt" * (k // 4)
                  + "a" * (k % 4)]


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("k", [27, 31])
class TestWideIndex:
    def test_arrays(self, random_reads, k, source):
        t, j, _ = _built(k, source, random_reads)
        _eq(t.checker_host, j.checker_host)
        _eq(t.tf_host, j.tf_host)
        _eq(t.mphf.g_packed, j.mphf.g_packed)

    @pytest.mark.parametrize("fn", ["get_tf_values", "get_pfids", "get_strands",
                                    "get_tf_both_directions", "get_hash_values"])
    def test_kmer_queries(self, random_reads, k, source, fn):
        t, j, _ = _built(k, source, random_reads)
        kmers = _kmers(_sequences(source, random_reads), k)
        a, b = getattr(t, fn)(kmers), getattr(j, fn)(kmers)
        for x, y in zip(a, b) if isinstance(a, tuple) else [(a, b)]:
            _eq(x, y)

    def test_codes_in(self, random_reads, k, source):
        t, j, _ = _built(k, source, random_reads)
        codes, valid = _probe_codes(j, np.random.default_rng(3))
        _eq(_u32(t.get_tf_values_codes(codes)), j.get_tf_values_codes(codes))
        _eq(_u32(t.get_tf_values_codes(codes, valid)), j.get_tf_values_codes(codes, valid))

    @pytest.mark.parametrize("cutoff", [0, 10])
    def test_coverage(self, random_reads, k, source, cutoff):
        t, j, _ = _built(k, source, random_reads)
        seqs = _sequences(source, random_reads)[:80] + ["ACGT" * 3, "ACGTN" * 20]
        for a, b in zip(t.sequence_coverage_batch(seqs, cutoff),
                        j.sequence_coverage_batch(seqs, cutoff)):
            _eq(a, b)

    @pytest.mark.parametrize("fn", ["debruijn_next_info", "debruijn_prev_info"])
    def test_cont_info(self, random_reads, k, source, fn):
        t, j, _ = _built(k, source, random_reads)
        kmers = [km for km in _kmers(_sequences(source, random_reads), k)
                 if set(km) <= set("ACGT")]
        a, b = getattr(t, fn)(kmers, 1), getattr(j, fn)(kmers, 1)
        assert a.keys() == b.keys()
        for key in a:
            _eq(a[key], b[key])

    def test_positional_csr_bytes(self, random_reads, k, source):
        t, j, blob = _built(k, source, random_reads)
        pt = TPos.build_sparse23(blob, t, chunk=1 << 12)
        pj = JPos.build_sparse23(blob, j, chunk=1 << 12)
        assert pt.offsets.tobytes() == pj.offsets.tobytes()
        assert pt.positions.tobytes() == pj.positions.tobytes()
