"""K11's node records (aindex_torch.kernels.lookup.walk_records, the walk
of MphfTables.probe_plain over them) against aindex_tpu's MPHF walk
(kernels/lookup.py mphf_lookup with index/sparse23.py _query_kernel and the
rules of _resolve_device). All inputs come from numpy seeds; every
compared value is an integer, so equality is exact (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aindex_tpu.core import codec as jcodec
from aindex_tpu.core.reads import ReadsStore
from aindex_tpu.index.sparse23 import Sparse23Index as JIndex, _query_kernel
from aindex_tpu.kernels import lookup as jlookup
from aindex_torch import Sparse23Index as TIndex
from aindex_torch.kernels import lookup as tlookup, probe
from test_torch_host import jax_native  # noqa: F401 (a fixture)

#: aindex_tpu's native library loads before anything here builds through it
pytestmark = pytest.mark.usefixtures("jax_native")

RULES = {"keys": probe.KEYS, "canon": probe.CANON, "fwd_rc": probe.FWD_RC}
_CACHE: dict = {}


def _i64(codes: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(codes, dtype=np.uint64).view(np.int64))


def _u32(x: torch.Tensor) -> np.ndarray:
    assert x.dtype == torch.uint32
    return x.view(torch.int32).numpy().view(np.uint32)


def _built(name: str, random_reads):
    """(port index, JAX index) at k = 31 on the conftest reads ("reads") or
    on one 31-base read ("one", n = 1), built once per module."""
    if name not in _CACHE:
        seqs = random_reads if name == "reads" else ["ACGT" * 7 + "ACG"]
        blob = ReadsStore.from_sequences(seqs).blob
        _CACHE[name] = (TIndex.build_from_blob(blob, k=31, device="cpu"),
                        JIndex.build_from_blob(blob, k=31))
    return _CACHE[name]


@pytest.fixture(scope="module", autouse=True)
def _clear_cache(jax_native):
    """aindex_tpu's native library is loaded before _CACHE fills, and
    _CACHE is emptied after the module."""
    yield
    _CACHE.clear()


def _unassigned_keys(t, rng, n: int = 4000) -> np.ndarray:
    """Random 62-bit keys whose walk ends at a node no key owns (g = 3)."""
    draws = rng.integers(0, 1 << 62, 200 * n, dtype=np.uint64)
    node = tlookup.mphf_owner_node(t.g_packed, _i64(draws), t.seed, t.domain).numpy()
    g = (t.g_packed.numpy().view(np.uint32)[node >> 4] >> (2 * (node & 15))) & 3
    return draws[g == 3][:n]


def _keys(t, index, rng) -> np.ndarray:
    """Members, their reverse complements, random 62-bit keys, keys that
    walk to unassigned nodes, the key in slot 0, 0 and 2^62 - 1."""
    members = index.checker_host
    return np.concatenate([
        members, jcodec.revcomp_code(members, 31),
        rng.integers(0, 1 << 62, 3000, dtype=np.uint64), _unassigned_keys(t, rng),
        members[:1], np.array([0, (1 << 62) - 1], dtype=np.uint64)])


@pytest.mark.parametrize("name", ["reads", "one"])
def test_records_layout(random_reads, name):
    """records int32[3 domain, 4]: row v = (checker[slots[v]] low and high
    words, tf[slots[v]], slots[v]), unassigned nodes included."""
    t, _ = _built(name, random_reads)
    r = t.tables.records
    m = t.mphf
    assert r.dtype == torch.int32 and r.shape == (3 * m.domain, 4) and r.is_contiguous()
    slots = np.asarray(m.slots, np.int64)
    key = t.checker_host[slots]
    want = np.stack([(key & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32),
                     (key >> np.uint64(32)).astype(np.uint32).view(np.int32),
                     t.tf_host[slots].view(np.int32), slots.astype(np.int32)], axis=1)
    np.testing.assert_array_equal(r.numpy(), want)
    g = t.tables.g_packed
    assert g.dtype == torch.int32
    np.testing.assert_array_equal(g.numpy().view(np.uint32), m.g_packed)


@pytest.mark.parametrize("name", ["reads", "one"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_record_walk_keys_rule_matches_query_kernel(random_reads, name, masked):
    """The plain walk over the records (rule KEYS, tf and slot) ==
    mphf_lookup + _query_kernel, members, random, unassigned-node keys,
    checker[0], 0 and 2^62 - 1 included."""
    t, j = _built(name, random_reads)
    rng = np.random.default_rng(101)
    codes = _keys(t.tables, t, rng)
    valid = rng.random(codes.size) < 0.8
    v = valid if masked else np.ones(codes.size, bool)
    want_tf, want_slot = _query_kernel(j.g_packed, j.slots, j.checker, j.tf, j.seed, j.domain,
                                       jnp.asarray(codes), jnp.asarray(v))
    tf, slot = probe.query_plain(t.tables, _i64(codes), torch.from_numpy(valid) if masked
                                 else None, k=31, rule=probe.KEYS, slot=True)
    np.testing.assert_array_equal(_u32(tf), np.asarray(want_tf))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want_slot))


@pytest.mark.parametrize("name", ["reads", "one"])
@pytest.mark.parametrize("rule", ["canon", "fwd_rc"])
def test_record_walk_rules_match_resolve_device(random_reads, name, rule):
    """(tf, slot, strand) under CANON and FWD_RC == aindex_tpu's
    _resolve_device with canonical_keys set accordingly."""
    t, j = _built(name, random_reads)
    rng = np.random.default_rng(103)
    codes = _keys(t.tables, t, rng)
    valid = rng.random(codes.size) < 0.9
    j.canonical_keys = rule == "canon"
    try:
        want = j._resolve_device(jnp.asarray(codes), jnp.asarray(valid))
    finally:
        j.canonical_keys = True
    got = probe.query_plain(t.tables, _i64(codes), torch.from_numpy(valid), k=31,
                            rule=RULES[rule], slot=True, strand=True)
    np.testing.assert_array_equal(_u32(got[0]), np.asarray(want[0]).astype(np.uint32))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_unassigned_nodes_hold_slot_zero(random_reads):
    """A key that walks to an unassigned node reads slot 0's record, as
    JAX's node -> slot table reads slot 0 there, and is absent; the key in
    slot 0 hits slot 0."""
    t, j = _built("reads", random_reads)
    keys = _unassigned_keys(t.tables, np.random.default_rng(107))
    assert keys.size > 100
    hit, tf, slot = t.tables.probe_plain(_i64(keys))
    assert not hit.any() and (slot == 0).all()
    np.testing.assert_array_equal(np.asarray(jlookup.mphf_lookup(
        j.g_packed, j.slots, jnp.asarray(keys), j.seed, j.domain)), 0)
    hit, tf, slot = t.tables.probe_plain(_i64(t.checker_host[:1]))
    assert bool(hit[0]) and int(slot[0]) == 0 and int(tf[0]) == int(t.tf_host[0])


@pytest.mark.parametrize("rule", list(RULES))
def test_no_keys_are_absent(rule):
    """n = 0: every record is 0 and every key absent (tf 0, slot -1, strand
    0), where aindex_tpu's walk has no checker entry to gather and raises."""
    blob = ReadsStore.from_sequences(["ACGTACG"]).blob
    t = TIndex.build_from_blob(blob, k=31, device="cpu")
    assert t.n == 0
    assert not t.tables.records.any()
    codes = np.array([0, 5, (1 << 62) - 1], dtype=np.uint64)
    strand = RULES[rule] != probe.KEYS
    got = probe.query_plain(t.tables, _i64(codes), k=31, rule=RULES[rule], slot=True,
                            strand=strand)
    np.testing.assert_array_equal(_u32(got[0]), 0)
    np.testing.assert_array_equal(got[1].numpy(), -1)
    if strand:
        np.testing.assert_array_equal(got[2].numpy(), 0)
    j = JIndex.build_from_blob(blob, k=31)
    with pytest.raises(TypeError):
        j._resolve_device(jnp.asarray(codes), None)


def test_from_host_drops_nothing_it_needs(random_reads):
    """MphfTables.from_host holds g_packed and the records only, and
    answers as the index's own engine."""
    t, _ = _built("reads", random_reads)
    e = tlookup.MphfTables.from_host(t.mphf, t.checker_host, t.tf_host, "cpu")
    e.check()
    assert e.tensors() == (e.g_packed, e.records)
    assert torch.equal(e.records, t.tables.records)
    assert (e.n, e.domain, e.seed) == (t.mphf.n, t.mphf.domain, t.mphf.seed)
