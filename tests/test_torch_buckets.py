"""The bucketed record layout that K6 and K10 probe on the device
(aindex_torch/kernels/buckets.py: ``QuotTables`` and ``CuckooTables`` built
from the host tables) and its plain probe, against aindex_tpu's probes of
its own tables: ``quot_query`` and ``quot_query_tf`` (with ``_probe``) on
the quotient table, ``cuckoo_query`` on the wide table, and
``Sparse23Index._resolve_device`` under the canonical and the
forward-else-reverse-complement rules. Indexes are built from the conftest
reads (k = 23: the quotient table; k = 27: the wide table) and from small
seeded key sets. Every answer is an integer: equality is exact."""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aindex_tpu.core import codec as jcodec
from aindex_tpu.core.reads import ReadsStore
from aindex_tpu.index import quotcuckoo as jq
from aindex_tpu.index.cuckoo import CuckooTable as JCuckoo, cuckoo_query
from aindex_tpu.index.sparse23 import Sparse23Index as JIndex
from aindex_torch import Sparse23Index as TIndex
from aindex_torch.index import quotcuckoo as tq
from aindex_torch.index.cuckoo import CuckooTable as TCuckoo, _mix64_np
from aindex_torch.kernels import buckets, probe
from aindex_torch.kernels.quot import QuotTables, bij, bij_inverse
from test_torch_host import jax_native  # noqa: F401 (a fixture)

#: aindex_tpu's native library loads before anything here builds through it
pytestmark = pytest.mark.usefixtures("jax_native")

EMPTY_KEY = np.uint64(buckets.EMPTY_KEY)
ENGINES = {"quot": 23, "wide": 27}


def _i64(codes: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(codes, dtype=np.uint64).view(np.int64))


def _u32(x: torch.Tensor) -> np.ndarray:
    assert x.dtype == torch.uint32
    return x.view(torch.int32).numpy().view(np.uint32)


@pytest.fixture(scope="module")
def indexes(random_reads, jax_native):
    """engine -> (port index, JAX index) over the conftest reads."""
    blob = ReadsStore.from_sequences(random_reads).blob
    out = {}
    for engine, k in ENGINES.items():
        t, j = TIndex.build_from_blob(blob, k=k, device="cpu"), JIndex.build_from_blob(blob, k=k)
        assert t.engine == ("quot" if engine == "quot" else "cuckoo")
        out[engine] = t, j
    return out


def _codes(j, rng) -> tuple[np.ndarray, np.ndarray]:
    """Stored keys, their reverse complements, random codes below 4^k and
    over the whole uint64 range, stored keys with bits above 2k, and the
    edge codes; a mask that drops a fifth of them."""
    k = j.k
    keys = j.checker_host
    high = rng.integers(1, 1 << (62 - 2 * k), keys.size, dtype=np.uint64) << np.uint64(2 * k)
    codes = np.concatenate([
        keys, jcodec.revcomp_code(keys, k), keys | high,
        rng.integers(0, 4 ** k, 3000, dtype=np.uint64),
        rng.integers(0, 2 ** 64 - 1, 300, dtype=np.uint64),
        np.array([0, 4 ** k - 1, 2 ** 62 - 1, 2 ** 63, 2 ** 64 - 1, EMPTY_KEY], np.uint64)])
    return codes, rng.random(codes.size) < 0.8


def _jax_keys(j, codes: np.ndarray, valid):
    """aindex_tpu's (tf, slot) of literal keys on its own table."""
    v = None if valid is None else jnp.asarray(valid)
    if j.quot is not None:
        qc = j.quot
        return jq.quot_query(*qc.device, *qc.slot_device, jnp.asarray(codes), v, *qc.mults,
                             m=qc.m, lb=qc.lb, w=qc.w)
    ck = j.cuckoo
    return cuckoo_query(ck.device, jnp.asarray(codes), v, ck.seed1, ck.seed2, m=ck.m)


def _records(t) -> list[tuple[int, int, int]]:
    """(key, tf, slot) of every non-empty record, sorted."""
    rec = t.records.to(torch.int64)
    real = (rec[:, 1] & buckets.EMPTY_HI) == 0
    key = (rec[:, 0] & 0xFFFFFFFF) | ((rec[:, 1] & 0x3FFFFFFF) << 32)
    return sorted(zip(key[real].tolist(), (rec[real, 2] & 0xFFFFFFFF).tolist(),
                      rec[real, 3].tolist()))


# -- the layout -----------------------------------------------------------------

@pytest.mark.parametrize("engine", list(ENGINES))
def test_records_hold_every_key_once_with_its_answer(indexes, engine):
    """Every key of the host table is in the records once, with the tf and
    slot aindex_tpu's own lookup gives it; some keys sit in an overflow
    level, and exactly the level-0 buckets they came from are marked."""
    t, j = indexes[engine]
    tables = t.tables
    keys = np.sort(j.checker_host)
    found, tf, slot = (j.quot or j.cuckoo).lookup_host(keys)
    assert found.all()
    assert _records(tables) == list(zip(keys.astype(np.int64).tolist(), tf.tolist(),
                                        slot.tolist()))
    assert len(tables.levels) > 1
    n0 = 1 << tables.levels[0][1]
    rec = tables.records.view(-1, buckets.BUCKET, 4)
    assert bool(((rec[n0:, :, 1] & buckets.EMPTY_HI) == 0).any()), "an overflow level holds keys"
    full = ((rec[:n0, :, 1] & buckets.EMPTY_HI) == 0).all(dim=1)
    marked = rec[:n0, 0, 1] < 0
    assert bool(marked.any()) and bool((full | ~marked).all())


@pytest.mark.parametrize("engine", list(ENGINES))
def test_build_is_deterministic_and_keeps_smallest_keys(indexes, engine):
    t, _ = indexes[engine]
    host = t.quot if engine == "quot" else t.cuckoo
    a = host.tables("cpu")
    host.release_device()
    b = host.tables("cpu")
    assert torch.equal(a.records, b.records) and a.levels == b.levels
    rec = a.records.view(-1, buckets.BUCKET, 4).to(torch.int64)
    n0 = 1 << a.levels[0][1]
    key = (rec[..., 0] & 0xFFFFFFFF) | ((rec[..., 1] & 0x3FFFFFFF) << 32)
    real = (rec[..., 1] & buckets.EMPTY_HI) == 0
    for bkt in torch.nonzero(real[:n0].sum(dim=1) > 1).reshape(-1).tolist():
        ks = key[bkt][real[bkt]].tolist()
        assert ks == sorted(ks)


def test_bij_inverse_inverts():
    rng = np.random.default_rng(3)
    for w in (2, 26, 46, 54, 60, 62):
        x = torch.from_numpy(rng.integers(0, 1 << w, 5000, dtype=np.uint64).view(np.int64))
        for attempt in range(3):
            ma, mb = tq.derive_mults(attempt, w)[:2]
            assert torch.equal(bij_inverse(bij(x, ma, mb, w), ma, mb, w), x)


# -- the plain probe against aindex_tpu --------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_keys_rule_matches_jax_probe(indexes, engine, masked):
    """Rule KEYS, tf and slot, == quot_query / cuckoo_query; tf alone ==
    quot_query_tf on the quotient table."""
    t, j = indexes[engine]
    codes, valid = _codes(j, np.random.default_rng(11))
    v = valid if masked else None
    tv = None if v is None else torch.from_numpy(v)
    tf, slot = probe.query_plain(t.tables, _i64(codes), tv, k=j.k, rule=probe.KEYS, slot=True)
    want_tf, want_slot = _jax_keys(j, codes, v)
    np.testing.assert_array_equal(_u32(tf), np.asarray(want_tf))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want_slot))
    if engine == "quot":
        qc = j.quot
        want = jq.quot_query_tf(*qc.device, jnp.asarray(codes), None if v is None else
                                jnp.asarray(v), *qc.mults, m=qc.m, lb=qc.lb, w=qc.w)
        got = probe.query_plain(t.tables, _i64(codes), tv, k=j.k, rule=probe.KEYS)
        np.testing.assert_array_equal(_u32(got), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("rule", [probe.CANON, probe.FWD_RC], ids=["canon", "fwd_rc"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_rules_match_resolve_device(indexes, engine, rule, masked):
    """tf, slot and strand under the canonical rule (the index's own) and
    the forward-else-revcomp rule (aindex_tpu's index with its reference
    rule switched on) == _resolve_device."""
    t, j = indexes[engine]
    if rule == probe.FWD_RC:
        j = copy.copy(j)
        j.canonical_keys = False
    codes, valid = _codes(j, np.random.default_rng(13))
    v = valid if masked else None
    tf, slot, strand = probe.query_plain(t.tables, _i64(codes),
                                         None if v is None else torch.from_numpy(v), k=j.k,
                                         rule=rule, slot=True, strand=True)
    want = j._resolve_device(jnp.asarray(codes), None if v is None else jnp.asarray(v))
    np.testing.assert_array_equal(_u32(tf), np.asarray(want[0]))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(strand.numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("kpb", [1.0, 3.6])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_other_loads_match_jax(indexes, engine, kpb, monkeypatch):
    """The same answers with buckets sized for fewer (1.0: almost no
    overflow) or more keys (3.6: a chain of overflow levels)."""
    monkeypatch.setattr(buckets, "KEYS_PER_BUCKET", kpb)
    t, j = indexes[engine]
    host = t.quot if engine == "quot" else t.cuckoo
    tables = (QuotTables.from_host(host.fp_tf_host, host.slot_host, host.m, host.lb, host.w,
                                   host.mults, "cpu") if engine == "quot" else
              type(t.tables).from_host(host.table_host, host.m, host.seed1, host.seed2, "cpu"))
    if kpb > buckets.BUCKET / 2:
        assert len(tables.levels) >= 3
    codes, _ = _codes(j, np.random.default_rng(17))
    tf, slot = probe.query_plain(tables, _i64(codes), k=j.k, rule=probe.KEYS, slot=True)
    want_tf, want_slot = _jax_keys(j, codes, None)
    np.testing.assert_array_equal(_u32(tf), np.asarray(want_tf))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want_slot))


# -- small tables ----------------------------------------------------------------

def _empty_rows(ct) -> tuple[bool, bool]:
    """Whether EMPTY_KEY's first-half and second-half rows are empty."""
    rows = []
    for base, seed in ((0, ct.seed1), (ct.m, ct.seed2)):
        r = int(_mix64_np(EMPTY_KEY ^ np.uint64(seed)) & np.uint64(ct.m - 1)) + base
        rows.append(int(ct.table_host[r, 1]) == 0xFFFFFFFF)
    return tuple(rows)


def _key_set(state: tuple[bool, bool]) -> np.ndarray:
    """The first seeded set of 12 keys below 4^27 whose wide table leaves
    EMPTY_KEY's rows empty or full as ``state`` says."""
    for seed in range(1000):
        keys = np.unique(np.random.default_rng(seed).integers(0, 4 ** 27, 12, dtype=np.uint64))
        ct = TCuckoo.build(keys, np.ones(keys.size, np.uint32),
                           np.arange(keys.size, dtype=np.int32))
        if _empty_rows(ct) == state:
            return keys
    raise AssertionError(f"no key set with rows {state}")


@pytest.mark.parametrize("state", [(True, True), (True, False), (False, True), (False, False)],
                         ids=["both-empty", "first-empty", "second-empty", "neither-empty"])
def test_empty_row_key(state):
    """0xFFFFFFFF_00000000 hits (tf 0, slot 0) exactly when one of its rows
    is empty, under KEYS (== cuckoo_query) and FWD_RC (==
    _resolve_device), on tables of each kind."""
    keys = _key_set(state)
    counts = np.arange(1, keys.size + 1, dtype=np.uint32) * 7
    t = TIndex.from_spectrum(keys, counts, 27, device="cpu")
    j = JIndex.from_spectrum(keys, counts, 27)
    assert t.engine == "cuckoo" and j.quot is None
    assert _empty_rows(t.cuckoo) == state
    codes = np.concatenate([[EMPTY_KEY, np.uint64(0xFFFFFFFF_00000001), np.uint64(0)],
                            np.sort(j.checker_host)])
    tf, slot = probe.query_plain(t.tables, _i64(codes), k=27, rule=probe.KEYS, slot=True)
    want_tf, want_slot = _jax_keys(j, codes, None)
    np.testing.assert_array_equal(_u32(tf), np.asarray(want_tf))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want_slot))
    assert int(slot[0]) == (0 if any(state) else -1)
    assert t.tables.empty[0] == any(state)
    jr = copy.copy(j)
    jr.canonical_keys = False
    got = probe.query_plain(t.tables, _i64(codes), k=27, rule=probe.FWD_RC, slot=True,
                            strand=True)
    want = jr._resolve_device(jnp.asarray(codes), None)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.view(torch.int32).numpy(),
                                      np.asarray(b).view(np.int32))


@pytest.mark.parametrize("n", [0, 1, 5])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_tiny_tables_match_jax(engine, n):
    """n = 0, one key and five keys: the host tables of both packages,
    probed by rule KEYS (tf, slot)."""
    k = ENGINES[engine]
    rng = np.random.default_rng(100 + n)
    keys = np.unique(rng.integers(0, 4 ** k, n, dtype=np.uint64))
    tf = rng.integers(0, 1 << 32, keys.size, dtype=np.uint64).astype(np.uint32)
    slot = np.arange(keys.size, dtype=np.int32)
    codes = np.concatenate([keys, rng.integers(0, 4 ** k, 200, dtype=np.uint64),
                            np.array([0, 2 ** 64 - 1, EMPTY_KEY], np.uint64)])
    if engine == "quot":
        t, j = tq.QuotCuckoo.build(keys, tf, slot, k), jq.QuotCuckoo.build(keys, tf, slot, k)
        want = jq.quot_query(*j.device, *j.slot_device, jnp.asarray(codes), None, *j.mults,
                             m=j.m, lb=j.lb, w=j.w)
    else:
        t, j = TCuckoo.build(keys, tf, slot), JCuckoo.build(keys, tf, slot)
        want = cuckoo_query(j.device, jnp.asarray(codes), None, j.seed1, j.seed2, m=j.m)
    tables = t.tables("cpu")
    assert tables.levels[0] == (0, buckets.level_bits(keys.size))
    got_tf, got_slot = probe.query_plain(tables, _i64(codes), k=k, rule=probe.KEYS, slot=True)
    np.testing.assert_array_equal(_u32(got_tf), np.asarray(want[0]))
    np.testing.assert_array_equal(got_slot.numpy(), np.asarray(want[1]))


# -- the engine's arguments --------------------------------------------------------

@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_args_and_checks(indexes, engine):
    t, j = indexes[engine]
    tables = t.tables
    ptrs, params = tables.engine_args()
    assert ptrs == [tables.records.data_ptr()]
    hit, tf, slot = tables.empty
    assert params[:7] == [buckets.BUCKET, 2 * j.k if engine == "quot" else 64, tables.seed,
                          int(hit), tf, slot, len(tables.levels)]
    assert params[7:] == [x for level in tables.levels for x in level]
    tables.check()
    bad = dataclasses.replace(tables, records=tables.records[:-1])
    with pytest.raises(ValueError, match="records"):
        bad.check()
    with pytest.raises(ValueError, match="k="):
        tables.check_k(0)
    if engine == "quot":
        with pytest.raises(ValueError, match="code width"):
            tables.check_k(22)

