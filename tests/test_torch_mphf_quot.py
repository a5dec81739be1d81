"""The sparse index's host builds and device probes: aindex_torch's MPHF and
QuotCuckoo against aindex_tpu's (byte-equal, native and pure numpy), the
native bridge (compute_reads), and the plain versions of K6 (quot23) and
K7 (quotcov23) against aindex_tpu's quot_tf_canonical, quot_query,
quot_query_tf and quot_tf_windows_packed. All integers: equality is exact,
dtypes included."""

import os
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aindex_tpu import native as jnative
from aindex_tpu.core import codec as jcodec
from aindex_tpu.index import quotcuckoo as jq
from aindex_tpu.index.mphf import MPHF as JMPHF
from aindex_tpu.index.sparse23 import Sparse23Index as JIndex
from aindex_tpu.index.sparse23 import _extract_windows
from aindex_tpu.io import fastq as jfastq
from aindex_torch import native as tnative
from aindex_torch.core import codec as tcodec
from aindex_torch.index import mphf as tmphf
from aindex_torch.index import quotcuckoo as tq
from aindex_torch.io import fastq as tfastq
from aindex_torch.kernels import probe as tprobe
from aindex_torch.kernels import quot as tquot
from test_torch_coverage import EDGE_SHAPES, edge_matrix
from test_torch_host import jax_native  # noqa: F401 (a fixture)

#: aindex_tpu's native library loads before anything here builds through it
pytestmark = pytest.mark.usefixtures("jax_native")

DATA = os.path.join(os.path.dirname(__file__), "data")


def _keys(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, 2**46, size=n).astype(np.uint64))


def _files_equal(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


# -- MPHF -----------------------------------------------------------------------

@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("n", [1, 700, 20000])
def test_mphf_build_byte_equal_to_jax(tmp_path, native, n, jax_native):
    keys = _keys(n, n)
    t, t_slot = tmphf.MPHF.build_with_slots(keys, use_native=native)
    j, j_slot = JMPHF.build_with_slots(keys, use_native=native)
    assert (t.n, t.domain, t.seed) == (j.n, j.domain, j.seed)
    np.testing.assert_array_equal(t.g_packed, j.g_packed)
    np.testing.assert_array_equal(t.slots, j.slots)
    assert t_slot.dtype == j_slot.dtype
    np.testing.assert_array_equal(t_slot, j_slot)
    t.save(str(tmp_path / "t.pf"))
    j.save(str(tmp_path / "j.pf"))
    assert _files_equal(str(tmp_path / "t.pf"), str(tmp_path / "j.pf"))
    back = tmphf.MPHF.load(str(tmp_path / "j.pf"))
    np.testing.assert_array_equal(back.lookup(keys), j.lookup(keys))
    assert sorted(back.lookup(keys).tolist()) == list(range(len(keys)))


def test_mphf_empty_duplicates_and_bad_magic(tmp_path):
    empty = tmphf.MPHF.build(np.zeros(0, np.uint64))
    j_empty = JMPHF.build(np.zeros(0, np.uint64))
    assert empty.n == j_empty.n == 0
    np.testing.assert_array_equal(empty.g_packed, j_empty.g_packed)
    with pytest.raises(ValueError, match="distinct"):
        tmphf.MPHF.build(np.array([1, 1, 2], np.uint64))
    path = tmp_path / "x.pf"
    path.write_bytes(b"NOTATPF!" + bytes(64))
    with pytest.raises(ValueError, match="magic"):
        tmphf.MPHF.load(str(path))


def test_builds_need_native_at_main_path_sizes():
    """Without a compiler a large MPHF or quotient build raises instead of
    running the pure-Python versions; small ones still build."""
    keys = _keys(tmphf.PURE_MAX_KEYS + 10, 5)
    tf = np.ones(keys.size, np.uint32)
    slot = np.arange(keys.size, dtype=np.int32)
    with mock.patch.object(tnative, "get_lib", side_effect=RuntimeError("no g++")):
        with pytest.raises(RuntimeError, match="no g"):
            tmphf.MPHF.build(keys)
        with pytest.raises(RuntimeError, match="no g"):
            tq.QuotCuckoo.build(keys[:tq.PURE_MAX_KEYS + 10], tf, slot, 23)
        small = tmphf.MPHF.build(keys[:500])       # pure numpy below the limit
        table = tq.QuotCuckoo.build(keys[:300], tf[:300], slot[:300], 23)
    assert sorted(small.lookup(keys[:500]).tolist()) == list(range(500))
    assert table.lookup_host(keys[:300])[0].all()


# -- quotient cuckoo: host build -------------------------------------------------

@pytest.fixture(scope="module")
def jindex(random_reads, jax_native):
    return JIndex.build_from_sequences(random_reads)


@pytest.fixture(scope="module")
def built(jindex):
    """(port table, JAX table) over the conftest reads' spectrum."""
    slot = np.arange(jindex.n, dtype=np.int32)
    t = tq.QuotCuckoo.build(jindex.checker_host, jindex.tf_host, slot, 23)
    j = jq.QuotCuckoo.build(jindex.checker_host, jindex.tf_host, slot, 23)
    return t, j


def test_quot_build_native_byte_equal_to_jax(built):
    t, j = built
    assert (t.m, t.lb, t.w, t.mults) == (j.m, j.lb, j.w, j.mults)
    assert t.fp_tf_host.dtype == j.fp_tf_host.dtype and t.slot_host.dtype == j.slot_host.dtype
    np.testing.assert_array_equal(t.fp_tf_host, j.fp_tf_host)
    np.testing.assert_array_equal(t.slot_host, j.slot_host)


def test_quot_build_pure_python_byte_equal_to_jax_and_native(jindex, built):
    keys, tf = jindex.checker_host[:400], jindex.tf_host[:400]
    slot = np.arange(400, dtype=np.int32)
    with mock.patch.object(tnative, "available", return_value=False):
        t = tq.QuotCuckoo.build(keys, tf, slot, 23)
    with mock.patch.object(jnative, "available", return_value=False):
        j = jq.QuotCuckoo.build(keys, tf, slot, 23)
    nat = tq.QuotCuckoo.build(keys, tf, slot, 23)
    for other in (j, nat):
        np.testing.assert_array_equal(t.fp_tf_host, other.fp_tf_host)
        np.testing.assert_array_equal(t.slot_host, other.slot_host)


def test_lookup_host_matches_jax(jindex, built):
    t, j = built
    rng = np.random.default_rng(4)
    keys = np.concatenate([jindex.checker_host, rng.integers(0, 2**46, 3000).astype(np.uint64)])
    for a, b in zip(t.lookup_host(keys), j.lookup_host(keys)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [13, 23, 30, 31])
def test_sizing_and_multipliers_match_jax(k):
    for n in (0, 1, 1000, 9_602_528, 1 << 30):
        assert tq.natural_lb(n, 2 * k) == jq.natural_lb(n, 2 * k)
        assert tq.eligible(n, k) == jq.eligible(n, k)
    for attempt in range(4):
        assert tq.derive_mults(attempt, 2 * k) == jq.derive_mults(attempt, 2 * k)


# -- K6 / K7 plain versions against the JAX probes --------------------------------

@pytest.fixture(scope="module")
def probe_inputs(jindex):
    """Literal codes: every stored key forward and reverse complemented,
    random codes, and codes with bits above 2k; a mask; the tables."""
    rng = np.random.default_rng(9)
    keys = jindex.checker_host
    codes = np.concatenate([keys, jcodec.revcomp_code(keys, 23),
                            rng.integers(0, 2**46, 2000).astype(np.uint64),
                            rng.integers(0, 2**64 - 1, 500, dtype=np.uint64)])
    valid = rng.random(codes.size) < 0.8
    return codes, valid


def _tables(t: tq.QuotCuckoo):
    return t.tables("cpu")



def _u32(x: torch.Tensor) -> np.ndarray:
    assert x.dtype == torch.uint32
    return x.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_quot_tf_canonical_matches_jax(built, probe_inputs, masked):
    t, j = built
    codes, valid = probe_inputs
    v = valid if masked else None
    got = tquot.quot23(_tables(t), torch.from_numpy(codes.view(np.int64)),
                       None if v is None else torch.from_numpy(v), k=23)
    want = jq.quot_tf_canonical(*j.device, jnp.asarray(codes),
                                None if v is None else jnp.asarray(v), *j.mults,
                                k=23, m=j.m, lb=j.lb, w=j.w)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_quot_query_and_query_tf_match_jax(built, probe_inputs, masked):
    t, j = built
    codes, valid = probe_inputs
    canon = jcodec.canonical_code(codes & np.uint64(2**46 - 1), 23)
    v = valid if masked else None
    tv = None if v is None else torch.from_numpy(v)
    jv = None if v is None else jnp.asarray(v)
    tk = torch.from_numpy(canon.view(np.int64))
    tf, slot = tquot.quot23(_tables(t), tk, tv, k=23, rule=tprobe.KEYS, slot=True)
    jtf, jslot = jq.quot_query(*j.device, *j.slot_device, jnp.asarray(canon), jv, *j.mults,
                               m=j.m, lb=j.lb, w=j.w)
    np.testing.assert_array_equal(_u32(tf), np.asarray(jtf))
    assert slot.dtype == torch.int32
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    tf_only = tquot.quot23(_tables(t), tk, tv, k=23, rule=tprobe.KEYS)
    jtf_only = jq.quot_query_tf(*j.device, jnp.asarray(canon), jv, *j.mults,
                                m=j.m, lb=j.lb, w=j.w)
    np.testing.assert_array_equal(_u32(tf_only), np.asarray(jtf_only))


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_quot23_strand_matches_jax_resolve_device(jindex, built, probe_inputs, masked):
    t, _ = built
    codes, valid = probe_inputs
    v = valid if masked else None
    tf, slot, strand = tquot.quot23(_tables(t), torch.from_numpy(codes.view(np.int64)),
                                    None if v is None else torch.from_numpy(v), k=23,
                                    slot=True, strand=True)
    jtf, jslot, jstrand = jindex._resolve_device(jnp.asarray(codes),
                                                 None if v is None else jnp.asarray(v))
    np.testing.assert_array_equal(_u32(tf), np.asarray(jtf))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    assert strand.dtype == torch.int32
    np.testing.assert_array_equal(strand.numpy(), np.asarray(jstrand))


def test_quot23_ascii_rows_match_jax(jindex, built, random_reads):
    t, _ = built
    kmers = [r[i:i + 23] for r in random_reads for i in range(len(r) - 22)]
    kmers += ["A" * 23, "acgt" * 5 + "acg", "ACGTN" * 4 + "ACG", "ACGT~" * 4 + "ACG"]
    rows = np.frombuffer("".join(kmers).encode(), np.uint8).reshape(-1, 23)
    tf, slot, strand = tquot.quot23(_tables(t), ascii=torch.from_numpy(rows.copy()), k=23,
                                    slot=True, strand=True)
    codes, valid = _extract_windows(jnp.asarray(rows), 23)
    jtf, jslot, jstrand = jindex._resolve_device(codes.reshape(-1), valid.reshape(-1))
    np.testing.assert_array_equal(_u32(tf), np.asarray(jtf))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(strand.numpy(), np.asarray(jstrand))


def test_quot23_checks_arguments(built):
    t = _tables(built[0])
    codes = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="exactly one"):
        tquot.quot23(t)
    with pytest.raises(ValueError, match="int64"):
        tquot.quot23(t, codes.to(torch.int32))
    with pytest.raises(ValueError, match="strand"):
        tquot.quot23(t, codes, strand=True)
    with pytest.raises(ValueError, match="code width"):
        tquot.quot23(t, codes, k=13)
    with pytest.raises(ValueError, match="different devices"):
        tquot.quot23(t, codes.to("meta"))


@pytest.mark.parametrize("cutoff", [0, 2])
def test_quotcov23_matches_jax_windows_packed(built, random_reads, cutoff):
    t, j = built
    L = max(len(r) for r in random_reads)
    rows = 64
    mat = np.full((rows, L), ord("\n"), np.uint8)
    for i, r in enumerate(random_reads[:rows]):
        mat[i, :len(r)] = np.frombuffer(r.encode(), np.uint8)
    flat = np.concatenate([np.hstack([mat, np.full((rows, 1), ord("\n"), np.uint8)]).ravel(),
                           np.full(23, ord("\n"), np.uint8)])
    packed, vbits = jcodec.pack_ascii_chunk(flat)
    got = tquot.quotcov23(_tables(t), torch.from_numpy(packed.view(np.int32)),
                          torch.from_numpy(vbits), rows, L + 1, 23, cutoff)
    want = np.asarray(jq.quot_tf_windows_packed(
        *j.device, jnp.asarray(packed), jnp.asarray(vbits), *j.mults,
        k=23, m=j.m, lb=j.lb, w=j.w, rows=rows, stride=L + 1))
    want = np.where(want >= cutoff, want, 0)
    assert got.shape == (rows, L + 1 - 23)
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("cutoff", [0, 2, 2**32 - 1])
@pytest.mark.parametrize("shape", list(EDGE_SHAPES))
def test_quotcov23_edges_match_jax_windows_packed(built, random_reads, shape, cutoff):
    """K7's plain version at the tiled kernel's edge shapes (rows cut from
    the reads the table holds), on packed buffers of exactly rows * stride
    bases (rounded up to a word), against aindex_tpu's on the same rows
    with its k-byte tail."""
    t, j = built
    mat = edge_matrix(shape, 23, 7, "".join(random_reads).encode())
    rows, stride = mat.shape
    flat = np.concatenate([mat.ravel(), np.full(23, ord("\n"), np.uint8)])
    packed, vbits = jcodec.pack_ascii_chunk(flat)
    want = np.asarray(jq.quot_tf_windows_packed(
        *j.device, jnp.asarray(packed), jnp.asarray(vbits), *j.mults,
        k=23, m=j.m, lb=j.lb, w=j.w, rows=rows, stride=stride))
    want = np.where(want >= cutoff, want, 0)
    packed, vbits = tcodec.pack_ascii_chunk(mat.ravel())
    got = tquot.quotcov23(_tables(t), torch.from_numpy(packed.view(np.int32)),
                          torch.from_numpy(vbits), rows, stride, 23, cutoff)
    assert got.shape == (rows, stride - 23)
    np.testing.assert_array_equal(_u32(got), want)


# -- native bridge ------------------------------------------------------------------

def test_native_library_builds_into_build_dir():
    path = tnative.build()
    assert os.path.exists(path) and os.sep + os.path.join("build", "native") in path
    assert tnative.available()


@pytest.mark.parametrize("case", ["fastq", "se", "fasta", "reads"])
def test_compute_reads_native_matches_jax_native(tmp_path, case, jax_native):
    args = {"fastq": (f"{DATA}/test_R1.fastq", f"{DATA}/test_R2.fastq", "fastq"),
            "se": (f"{DATA}/test_se.fastq", None, "se"),
            "fasta": (f"{DATA}/test.fasta", None, "fasta"),
            "reads": (f"{DATA}/test_reads.txt", None, "reads")}[case]
    t = tfastq.compute_reads(*args, str(tmp_path / "t"), use_native=True)
    j = jfastq.compute_reads(*args, str(tmp_path / "j"), use_native=True)
    assert t["n_reads"] == j["n_reads"] > 0
    for key in ("reads", "ridx", "header"):
        if key in j:
            assert _files_equal(t[key], j[key]), key
