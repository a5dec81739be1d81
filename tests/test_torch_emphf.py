"""The emphf reader and reference-built artifacts: aindex_torch's
index/emphf.py, the reference-keyed Sparse23Index, Dense13Index.load with
an emphf .pf and AIndex.load_from_prefix on tests/golden_ref/p.13.*,
against aindex_tpu on the CPU. Every comparison is of integers or bytes:
equality is exact, the tolerance 0."""

import gzip
import os
import shutil

import numpy as np
import pytest

from aindex_tpu.api import AIndex as JAIndex
from aindex_tpu.core import codec as jcodec
from aindex_tpu.index import emphf as jemphf
from aindex_tpu.index.dense13 import Dense13Index as JDense
from aindex_tpu.index.sparse23 import Sparse23Index as JIndex
from aindex_torch import AIndex as TAIndex
from aindex_torch import native as tnative
from aindex_torch.index import emphf as temphf
from aindex_torch.index.dense13 import Dense13Index as TDense
from aindex_torch.index.sparse23 import Sparse23Index as TIndex
from test_torch_host import jax_native  # noqa: F401 (a fixture)

#: aindex_tpu's native library loads before anything here builds through it
pytestmark = pytest.mark.usefixtures("jax_native")

GOLD = os.path.join(os.path.dirname(__file__), "golden_ref")
PREFIX = os.path.join(GOLD, "p.23")


def _eq(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def golden_kmers():
    """Every valid 23-mer window of the golden reads, their reverse
    complements, and absent k-mers."""
    out = []
    with open(os.path.join(GOLD, "p.reads")) as f:
        for line in f:
            for sub in line.strip().split("~"):
                out += [sub[i:i + 23] for i in range(len(sub) - 22)]
    out = [km for km in out if set(km) <= set("ACGT")]
    return out + [jcodec.revcomp(km) for km in out] + ["A" * 23, "ACGT" * 5 + "ACG"]


@pytest.fixture(scope="module")
def golden_reads():
    with open(os.path.join(GOLD, "p.reads")) as f:
        return [line.strip() for line in f]


@pytest.fixture(scope="module")
def indexes(jax_native):
    return TIndex.load(PREFIX, device="cpu"), JIndex.load(PREFIX)


# -- the .pf reader ---------------------------------------------------------------

class TestEmphfPF:
    def test_load_fields_equal(self):
        a, b = temphf.EmphfPF.load(PREFIX + ".pf"), jemphf.EmphfPF.load(PREFIX + ".pf")
        assert (a.n, a.domain, a.seed) == (b.n, b.domain, b.seed)
        _eq(a.values, b.values)
        _eq(a.ranks, b.ranks)

    def test_lookup_is_the_reference_slot(self):
        pf = temphf.EmphfPF.load(PREFIX + ".pf")
        checker = np.fromfile(PREFIX + ".kmers.bin", dtype=np.uint64)
        _eq(pf.lookup_codes(checker, 23), np.arange(pf.n, dtype=np.int64))
        codes = np.random.default_rng(1).integers(0, 4 ** 23, 5000, dtype=np.uint64)
        _eq(pf.lookup_codes(codes, 23), jemphf.EmphfPF.load(PREFIX + ".pf")
            .lookup_codes(codes, 23))

    def test_save_is_byte_identical(self, tmp_path):
        out = tmp_path / "p.pf"
        temphf.EmphfPF.load(PREFIX + ".pf").save(str(out))
        assert out.read_bytes() == open(PREFIX + ".pf", "rb").read()

    def test_build_exact_rebuilds_golden_pf(self, tmp_path):
        codes = np.fromfile(PREFIX + ".kmers.bin", dtype=np.uint64)
        pf = temphf.EmphfPF.build_exact(codes[::-1].copy(), 23)
        out = tmp_path / "rebuilt.pf"
        pf.save(str(out))
        assert out.read_bytes() == open(PREFIX + ".pf", "rb").read()

    @pytest.mark.parametrize("k", [5, 8, 13, 16, 23, 24, 27, 31, 32])
    def test_jenkins_numpy_native_and_jax_agree(self, k):
        codes = np.random.default_rng(k).integers(0, 2 ** (2 * k) - 1, 3000,
                                                  dtype=np.uint64)
        got_np = temphf.jenkins_triple_codes(codes, k, 987654321)
        got_c = tnative.jenkins_triple_codes(codes, k, 987654321)
        want = jemphf.jenkins_triple_codes(codes, k, 987654321)
        for a, b, c in zip(got_np, got_c, want):
            _eq(a, c)
            _eq(b, c)

    def test_build_and_is_emphf_file(self, tmp_path):
        codes = np.unique(np.random.default_rng(2).integers(0, 1 << 46, 700,
                                                            dtype=np.uint64))
        a, b = temphf.EmphfPF.build(codes, 23), jemphf.EmphfPF.build(codes, 23)
        assert (a.seed, a.domain) == (b.seed, b.domain)
        _eq(a.values, b.values)
        a.save(str(tmp_path / "a.pf"))
        assert temphf.EmphfPF.is_emphf_file(str(tmp_path / "a.pf"))
        assert not temphf.EmphfPF.is_emphf_file(PREFIX + ".tf.bin")


# -- the reference-keyed sparse index ------------------------------------------------

class TestReferenceKeyedIndex:
    def test_arrays_and_rule(self, indexes):
        t, j = indexes
        assert not t.canonical_keys and t.engine == "quot"
        _eq(t.checker_host, j.checker_host)
        _eq(t.tf_host, j.tf_host)

    @pytest.mark.parametrize("fn", ["get_tf_values", "get_tf_both_directions", "get_strands",
                                    "get_pfids", "get_hash_values"])
    def test_queries(self, indexes, golden_kmers, fn):
        t, j = indexes
        a, b = getattr(t, fn)(golden_kmers), getattr(j, fn)(golden_kmers)
        for x, y in zip(a, b) if isinstance(a, tuple) else [(a, b)]:
            _eq(x, y)

    def test_codes_in(self, indexes, golden_kmers):
        t, j = indexes
        codes, valid = jcodec.encode_kmers(golden_kmers, 23)
        got = t.get_tf_values_codes(codes, valid)
        _eq(got.view(__import__("torch").int32).numpy().view(np.uint32),
            j.get_tf_values_codes(codes, valid))

    @pytest.mark.parametrize("cutoff", [0, 2])
    def test_coverage(self, indexes, golden_reads, cutoff):
        t, j = indexes
        for a, b in zip(t.sequence_coverage_batch(golden_reads, cutoff),
                        j.sequence_coverage_batch(golden_reads, cutoff)):
            _eq(a, b)

    def test_positional_csr_bytes(self, indexes):
        from aindex_tpu.index.positional import PositionalIndex as JPos
        from aindex_torch.index.positional import PositionalIndex as TPos
        t, j = indexes
        blob = np.fromfile(os.path.join(GOLD, "p.reads"), dtype=np.uint8)
        a, b = TPos.build_sparse23(blob, t), JPos.build_sparse23(blob, j)
        assert a.offsets.tobytes() == b.offsets.tobytes()
        assert a.positions.tobytes() == b.positions.tobytes()

    def test_k_above_30_raises(self):
        with pytest.raises(ValueError, match="k > 30"):
            TIndex.load(PREFIX, k=31, device="cpu")

    def test_export_reference(self, random_reads, tmp_path):
        t = TIndex.build_from_sequences(random_reads, device="cpu")
        j = JIndex.build_from_sequences(random_reads)
        t.export_reference(str(tmp_path / "t"))
        j.export_reference(str(tmp_path / "j"))
        for ext in (".pf", ".tf.bin", ".kmers.bin"):
            assert (tmp_path / f"t{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes()
        back = TIndex.load(str(tmp_path / "t"), device="cpu")
        assert not back.canonical_keys
        kmers = [r[i:i + 23] for r in random_reads for i in range(0, len(r) - 22, 4)]
        _eq(back.get_tf_values(kmers), t.get_tf_values(kmers))


# -- the reference 13-mer set: the dense table re-keyed by its .pf ----------------------

@pytest.fixture(scope="module")
def prefix13(tmp_path_factory):
    """Decompressed golden 13-mer artifact set under a temp prefix 'p.13'."""
    d = tmp_path_factory.mktemp("gold13")
    for name in ("p.13.pf", "p.13.tf.bin", "p.13.indices.bin"):
        with gzip.open(os.path.join(GOLD, name + ".gz"), "rb") as f, \
                open(d / name, "wb") as out:
            shutil.copyfileobj(f, out)
    for name in ("p.13.index.bin", "p.reads", "p.ridx"):
        shutil.copy(os.path.join(GOLD, name), d / name)
    yield str(d / "p.13")
    temphf.clear_perm_cache()
    jemphf.clear_perm_cache()
    shutil.rmtree(d)


class TestReference13:
    def test_dense_load_with_pf(self, prefix13):
        t = TDense.load(prefix13 + ".tf.bin", prefix13 + ".pf", device="cpu")
        j = JDense.load(prefix13 + ".tf.bin", prefix13 + ".pf")
        _eq(t.tf_host, j.tf_host)

    def test_slot_permutation(self, prefix13):
        pf = temphf.EmphfPF.load(prefix13 + ".pf")
        _eq(temphf.dense_slot_permutation(pf, 13),
            jemphf.dense_slot_permutation(jemphf.EmphfPF.load(prefix13 + ".pf"), 13))

    def test_facade_load_from_prefix(self, prefix13):
        t = TAIndex.load_from_prefix(prefix13, load_reads=True, device="cpu")
        j = JAIndex.load_from_prefix(prefix13, load_reads=True)
        _eq(t.dense13.tf_host, j.dense13.tf_host)
        _eq(t.pos13.offsets, j.pos13.offsets)
        _eq(t.pos13.positions, j.pos13.positions)
        assert t.n_reads == j.n_reads
        kmers = [t.get_read_by_rid(r)[i:i + 13] for r in range(t.n_reads) for i in (0, 9)]
        assert t.get_tf_values(kmers) == j.get_tf_values(kmers)
        assert t.get_positions_batch(kmers) == j.get_positions_batch(kmers)
        assert [t.get_positions(km) for km in kmers[:20]] == \
            [j.get_positions(km) for km in kmers[:20]]
