"""The whole sparse 23-mer slice: aindex_torch.Sparse23Index on the CPU (the
kernels' plain versions) against aindex_tpu.index.sparse23.Sparse23Index on
the conftest reads and tests/data/*. Index arrays, query answers, coverage,
CONT records, statistics and saved artifacts are integers or bytes:
equality is exact, dtypes included."""

import glob
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aindex_tpu.core import codec as jcodec
from aindex_tpu.core.reads import ReadsStore
from aindex_tpu.index.sparse23 import Sparse23Index as JIndex
from aindex_tpu.io.fastq import iter_sequence_bytes as j_iter_bytes
from aindex_torch import Sparse23Index as TIndex
from aindex_torch.io.fastq import iter_sequence_bytes as t_iter_bytes

import oracle
from test_torch_host import jax_native  # noqa: F401 (a fixture)

#: aindex_tpu's native library loads before anything here builds through it
pytestmark = pytest.mark.usefixtures("jax_native")

HERE = os.path.dirname(__file__)
DATA = sorted(glob.glob(os.path.join(HERE, "data", "*")))
REPO = os.path.dirname(HERE)


def _same_index(t: TIndex, j: JIndex) -> None:
    assert (t.n, t.k) == (j.n, j.k)
    assert (t.mphf.domain, t.mphf.seed) == (j.mphf.domain, j.mphf.seed)
    np.testing.assert_array_equal(t.mphf.g_packed, j.mphf.g_packed)
    np.testing.assert_array_equal(t.mphf.slots, j.mphf.slots)
    assert t.checker_host.dtype == j.checker_host.dtype and t.tf_host.dtype == j.tf_host.dtype
    np.testing.assert_array_equal(t.checker_host, j.checker_host)
    np.testing.assert_array_equal(t.tf_host, j.tf_host)


def _u32(x: torch.Tensor) -> np.ndarray:
    assert x.dtype == torch.uint32
    return x.view(torch.int32).numpy().view(np.uint32)


def _eq(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def built(random_reads, jax_native):
    """(port index, JAX index) over the conftest reads."""
    blob = ReadsStore.from_sequences(random_reads).blob
    return (TIndex.build_from_blob(blob, device="cpu"), JIndex.build_from_blob(blob))


@pytest.fixture(scope="module")
def kmers(random_reads):
    """Every window of the reads (N- and '~'-containing ones included),
    their reverse complements, absent k-mers and lowercase."""
    out = [r[i:i + 23] for r in random_reads for i in range(len(r) - 22)]
    out += [jcodec.revcomp(km) for km in out[:200]]
    return out + ["G" * 23, "A" * 23, "acgt" * 5 + "acg", "ACGTN" * 4 + "ACG"]


# -- building -------------------------------------------------------------------

class TestBuild:
    def test_matches_oracle(self, random_reads, built):
        golden = oracle.count_canonical(random_reads, 23)
        t, _ = built
        got = dict(zip(jcodec.decode_kmers(t.checker_host, 23), t.tf_host.tolist()))
        assert got == golden

    @pytest.mark.parametrize("chunk", [128, 4096, 1 << 22])
    def test_build_from_blob_chunks(self, random_reads, built, chunk):
        blob = ReadsStore.from_sequences(random_reads).blob
        _same_index(TIndex.build_from_blob(blob, chunk=chunk, device="cpu"), built[1])

    def test_build_from_stream_equals_blob_build(self, random_reads, built):
        pieces = [np.frombuffer((r + "\n").encode(), np.uint8) for r in random_reads]
        t = TIndex.build_from_stream(iter(pieces), chunk=256, device="cpu")
        _same_index(t, built[1])
        assert set(t.build_seconds) == {"spectrum", "merge", "mphf"}

    def test_build_from_sequences(self, random_reads, built):
        _same_index(TIndex.build_from_sequences(random_reads, device="cpu"), built[1])

    @pytest.mark.parametrize("min_tf", [2, 3])
    def test_min_tf(self, random_reads, min_tf):
        t = TIndex.build_from_sequences(random_reads, min_tf=min_tf, device="cpu")
        j = JIndex.build_from_sequences(random_reads, min_tf=min_tf)
        _same_index(t, j)
        assert t.n > 0 and (t.tf_host >= min_tf).all()

    @pytest.mark.parametrize("path", DATA, ids=[os.path.basename(p) for p in DATA])
    def test_build_from_stream_on_test_data(self, path):
        t = TIndex.build_from_stream(t_iter_bytes(path), device="cpu")
        j = JIndex.build_from_blob(np.concatenate(list(j_iter_bytes(path))))
        _same_index(t, j)
        assert t.stats() == j.stats()

    def test_from_spectrum_and_from_numpy(self, built):
        t, j = built
        order = np.argsort(j.checker_host)
        _same_index(TIndex.from_spectrum(j.checker_host[order], j.tf_host[order],
                                         device="cpu"), j)
        _same_index(TIndex.from_numpy(vars(j.mphf), j.checker_host, j.tf_host,
                                      device="cpu"), j)

    def test_cuda_device_raises_without_cuda(self, random_reads, built):
        """The default device is the card; without CUDA it raises."""
        if torch.cuda.is_available():
            pytest.skip("this host has CUDA")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TIndex.build_from_sequences(random_reads)
        t = built[0]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TIndex(t.mphf, t.checker_host, t.tf_host)
        with pytest.raises(ValueError, match="unsupported device"):
            TIndex(t.mphf, t.checker_host, t.tf_host, device="meta")


# -- queries --------------------------------------------------------------------

class TestQueries:
    @pytest.mark.parametrize("family", ["get_tf_values", "get_pfids", "get_strands",
                                        "get_hash_values"])
    def test_ascii_family(self, built, kmers, family):
        t, j = built
        _eq(getattr(t, family)(kmers), getattr(j, family)(kmers))

    def test_tf_both_directions(self, built, kmers):
        t, j = built
        for a, b in zip(t.get_tf_both_directions(kmers), j.get_tf_both_directions(kmers)):
            _eq(a, b)

    def test_pfids_point_at_canonical_checker(self, built, kmers):
        t, _ = built
        pf = t.get_pfids(kmers)
        codes, valid = jcodec.encode_kmers(kmers, 23)
        canon = jcodec.canonical_code(codes, 23)
        present = pf < t.n
        assert (t.checker_host[pf[present]] == canon[present]).all()
        assert valid[present].all()

    @pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
    def test_tf_values_codes(self, built, kmers, masked):
        t, j = built
        codes, valid = jcodec.encode_kmers(kmers, 23)
        rng = np.random.default_rng(5)
        codes = np.concatenate([codes, rng.integers(0, 2**64 - 1, 300, dtype=np.uint64)])
        valid = np.concatenate([valid, rng.random(300) < 0.5])
        v = valid if masked else None
        got = t.get_tf_values_codes(codes, v)
        assert got.dtype == torch.uint32 and got.device == t.device
        _eq(_u32(got), np.asarray(j.get_tf_values_codes(jnp.asarray(codes), v)))
        # a tensor in gives the same answer
        again = t.get_tf_values_codes(torch.from_numpy(codes.view(np.int64)),
                                      None if v is None else torch.from_numpy(v))
        _eq(_u32(again), _u32(got))

    def test_kmer_by_kid_and_info(self, built):
        t, j = built
        for kid in (-1, 0, 1, t.n // 2, t.n - 1, t.n, t.n + 5):
            assert t.get_kmer_by_kid(kid) == j.get_kmer_by_kid(kid)
            assert t.get_kmer_info(kid) == j.get_kmer_info(kid)

    def test_ragged_batch_raises(self, built):
        with pytest.raises(ValueError, match="multiple of k"):
            built[0].get_tf_values(["ACGT" * 6, "ACG"])

    def test_empty_batch(self, built):
        t, j = built
        _eq(t.get_tf_values([]), np.zeros(0, np.uint32))


# -- coverage and CONT ------------------------------------------------------------

class TestCoverageAndCont:
    @pytest.mark.parametrize("cutoff", [0, 2])
    def test_sequence_coverage(self, built, random_reads, cutoff):
        t, j = built
        for seq in random_reads[:8] + ["ACGT" * 3, "".join(random_reads)]:
            _eq(t.sequence_coverage(seq, cutoff), j.sequence_coverage(seq, cutoff))

    @pytest.mark.parametrize("cutoff", [0, 2])
    def test_sequence_coverage_batch(self, built, random_reads, cutoff):
        t, j = built
        seqs = random_reads + ["ACG", "".join(random_reads[:5]), random_reads[0] * 3]
        for a, b in zip(t.sequence_coverage_batch(seqs, cutoff),
                        j.sequence_coverage_batch(seqs, cutoff)):
            _eq(a, b)

    @pytest.mark.parametrize("lengths, shapes", [
        ([150] * 10, [(10, 151)]),
        ([150, 100, 300, 10, 140], [(2, 151), (1, 101), (1, 301)]),
    ], ids=["reads", "classes"])
    def test_coverage_batch_launch_shapes(self, built, monkeypatch, lengths, shapes):
        """One K7 launch per length class, one row per sequence, rows as long
        as the class's longest sequence plus a newline: no padding beyond."""
        import aindex_torch.index.sparse23 as tsparse
        seen = []

        def spy(t, packed, vbits, rows, stride, k, cutoff, rule):
            seen.append((rows, stride))
            return real(t, packed, vbits, rows, stride, k, cutoff, rule)

        real = tsparse.probe.coverage
        monkeypatch.setattr(tsparse.probe, "coverage", spy)
        rng = np.random.default_rng(3)
        seqs = ["".join(rng.choice(list("ACGT"), n)) for n in lengths]
        covs = built[0].sequence_coverage_batch(seqs)
        assert seen == shapes
        assert [c.size for c in covs] == [max(n - 22, 0) for n in lengths]

    @pytest.mark.parametrize("fn", ["debruijn_next", "debruijn_prev"])
    @pytest.mark.parametrize("cutoff", [0, 1])
    def test_debruijn(self, built, kmers, fn, cutoff):
        t, j = built
        _eq(getattr(t, fn)(kmers, cutoff), getattr(j, fn)(kmers, cutoff))

    @pytest.mark.parametrize("fn", ["debruijn_next_info", "debruijn_prev_info"])
    def test_cont_info(self, built, kmers, fn):
        t, j = built
        a, b = getattr(t, fn)(kmers), getattr(j, fn)(kmers)
        assert a.keys() == b.keys()
        for key in a:
            _eq(a[key], b[key])


# -- statistics and persistence ---------------------------------------------------

class TestStatsAndPersistence:
    def test_stats(self, built):
        assert built[0].stats() == built[1].stats()

    @pytest.mark.parametrize("coverage", [1, 4, 30])
    def test_set_stats(self, built, coverage):
        a, b = built[0].set_stats(coverage), built[1].set_stats(coverage)
        assert a.keys() == b.keys()
        for key in a:
            _eq(a[key], b[key])

    @pytest.mark.parametrize("skip_zeros", [True, False])
    def test_save_values(self, built, tmp_path, skip_zeros):
        t, j = built
        assert t.save_values(str(tmp_path / "t.txt"), skip_zeros) == \
            j.save_values(str(tmp_path / "j.txt"), skip_zeros)
        assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()

    def test_save_byte_identical_and_cross_load(self, built, tmp_path, kmers):
        t, j = built
        t.save(str(tmp_path / "t"))
        j.save(str(tmp_path / "j"))
        for ext in (".pf", ".tf.bin", ".kmers.bin"):
            assert (tmp_path / f"t{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes(), ext
        from_jax = TIndex.load(str(tmp_path / "j"), device="cpu")
        _same_index(from_jax, j)
        _eq(from_jax.get_tf_values(kmers), j.get_tf_values(kmers))
        files = TIndex.load_files(str(tmp_path / "j.pf"), str(tmp_path / "j.tf.bin"),
                                  str(tmp_path / "j.kmers.bin"), device="cpu")
        _same_index(files, j)
        _same_index(t, JIndex.load(str(tmp_path / "t")))

    def test_load_rejects_emphf_garbage_and_mismatch(self, built, tmp_path):
        """A reference-built (emphf) set loads, reference-keyed, but not at
        k > 30 (it has no MPHF walk); garbage and size mismatches raise."""
        golden = os.path.join(HERE, "golden_ref", "p.23")
        assert not TIndex.load(golden, device="cpu").canonical_keys
        with pytest.raises(ValueError, match="emphf"):
            TIndex.load(golden, k=31, device="cpu")
        t, _ = built
        t.save(str(tmp_path / "t"))
        (tmp_path / "bad.pf").write_bytes(b"garbage!" * 8)
        with pytest.raises(ValueError, match="neither ATPF nor emphf"):
            TIndex.load_files(str(tmp_path / "bad.pf"), str(tmp_path / "t.tf.bin"),
                              str(tmp_path / "t.kmers.bin"), device="cpu")
        (tmp_path / "short.tf.bin").write_bytes(t.tf_host[:-1].tobytes())
        with pytest.raises(ValueError, match="size mismatch"):
            TIndex.load_files(str(tmp_path / "t.pf"), str(tmp_path / "short.tf.bin"),
                              str(tmp_path / "t.kmers.bin"), device="cpu")

    def test_unported_engine_raises(self, random_reads):
        """k = 31 is quotient-ineligible at this n: the MPHF walk serves it,
        as in aindex_tpu (tests/test_torch_engines.py holds it to every
        query family), and the index raises for no k up to 31."""
        t = TIndex.build_from_sequences(random_reads, k=31, device="cpu")
        j = JIndex.build_from_sequences(random_reads, k=31)
        _same_index(t, j)
        kmers = [r[i:i + 31] for r in random_reads for i in range(len(r) - 30)] + ["A" * 31]
        _eq(t.get_tf_values(kmers), j.get_tf_values(kmers))
        assert t.engine == "walk"


def test_sparse23_imports_without_jax_or_aindex_tpu():
    """aindex_torch.index.sparse23 imports and builds with jax and
    aindex_tpu made unimportable."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'aindex_tpu'):\n"
            "    sys.modules[name] = None\n"
            "from aindex_torch.index.sparse23 import Sparse23Index\n"
            "ix = Sparse23Index.build_from_sequences(['ACGT' * 10], device='cpu')\n"
            "print(ix.n, int(ix.get_tf_values(['CGTACGTACGTACGTACGTACGT'])[0]))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=REPO, timeout=300,
                       env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["2", "10"]   # as aindex_tpu counts it
