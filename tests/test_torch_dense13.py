"""The whole dense 13-mer slice: aindex_torch.Dense13Index on the CPU (the
kernels' plain versions) against aindex_tpu.index.dense13.Dense13Index.
Tables, query answers, coverage and statistics are integers: equality is
exact, dtypes included."""

import glob
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aindex_tpu.constants import SPACE_13
from aindex_tpu.core import codec as jcodec
from aindex_tpu.core.reads import ReadsStore
from aindex_tpu.index import dense13 as jd
from aindex_tpu.io.fastq import iter_sequence_bytes as j_iter_bytes
from aindex_torch.index import dense13 as td
from aindex_torch.io.fastq import iter_sequence_bytes as t_iter_bytes

import oracle

DATA = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "data", "*")))


@pytest.fixture(scope="module")
def built(random_reads):
    """(port index, JAX index) over the conftest reads, default chunk."""
    blob = ReadsStore.from_sequences(random_reads).blob
    return (td.Dense13Index.build_from_blob(blob, device="cpu"),
            jd.Dense13Index.build_from_blob(blob))


@pytest.fixture(scope="module")
def kmers(random_reads):
    """Every window of the reads (N-containing ones included), absent
    k-mers, lowercase and '~'."""
    out = [r[i:i + 13] for r in random_reads for i in range(len(r) - 12)]
    return out + ["G" * 13, "ACGTNACGTACGT", "acgtacgtacgta", "ACGTAC~GTACGT"]


class TestBuild:
    @pytest.mark.parametrize("chunk", [64, 1 << 22])
    def test_build_from_blob(self, random_reads, built, chunk):
        blob = ReadsStore.from_sequences(random_reads).blob
        t = td.Dense13Index.build_from_blob(blob, chunk=chunk, device="cpu")
        assert t.tf_host.dtype == np.uint32
        np.testing.assert_array_equal(t.tf_host, built[1].tf_host)

    def test_build_from_stream_and_sequences(self, random_reads, built):
        pieces = [np.frombuffer((r + "\n").encode(), np.uint8) for r in random_reads]
        t = td.Dense13Index.build_from_stream(iter(pieces), chunk=256, device="cpu")
        np.testing.assert_array_equal(t.tf_host, built[1].tf_host)
        s = td.Dense13Index.build_from_sequences(random_reads, device="cpu")
        np.testing.assert_array_equal(s.tf_host, built[1].tf_host)

    def test_table_matches_oracle(self, random_reads, built):
        golden = oracle.count_forward(random_reads, 13)
        tf = built[0].tf_host
        codes, _ = jcodec.encode_kmers(sorted(golden), 13)
        np.testing.assert_array_equal(tf[codes.astype(np.int64)],
                                      [golden[k] for k in sorted(golden)])
        assert int(tf.sum()) == sum(golden.values())

    @pytest.mark.parametrize("path", DATA, ids=[os.path.basename(p) for p in DATA])
    def test_build_from_stream_on_test_data(self, path):
        t = td.Dense13Index.build_from_stream(t_iter_bytes(path), device="cpu")
        j = jd.Dense13Index.build_from_stream(j_iter_bytes(path))
        np.testing.assert_array_equal(t.tf_host, j.tf_host)
        assert t.stats() == j.stats()

    def test_progress_callback(self, random_reads):
        blob = ReadsStore.from_sequences(random_reads).blob
        seen_t, seen_j = [], []
        td.Dense13Index.build_from_blob(blob, chunk=1024, on_progress=seen_t.append,
                                        device="cpu")
        jd.Dense13Index.build_from_blob(blob, chunk=1024, on_progress=seen_j.append)
        assert seen_t == seen_j and seen_t[-1] == blob.size


class TestTables:
    def test_total_and_query_tables(self, built):
        t, j = built
        assert t.tf.dtype == torch.uint32
        for mine, theirs in ((t.tf_total, j.tf_total), (t.tf_query, j.tf_query)):
            want = np.asarray(theirs)
            got = mine.numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)

    def test_total13_plain_wraps_like_jax(self):
        rng = np.random.default_rng(4)
        tf = rng.integers(0, 2 ** 32, size=SPACE_13, dtype=np.uint64).astype(np.uint32)
        want = np.asarray(jd._build_total_table(jnp.asarray(tf)))
        np.testing.assert_array_equal(td.total13(torch.from_numpy(tf)).numpy(), want)

    @pytest.mark.parametrize("top", [0, 255, 256, 65535, 65536, 2 ** 31, 2 ** 32 - 1])
    def test_narrow_width(self, top):
        t = np.array([0, 3, top], dtype=np.uint32)
        want = np.asarray(jd._narrow(jnp.asarray(t)))
        got = td._narrow(torch.from_numpy(t)).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


class TestQueries:
    @pytest.mark.parametrize("fn", ["get_tf_values", "get_total_tf_values",
                                    "get_tf_both_directions"])
    def test_ascii_queries(self, built, kmers, fn):
        t, j = built
        got, want = getattr(t, fn)(kmers), getattr(j, fn)(kmers)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.dtype == np.uint32 == w.dtype
            np.testing.assert_array_equal(g, w)

    def test_ascii_queries_empty_and_ragged(self, built):
        t, _ = built
        assert t.get_tf_values([]).shape == (0,)
        with pytest.raises(ValueError, match="not a multiple of k"):
            t.get_tf_values(["ACGT"])

    @pytest.mark.parametrize("fn", ["get_tf_values_codes", "get_total_tf_values_codes"])
    @pytest.mark.parametrize("masked", [False, True], ids=["all", "mask"])
    def test_codes_in(self, built, kmers, fn, masked):
        t, j = built
        codes, valid = jcodec.encode_kmers(kmers, 13)          # uint64 codes
        codes = np.concatenate([codes, np.array([SPACE_13, 2 ** 31, 2 ** 32 - 1,
                                                 2 ** 32 + 5], np.uint64)])
        valid = np.concatenate([valid, [True, True, True, False]])
        args = (codes, valid) if masked else (codes,)
        want = np.asarray(getattr(j, fn)(*args))
        for c in (codes, torch.from_numpy(codes.astype(np.int64)),
                  torch.from_numpy(codes.astype(np.uint32))):
            got = getattr(t, fn)(c, *args[1:])
            assert got.dtype == torch.uint32 and want.dtype == np.uint32
            np.testing.assert_array_equal(got.numpy(), want)

    def test_codes_in_rejects_mismatched_mask(self, built):
        with pytest.raises(ValueError):
            built[0].get_tf_values_codes(np.zeros(4, np.uint32), np.ones(3, bool))

    def test_table_reads(self, built):
        t, j = built
        for i in (0, 1, 12345, SPACE_13 - 1, int(np.argmax(j.tf_host))):
            assert t.get_tf_by_index(i) == j.get_tf_by_index(i)
        np.testing.assert_array_equal(t.get_tf_array(), j.get_tf_array())


class TestCoverage:
    @pytest.mark.parametrize("cutoff", [0, 10])
    def test_single(self, built, random_reads, cutoff):
        t, j = built
        for seq in [random_reads[0], random_reads[-3], random_reads[40],
                    "ACGTN" + random_reads[1], "ACGT", ""]:
            got, want = t.sequence_coverage(seq, cutoff), j.sequence_coverage(seq, cutoff)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("cutoff", [0, 10])
    def test_batch(self, built, random_reads, cutoff):
        t, j = built
        seqs = random_reads + ["ACGT", "ACGTN" + random_reads[1], "".join(random_reads)]
        got, want = t.sequence_coverage_batch(seqs, cutoff), j.sequence_coverage_batch(seqs, cutoff)
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


class TestStats:
    def test_stats(self, built):
        t, j = built
        t._tf_host = None                    # the device path, then the host path
        assert t.stats() == j.stats()
        t.tf_host
        assert t.stats() == j.stats()

    def test_stats_device_path_above_2_31(self):
        tf = np.zeros(SPACE_13, np.uint32)
        tf[[3, 9]] = [2 ** 32 - 2, 5]
        t = td.Dense13Index(torch.from_numpy(tf))
        assert t.stats() == {"total_kmers": SPACE_13, "non_zero_kmers": 2,
                             "max_frequency": 2 ** 32 - 2, "total_count": 2 ** 32 + 3}

    def test_set_stats_and_save_values(self, built, tmp_path):
        t, j = built
        a, b = t.set_stats(5), j.set_stats(5)
        np.testing.assert_array_equal(a.pop("profile"), b.pop("profile"))
        assert a == b
        pa, pb = tmp_path / "t.txt", tmp_path / "j.txt"
        assert t.save_values(str(pa)) == j.save_values(str(pb))
        assert pa.read_bytes() == pb.read_bytes()


class TestFiles:
    def test_tf_bin_is_shared(self, built, tmp_path):
        t, j = built
        pt, pj = str(tmp_path / "t.tf.bin"), str(tmp_path / "j.tf.bin")
        try:
            t.save(pt)
            j.save(pj)
            with open(pt, "rb") as a, open(pj, "rb") as b:
                assert a.read() == b.read()
            np.testing.assert_array_equal(td.Dense13Index.load(pj, device="cpu").tf_host,
                                          j.tf_host)
            np.testing.assert_array_equal(jd.Dense13Index.load(pt).tf_host, t.tf_host)
        finally:
            # two 512 MB files; pytest keeps tmp_path contents of recent runs
            for path in (pt, pj):
                if os.path.exists(path):
                    os.remove(path)

    def test_load_pf_path_not_ported(self, tmp_path):
        with pytest.raises(NotImplementedError):
            td.Dense13Index.load(str(tmp_path / "x.tf.bin"), str(tmp_path / "x.pf"),
                                 device="cpu")

    def test_from_numpy_on_jax_table(self, built, kmers):
        _, j = built
        for tf in (np.asarray(j.tf), j.tf_host.astype(np.uint64)):
            t = td.Dense13Index.from_numpy(tf, device="cpu")
            np.testing.assert_array_equal(t.tf_host, j.tf_host)
            np.testing.assert_array_equal(t.get_total_tf_values(kmers),
                                          j.get_total_tf_values(kmers))
            np.testing.assert_array_equal(t.sequence_coverage(kmers[0] * 3),
                                          j.sequence_coverage(kmers[0] * 3))
        with pytest.raises(ValueError):
            td.Dense13Index.from_numpy(np.zeros(SPACE_13, np.int32), device="cpu")

    def test_uint32_overflow_saturates_device_and_keeps_host_exact(self, caplog):
        """The rule of aindex_tpu's _from_raw_u64 (test_dense13.py): counts
        beyond uint32 saturate in the device table, with a warning, and
        the uint64 host table and save() stay exact."""
        raw = np.zeros(SPACE_13, dtype=np.uint64)
        big = np.uint64(1) << np.uint64(33)
        raw[5] = big
        raw[7] = 3
        with caplog.at_level(logging.WARNING, "aindex_torch.index.dense13"):
            idx = td.Dense13Index._from_raw_u64(raw, "synthetic", "cpu")
        assert any("exceed uint32" in r.message for r in caplog.records)
        assert idx.tf_host.dtype == np.uint64
        assert idx.tf_host[5] == big
        assert int(idx.tf[5]) == np.iinfo(np.uint32).max
        assert int(idx.tf[7]) == 3
        assert idx.stats()["max_frequency"] == int(big)
        j = jd.Dense13Index._from_raw_u64(raw, "synthetic")
        np.testing.assert_array_equal(idx.get_tf_values_codes(np.array([5, 7])).numpy(),
                                      np.asarray(j.get_tf_values_codes(np.array([5, 7]))))
        caplog.clear()
        idx2 = td.Dense13Index._from_raw_u64(raw * 0 + 2, "synthetic", "cpu")
        assert idx2.tf_host.dtype == np.uint32 and not caplog.records
