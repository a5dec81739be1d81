"""Host layer of aindex_torch against aindex_tpu (codec, reads chunking,
fastq reads files, stats), the rules the port keeps (no JAX, no quiet CPU
fallback, no build at import), and chip_smoke.py's corpus and oracle."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from aindex_tpu.core import codec as jcodec
from aindex_tpu.core import reads as jreads
from aindex_tpu.core import stats as jstats
from aindex_tpu.io import fastq as jfastq
from aindex_torch.core import codec as tcodec
from aindex_torch.core import reads as treads
from aindex_torch.core import stats as tstats
from aindex_torch.io import fastq as tfastq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
ALPHABET = np.frombuffer(b"ACGTACGTacgtN~\n", dtype=np.uint8)


def _run(code: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


class TestCodec:
    @pytest.mark.parametrize("shape", [(4096,), (3, 160), (1000,), (5, 21)])
    def test_pack_ascii_chunk(self, shape):
        rng = np.random.default_rng(int(np.prod(shape)))
        chunk = ALPHABET[rng.integers(0, ALPHABET.size, size=shape)]
        for a, b in zip(tcodec.pack_ascii_chunk(chunk), jcodec.pack_ascii_chunk(chunk)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("k", [5, 13, 23, 32])
    def test_kmer_codes(self, k):
        rng = np.random.default_rng(k)
        raw = ALPHABET[rng.integers(0, 14, size=500 * k)].tobytes().decode()
        kmers = [raw[i:i + k] for i in range(0, len(raw), k)]
        tc, tv = tcodec.encode_kmers(kmers, k)
        jc, jv = jcodec.encode_kmers(kmers, k)
        np.testing.assert_array_equal(tc[jv], jc[jv])
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tcodec.revcomp_code(jc, k), jcodec.revcomp_code(jc, k))
        np.testing.assert_array_equal(tcodec.canonical_code(jc, k),
                                      jcodec.canonical_code(jc, k))
        assert tcodec.decode_kmers(jc, k) == jcodec.decode_kmers(jc, k)
        assert [tcodec.revcomp(s) for s in kmers] == [jcodec.revcomp(s) for s in kmers]

    def test_hamming_distance(self):
        pairs = [("ACGT", "ACGA"), ("ANGT", "ACGA"), ("", ""), ("ACGTT", "ACG")]
        assert [tcodec.hamming_distance(*p) for p in pairs] == \
            [jcodec.hamming_distance(*p) for p in pairs]


class TestReads:
    @pytest.mark.parametrize("chunk", [64, 256, 1000, 1 << 22])
    def test_blob_chunks(self, random_reads, chunk):
        blob = jreads.ReadsStore.from_sequences(random_reads).blob
        a = list(treads.blob_chunks(blob, 13, chunk))
        b = list(jreads.blob_chunks(blob, 13, chunk))
        assert [o for _, o in a] == [o for _, o in b]
        for (pa, _), (pb, _) in zip(a, b):
            np.testing.assert_array_equal(pa, pb)

    @pytest.mark.parametrize("chunk", [64, 256, 1 << 22])
    def test_stream_blob_chunks(self, random_reads, chunk):
        pieces = [np.frombuffer((r + "\n").encode(), np.uint8) for r in random_reads]
        a = list(treads.stream_blob_chunks(iter(pieces), 13, chunk))
        b = list(jreads.stream_blob_chunks(iter(pieces), 13, chunk))
        assert [o for _, o in a] == [o for _, o in b]
        for (pa, _), (pb, _) in zip(a, b):
            np.testing.assert_array_equal(pa, pb)

    def test_reads_store(self, random_reads, tmp_path):
        a = treads.ReadsStore.from_sequences(random_reads)
        b = jreads.ReadsStore.from_sequences(random_reads)
        for ext, (pa, pb) in zip(("reads", "ridx"), zip(a.save(str(tmp_path / "t")),
                                                       b.save(str(tmp_path / "j")))):
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), ext
        assert a.rid_by_pos(np.arange(0, a.reads_size, 7)).tolist() == \
            b.rid_by_pos(np.arange(0, b.reads_size, 7)).tolist()


class TestFastq:
    CASES = [("fastq", ["test_R1.fastq", "test_R2.fastq"]), ("se", ["test_se.fastq"]),
             ("fasta", ["test.fasta"]), ("reads", ["test_reads.txt"])]

    @pytest.mark.parametrize("read_type,files", CASES, ids=[c[0] for c in CASES])
    def test_compute_reads_files_identical(self, tmp_path, read_type, files):
        paths = [os.path.join(DATA, f) for f in files]
        in1, in2 = (paths[0], paths[1]) if read_type == "fastq" else (paths, None)
        a = tfastq.compute_reads(in1, in2, read_type, str(tmp_path / "t" / "p"))
        b = jfastq.compute_reads(in1, in2, read_type, str(tmp_path / "j" / "p"),
                                 use_native=False)
        assert a["n_reads"] == b["n_reads"] > 0
        for key in ("reads", "ridx", "header"):
            if key in b:
                with open(a[key], "rb") as fa, open(b[key], "rb") as fb:
                    assert fa.read() == fb.read(), key

    def test_native_reader_not_ported(self, tmp_path):
        """The native reader is ported now: use_native=True on the paired
        test FASTQs writes the files of aindex_tpu's native reader."""
        args = (os.path.join(DATA, "test_R1.fastq"), os.path.join(DATA, "test_R2.fastq"),
                "fastq")
        a = tfastq.compute_reads(*args, str(tmp_path / "t" / "p"), use_native=True)
        b = jfastq.compute_reads(*args, str(tmp_path / "j" / "p"), use_native=True)
        assert a["n_reads"] == b["n_reads"] > 0
        for key in ("reads", "ridx"):
            with open(a[key], "rb") as fa, open(b[key], "rb") as fb:
                assert fa.read() == fb.read(), key

    @pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(DATA, "*"))),
                             ids=lambda p: os.path.basename(p))
    def test_iter_sequence_bytes(self, path):
        a = [x.tobytes() for x in tfastq.iter_sequence_bytes(path)]
        assert a == [x.tobytes() for x in jfastq.iter_sequence_bytes(path)]


class TestStats:
    def test_coverage_stats_and_save_values(self, tmp_path):
        rng = np.random.default_rng(2)
        tf = rng.integers(0, 40, size=1 << 14).astype(np.uint32)
        tf[::3] = 0
        a, b = tstats.coverage_stats(tf, 20), jstats.coverage_stats(tf, 20)
        np.testing.assert_array_equal(a.pop("profile"), b.pop("profile"))
        assert a == b
        assert tstats.format_stats({**a, "profile": None}) == \
            jstats.format_stats({**b, "profile": None})
        codes = np.arange(tf.size, dtype=np.uint64)
        pa, pb = str(tmp_path / "a"), str(tmp_path / "b")
        assert tstats.save_values(pa, codes, tf, 13, True, block=1000) == \
            jstats.save_values(pb, codes, tf, 13, True, block=1000)
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read()


class TestRules:
    def test_port_imports_no_jax(self):
        code = ("import pkgutil, importlib, sys, aindex_torch\n"
                "for m in pkgutil.walk_packages(aindex_torch.__path__, 'aindex_torch.'):\n"
                "    importlib.import_module(m.name)\n"
                "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'aindex_tpu')]\n"
                "assert not bad, bad\n"
                "print(len([m for m in sys.modules if m.startswith('aindex_torch')]))\n")
        r = _run(code)
        assert r.returncode == 0, r.stderr
        assert int(r.stdout) >= 12

    def test_cuda_device_raises_without_cuda(self):
        """No quiet CPU run when CUDA was asked for."""
        if torch.cuda.is_available():
            pytest.skip("this host has CUDA")
        from aindex_torch import Dense13Index
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Dense13Index.build_from_sequences(["ACGTACGTACGTACGT"], device="cuda")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Dense13Index.from_numpy(np.zeros(4 ** 13, np.uint32), device="cuda")
        with pytest.raises(ValueError, match="unsupported device"):
            Dense13Index.build_from_sequences(["ACGTACGTACGTACGT"], device="meta")

    def test_kernel_module_needs_no_nvcc_or_gpu(self):
        env = {**os.environ, "PATH": "", "CUDA_VISIBLE_DEVICES": ""}
        code = ("from aindex_torch.kernels import _cuda\n"
                "assert all(k._lib is None and k.launches == 0 for k in _cuda.KERNELS.values())\n"
                "import os\n"
                "try:\n"
                "    _cuda.nvcc_path()\n"
                "except RuntimeError:\n"
                "    print('no nvcc')\n"
                "else:\n"
                "    print('nvcc at', _cuda.nvcc_path())\n"
                "print(sorted(_cuda.KERNELS))\n")
        r = _run(code, env=env)
        assert r.returncode == 0, r.stderr
        assert "count13_packed" in r.stdout
        if not os.path.exists("/usr/local/cuda/bin/nvcc"):
            assert "no nvcc" in r.stdout

    def test_chip_smoke_fails_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("this host has CUDA")
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


class TestChipSmokeOracle:
    """chip_smoke.py's corpus is scripts/make_scale_corpus.py's, and its
    numpy oracle agrees with aindex_tpu's count."""

    def test_corpus_matches_script(self, tmp_path):
        sys.path.insert(0, ROOT)
        try:
            import chip_smoke
        finally:
            sys.path.remove(ROOT)
        ref = tmp_path / "ref.fasta"
        subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "make_scale_corpus.py"),
                        str(ref), "0.05", "3"], check=True, capture_output=True, timeout=300)
        genome, reads = chip_smoke.scale_corpus(0.05, 3)
        mine = tmp_path / "mine.fasta"
        chip_smoke.write_fasta(reads, str(mine))
        assert mine.read_bytes() == ref.read_bytes()
        assert genome.size == chip_smoke.GENOME_BP

    def test_oracle_matches_jax_count(self, random_reads):
        sys.path.insert(0, ROOT)
        try:
            import chip_smoke
        finally:
            sys.path.remove(ROOT)
        from aindex_tpu.index.dense13 import Dense13Index
        reads = [r for r in random_reads if len(r) == 60]
        mat = np.frombuffer("".join(reads).encode(), np.uint8).reshape(len(reads), 60)
        np.testing.assert_array_equal(chip_smoke.oracle_table(mat),
                                      Dense13Index.build_from_sequences(reads).tf_host)
        codes = np.arange(0, 4 ** 13, 4099, dtype=np.uint32)
        np.testing.assert_array_equal(chip_smoke.oracle_rc(codes),
                                      jcodec.revcomp_code(codes.astype(np.uint64), 13))
