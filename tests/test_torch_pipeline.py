"""The build pipeline: aindex_torch.pipeline.build.build_all on the CPU
against aindex_tpu.pipeline.build.build_all on tests/data/*, for k = 13 and
k = 23. Every artifact is compared byte for byte; the resume gates, the
external-counter input, progress and the unported options are checked on
the port alone."""

import filecmp
import glob
import io
import logging
import os
import shutil

import numpy as np
import pytest

from aindex_tpu.pipeline import build as jbuild
from aindex_torch.pipeline import build as tbuild
from aindex_torch.pipeline.progress import Progress, make_progress
from test_torch_host import jax_native  # noqa: F401 (a fixture)

#: aindex_tpu's native library loads before anything here builds through it
pytestmark = pytest.mark.usefixtures("jax_native")

DATA = os.path.join(os.path.dirname(__file__), "data")
INPUTS = {
    "fasta": ["test.fasta"],
    "paired": ["test_R1.fastq", "test_R2.fastq"],
    "se": ["test_se.fastq"],
    "reads": ["test_reads.txt"],
}
SPARSE = (".pf", ".kmers.bin", ".dat")
POSITIONAL = (".index.bin", ".indices.bin")


@pytest.fixture
def out(tmp_path):
    """A scratch directory, emptied after the test: a k = 13 build writes
    two 0.5 GB tables per package."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def reads(random_reads):
    return [r for r in random_reads if "~" not in r]


@pytest.fixture
def fasta(reads, tmp_path):
    p = tmp_path / "in.fa"
    p.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    return str(p)


def _same_files(a: str, b: str, suffixes) -> None:
    for sfx in suffixes:
        assert os.path.exists(b + sfx), sfx
        assert filecmp.cmp(a + sfx, b + sfx, shallow=False), sfx


@pytest.mark.parametrize("k", [13, 23])
@pytest.mark.parametrize("name", list(INPUTS))
def test_build_all_matches_aindex_tpu(out, name, k):
    inputs = [os.path.join(DATA, f) for f in INPUTS[name]]
    t = tbuild.build_all(inputs, tbuild.BuildConfig(prefix=str(out / "t" / "x"), k=k,
                                                    keep_dat=True, device="cpu"))
    j = jbuild.build_all(inputs, jbuild.BuildConfig(prefix=str(out / "j" / "x"), k=k,
                                                    keep_dat=True))
    assert {n: os.path.basename(p) for n, p in t.items()} == \
        {n: os.path.basename(p) for n, p in j.items()}
    made = sorted(os.path.basename(p)[1:] for p in glob.glob(str(out / "j" / "x.*")))
    assert made == sorted(os.path.basename(p)[1:] for p in glob.glob(str(out / "t" / "x.*")))
    want = {".reads", ".ridx", ".tf.bin", *POSITIONAL} | (set(SPARSE) if k != 13 else set())
    assert want <= set(made), made
    _same_files(str(out / "t" / "x"), str(out / "j" / "x"), made)


def test_multi_file_and_external_counter(reads, out):
    """A list of files concatenates into one reads set, and a text spectrum
    from an external counter seeds the same index as the counted build,
    each equal to aindex_tpu's counted build."""
    paths = []
    for i, part in enumerate((reads[:10], reads[10:20], reads[20:])):
        p = out / f"part{i}.fa"
        p.write_text("".join(f">r{j}\n{r}\n" for j, r in enumerate(part)))
        paths.append(str(p))
    whole = out / "whole.fa"
    whole.write_text("".join(f">r{j}\n{r}\n" for j, r in enumerate(reads)))
    jbuild.build_all([str(whole)], jbuild.BuildConfig(prefix=str(out / "j.23"), keep_dat=True))
    tbuild.build_all(paths, tbuild.BuildConfig(prefix=str(out / "m.23"), device="cpu"))
    tbuild.build_all([str(whole)], tbuild.BuildConfig(
        prefix=str(out / "d.23"), dat_path=str(out / "j.23.dat"), device="cpu"))
    suffixes = (".reads", ".tf.bin", ".pf", ".kmers.bin", *POSITIONAL)
    _same_files(str(out / "m.23"), str(out / "j.23"), suffixes)
    _same_files(str(out / "d.23"), str(out / "j.23"), suffixes[1:])


def test_skip_existing_is_noop(fasta, out, caplog):
    prefix = str(out / "r.23")
    cfg = tbuild.BuildConfig(prefix=prefix, k=23, chunk=2048, skip_existing=True,
                             device="cpu")
    tbuild.build_all([fasta], cfg)
    mtimes = {p: os.path.getmtime(prefix + p)
              for p in (".reads", ".tf.bin", ".pf", ".index.bin")}
    with caplog.at_level(logging.INFO, logger="aindex_torch.pipeline"):
        tbuild.build_all([fasta], cfg)
    assert sum("resumed" in r.message for r in caplog.records) >= 3
    for p, t in mtimes.items():
        assert os.path.getmtime(prefix + p) == t, f"{p} was rewritten"


@pytest.mark.parametrize("k", [13, 23])
def test_stale_positional_rebuilt(fasta, out, k, caplog):
    prefix = str(out / f"s.{k}")
    cfg = tbuild.BuildConfig(prefix=prefix, k=k, chunk=2048, skip_existing=True,
                             device="cpu")
    tbuild.build_all([fasta], cfg)
    good = np.fromfile(prefix + ".index.bin", dtype=np.uint64)
    # truncate the positions artifact: the gate must detect it and rebuild
    good[:10].tofile(prefix + ".index.bin")
    with caplog.at_level(logging.WARNING, logger="aindex_torch.pipeline"):
        tbuild.build_all([fasta], cfg)
    assert any("stale" in r.message for r in caplog.records)
    np.testing.assert_array_equal(np.fromfile(prefix + ".index.bin", dtype=np.uint64), good)


class TestLoadDat:
    def test_merges_like_aindex_tpu(self, out):
        rng = np.random.default_rng(8)
        kmers = ["".join("ACGT"[b] for b in rng.integers(0, 4, 23)) for _ in range(300)]
        p = out / "x.dat"
        p.write_text("".join(f"{km}\t{rng.integers(1, 9)}\n" for km in kmers + kmers[:50])
                     + "\n")
        for got, want in zip(tbuild.load_dat(str(p), 23, block=64),
                             jbuild.load_dat(str(p), 23, block=64)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)

    def test_canonical_merge(self, out):
        from aindex_torch.core import codec
        km = "ACGTACGTACGTACGTACGTACG"
        p = out / "x.dat"
        p.write_text(f"{km}\t3\n{codec.revcomp(km)}\t4\n\n")
        keys, counts = tbuild.load_dat(str(p), 23)
        assert keys.size == 1 and counts[0] == 7

    @pytest.mark.parametrize("text,match", [
        ("ACGTNCGTACGTACGTACGTACG\t1\n", "non-ACGT"),
        ("ACGTACGTACGTACGTACGTACG\n", "count column")])
    def test_rejects(self, out, text, match):
        p = out / "bad.dat"
        p.write_text(text)
        with pytest.raises(ValueError, match=match):
            tbuild.load_dat(str(p), 23)

    def test_empty(self, out):
        p = out / "empty.dat"
        p.write_text("\n")
        keys, counts = tbuild.load_dat(str(p), 23)
        assert keys.size == counts.size == 0 and keys.dtype == np.uint64


class TestProgress:
    def test_renders_and_completes(self):
        class Tty(io.StringIO):
            def isatty(self):
                return True
        t = Tty()
        with Progress(1000, "phase", interval=0.0, stream=t) as p:
            p.step(500)
            p.add(100)
        text = t.getvalue()
        assert "50.0%" in text and "60.0%" in text and "100.0%" in text
        assert text.endswith("\n")

    def test_log_lines_off_a_tty(self, caplog):
        with caplog.at_level(logging.INFO, logger="aindex_torch.progress"):
            with Progress(1000, "phase", interval=0.0, stream=io.StringIO()) as p:
                p.step(250)
        assert any("25.0%" in r.message for r in caplog.records)
        assert make_progress(10, "x", False) is None
        assert isinstance(make_progress(10, "x", True), Progress)

    def test_build_with_progress_and_profile(self, fasta, out):
        prefix = str(out / "p.23")
        cfg = tbuild.BuildConfig(prefix=prefix, k=23, chunk=1024, progress=True,
                                 profile_dir=str(out / "trace"), device="cpu")
        tbuild.build_all([fasta], cfg)
        assert os.path.exists(prefix + ".index.bin")
        assert os.path.getsize(out / "trace" / "build_all.trace.json") > 0


@pytest.mark.parametrize("kw", [{"mesh": "world"}, {"n_devices": 2}])
def test_multi_device_not_ported(fasta, out, kw):
    """Once unported, now the mesh build: on a world of one (``n_devices``
    clamped to it) its artifacts equal the single-device build's."""
    from aindex_torch.parallel import distributed
    from aindex_torch.parallel.mesh import make_mesh
    if kw.get("mesh") == "world":
        distributed.ensure_group(device="cpu")
        kw = {"mesh": make_mesh(1, 1, device_type="cpu")}
    tbuild.build_all([fasta], tbuild.BuildConfig(prefix=str(out / "s"), device="cpu"))
    cfg = tbuild.BuildConfig(prefix=str(out / "x"), device="cpu", **kw)
    tbuild.build_all([fasta], cfg)
    assert cfg.mesh is not None
    _same_files(str(out / "s"), str(out / "x"), (".reads", ".ridx", ".tf.bin") + SPARSE[:2]
                + POSITIONAL)


def test_paired_fastq_requires_two(out):
    fq = out / "a.fq"
    fq.write_text("@r\nACGT\n+\nIIII\n")
    with pytest.raises(ValueError, match="exactly two"):
        tbuild.build_all([str(fq)] * 3, tbuild.BuildConfig(prefix=str(out / "x"), device="cpu"),
                         read_type="fastq")


def test_build_config_positional_fields():
    """aindex_tpu's positional field order binds the same fields of both
    BuildConfigs, lowercase_ok (accepted and unused) in its place."""
    import dataclasses
    jnames = [f.name for f in dataclasses.fields(jbuild.BuildConfig)]
    tnames = [f.name for f in dataclasses.fields(tbuild.BuildConfig)]
    assert tnames[:len(jnames)] == jnames
    args = ("p", 23, 2, False, True, 1 << 20, False, None, None, True, None, None, True)
    j, t = jbuild.BuildConfig(*args), tbuild.BuildConfig(*args)
    for name in jnames:
        assert getattr(t, name) == getattr(j, name), name
    assert tbuild.BuildConfig("p", lowercase_ok=False).lowercase_ok is False
