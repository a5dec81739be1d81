"""The command line: ``aindex_torch.cli.main`` (with ``--device cpu``)
against ``aindex_tpu.cli.main`` on tests/data/*, each subcommand run by both
in its own directory, their artifacts compared byte for byte and their
printed reports line for line (the file names and paths they print aside).
One k = 13 run per package (compute-aindex, whose 0.5 GB tables the
directory's removal frees); the sparse runs take k = 23 and k = 31."""

import filecmp
import os
import shutil
import subprocess
import sys

import pytest

from aindex_tpu.cli import main as jmain
from aindex_torch.cli import main as tmain
from test_torch_host import jax_native  # noqa: F401 (a fixture)

#: aindex_tpu's native library loads before anything here builds through it
pytestmark = pytest.mark.usefixtures("jax_native")

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_CMDS = {"count", "count-direct", "compute-index", "compute-aindex",
               "compute-aindex-direct", "info"}


def run_both(tmp_path, monkeypatch, capsys, *argv):
    """Run argv in tmp/t (port) and tmp/j (aindex_tpu); returns the two
    directories and the two printed outputs, the directory names masked."""
    outs = []
    for name, main in (("t", tmain), ("j", jmain)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        monkeypatch.chdir(d)
        args = list(argv) + (["--device", "cpu"] if name == "t" and argv[0] in DEVICE_CMDS
                             else [])
        capsys.readouterr()
        assert main(args) == 0
        outs.append(capsys.readouterr().out.replace(str(d), "<dir>"))
    return tmp_path / "t", tmp_path / "j", outs[0], outs[1]


def same_files(t, j) -> list[str]:
    names = sorted(os.listdir(j))
    assert sorted(os.listdir(t)) == names
    for name in names:
        assert filecmp.cmp(t / name, j / name, shallow=False), name
    return names


@pytest.mark.parametrize("k", [23, 31])
@pytest.mark.parametrize("inputs", [["test.fasta"], ["test_R1.fastq", "test_R2.fastq"]],
                         ids=["fasta", "paired"])
def test_compute_aindex(tmp_path, monkeypatch, capsys, k, inputs):
    t, j, out_t, out_j = run_both(tmp_path, monkeypatch, capsys, "compute-aindex", "-i",
                                  ",".join(f"{DATA}/{p}" for p in inputs), "-o", "x",
                                  "-k", str(k), "--keep-dat")
    names = same_files(t, j)
    assert {"x.pf", "x.tf.bin", "x.kmers.bin", "x.index.bin", "x.indices.bin",
            "x.reads", "x.dat"} <= set(names)
    assert out_t == out_j


def test_compute_aindex_13_and_info(tmp_path, monkeypatch, capsys):
    """The one k = 13 run of each package, then ``info`` on its prefix."""
    try:
        t, j, out_t, out_j = run_both(tmp_path, monkeypatch, capsys,
                                      "compute-aindex-direct", "-i", f"{DATA}/test.fasta",
                                      "-o", "x")
        same_files(t, j)
        assert out_t == out_j
        _, _, out_t, out_j = run_both(tmp_path, monkeypatch, capsys, "info", "-p", "x",
                                      "--stats", "--reads", "--coverage", "3")
        assert out_t == out_j and "13-mer dense index" in out_t
    finally:
        shutil.rmtree(tmp_path / "t", ignore_errors=True)
        shutil.rmtree(tmp_path / "j", ignore_errors=True)


@pytest.mark.parametrize("k", [23, 31])
def test_count_build_hash_compute_index(tmp_path, monkeypatch, capsys, k):
    """count -> .dat, build-hash over its k-mers, compute-index from it."""
    t, j, out_t, out_j = run_both(tmp_path, monkeypatch, capsys, "count", "-i",
                                  f"{DATA}/test.fasta,{DATA}/test_se.fastq", "-k", str(k),
                                  "-o", "c", "--min-count", "2")
    assert out_t == out_j
    for d in (t, j):
        with open(d / "c.dat") as f, open(d / "c.kmers", "w") as out:
            out.writelines(line.split("\t")[0] + "\n" for line in f)
    _, _, out_t, out_j = run_both(tmp_path, monkeypatch, capsys, "build-hash", "-i", "c.kmers",
                                  "-k", str(k), "-o", "h")
    assert out_t == out_j
    _, _, out_t, out_j = run_both(tmp_path, monkeypatch, capsys, "compute-index", "-d",
                                  "c.dat", "-o", "ix")
    assert out_t == out_j
    same_files(t, j)


@pytest.mark.parametrize("argv", [
    ["compute-reads", "-i", f"{DATA}/test_R1.fastq,{DATA}/test_R2.fastq", "-o", "r"],
    ["compute-reads", "-i", f"{DATA}/test_se.fastq", "-o", "r"],
    ["generate", "-o", "all13.bin", "--binary"],
    ["analyze", "-i", f"{DATA}/test.fasta", "-k", "15", "-o", "an.txt"],
    ["analyze", "-i", f"{DATA}/test_reads.txt", "-k", "23", "-o", "an.txt", "--min-count", "2"],
    ["version"], ["api-docs"],
], ids=["compute-reads-paired", "compute-reads-se", "generate", "analyze-15", "analyze-23",
        "version", "api-docs"])
def test_host_subcommands(tmp_path, monkeypatch, capsys, argv):
    t, j, out_t, out_j = run_both(tmp_path, monkeypatch, capsys, *argv)
    same_files(t, j)
    if argv[0] == "api-docs":  # the same methods; their docstrings are the port's own
        names = [[line.split(":")[0] for line in out.splitlines() if line.startswith("  ")]
                 for out in (out_t, out_j)]
        assert names[0] == names[1] and "  get_tf_value" in names[0]
    else:
        assert out_t == out_j


def test_reads_to_fasta(tmp_path, monkeypatch, capsys):
    run_both(tmp_path, monkeypatch, capsys, "compute-reads", "-i", f"{DATA}/test_se.fastq",
             "-o", "se")
    t, j, out_t, out_j = run_both(tmp_path, monkeypatch, capsys, "reads-to-fasta", "-i",
                                  "se.reads", "-o", "se.fasta")
    same_files(t, j)
    assert out_t == out_j


def test_platform_and_errors(tmp_path, monkeypatch, capsys):
    assert tmain(["platform"]) == 0
    assert "torch" in capsys.readouterr().out
    assert tmain([]) == 1
    monkeypatch.chdir(tmp_path)
    # outside a torchrun job --distributed and --devices build on a world of
    # one rank, byte for byte as the single-device build
    for out, extra in (("w", []), ("x", ["--distributed"]), ("y", ["--devices", "2"])):
        assert tmain(["compute-aindex", "-i", f"{DATA}/test.fasta", "-o", out, "--device",
                      "cpu", *extra]) == 0
    for sfx in (".reads", ".pf", ".tf.bin", ".kmers.bin", ".index.bin", ".indices.bin"):
        for out in ("x", "y"):
            assert filecmp.cmp(f"w{sfx}", f"{out}{sfx}", shallow=False), (out, sfx)
    with pytest.raises(SystemExit):
        tmain(["compute-aindex", "-i", f"{DATA}/test.fasta", "-o", "z", "--devices", "two"])


def test_python_m_runs_without_jax(tmp_path):
    """``python -m aindex_torch`` with jax and aindex_tpu unimportable."""
    code = ("import runpy, sys\n"
            "for name in ('jax', 'jaxlib', 'aindex_tpu'):\n"
            "    sys.modules[name] = None\n"
            f"sys.argv = ['aindex_torch', 'compute-aindex', '-i', {DATA + '/test.fasta'!r},\n"
            "            '-o', 'x', '-k', '31', '--device', 'cpu']\n"
            "runpy.run_module('aindex_torch', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=600, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert "pipeline complete" in proc.stdout
    assert os.path.getsize(tmp_path / "x.index.bin") > 0
