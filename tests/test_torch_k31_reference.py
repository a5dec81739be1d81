"""The sparse canonical index at k = 31, which the MPHF walk (K11) serves,
held to the benchmark's plain reference (``kmerbench/reference/kmers.py``)
through the facade's codes-in entry; the benchmark's cell
``ecoli-k31-mphf.reads`` run whole at a tiny size, its planted faults and
control; K11's roofline count; and the walk's tables built once an index
(the timed span ``aindex.build.walk``), with nothing copied again on later
queries. On the CPU the kernels' plain versions answer."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aindex_torch import AIndex, trace
from kmerbench import trace as bench_trace
from kmerbench.corpus import make_corpus
from kmerbench.reference.kmers import ExactCounts, canonical, revcomp, window_codes
from kmerbench.spec import Spec
from kmerbench.tests.helpers import ROOT, run_tiny, tiny_bench
from kmerbench.tests.test_kmerbench_run import Altered, Unchanged
from kmerbench.traffic import BatchStats
from test_torch_trace import counts  # noqa: F401  (the counters zeroed for a test)

K = 31
CELL = "ecoli-k31-mphf.reads"
#: a genome of a few kbp, read at 8x in 150 bp reads with 0.3% substitutions
SMALL = {"genome_bp": 4000, "coverage": 8, "read_len": 150, "error_rate": 0.003}
SEEDS = [7, 2 ** 31 + 5, 3 * 2 ** 33 + 1]


@pytest.fixture(scope="module", params=SEEDS)
def built(request):
    """(facade index on the CPU, reads, second genome, reference) of a seed."""
    corpus = make_corpus(SMALL, request.param, torch.device("cpu"))
    other = make_corpus(SMALL, request.param, torch.device("cpu"), stream=1)
    idx = AIndex.build_from_sequences(corpus.sequences(), K, build_aindex=False, device="cpu")
    return idx, corpus.reads, other.genome, ExactCounts(corpus.reads, K, "canonical")


def _windows(reads):
    return window_codes(reads, K).reshape(-1)


def _answers(idx, codes):
    out = idx.get_tf_values_codes_23mer(codes)
    assert out.dtype == torch.uint32 and out.shape == codes.shape
    return out.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


class TestReference:
    def test_engine_is_the_walk(self, built):
        idx = built[0]
        assert idx.sparse23.k == K and idx.sparse23.engine == "walk"
        assert idx.sparse23.quot is None and idx.sparse23.cuckoo is None

    def test_every_window_of_the_reads(self, built):
        idx, reads, _, ref = built
        codes = _windows(reads)
        got = _answers(idx, codes)
        assert torch.equal(got, ref.answers(codes))
        assert bool((got > 0).all())
        # every distinct canonical key of the reads is held, with its count
        assert idx.sparse23.n == len(ref.spectrum)

    def test_reverse_complements_answer_alike(self, built):
        idx, reads, _, ref = built
        codes = _windows(reads)
        rc = revcomp(codes, K)
        assert torch.equal(_answers(idx, rc), _answers(idx, codes))
        assert torch.equal(_answers(idx, canonical(codes, K)), ref.answers(codes))

    @pytest.mark.parametrize("draw", ["second_genome", "second_genome_rc", "random_62_bit"])
    def test_absent_kmers_answer_zero(self, built, draw):
        idx, _, genome, ref = built
        if draw == "random_62_bit":
            g = torch.Generator().manual_seed(K)
            codes = torch.randint(0, 1 << 62, (20000,), generator=g, dtype=torch.int64)
        else:
            codes = _windows(genome[None, :])
            if draw == "second_genome_rc":
                codes = revcomp(codes, K)
        want = ref.answers(codes)
        assert int((want == 0).sum()) >= 0.99 * codes.numel()
        assert torch.equal(_answers(idx, codes), want)


# -- the benchmark's cell, whole, at a tiny size on the CPU ------------------------------

FAULTS = {"Unchanged": Unchanged, "Altered": Altered, "control": "control"}
#: (system, seed, traced) of every tiny run the tests below read
RUNS = ([("port", seed, False) for seed in (2 ** 31 + 5, 2 ** 33 + 17)]
        + [("port", 5, True)]
        + [(fault, seed, False) for fault in FAULTS for seed in (5, 2 ** 32 + 3)])


def run_all(root: str) -> dict:
    """Every run of ``RUNS`` in the benchmark root ``root``, keyed by
    ``system/seed/traced``; a traced run also gives the names of the port's
    counters that grew. A run refuses a process that holds JAX, which this
    suite imports, so the tests call this in a process of its own."""
    out = {}
    for system, seed, traced in RUNS:
        before = trace.counters()
        r = run_tiny(root, CELL, seed=seed, trace=traced,
                     system=FAULTS.get(system, system))
        after = trace.counters()
        r["grew"] = sorted(n for n in after if after[n] != before.get(n, 0))
        out[f"{system}/{seed}/{traced}"] = r
    return out


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    root = tiny_bench(str(tmp_path_factory.mktemp("tiny")))
    code = ("import json, sys; sys.path[:0] = [%r, %r]\n"
            "import test_torch_k31_reference as t\n"
            "print(json.dumps(t.run_all(%r)))" % (ROOT, os.path.dirname(__file__), root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    return root, json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 2 ** 33 + 17])
def test_cell_runs_correct(tiny_runs, seed):
    root, runs = tiny_runs
    r = runs[f"port/{seed}/False"]
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"] == {"mismatches": {"value": 0, "limit": 0}}
    # the cell's end-to-end metrics but index_gib: no allocator on the CPU
    want = {m["name"] for m in Spec(root).metrics(CELL, False)} - {"index_gib"}
    assert set(r["metrics"]) == want == {"query_rate", "setup_s"}


def test_traced_cell_counts_the_walk(tiny_runs):
    root, runs = tiny_runs
    r = runs["port/5/True"]
    assert r["correct"] is True
    device_only = {"device_idle_pct", "mphfwalk_roofline"}
    assert set(r["metrics"]) == {m["name"] for m in Spec(root).metrics(CELL, True)} \
        - device_only == {"build_s", "call_host_us"}
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    grew = set(r["grew"])
    assert {f"seconds.aindex.build.{s}" for s in ("spectrum", "merge", "mphf", "walk")} <= grew
    assert "seconds.aindex.build.quot" not in grew
    assert not any(name.startswith("h2d.") for name in grew)      # nothing crosses on the CPU


@pytest.mark.parametrize("seed", [5, 2 ** 32 + 3])
@pytest.mark.parametrize("system", list(FAULTS))
def test_faults_are_not_correct(tiny_runs, system, seed):
    r = tiny_runs[1][f"{system}/{seed}/False"]
    assert r["correct"] is False and r["checks"]["mismatches"]["value"] > 0
    if system == "control":
        assert r["checks"]["mismatches"]["value"] > r["attempted"] > 0


# -- K11's roofline count and the cell's metrics -----------------------------------------

#: K11's name as the profiler gives it, and others it must not match
K11 = ("void probe::query_kernel<probe::Mphf, 1, false, false, false, false>(probe::Mphf, "
       "long long const*, unsigned char const*, unsigned char const*, int, long long, "
       "unsigned int*, int*, int*)")
NOT_K11 = (
    "void probe::query_kernel<probe::Buckets, 1, false, false, false, false>(probe::Buckets, "
    "long long const*, unsigned char const*, unsigned char const*, int, long long, "
    "unsigned int*, int*, int*)",
    "void (anonymous namespace)::gather13_kernel<unsigned char, false, false, false, true>"
    "(unsigned char const*, int const*, unsigned char const*, long long, unsigned int*)",
    "void probe::coverage_kernel<probe::Mphf, 1>(probe::Mphf, int const*)",
    "void probe::query_kernel<probe::MphfOther, 1>(int)",
    "Memset (Device)",
)


def test_mphfwalk_call_bytes_by_hand():
    count = Spec(ROOT).roofline("mphfwalk")
    assert count.ENTRY_BYTES == 12
    # 10 int64 codes read, 10 uint32 answers written, 3 keys of 8 + 4 bytes
    assert count.call_bytes(BatchStats(n=10, code_bytes=8, distinct=3)) == 80 + 40 + 36
    big = BatchStats(n=2 ** 24, code_bytes=8, distinct=6_000_000)
    assert count.call_bytes(big) == 2 ** 24 * (8 + 4) + 6_000_000 * 12


def test_mphfwalk_pattern_matches_k11_only():
    pattern = Spec(ROOT).roofline("mphfwalk").PATTERN
    assert re.search(pattern, bench_trace.short_name(K11))
    for name in NOT_K11:
        assert not re.search(pattern, bench_trace.short_name(name)), name


@pytest.mark.parametrize("traced, want", [
    (False, {"query_rate", "index_gib", "setup_s"}),
    (True, {"build_s", "call_host_us", "device_idle_pct", "mphfwalk_roofline"}),
])
def test_cell_metrics(traced, want):
    spec = Spec(ROOT)
    assert {m["name"] for m in spec.metrics(CELL, traced)} == want
    cell = spec.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("ecoli-k31-mphf", "reads", 1)
    config = spec.config("ecoli-k31-mphf")
    assert (config["k"], config["rule"], config["kernel"], config["entry"]) == \
        (K, "canonical", "mphfwalk", "get_tf_values_codes_23mer")


# -- the walk's tables, built once an index ----------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_walk_is_built_once(counts, device):
    """The first query builds the walk in ``aindex.build.walk``; later
    queries copy nothing but their own codes. ``"cuda"`` is left unresolved,
    as the facade's default is."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA card: the unresolved 'cuda' device runs on a card only")
    corpus = make_corpus(SMALL, 11, torch.device("cpu"))
    idx = AIndex.build_from_sequences(corpus.sequences(), K, build_aindex=False, device=device)
    codes = _windows(corpus.reads)[:5000].contiguous()      # on the host
    ref = ExactCounts(corpus.reads, K, "canonical").answers(codes)
    copied = codes.numel() * codes.element_size() if device == "cuda" else 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = []
        marks = []
        for _ in range(3):
            trace.reset("h2d.")
            got.append(_answers(idx, codes).cpu())
            marks.append(trace.counters())
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if str(e.device_type()).endswith("CPU")]
    assert names.count("aindex.build.walk") == 1
    assert names.count("aindex.index.query") == 3
    first = marks[0]["seconds.aindex.build.walk"]
    assert first > 0
    for mark in marks[1:]:
        assert mark["seconds.aindex.build.walk"] == first
        assert mark.get("h2d.bytes", 0) == copied
    for out in got:
        assert torch.equal(out, ref)
    assert idx.sparse23.tables is idx.sparse23.tables
