"""aindex_torch.trace: spans on the profiler's clock, the counter registry,
the host-to-device byte count, and where the port's spans sit (facade ->
index -> codes_in / kernel wrapper; the builds' timed stages). On the CPU:
the kernels' plain versions run under the same spans."""

import ast
import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aindex_torch import AIndex, Sparse23Index, trace
from aindex_torch.kernels import _cuda
from aindex_torch.pipeline import build as tbuild

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def counts():
    """The counters zeroed for the test, and restored after it."""
    saved = trace.counters()
    trace.reset()
    yield
    trace.reset()
    for name, n in saved.items():
        trace.count(name, n)


def _ranges(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of the port's ranges in a CPU trace, by start."""
    out = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
           if e.name().startswith("aindex.") and str(e.device_type()).endswith("CPU")]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _parent(ranges, child) -> str | None:
    """The innermost port range that holds ``child``."""
    _, a, b = child
    holders = [r for r in ranges if r is not child and r[1] <= a and b <= r[2]]
    return min(holders, key=lambda r: r[2] - r[1])[0] if holders else None


def _reads(n: int, length: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, length)]).decode()
            for _ in range(n)]


class TestSpan:
    def test_emits_ranges_under_a_profiler(self):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("aindex.test.outer"):
                with trace.span("aindex.test.inner"):
                    pass
        names = [r[0] for r in _ranges(prof)]
        assert names == ["aindex.test.outer", "aindex.test.inner"]
        ranges = _ranges(prof)
        assert _parent(ranges, ranges[1]) == "aindex.test.outer"

    def test_idle_span_makes_no_range(self, monkeypatch):
        made = []
        monkeypatch.setattr(trace, "_Range", lambda name: made.append(name))
        assert not torch.autograd._profiler_enabled()
        first = trace.span("aindex.test.idle")
        with first as entered:
            assert entered is first
        assert trace.span("aindex.test.other") is first
        assert made == []

    def test_idle_span_passes_exceptions(self):
        with pytest.raises(KeyError):
            with trace.span("aindex.test.idle"):
                raise KeyError("x")

    def test_timed_span_counts_seconds(self, counts):
        with trace.span("aindex.test.stage", timed=True) as t:
            pass
        with trace.span("aindex.test.stage", timed=True) as u:
            pass
        assert t.seconds >= 0 and u.seconds >= 0
        got = trace.counters()["seconds.aindex.test.stage"]
        assert got == pytest.approx(t.seconds + u.seconds)

    def test_timed_span_is_a_range_under_a_profiler(self, counts):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("aindex.test.stage", timed=True):
                pass
        assert [r[0] for r in _ranges(prof)] == ["aindex.test.stage"]
        assert "seconds.aindex.test.stage" in trace.counters()

    def test_only_trace_opens_ranges(self):
        """Every profiler range of the port goes through the span helper."""
        found = []
        for path in glob.glob(os.path.join(REPO, "aindex_torch", "**", "*.py"), recursive=True):
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.ImportFrom):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.Attribute):
                    names = [node.attr]
                if {"record_function", "_RecordFunctionFast"} & set(names):
                    found.append(os.path.relpath(path, REPO))
        assert sorted(set(found)) == ["aindex_torch/trace.py"]

    def test_span_names_share_the_prefix(self):
        """Every span the port opens is named aindex.<layer>.<step>."""
        names = []
        for path in glob.glob(os.path.join(REPO, "aindex_torch", "**", "*.py"), recursive=True):
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span" \
                        or isinstance(node, ast.Call) \
                        and getattr(node.func, "attr", None) == "span":
                    arg = node.args[0]
                    assert isinstance(arg, ast.Constant), (path, ast.dump(arg))
                    names.append(arg.value)
        assert len(names) >= 20
        assert all(n.startswith("aindex.") and n.count(".") >= 2 for n in names), names


class TestCounters:
    def test_count_snapshot_reset(self, counts):
        trace.count("test.a")
        trace.count("test.a", 2)
        trace.count("test.b", 0.5)
        snap = trace.counters()
        assert snap == {"test.a": 3, "test.b": 0.5}
        trace.count("test.a")
        assert snap["test.a"] == 3 and trace.counters()["test.a"] == 4
        trace.reset("test.a")
        assert trace.counters() == {"test.b": 0.5}
        trace.reset()
        assert trace.counters() == {}

    def test_launches_are_a_view(self, counts):
        assert set(_cuda.launches()) == set(_cuda.KERNELS)
        assert all(n == 0 for n in _cuda.launches().values())
        trace.count("launch.gather13", 2)
        trace.count("h2d.copies")
        assert _cuda.launches()["gather13"] == 2
        assert _cuda.KERNELS["gather13"].launches == 2
        assert isinstance(_cuda.launches()["gather13"], int)
        _cuda.reset_launches()
        assert _cuda.launches()["gather13"] == 0
        assert trace.counters() == {"h2d.copies": 1}


class TestHostToDevice:
    def test_counts_a_crossing_copy(self, counts):
        t = torch.arange(10, dtype=torch.int64)
        out = trace.to_device(t, "meta")
        assert out.device.type == "meta" and out.shape == t.shape
        assert trace.counters() == {"h2d.bytes": 80, "h2d.copies": 1}
        trace.to_device(torch.zeros(3, 5, dtype=torch.uint8), torch.device("meta"))
        assert trace.counters() == {"h2d.bytes": 95, "h2d.copies": 2}

    @pytest.mark.parametrize("src, dst", [("cpu", "cpu"), ("meta", "meta")])
    def test_counts_nothing_otherwise(self, counts, src, dst):
        t = torch.zeros(4, dtype=torch.int32, device=src)
        assert trace.to_device(t, dst).device.type == dst
        assert trace.counters() == {}

    def test_same_tensor_on_its_device(self, counts):
        t = torch.zeros(4, dtype=torch.int32)
        assert trace.to_device(t, torch.device("cpu")) is t

    def test_note_h2d(self, counts):
        trace.note_h2d(torch.zeros(7, dtype=torch.int32))
        assert trace.counters() == {"h2d.bytes": 28, "h2d.copies": 1}


@pytest.fixture(scope="module")
def dense():
    return AIndex.build_from_sequences(_reads(30, 80, 1), kmer_size=13, build_aindex=False,
                                       device="cpu")


@pytest.fixture(scope="module")
def sparse():
    return AIndex.build_from_sequences(_reads(30, 80, 2), kmer_size=23, build_aindex=False,
                                       device="cpu")


class TestQueryPath:
    @pytest.mark.parametrize("entry", ["get_tf_values_codes_13mer",
                                       "get_total_tf_values_codes_13mer"])
    def test_dense_nesting(self, dense, counts, entry):
        codes = torch.arange(0, 4 ** 13, 4 ** 9, dtype=torch.int32)
        getattr(dense, entry)(codes)          # the tables, made at first use
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = getattr(dense, entry)(codes)
        assert out.shape == codes.shape
        ranges = _ranges(prof)
        parent = {r[0]: _parent(ranges, r) for r in ranges}
        assert parent == {f"aindex.facade.{entry}": None,
                          "aindex.index.query": f"aindex.facade.{entry}",
                          "aindex.index.codes_in": "aindex.index.query",
                          "aindex.kernel.gather13": "aindex.index.query"}
        assert [r[0] for r in ranges].count("aindex.index.query") == 1
        assert "h2d.bytes" not in trace.counters()

    def test_dense_total_table_is_timed_once(self, counts):
        idx = AIndex.build_from_sequences(_reads(5, 40, 3), kmer_size=13, build_aindex=False,
                                          device="cpu")
        assert set(trace.counters()) >= {"seconds.aindex.build.reads",
                                         "seconds.aindex.build.count"}
        codes = torch.zeros(8, dtype=torch.int32)
        idx.get_total_tf_values_codes_13mer(codes)
        first = trace.counters()["seconds.aindex.index.total"]
        idx.get_total_tf_values_codes_13mer(codes)
        assert trace.counters()["seconds.aindex.index.total"] == first

    def test_sparse_nesting(self, sparse, counts):
        codes = torch.arange(0, 1 << 40, 1 << 30, dtype=torch.int64)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            first = sparse.get_tf_values_codes_23mer(codes)
            again = sparse.get_tf_values_codes_23mer(codes)
        assert torch.equal(first, again)
        ranges = _ranges(prof)
        parent = {r[0]: _parent(ranges, r) for r in ranges}
        assert parent["aindex.index.query"] == "aindex.facade.get_tf_values_codes_23mer"
        assert parent["aindex.index.codes_in"] == "aindex.index.query"
        assert parent["aindex.kernel.query"] == "aindex.index.query"
        # the engine's tables, built and uploaded at the first query only
        assert parent["aindex.build.quot"] == "aindex.index.query"
        assert parent["aindex.index.upload"] == "aindex.index.query"
        names = [r[0] for r in ranges]
        assert names.count("aindex.index.query") == 2
        assert names.count("aindex.index.upload") == 1
        assert names.count("aindex.build.quot") == 1
        assert {"seconds.aindex.build.quot", "seconds.aindex.index.upload"} \
            <= set(trace.counters())

    def test_host_codes_cross_nothing_on_the_cpu(self, sparse, dense, counts):
        sparse.get_tf_values_codes_23mer(np.arange(16, dtype=np.uint64))
        dense.get_tf_values_codes_13mer(list(range(16)), valid=[True] * 16)
        assert not any(n.startswith("h2d.") for n in trace.counters())


class TestBuild:
    def test_sparse_build_seconds_are_the_spans(self, counts):
        idx = Sparse23Index.build_from_sequences(_reads(20, 60, 4), device="cpu")
        stages = {"spectrum", "merge", "mphf"}
        assert set(idx.build_seconds) == stages
        got = trace.counters()
        for stage in stages:
            assert got[f"seconds.aindex.build.{stage}"] == idx.build_seconds[stage]
        assert "seconds.aindex.build.reads" not in got

    def test_build_spans_under_a_profiler(self, counts):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            AIndex.build_from_sequences(_reads(20, 60, 5), kmer_size=23, build_aindex=False,
                                        device="cpu")
        names = [r[0] for r in _ranges(prof)]
        assert names == ["aindex.build.reads", "aindex.build.spectrum", "aindex.build.merge",
                         "aindex.build.mphf"]

    def test_profile_dir_names_the_phases(self, tmp_path):
        fasta = tmp_path / "r.fa"
        fasta.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(_reads(20, 60, 6))))
        cfg = tbuild.BuildConfig(prefix=str(tmp_path / "p.23"), k=23, chunk=1024,
                                 profile_dir=str(tmp_path / "trace"), device="cpu")
        tbuild.build_all([str(fasta)], cfg)
        with open(tmp_path / "trace" / "build_all.trace.json") as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name") for e in events if e.get("ph") == "X"}
        assert {"aindex.build_all.reads", "aindex.build_all.count",
                "aindex.build_all.positional", "aindex.positional.tables",
                "aindex.positional.offsets", "aindex.positional.fill",
                "aindex.positional.copy", "aindex.positional.save"} <= names
        assert not any(n.startswith(("build_all.", "positional.")) for n in names)
