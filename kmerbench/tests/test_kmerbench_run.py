"""Whole runs on the CPU at a tiny size: the result line, the faults and
the control that ``correct`` has to catch, and what a run may import."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from kmerbench.harness import FORBIDDEN
from kmerbench.spec import Spec
from kmerbench.system import PortSystem
from kmerbench.tests.helpers import ROOT, copy_bench, run_tiny, tiny_bench

CELLS = ["ecoli-k23-sparse.reads", "ecoli-k13-dense.zipf", "ecoli-k13-dense.reads",
         "ecoli-k23-sparse.foreign"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_bench(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("workload", CELLS)
def test_result_line(tiny, workload):
    r = run_tiny(tiny, workload, seed=2 ** 31 + 5)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    # every end-to-end metric of the cell but index_gib: no allocator on the CPU
    want = {m["name"] for m in Spec(tiny).metrics(workload, False)} - {"index_gib"}
    assert set(r["metrics"]) == want and "setup_s" in want
    assert r["checks"] == {"mismatches": {"value": 0, "limit": 0}}
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    json.dumps(r)


def test_traced_result_line(tiny):
    r = run_tiny(tiny, "ecoli-k13-dense.zipf", trace=True)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"build_s", "call_host_us"}   # no device trace on the CPU
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0


class Unchanged(PortSystem):
    """Returns its first answers on every later call."""

    def call(self, codes):
        if not hasattr(self, "_first"):
            self._first = super().call(codes)
        return self._first


class HalfBatch(PortSystem):
    """Answers half of the batch; the rest get the mean of those answers."""

    def call(self, codes):
        half = codes.numel() // 2
        out = super().call(codes[:half]).to(torch.int64)
        return torch.cat([out, torch.full((codes.numel() - half,), int(out.double().mean()))])


class Altered(PortSystem):
    """Alters one answer of each call where it is produced."""

    def call(self, codes):
        out = super().call(codes).to(torch.int64)
        out[len(out) // 3] += 1
        return out


@pytest.mark.parametrize("fault", [Unchanged, HalfBatch, Altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", ["ecoli-k23-sparse.reads", "ecoli-k13-dense.zipf",
                                      "ecoli-k23-sparse.foreign"])
def test_faults_are_not_correct(tiny, fault, workload):
    r = run_tiny(tiny, workload, system=fault)
    assert r["correct"] is False and r["checks"]["mismatches"]["value"] > 0


@pytest.mark.parametrize("workload", ["ecoli-k23-sparse.reads", "ecoli-k13-dense.reads",
                                      "ecoli-k23-sparse.foreign"])
def test_control_is_not_correct(tiny, workload):
    r = run_tiny(tiny, workload, system="control")
    assert r["correct"] is False
    assert r["checks"]["mismatches"]["value"] > r["attempted"] and r["attempted"] > 0


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    base = os.path.join(ROOT, "kmerbench", sub)
    for d, _, files in os.walk(base):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(d, name)


def test_no_forbidden_imports():
    """No module of the harness imports JAX or the JAX package, and none of
    the reference imports those or the port; names compared whole."""
    for path in _sources():
        assert not _imports(path) & set(FORBIDDEN), path
    for path in _sources("reference"):
        assert not _imports(path) & (set(FORBIDDEN) | {"aindex_torch"}), path
        assert _imports(path) <= {"__future__", "torch", "kmerbench"}, path


def test_a_run_loads_no_forbidden_module(tiny):
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from kmerbench.tests.helpers import run_tiny\n"
            "r = run_tiny(%r, 'ecoli-k23-sparse.reads')\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'aindex_tpu'}), r['correct'])"
            % (ROOT, tiny))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def _cli(root):
    return subprocess.run([sys.executable, "kmerbench/run.py", "--workload",
                           "ecoli-k13-dense.reads", "--seed", str(2 ** 33), "--seconds", "1",
                           "--trace", "0"], cwd=root, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": ""})


def test_cli_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_cli_without_the_program_prints_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files
    the run fails and prints nothing."""
    root = copy_bench(str(tmp_path))
    shutil.rmtree(os.path.join(root, "kmerbench", "tests"), ignore_errors=True)
    out = _cli(root)
    assert out.returncode != 0 and out.stdout.strip() == ""
