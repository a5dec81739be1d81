"""The port's examples (examples/torch_*.py, torch_pipeline_cli.sh) on the
CPU against aindex_tpu's (examples/*.py, pipeline_cli.sh): each Python
example runs once per package (the port's with ``device="cpu"``), prints
what tests/test_examples.py asserts, and prints the same value lines for
the same seed, apart from the lines named below as different by design;
the two CLI examples write byte-identical artifacts."""

import ast
import contextlib
import importlib.util
import io
import os
import subprocess
import sys

import pytest
import torch

from test_torch_host import jax_native  # noqa: F401 (a fixture)

#: aindex_tpu's native library loads before anything here builds through it
pytestmark = pytest.mark.usefixtures("jax_native")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
NAMES = ["basic_usage", "comprehensive_demo", "device_and_sharded_queries"]

#: what tests/test_examples.py asserts of aindex_tpu's examples, and the
#: port's sharded line (a world of one rank where aindex_tpu's conftest
#: gives JAX 8 host devices)
MUST_PRINT = {
    "basic_usage": ["tf("],
    "comprehensive_demo": ["All API families exercised.",
                           "reloaded index answers identically: True"],
    "device_and_sharded_queries": ["codes-in tf: device array", "coverage profile:",
                                   "sharded over 1 rank"],
}

#: lines that differ by design, by prefix: two section titles that name
#: aindex_tpu's host/device routing and the TPU (the port has one device
#: engine and no routing), the codes-in result's dtype text (torch's), and
#: the sharded line (1 rank against 8 JAX host devices; per_device_bytes
#: counts the port's node records)
BY_DESIGN = ("=== batched tf queries", "=== codes-in device queries",
             "codes-in tf: device array", "sharded over ")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(main, *args) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(*args)
    return buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def printed(jax_native):
    """{example: (aindex_tpu's lines, the port's lines)}, each run once."""
    out = {}
    for name in NAMES:
        jmod = _load(os.path.join(EXAMPLES, f"{name}.py"), f"jax_example_{name}")
        tmod = _load(os.path.join(EXAMPLES, f"torch_{name}.py"), f"torch_example_{name}")
        out[name] = (_printed(jmod.main), _printed(tmod.main, "cpu"))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_prints_what_test_examples_asserts(printed, name):
    text = "\n".join(printed[name][1])
    for s in MUST_PRINT[name]:
        assert s in text


@pytest.mark.parametrize("name", NAMES)
def test_value_lines_equal(printed, name):
    jax_lines, torch_lines = printed[name]
    assert len(torch_lines) == len(jax_lines)
    for j, t in zip(jax_lines, torch_lines):
        if j.startswith(BY_DESIGN):
            assert t.startswith(BY_DESIGN), (j, t)
        else:
            assert t == j


def test_by_design_lines(printed):
    """The lines named as different differ only where named."""
    jax_lines, torch_lines = printed["device_and_sharded_queries"]
    (jdt,) = [ln for ln in jax_lines if ln.startswith("codes-in tf: device array")]
    (tdt,) = [ln for ln in torch_lines if ln.startswith("codes-in tf: device array")]
    assert tdt == jdt.replace(" uint32,", " torch.uint32,")
    (shard,) = [ln for ln in torch_lines if ln.startswith("sharded over ")]
    assert shard.startswith("sharded over 1 rank(s): ")
    assert shard.endswith(" bytes/device, tf/De Bruijn/coverage all served sharded")
    titles = [ln for ln in torch_lines if ln.startswith("=== ")]
    assert not any("TPU" in ln or "adaptive" in ln for ln in titles)


@pytest.mark.parametrize("name", NAMES)
def test_raises_without_a_card(name, monkeypatch):
    """The default device is the card; with none, main() raises and never
    runs on the CPU instead."""
    tmod = _load(os.path.join(EXAMPLES, f"torch_{name}.py"), f"torch_example_{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmod.main()


@pytest.mark.parametrize("name", [f"torch_{n}.py" for n in NAMES])
def test_imports_the_port_only(name):
    with open(os.path.join(EXAMPLES, name)) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert "aindex_torch" in roots
    assert not roots & {"jax", "jaxlib", "aindex_tpu"}


def test_pipeline_cli(tmp_path):
    """Both CLI examples exit 0 and write byte-identical artifacts; their
    printed lines are equal but for the prefix."""
    env = dict(os.environ, DEVICE="cpu", JAX_PLATFORMS="cpu", PYTHON=sys.executable,
               PYTHONPATH=os.pathsep.join([ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                                                    if p]))
    runs = {}
    for tag, script in (("jax", "pipeline_cli.sh"), ("torch", "torch_pipeline_cli.sh")):
        prefix = str(tmp_path / tag / "p23")
        proc = subprocess.run(["sh", os.path.join(EXAMPLES, script), prefix], cwd=ROOT,
                              env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        runs[tag] = (prefix, proc.stdout.replace(prefix, "PREFIX"))
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "torch"))
    assert {".reads", ".ridx", ".tf.bin", ".pf", ".kmers.bin", ".index.bin", ".indices.bin",
            ".dat"} <= {f[len("p23"):] for f in files}
    for f in files:
        with open(tmp_path / "jax" / f, "rb") as a, open(tmp_path / "torch" / f, "rb") as b:
            assert a.read() == b.read(), f
    assert runs["torch"][1] == runs["jax"][1]
