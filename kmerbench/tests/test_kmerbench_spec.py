"""BENCHMARK.json against the benchmark's contract, and the files it names
found by name, new ones included."""

import hashlib
import json
import os
import re

import pytest

from kmerbench.spec import Spec
from kmerbench.tests.helpers import ROOT, run_tiny, tiny_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion)")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_contract_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) for p in b["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in b["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        assert len(c["reduced"]) <= 16 and not any(WIDTH.search(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    cells = b["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({c["name"] for c in cells}) == len(cells)
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    for c in cells:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(c["name"]) and NAME.match(c["traffic"]) and line(c["why"])
        assert c["config"] in names and c["chips"] in (1, 4)
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)
    assert set(names) == {c["config"] for c in cells}
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= {c["name"] for c in cells}


def test_contract_metrics():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    for m in e2e.values():
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert 1 <= len(b["per_layer"]) <= 128
    layers = {}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    spec = Spec(ROOT)
    for c in b["workloads"]:
        reported = {m["name"] for m in spec.metrics(c["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        per_layer = spec.metrics(c["name"], True)
        assert per_layer and all(m["moves"] in reported for m in per_layer)


def test_every_named_file_is_found():
    b = bench()
    spec = Spec(ROOT)
    for c in b["workloads"]:
        config = spec.config(c["config"])
        spec.mix(c["traffic"])
        code = spec.mix_code(c["traffic"])
        assert code is None or callable(code.make_pool)
        assert spec.roofline(config["kernel"]).PATTERN
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(spec.reader(m["name"]).read)


def _digest(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "kmerbench")):
        for name in files:
            if "__pycache__" not in d:
                with open(os.path.join(d, name), "rb") as f:
                    out[os.path.relpath(os.path.join(d, name), root)] = \
                        hashlib.sha256(f.read()).hexdigest()
    return out


def test_new_config_mix_and_metric_as_files_only(tmp_path):
    """A configuration, a mix and a metric added as new files and entries
    run, and no file that was there changes."""
    root = tiny_bench(str(tmp_path))
    before = _digest(root)
    kb = os.path.join(root, "kmerbench")
    with open(os.path.join(kb, "configs", "ecoli-k23-sparse.json")) as f:
        config = json.load(f)
    config.update(name="tiny-k21-sparse", k=21)
    with open(os.path.join(kb, "configs", "tiny-k21-sparse.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(kb, "mixes", "reads.json")) as f:
        mix = json.load(f)
    mix.update(strand="either", pool_batches=3)
    with open(os.path.join(kb, "mixes", "reads-either.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(kb, "metrics", "calls_per_s.py"), "w") as f:
        f.write("def read(run):\n    return run.calls / run.window_s if run.window_s else None\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "tiny-k21-sparse", "source": "a test", "why": "a test",
                         "file": "kmerbench/configs/tiny-k21-sparse.json", "reduced": []})
    b["workloads"].append({"name": "tiny-k21-sparse.reads-either", "config": "tiny-k21-sparse",
                           "traffic": "reads-either", "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["tiny-k21-sparse.reads-either"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    result = run_tiny(root, "tiny-k21-sparse.reads-either")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"calls_per_s", "setup_s"}
    assert result["metrics"]["calls_per_s"]["value"] > 0
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"kmerbench/configs/tiny-k21-sparse.json",
                                        "kmerbench/mixes/reads-either.json",
                                        "kmerbench/metrics/calls_per_s.py"}


def test_unknown_names_raise(tmp_path):
    spec = Spec(ROOT)
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
    with pytest.raises(KeyError):
        spec.config("no-such-config")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")


GENOME_FWD = '''"""Every forward window of the genome in order, asked through the
forward-strand entry and held to forward counts."""

import torch

from kmerbench.reference.kmers import Spectrum, read_keys, window_codes


def make_pool(mix, corpus, config, seed, device):
    codes = window_codes(corpus.genome[None, :], int(config["k"])).reshape(-1)
    n = int(mix["codes_per_call"])
    return [codes[b * n:(b + 1) * n].to(torch.int32).contiguous()
            for b in range(int(mix["pool_batches"]))]


def call(system, batch):
    return system.index.get_tf_values_codes_13mer(batch)


class Forward:
    def __init__(self, reads, k):
        self.spectrum = Spectrum(read_keys(reads, k, "total"))

    def answers(self, batch):
        return self.spectrum.lookup(batch.to(torch.int64))


def reference(reads, config):
    return Forward(reads, int(config["k"]))
'''


def test_new_mix_as_a_module(tmp_path):
    """A mix with a source, a facade entry and a reference of its own,
    added as a module and its parameters, runs with no file edited; a
    fault in its entry is caught by its own reference."""
    root = tiny_bench(str(tmp_path))
    before = _digest(root)
    mixes = os.path.join(root, "kmerbench", "mixes")
    with open(os.path.join(mixes, "genome-fwd.json"), "w") as f:
        json.dump({"why": "a test", "codes_per_call": 4000, "pool_batches": 3,
                   "in_flight": 2}, f)
    with open(os.path.join(mixes, "genome-fwd.py"), "w") as f:
        f.write(GENOME_FWD)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["workloads"].append({"name": "ecoli-k13-dense.genome-fwd", "config": "ecoli-k13-dense",
                           "traffic": "genome-fwd", "chips": 1, "why": "a test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    result = run_tiny(root, "ecoli-k13-dense.genome-fwd")
    assert result["correct"] is True and result["attempted"] > 0
    # the same calls through the total entry differ from the forward counts
    with open(os.path.join(mixes, "genome-total.json"), "w") as f:
        json.dump({"why": "a test", "codes_per_call": 4000, "pool_batches": 3,
                   "in_flight": 2}, f)
    with open(os.path.join(mixes, "genome-total.py"), "w") as f:
        f.write(GENOME_FWD.replace("get_tf_values_codes_13mer", "get_total_tf_values_codes_13mer"))
    b["workloads"].append({"name": "ecoli-k13-dense.genome-total", "config": "ecoli-k13-dense",
                           "traffic": "genome-total", "chips": 1, "why": "a test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    assert run_tiny(root, "ecoli-k13-dense.genome-total")["correct"] is False
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_foreign_keys_are_mostly_absent(tmp_path):
    """The foreign mix's keys: about its foreign share absent from the reads,
    the same for the same seed."""
    import torch

    from kmerbench.corpus import make_corpus
    from kmerbench.traffic import hooks

    root = tiny_bench(str(tmp_path))
    spec = Spec(root)
    config = spec.config("ecoli-k23-sparse")
    mix = dict(spec.mix("foreign"), codes_per_call=128 * 2000)   # 2,000 reads a batch
    traffic = hooks(spec.mix_code("foreign"))
    corpus = make_corpus(config, 2 ** 33 + 7, torch.device("cpu"))
    pool = traffic.make_pool(mix, corpus, config, 2 ** 33 + 7, "cpu")
    again = traffic.make_pool(mix, corpus, config, 2 ** 33 + 7, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(pool, again))
    answers = traffic.reference(corpus.reads, config).answers(pool[0])
    absent = float((answers == 0).double().mean())
    assert abs(absent - mix["foreign_share"]) < 0.03, absent
