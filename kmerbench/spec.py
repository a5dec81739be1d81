"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: the ``file`` of its ``configs`` entry (JSON);
* a traffic mix: ``kmerbench/mixes/<traffic>.json``, its parameters, which
  ``traffic.py``'s one generator reads; beside it, where the mix needs a
  source, a facade entry or a reference of its own, ``mixes/<traffic>.py``,
  a module whose ``make_pool``, ``call``, ``reference`` and ``batch_stats``
  take the place of the generator's (each one it defines);
* a metric, end-to-end or per-layer: ``kmerbench/metrics/<name>.py``, a
  module with ``read(run) -> float | None``;
* a kernel's roofline count: ``kmerbench/roofline/<kernel>.py``.

A later cell, configuration, mix or metric is new files and new entries
in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = os.path.basename(HERE)

#: keys every configuration file holds, besides its own notes
CONFIG_KEYS = ("k", "rule", "code_dtype", "entry", "kernel", "genome_bp", "coverage",
               "read_len", "error_rate")


def _load_module(path: str, name: str) -> ModuleType:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spec:
    """One benchmark: ``BENCHMARK.json`` under ``root`` and its files."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)
        self.dir = os.path.join(self.root, PACKAGE)
        self._modules: dict[str, ModuleType] = {}

    def cell(self, name: str) -> dict:
        for cell in self.bench["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for entry in self.bench["configs"]:
            if entry["name"] == name:
                with open(os.path.join(self.root, entry["file"])) as f:
                    config = json.load(f)
                missing = [key for key in CONFIG_KEYS if key not in config]
                if missing:
                    raise ValueError(f"configuration {name!r} lacks {missing}")
                return config
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        with open(os.path.join(self.dir, "mixes", f"{name}.json")) as f:
            return json.load(f)

    def mix_code(self, name: str) -> ModuleType | None:
        """The mix's own module, ``mixes/<name>.py``, or None."""
        if not os.path.isfile(os.path.join(self.dir, "mixes", f"{name}.py")):
            return None
        return self._module("mixes", name)

    def _module(self, kind: str, name: str) -> ModuleType:
        key = f"{kind}/{name}"
        if key not in self._modules:
            path = os.path.join(self.dir, kind, f"{name}.py")
            self._modules[key] = _load_module(path, f"{PACKAGE}_{kind}_{name}".replace(".", "_")
                                              .replace("-", "_"))
        return self._modules[key]

    def reader(self, metric: str) -> ModuleType:
        return self._module("metrics", metric)

    def roofline(self, kernel: str) -> ModuleType:
        return self._module("roofline", kernel)

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metric entries that ``cell`` reports: the end-to-end ones
        untraced, the per-layer ones traced; an entry with ``workloads``
        only in the cells it lists, one without it in every cell that
        reports the end-to-end metric it moves."""
        end_to_end = [m for m in self.bench["end_to_end"]
                      if "workloads" not in m or cell in m["workloads"]]
        if not trace:
            return end_to_end
        reported = {m["name"] for m in end_to_end}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]
