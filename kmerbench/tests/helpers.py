"""A small benchmark root for the CPU tests: ``BENCHMARK.json`` and a copy
of ``kmerbench/`` in a temporary directory, the configurations cut to a
20 kbp genome at 4x and the mixes to 4,096 codes a call."""

from __future__ import annotations

import json
import os
import shutil
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY_CONFIG = {"genome_bp": 20000, "coverage": 4}
TINY_MIX = {"codes_per_call": 4096, "pool_batches": 2}


def copy_bench(dest: str) -> str:
    """``BENCHMARK.json`` and ``kmerbench/`` (without its tests) under ``dest``."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "kmerbench"), os.path.join(dest, "kmerbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return dest


def tiny_bench(dest: str) -> str:
    """``copy_bench`` with every configuration and mix cut to a CPU's size."""
    copy_bench(dest)
    for sub, cut in (("configs", TINY_CONFIG), ("mixes", TINY_MIX)):
        d = os.path.join(dest, "kmerbench", sub)
        for name in sorted(n for n in os.listdir(d) if n.endswith(".json")):
            with open(os.path.join(d, name)) as f:
                data = json.load(f)
            data.update(cut)
            with open(os.path.join(d, name), "w") as f:
                json.dump(data, f)
    return dest


def run_tiny(root: str, workload: str, seed: int = 5, trace: bool = False, system="port",
             seconds: float = 0.3) -> dict:
    from kmerbench.harness import run_cell

    return run_cell(root, workload, seed, seconds, trace, "cpu", time.perf_counter(),
                    system=system, strict=False)
