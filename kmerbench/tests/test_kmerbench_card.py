"""Tests that need the card (marker ``card``): the control at each
configuration's own size, on three seeds, has to come out not correct.
Run on the card with ``python3 -m pytest kmerbench/tests -m card -s``; the
readings are printed."""

import time

import pytest

from kmerbench.harness import run_cell
from kmerbench.tests.helpers import ROOT

SEEDS = [2 ** 31 + 101, 2 ** 32 + 202, 3 * 2 ** 31 + 303]


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", ["ecoli-k13-dense.reads", "ecoli-k23-sparse.reads",
                                      "ecoli-k23-sparse.foreign"])
def test_control_fails_at_cell_size(card, workload, seed):
    r = run_cell(ROOT, workload, seed, 2.0, False, card, time.perf_counter(),
                 system="control", strict=False)
    print(f"control {workload} seed {seed}: mismatches {r['checks']['mismatches']['value']} "
          f"of {r['attempted']} calls")
    assert r["correct"] is False
    assert r["checks"]["mismatches"]["value"] > 0
