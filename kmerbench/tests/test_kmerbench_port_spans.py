"""The port's own spans (``aindex.*`` ranges of ``aindex_torch.trace``) inside
the harness's window leave the trace's reduction and every reading as they
were: the breakdown names gaps by the harness's ranges alone."""

import pytest

from kmerbench import trace
from kmerbench.spec import Spec
from kmerbench.tests.helpers import run_tiny, tiny_bench
from kmerbench.tests.test_kmerbench_roofline import Ev, fake_events

S = 1_000_000_000


def port_spans():
    """The port's ranges of one call in ``submit`` ([0, 1) s), mirrored on
    the device as the profiler mirrors a range, and one range outside the
    harness's ranges."""
    return [
        Ev("aindex.facade.get_total_tf_values_codes_13mer", "CPU", S // 10, 9 * S // 10, True),
        Ev("aindex.index.query", "CPU", 2 * S // 10, 8 * S // 10, True),
        Ev("aindex.index.codes_in", "CPU", 3 * S // 10, 4 * S // 10, True),
        Ev("aindex.kernel.gather13", "CPU", 5 * S // 10, 7 * S // 10, True),
        Ev("aindex.kernel.gather13", "CUDA", 5 * S // 10, 7 * S // 10, True),
        Ev("aindex.index.upload", "CPU", 5 * S, 6 * S, True),
    ]


def test_port_spans_leave_the_summary():
    bare = trace.summarize(fake_events())
    spanned = trace.summarize(fake_events() + port_spans())
    assert spanned == bare
    assert spanned.breakdown() == bare.breakdown()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_bench(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("workload, stages", [
    ("ecoli-k13-dense.zipf", {"reads", "count"}),
    ("ecoli-k23-sparse.reads", {"reads", "spectrum", "merge", "mphf", "quot"}),
])
def test_traced_run_counts_the_build(tiny, workload, stages):
    from aindex_torch import trace as port

    before = port.counters()
    r = run_tiny(tiny, workload, trace=True)
    after = port.counters()
    assert r["correct"] is True
    # the readings a traced CPU run gives (no device clock or allocator here)
    device_only = {"gather13_roofline", "device_idle_pct"}
    assert set(r["metrics"]) == {m["name"] for m in Spec(tiny).metrics(workload, True)} \
        - device_only
    grew = {name for name in after if after[name] != before.get(name, 0)}
    assert {f"seconds.aindex.build.{s}" for s in stages} <= grew
    assert not any(name.startswith("h2d.") for name in grew)      # nothing crosses on the CPU
