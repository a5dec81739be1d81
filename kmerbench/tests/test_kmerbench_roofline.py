"""Roofline counts, the trace's reduction and the kernel-name patterns."""

import re
from types import SimpleNamespace

import pytest

from kmerbench import roofline, trace
from kmerbench.spec import Spec
from kmerbench.tests.helpers import ROOT
from kmerbench.traffic import BatchStats


def test_call_bytes_by_hand():
    stats = BatchStats(n=10, code_bytes=4, distinct=3)
    assert roofline.call_bytes(stats, 4) == 10 * 4 + 10 * 4 + 3 * 4
    spec = Spec(ROOT)
    assert spec.roofline("gather13").call_bytes(stats) == 92
    wide = BatchStats(n=2 ** 24, code_bytes=8, distinct=9_000_000)
    assert spec.roofline("quot23").call_bytes(wide) == 2 ** 24 * 12 + 9_000_000 * 12


@pytest.mark.parametrize("kernel,name", [
    ("gather13", "void (anonymous namespace)::gather13_kernel<unsigned char, false, false, "
                 "false>(unsigned char const*, int const*, unsigned char const*, long long, "
                 "unsigned int*)"),
    ("quot23", "void probe::query_kernel<probe::Buckets, 1, false, false, false, false>"
               "(probe::Buckets, long long const*, unsigned char const*, unsigned char const*, "
               "int, long long, unsigned int*, int*, int*)"),
])
def test_patterns_match_their_kernel_only(kernel, name):
    pattern = Spec(ROOT).roofline(kernel).PATTERN
    assert re.search(pattern, trace.short_name(name))
    for other in ("(anonymous namespace)::gather_total_kernel<unsigned char>",
                  "query_kernel<probe::Walk, 1>", "Memset (Device)", "gather13_kernel_other",
                  "x_gather13_kernel<int>"):
        assert not re.search(pattern, other)


class Ev:
    def __init__(self, name, dev, a, b, annotation=False):
        self._v = (name, dev, a, b, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType." + self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def fake_events():
    s = 1_000_000_000
    return [
        Ev(trace.WINDOW, "CPU", 0, 10 * s),
        Ev(trace.SUBMIT, "CPU", 0, 1 * s),
        Ev(trace.WAIT, "CPU", 1 * s, 4 * s),
        Ev(trace.POOL, "CPU", 6 * s, 7 * s),
        Ev("void gather13_kernel<unsigned char>(int const*)", "CUDA", 1 * s, 3 * s),
        Ev("void gather13_kernel<unsigned char>(int const*)", "CUDA", 2 * s, 5 * s),
        Ev("Memset (Device)", "CUDA", 8 * s, 9 * s),
        Ev(trace.SUBMIT, "CUDA", 0, 10 * s, annotation=True),   # a range mirrored on the device
        Ev("before the window", "CUDA", -3 * s, -1 * s),
    ]


def test_summarize_fake_trace():
    t = trace.summarize(fake_events())
    assert t.window_s == 10 and t.busy_s == 5 and t.device_events == 3
    assert t.kernel(r"^gather13_kernel\b") == (5.0, 2)
    # idle: [0,1) in submit, [5,8) begun outside the ranges, [9,10) outside
    assert t.idle_gaps == [(trace.OUTSIDE, 3.0), (trace.SUBMIT, 1.0), (trace.OUTSIDE, 1.0)]
    b = t.breakdown()
    assert b["device_ops"][0] == ["gather13_kernel<unsigned char>", 5.0]
    assert len(b["device_ops"]) <= trace.TOP and len(b["idle_gaps"]) <= trace.TOP


def test_share_reads_only_its_kernel():
    t = trace.summarize(fake_events())
    stats = [BatchStats(n=2 ** 20, code_bytes=4, distinct=1000)]
    run = SimpleNamespace(config={"kernel": "gather13"}, trace=t, spec=Spec(ROOT),
                          device_kind="NVIDIA H100 80GB HBM3", batch_calls=[3],
                          pool_stats=stats)
    want = 100 * 3 * (2 ** 20 * 8 + 4000) / 3.35e12 / 5.0
    assert roofline.share(run, "gather13") == pytest.approx(want)
    assert roofline.share(run, "quot23") is None
    run.device_kind = "some other card"
    assert roofline.share(run, "gather13") is None
    run.device_kind, run.trace = "NVIDIA H100 80GB HBM3", None
    assert roofline.share(run, "gather13") is None


def test_short_name():
    assert trace.short_name("void a::b<c<d>, 1>(x (*)(int), int)") == "a::b<c<d>, 1>"
    assert trace.short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
    assert trace.short_name("void (anonymous namespace)::k<int>(int)") == \
        "(anonymous namespace)::k<int>"
