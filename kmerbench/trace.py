"""The traced window, reduced from ``torch.profiler``'s events.

The harness wraps its own host work in ``record_function`` ranges
(``RANGES``) and the whole measured loop in ``WINDOW``. From the device
activities (kernels, copies, memsets) inside that window this module
takes the busy time (their union), the time of each kernel by name, the
device operations that took most time, and the longest idle gaps, each
named by the harness range the host was in when the gap began.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

WINDOW = "kmerbench.window"
SUBMIT = "kmerbench.submit"
WAIT = "kmerbench.wait"
POOL = "kmerbench.pool"
RANGES = (SUBMIT, WAIT, POOL)
OUTSIDE = "host outside the harness's ranges"

#: entries of each breakdown list
TOP = 10


ANONYMOUS = "(anonymous namespace)"


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void ", "", name)
    depth = 0
    i = 0
    while i < len(name):
        if name.startswith(ANONYMOUS, i):
            i += len(ANONYMOUS)
            continue
        ch = name[i]
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return name[:i].rstrip()
        i += 1
    return name


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    #: device seconds and launches by short kernel name
    ops: dict[str, list] = field(default_factory=dict)
    idle_gaps: list[tuple[str, float]] = field(default_factory=list)
    device_events: int = 0

    def kernel(self, pattern: str) -> tuple[float, int]:
        """(seconds, launches) of the device operations whose short name
        matches the regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [v for name, v in self.ops.items() if rx.search(name)]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)

    def breakdown(self) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:TOP]
        return {"device_ops": [[name, v[0]] for name, v in ops],
                "idle_gaps": [[name, s] for name, s in self.idle_gaps[:TOP]]}


def summarize(events) -> TraceSummary | None:
    """Reduce the profiler's raw events (``prof.profiler.kineto_results.
    events()``: objects with ``name()``, ``device_type()``, ``start_ns()``,
    ``end_ns()``, ``is_user_annotation()``). None when the window range is
    missing."""
    window = None
    host: list[tuple[int, int, str]] = []
    device: list[tuple[int, int, str]] = []
    for e in events:
        name = e.name()
        if str(e.device_type()).endswith("CPU"):
            if name == WINDOW:
                window = (e.start_ns(), e.end_ns())
            elif name in RANGES:
                host.append((e.start_ns(), e.end_ns(), name))
        elif not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns(), name))
    if window is None:
        return None
    w0, w1 = window
    device = [(max(a, w0), min(b, w1), n) for a, b, n in device if b > w0 and a < w1]
    ops: dict[str, list] = {}
    for a, b, name in device:
        v = ops.setdefault(short_name(name), [0.0, 0])
        v[0] += (b - a) / 1e9
        v[1] += 1
    busy = _union([(a, b) for a, b, _ in device])
    host.sort()
    starts = [h[0] for h in host]
    gaps = []
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            i = bisect.bisect_right(starts, edge) - 1
            name = host[i][2] if i >= 0 and host[i][1] >= edge else OUTSIDE
            gaps.append((name, (a - edge) / 1e9))
        edge = max(edge, b)
    gaps.sort(key=lambda g: -g[1])
    return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=sum(b - a for a, b in busy) / 1e9,
                        ops=ops, idle_gaps=gaps, device_events=len(device))
