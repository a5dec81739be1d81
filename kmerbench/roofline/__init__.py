"""Roofline counts of the query kernels: the least time the card could
take for the work the algorithm needs, over the time the kernel took.

Each ``<kernel>.py`` here names the kernel as the profiler reports it
(``PATTERN``, a regular expression on its short name) and counts the
bytes a call needs (``call_bytes``): every code the harness hands in,
read once at the width it hands it; every answer written once, as 4
bytes; every distinct table entry the batch's keys reach, read once at
the reference's logical size (``ENTRY_BYTES``). Both kernels are bound by
memory, so the count takes no operations. The peaks are the published
ones (``peaks.json``), beside the power limit they assume.
"""

from __future__ import annotations

import json
import os

#: bytes of one answer (a uint32 count)
ANSWER_BYTES = 4

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")) as _f:
    PEAKS = json.load(_f)


def call_bytes(stats, entry_bytes: int) -> int:
    """The bytes one call of ``stats`` (``traffic.BatchStats``) needs."""
    return stats.n * stats.code_bytes + stats.n * ANSWER_BYTES + stats.distinct * entry_bytes


def share(run, kernel: str):
    """Percent of the roofline that ``kernel`` reached over the traced
    window; None unless the run's configuration queries through that
    kernel, the trace holds its launches, and the card has a peak here."""
    if run.config.get("kernel") != kernel or run.trace is None:
        return None
    peak = PEAKS.get(run.device_kind or "")
    if peak is None:
        return None
    module = run.spec.roofline(kernel)
    seconds, launches = run.trace.kernel(module.PATTERN)
    if seconds <= 0 or not launches:
        return None
    total = sum(calls * module.call_bytes(stats)
                for calls, stats in zip(run.batch_calls, run.pool_stats))
    return 100.0 * total / peak["hbm_bytes_per_s"] / seconds
