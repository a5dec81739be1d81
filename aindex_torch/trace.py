"""Spans and counters of aindex_torch.

A span names a stretch of the port's host work in a ``torch.profiler``
trace. ``span(name)`` opens a profiler range only while a torch profiler
records; otherwise it costs one check and returns a shared no-op context.
The range is PyTorch's C++ ``_RecordFunctionFast``, the one its compiled
code uses: ``record_function`` costs some ten times as much a range under
a profiler, which would swell the host time it is there to measure. The
ranges are CPU events of the trace (``cpu_op`` in a chrome trace), on the
profiler's clock beside the device's kernels and copies, so a gap on the
device can be put down to the span the host was in. Every span is named
``aindex.<layer>.<step>``:

* ``aindex.facade.<entry>``: the facade's codes-in entries (``api.py``);
* ``aindex.index.query``, ``aindex.index.codes_in``: an index's codes-in
  query and the conversion of the caller's codes;
* ``aindex.index.upload``: a query table built from host arrays;
* ``aindex.index.total``: the dense query tables made on the device;
* ``aindex.kernel.<wrapper>``: a kernel wrapper's checks, allocation and
  launch;
* ``aindex.build.<stage>``, ``aindex.build_all.<phase>``,
  ``aindex.positional.<step>``, ``aindex.kernels.compile``: the builds.

A ``timed`` span (coarse stages only: builds, table uploads) also reads the
host clock every time, profiler or not, and adds its seconds to the counter
``seconds.<name>``.

Counters are one process-wide registry of plain adds: ``count``,
``counters`` (a snapshot) and ``reset``. What the port counts:

* ``h2d.bytes``, ``h2d.copies``: the port's host-to-device copies
  (``to_device`` and the build's packed ingest);
* ``launch.<kernel>``: launches of each CUDA kernel (``kernels/_cuda.py``'s
  ``launches()`` reads them);
* ``kernels.compiled``, ``kernels.loaded``: ``nvcc`` runs and kernel
  libraries loaded;
* ``seconds.<span>``: the timed spans.
"""

from __future__ import annotations

import time

import torch
from torch._C._profiler import _RecordFunctionFast as _Range

#: True while a torch profiler records (the one check an idle span makes)
_profiling = torch.autograd._profiler_enabled

_counts: dict[str, float] = {}


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counters() -> dict[str, float]:
    """A snapshot of every counter."""
    return dict(_counts)


def reset(prefix: str = "") -> None:
    """Zero the counters whose names start with ``prefix`` (all of them by
    default)."""
    for name in [n for n in _counts if n.startswith(prefix)]:
        del _counts[name]


class _Idle:
    """The context of a span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_IDLE = _Idle()


class _Timed:
    """A timed span: a profiler range while a profiler records, and the
    host clock always; ``seconds`` holds its time once it closes."""

    __slots__ = ("name", "seconds", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self) -> "_Timed":
        self._range = _Range(self.name) if _profiling() else None
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        count("seconds." + self.name, self.seconds)
        return False


def span(name: str, timed: bool = False):
    """The span ``name`` (``aindex.<layer>.<step>``) as a context manager."""
    if timed:
        return _Timed(name)
    if not _profiling():
        return _IDLE
    return _Range(name)


def note_h2d(t: torch.Tensor) -> None:
    """Count ``t``'s bytes as one host-to-device copy."""
    count("h2d.bytes", t.numel() * t.element_size())
    count("h2d.copies")


def to_device(t: torch.Tensor, device, **kwargs) -> torch.Tensor:
    """``t.to(device, **kwargs)``, counted by ``note_h2d`` when ``t`` lies on
    the host and ``device`` is not the host. A tensor already on a device
    counts nothing."""
    if t.is_cpu and torch.device(device).type != "cpu":
        note_h2d(t)
    return t.to(device, **kwargs)
