"""K6 and K7: verified k-mer queries and coverage in the quotient cuckoo
table of the sparse index.

Counterparts of aindex_tpu/index/quotcuckoo.py's device kernels:

* ``quot23`` (kernel ``csrc/quot23.cu``, K6) replaces ``quot_tf_canonical``
  (:310), ``quot_query_tf`` (:296), ``quot_query`` (:378), and the rules of
  ``index/sparse23.py`` ``_resolve_device`` (:553-578) with
  ``_extract_windows`` (:45) for ASCII rows;
* ``quotcov23`` (kernel ``csrc/quotcov23.cu``, K7) replaces
  ``quot_tf_windows_packed`` (:353) and the coverage cutoff;
* ``quot_tf_windows`` (K7's entry ``quotcov23_rows``) replaces
  ``quot_tf_windows`` (:329): the same coverage from ASCII rows,
  canonical probes, no cutoff.

Both are ``kernels/probe.py``'s ``query`` and ``coverage`` on a
``QuotTables``; ``quot23_plain``, ``quotcov23_plain`` and
``quot_tf_windows_plain`` are their plain PyTorch versions. Codes and keys are int64 tensors holding uint64 bit
patterns. The bijection masks to 2k bits after each multiply, so its int64
products, which wrap modulo 2^64, keep their low bits exact; the empty-row
marker 0xFFFFFFFF reads -1 in the int32 storage and never equals a
fingerprint of 31 bits or fewer.
"""

from __future__ import annotations

import dataclasses

import torch

from aindex_torch.kernels import _cuda, probe
from aindex_torch.kernels.encode import ascii_to_base_codes, window_codes
from aindex_torch.kernels.probe import CANON

KERNEL_ROWS = _cuda.KERNELS["quotcov23_rows"]


@dataclasses.dataclass(frozen=True)
class QuotTables:
    """The quotient cuckoo table on one device: each half's ``(fp, tf)``
    rows as its own int32[m, 2] tensor, the two int32[m] slot columns, and
    the table's shape and multipliers (index/quotcuckoo.py)."""
    half0: torch.Tensor
    half1: torch.Tensor
    slot0: torch.Tensor
    slot1: torch.Tensor
    m: int
    lb: int
    w: int
    mults: tuple[int, int, int, int]

    QUERY = "quot23"
    COVERAGE = "quotcov23"
    FILL = "posfill"

    @property
    def device(self) -> torch.device:
        return self.half0.device

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.half0, self.half1, self.slot0, self.slot1)

    def engine_args(self) -> tuple[list, list]:
        """probe.cuh ``Quot``: p = {half0, half1, slot0, slot1}, u = {m, lb,
        w, m1a, m1b, m2a, m2b}."""
        return ([x.data_ptr() for x in self.tensors()],
                [self.m, self.lb, self.w, *self.mults])

    def check(self) -> None:
        for name in ("half0", "half1"):
            x = getattr(self, name)
            if x.dtype != torch.int32 or x.shape != (self.m, 2) or not x.is_contiguous():
                raise ValueError(f"{name} must be a contiguous int32[{self.m}, 2] tensor")
        for name in ("slot0", "slot1"):
            x = getattr(self, name)
            if x.dtype != torch.int32 or x.shape != (self.m,) or not x.is_contiguous():
                raise ValueError(f"{name} must be a contiguous int32[{self.m}] tensor")
        if self.m <= 0 or self.m & (self.m - 1) or (1 << self.lb) != self.m:
            raise ValueError(f"m={self.m} is not 2^lb (lb={self.lb})")

    def check_k(self, k: int) -> None:
        if not 1 <= k <= 31 or 2 * k != self.w:
            raise ValueError(f"k={k} does not match the table's code width w={self.w}")

    def probe_plain(self, keys: torch.Tensor):
        """(hit, tf int64, slot int64) per key: both halves' verified
        probes, the first half winning, as ``_probe`` and its callers
        resolve them."""
        out = []
        for half, slots, ma, mb in ((self.half0, self.slot0, *self.mults[:2]),
                                    (self.half1, self.slot1, *self.mults[2:])):
            h = bij(keys, ma, mb, self.w)
            r = h & (self.m - 1)
            c = half[r]
            hit = c[:, 0].to(torch.int64) == (h >> self.lb)
            out.append((hit, c[:, 1].to(torch.int64) & 0xFFFFFFFF, slots[r].to(torch.int64)))
        (hit1, tf1, sl1), (hit2, tf2, sl2) = out
        tf = torch.where(hit1, tf1, torch.where(hit2, tf2, 0))
        slot = torch.where(hit1, sl1, torch.where(hit2, sl2, -1))
        return hit1 | hit2, tf, slot


def bij(x: torch.Tensor, ma: int, mb: int, w: int) -> torch.Tensor:
    """xorshift-multiply bijection on the low w bits (quotcuckoo.py:103),
    int64 in and out (values below 2^w)."""
    mask = (1 << w) - 1
    s = (w + 1) // 2
    x = x & mask
    x = x ^ (x >> s)
    x = (x * ma) & mask
    x = x ^ (x >> s)
    x = (x * mb) & mask
    return x ^ (x >> s)


def quot23_plain(t: QuotTables, codes=None, valid=None, ascii=None, k: int = 23,
                 rule: int = CANON, slot: bool = False, strand: bool = False):
    """Plain version of ``quot23``, same arguments and results."""
    return probe.query_plain(t, codes, valid, ascii, k, rule, slot, strand)


def quot23(t: QuotTables, codes: torch.Tensor | None = None,
           valid: torch.Tensor | None = None, ascii: torch.Tensor | None = None,
           k: int = 23, rule: int = CANON, slot: bool = False, strand: bool = False):
    """Verified lookups in the quotient cuckoo table: ``probe.query`` on a
    ``QuotTables``. A CPU tensor runs the plain version; a CUDA tensor
    launches K6."""
    if not isinstance(t, QuotTables):
        raise TypeError(f"expected QuotTables, got {type(t).__name__}")
    return probe.query(t, codes, valid, ascii, k, rule, slot, strand)


def quotcov23_plain(t: QuotTables, packed, vbits, rows: int, stride: int, k: int,
                    cutoff: int, rule: int = CANON) -> torch.Tensor:
    """Plain version of ``quotcov23``."""
    return probe.coverage_plain(t, packed, vbits, rows, stride, k, cutoff, rule)


def quotcov23(t: QuotTables, packed: torch.Tensor, vbits: torch.Tensor, rows: int,
              stride: int, k: int = 23, cutoff: int = 0, rule: int = CANON) -> torch.Tensor:
    """uint32[rows, stride - k] coverage of packed rows in the quotient
    cuckoo table: ``probe.coverage`` on a ``QuotTables``. A CPU tensor runs
    the plain version; a CUDA tensor launches K7."""
    if not isinstance(t, QuotTables):
        raise TypeError(f"expected QuotTables, got {type(t).__name__}")
    return probe.coverage(t, packed, vbits, rows, stride, k, cutoff, rule)


def quot_tf_windows_plain(t: QuotTables, mat: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of ``quot_tf_windows``."""
    codes, valid = window_codes(ascii_to_base_codes(mat), k)
    hit, tf, _, _ = probe.resolve_plain(t, codes.reshape(-1), k, CANON)
    tf = torch.where(hit & valid.reshape(-1), tf, 0)
    return probe.as_u32(tf).reshape(codes.shape)


def quot_tf_windows(t: QuotTables, mat: torch.Tensor, k: int) -> torch.Tensor:
    """uint32 [..., L-k+1] verified tf of every k-window of uint8 [..., L]
    ASCII rows (aindex_tpu/index/quotcuckoo.py:329): the canonical probe of
    each window, 0 for an absent window or one with a byte outside
    ACGT/acgt; no cutoff.

    A CPU tensor runs the plain version; a CUDA tensor launches K7's
    ``quotcov23_rows``."""
    if not isinstance(t, QuotTables):
        raise TypeError(f"expected QuotTables, got {type(t).__name__}")
    t.check()
    t.check_k(k)
    if mat.dtype != torch.uint8 or mat.dim() < 1 or not mat.is_contiguous():
        raise ValueError("mat must be a contiguous uint8 [..., L] tensor")
    length = mat.shape[-1]
    if length < k:
        raise ValueError(f"sequence length {length} shorter than k={k}")
    if not _cuda.on_cuda(*t.tensors(), mat):
        return quot_tf_windows_plain(t, mat, k)
    dev = t.device
    out = torch.empty((*mat.shape[:-1], length - k + 1), dtype=torch.int32, device=dev)
    if out.numel():
        p, u = probe.c_engine(t)
        with torch.cuda.device(dev):
            KERNEL_ROWS.launch(p, u, mat.data_ptr(), mat.numel() // length, length, k,
                               out.data_ptr(), _cuda.stream(dev))
    return out.view(torch.uint32)
