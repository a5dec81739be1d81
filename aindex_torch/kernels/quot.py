"""K6 and K7: verified k-mer queries and coverage in the quotient cuckoo
table of the sparse index.

Counterparts of aindex_tpu/index/quotcuckoo.py's device kernels:

* ``quot23`` (kernel ``csrc/quot23.cu``, K6) replaces ``quot_tf_canonical``
  (:310), ``quot_query_tf`` (:296), ``quot_query`` (:378), and the
  canonical rule of ``index/sparse23.py`` ``_resolve_device`` (:553-578)
  with ``_extract_windows`` (:45) for ASCII rows;
* ``quotcov23`` (kernel ``csrc/quotcov23.cu``, K7) replaces
  ``quot_tf_windows_packed`` (:353) and the coverage cutoff.

``quot23_plain`` and ``quotcov23_plain`` are their plain PyTorch versions.
Codes and keys are int64 tensors holding uint64 bit patterns. The
bijection masks to 2k bits after each multiply, so its int64 products,
which wrap modulo 2^64, keep their low bits exact; the empty-row marker
0xFFFFFFFF reads -1 in the int32 storage and never equals a fingerprint of
31 bits or fewer.
"""

from __future__ import annotations

import dataclasses

import torch

from aindex_torch.kernels import _cuda
from aindex_torch.kernels.encode import (ascii_to_base_codes, canonical_code64,
                                         check_packed, packed_window_codes,
                                         revcomp_code64, u64_le, window_codes)
from aindex_torch.kernels.lookup import as_u32

KERNEL_QUERY = _cuda.KERNELS["quot23"]
KERNEL_COVERAGE = _cuda.KERNELS["quotcov23"]


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

    @property
    def device(self) -> torch.device:
        return self.half0.device

    def args(self) -> tuple:
        """(m, lb, w, m1a, m1b, m2a, m2b) for the C entries."""
        return (self.m, self.lb, self.w, *self.mults)


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


def _probe_plain(t: QuotTables, keys: torch.Tensor):
    """(hit, tf int64, slot int64) per key: both halves' verified probes,
    the first half winning, as ``_probe`` and its callers resolve them."""
    out = []
    for half, slots, ma, mb in ((t.half0, t.slot0, *t.mults[:2]),
                                (t.half1, t.slot1, *t.mults[2:])):
        h = bij(keys, ma, mb, t.w)
        r = h & (t.m - 1)
        c = half[r]
        hit = c[:, 0].to(torch.int64) == (h >> t.lb)
        out.append((hit, c[:, 1].to(torch.int64) & 0xFFFFFFFF, slots[r].to(torch.int64)))
    (hit1, tf1, sl1), (hit2, tf2, sl2) = out
    tf = torch.where(hit1, tf1, torch.where(hit2, tf2, 0))
    slot = torch.where(hit1, sl1, torch.where(hit2, sl2, -1))
    return hit1 | hit2, tf, slot


def quot23_plain(t: QuotTables, codes=None, valid=None, ascii=None, k: int = 23,
                 canon: bool = True, slot: bool = False, strand: bool = False):
    """Plain version of ``quot23``, same arguments and results."""
    if ascii is not None:
        code, valid = window_codes(ascii_to_base_codes(ascii), k)
        code, valid = code.reshape(-1), valid.reshape(-1)
    else:
        code = codes
    key = canonical_code64(code, k) if canon else code
    hit, tf, sl = _probe_plain(t, key)
    if valid is not None:
        hit = hit & valid
    tf = as_u32(torch.where(hit, tf, 0))
    if not slot:
        return tf
    sl = torch.where(hit, sl, -1).to(torch.int32)
    if not strand:
        return tf, sl
    fwd = u64_le(code, revcomp_code64(code, k))
    return tf, sl, torch.where(hit, torch.where(fwd, 1, 2), 0).to(torch.int32)


def _check_tables(t: QuotTables) -> None:
    for name in ("half0", "half1"):
        x = getattr(t, name)
        if x.dtype != torch.int32 or x.shape != (t.m, 2) or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32[{t.m}, 2] tensor")
    for name in ("slot0", "slot1"):
        x = getattr(t, name)
        if x.dtype != torch.int32 or x.shape != (t.m,) or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32[{t.m}] tensor")
    if t.m <= 0 or t.m & (t.m - 1) or (1 << t.lb) != t.m:
        raise ValueError(f"m={t.m} is not 2^lb (lb={t.lb})")


def quot23(t: QuotTables, codes: torch.Tensor | None = None,
           valid: torch.Tensor | None = None, ascii: torch.Tensor | None = None,
           k: int = 23, canon: bool = True, slot: bool = False, strand: bool = False):
    """Verified lookups in the quotient cuckoo table.

    Queries are ``codes`` (1-D int64 of uint64 bit patterns, optionally
    masked by a bool ``valid``) or ``ascii`` rows (uint8[B, k], invalid
    where a byte is not ACGT/acgt). ``canon`` probes min(code, revcomp)
    (literal k-mer codes); without it the codes are probed as they are
    (canonical keys). Returns tf (uint32[B]; 0 when absent or invalid),
    with ``slot`` also the slot id (int32, -1 when absent), and with
    ``strand`` (needs ``canon`` and ``slot``) also the strand (int32: 0
    absent, 1 forward, 2 reverse complement).

    A CPU tensor runs the plain version; a CUDA tensor launches K6."""
    _check_tables(t)
    if (codes is None) == (ascii is None):
        raise ValueError("give exactly one of codes and ascii")
    if not 1 <= k <= 31 or 2 * k != t.w:
        raise ValueError(f"k={k} does not match the table's code width w={t.w}")
    if strand and not (canon and slot):
        raise ValueError("strand needs the canonical rule and the slot output")
    if ascii is not None:
        if ascii.dtype != torch.uint8 or ascii.dim() != 2 or ascii.shape[1] != k \
                or not ascii.is_contiguous():
            raise ValueError(f"ascii must be a contiguous uint8[B, {k}] tensor")
        if valid is not None:
            raise ValueError("ASCII rows carry their own validity")
        query = ascii
    else:
        if codes.dtype != torch.int64 or codes.dim() != 1 or not codes.is_contiguous():
            raise ValueError("codes must be a contiguous 1-D int64 tensor")
        if valid is not None and (valid.dtype != torch.bool or valid.shape != codes.shape
                                  or not valid.is_contiguous()):
            raise ValueError("valid must be a contiguous bool tensor shaped like codes")
        query = codes
    extra = (valid,) if valid is not None else ()
    if not _cuda.on_cuda(t.half0, t.half1, t.slot0, t.slot1, query, *extra):
        return quot23_plain(t, codes, valid, ascii, k, canon, slot, strand)
    dev = t.device
    n = query.shape[0]
    tf = torch.empty(n, dtype=torch.int32, device=dev)
    sl = torch.empty(n, dtype=torch.int32, device=dev) if slot else None
    st = torch.empty(n, dtype=torch.int32, device=dev) if strand else None
    if n:
        with torch.cuda.device(dev):
            KERNEL_QUERY.launch(
                t.half0.data_ptr(), t.half1.data_ptr(), t.slot0.data_ptr(),
                t.slot1.data_ptr(), *t.args(),
                None if codes is None else codes.data_ptr(),
                None if valid is None else valid.data_ptr(),
                None if ascii is None else ascii.data_ptr(), k, n, int(canon),
                tf.data_ptr(), None if sl is None else sl.data_ptr(),
                None if st is None else st.data_ptr(), _cuda.stream(dev))
    tf = tf.view(torch.uint32)
    if not slot:
        return tf
    return (tf, sl) if not strand else (tf, sl, st)


def quotcov23_plain(t: QuotTables, packed, vbits, rows: int, stride: int, k: int,
                    cutoff: int) -> torch.Tensor:
    """Plain version of ``quotcov23``."""
    codes, valid = packed_window_codes(packed, vbits, k)
    dev = t.device
    pos = (torch.arange(rows, device=dev)[:, None] * stride
           + torch.arange(stride - k, device=dev)[None, :]).reshape(-1)
    _, tf, _ = _probe_plain(t, canonical_code64(codes[pos], k))
    tf = torch.where(valid[pos], tf, 0)
    tf = torch.where(tf >= cutoff, tf, 0)
    return as_u32(tf).reshape(rows, stride - k)


def quotcov23(t: QuotTables, packed: torch.Tensor, vbits: torch.Tensor, rows: int,
              stride: int, k: int = 23, cutoff: int = 0) -> torch.Tensor:
    """uint32[rows, stride - k] canonical coverage of ``rows`` packed rows of
    ``stride`` bases (``packed``/``vbits`` as ``codec.pack_ascii_chunk``
    makes them): the verified tf of every valid window, 0 for invalid or
    absent windows and for values below ``cutoff``.

    A CPU tensor runs the plain version; a CUDA tensor launches K7."""
    _check_tables(t)
    check_packed(packed, vbits)
    if not 1 <= k <= 31 or 2 * k != t.w:
        raise ValueError(f"k={k} does not match the table's code width w={t.w}")
    if stride <= k or rows < 0 or 16 * packed.numel() < rows * stride:
        raise ValueError(f"packed holds {16 * packed.numel()} bases, fewer than "
                         f"rows * stride = {rows} * {stride} (stride > {k})")
    if not 0 <= cutoff < 1 << 32:
        raise ValueError(f"cutoff {cutoff} is not a uint32")
    if not _cuda.on_cuda(t.half0, t.half1, packed, vbits):
        return quotcov23_plain(t, packed, vbits, rows, stride, k, cutoff)
    dev = t.device
    out = torch.empty((rows, stride - k), dtype=torch.int32, device=dev)
    if out.numel():
        with torch.cuda.device(dev):
            KERNEL_COVERAGE.launch(
                t.half0.data_ptr(), t.half1.data_ptr(), *t.args(), packed.data_ptr(),
                vbits.data_ptr(), packed.numel(), rows, stride, k, cutoff,
                out.data_ptr(), _cuda.stream(dev))
    return out.view(torch.uint32)
