"""Verified queries and coverage of the sparse index on any of its three
device tables, with the plain PyTorch versions of both.

The tables lie on one device, each a class with the same small interface
(``QuotTables`` in kernels/quot.py and ``CuckooTables`` in
kernels/cuckoo.py, both bucketed records of kernels/buckets.py;
``MphfTables`` in kernels/lookup.py):

* ``check()`` raises unless its tensors have the shapes and types its
  kernels take; ``check_k(k)`` raises for a k it cannot hold;
* ``tensors()`` its tensors, ``device`` theirs;
* ``engine_args()`` the pointer and parameter arrays of its C entries
  (``csrc/probe.cuh``: ``Buckets``' and ``Mphf``'s ``make``);
* ``probe_plain(keys)`` the plain version of its probe: (hit bool, tf
  int64, slot int64) per int64 key;
* ``QUERY``, ``COVERAGE`` and ``FILL``, the names of its kernels' C
  entries in ``kernels/_cuda.py``.

``query`` and ``coverage`` launch the engine's kernel for CUDA tensors and
run ``query_plain`` and ``coverage_plain`` for CPU tensors. The rule is one
of ``KEYS`` (codes probed as they are), ``CANON`` (one probe of min(code,
revcomp): indexes keyed by the true canonical code) and ``FWD_RC`` (the
forward code, else its reverse complement: reference-keyed indexes),
aindex_tpu/index/sparse23.py:553-578. Codes are int64 tensors holding
uint64 bit patterns.
"""

from __future__ import annotations

import ctypes

import torch

from aindex_torch.kernels import _cuda
from aindex_torch.trace import span
from aindex_torch.kernels.encode import (ascii_to_base_codes, check_packed,
                                         packed_window_codes, revcomp_code64, u64_le,
                                         window_codes)

KEYS, CANON, FWD_RC = 0, 1, 2
RULES = (KEYS, CANON, FWD_RC)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> uint32 tensor of their low 32 bits."""
    return x.to(torch.int32).view(torch.uint32)


def c_engine(t) -> tuple:
    """The engine's (p, u) host arrays for a C entry (kept alive by the
    caller for the call)."""
    ptrs, params = t.engine_args()
    return ((ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_ulonglong * len(params))(*(int(x) & (2**64 - 1) for x in params)))


def resolve_plain(t, code: torch.Tensor, k: int, rule: int):
    """(hit, tf int64, slot int64, strand int64) of literal codes under the
    rule, on the engine's plain probe."""
    if rule == KEYS:
        hit, tf, slot = t.probe_plain(code)
        return hit, tf, slot, torch.ones_like(tf)
    rc = revcomp_code64(code, k)
    if rule == CANON:
        fwd = u64_le(code, rc)
        hit, tf, slot = t.probe_plain(torch.where(fwd, code, rc))
        return hit, tf, slot, torch.where(fwd, 1, 2)
    hit1, tf1, slot1 = t.probe_plain(code)
    hit2, tf2, slot2 = t.probe_plain(rc)
    return (hit1 | hit2, torch.where(hit1, tf1, tf2), torch.where(hit1, slot1, slot2),
            torch.where(hit1, 1, 2))


def query_plain(t, codes=None, valid=None, ascii=None, k: int = 23, rule: int = CANON,
                slot: bool = False, strand: bool = False):
    """Plain version of ``query``, same arguments and results."""
    if ascii is not None:
        code, valid = window_codes(ascii_to_base_codes(ascii), k)
        code, valid = code.reshape(-1), valid.reshape(-1)
    else:
        code = codes
    hit, tf, sl, st = resolve_plain(t, code, k, rule)
    if valid is not None:
        hit = hit & valid
    tf = as_u32(torch.where(hit, tf, 0))
    if not slot:
        return tf
    sl = torch.where(hit, sl, -1).to(torch.int32)
    if not strand:
        return tf, sl
    return tf, sl, torch.where(hit, st, 0).to(torch.int32)


def _check_query(t, codes, valid, ascii, k, rule, slot, strand) -> torch.Tensor:
    t.check()
    t.check_k(k)
    if rule not in RULES:
        raise ValueError(f"rule {rule} is not one of KEYS, CANON, FWD_RC")
    if (codes is None) == (ascii is None):
        raise ValueError("give exactly one of codes and ascii")
    if strand and (rule == KEYS or not slot):
        raise ValueError("strand needs the CANON or FWD_RC rule and the slot output")
    if ascii is not None:
        if ascii.dtype != torch.uint8 or ascii.dim() != 2 or ascii.shape[1] != k \
                or not ascii.is_contiguous():
            raise ValueError(f"ascii must be a contiguous uint8[B, {k}] tensor")
        if valid is not None:
            raise ValueError("ASCII rows carry their own validity")
        return ascii
    if codes.dtype != torch.int64 or codes.dim() != 1 or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous 1-D int64 tensor")
    if valid is not None and (valid.dtype != torch.bool or valid.shape != codes.shape
                              or not valid.is_contiguous()):
        raise ValueError("valid must be a contiguous bool tensor shaped like codes")
    return codes


def query(t, codes: torch.Tensor | None = None, valid: torch.Tensor | None = None,
          ascii: torch.Tensor | None = None, k: int = 23, rule: int = CANON,
          slot: bool = False, strand: bool = False):
    """Verified lookups on the engine ``t``.

    Queries are ``codes`` (1-D int64 of uint64 bit patterns, optionally
    masked by a bool ``valid``) or ``ascii`` rows (uint8[B, k], invalid
    where a byte is not ACGT/acgt), probed under ``rule``. Returns tf
    (uint32[B]; 0 when absent or invalid), with ``slot`` also the slot id
    (int32, -1 when absent), and with ``strand`` (needs ``slot`` and the
    CANON or FWD_RC rule) also the strand (int32: 0 absent, 1 forward, 2
    reverse complement).

    A CPU tensor runs the plain version; a CUDA tensor launches the
    engine's query kernel (K6, K10 or K11). The whole call is the span
    ``aindex.kernel.query``."""
    with span("aindex.kernel.query"):
        q = _check_query(t, codes, valid, ascii, k, rule, slot, strand)
        extra = (valid,) if valid is not None else ()
        if not _cuda.on_cuda(*t.tensors(), q, *extra):
            return query_plain(t, codes, valid, ascii, k, rule, slot, strand)
        dev = t.device
        n = q.shape[0]
        tf = torch.empty(n, dtype=torch.int32, device=dev)
        sl = torch.empty(n, dtype=torch.int32, device=dev) if slot else None
        st = torch.empty(n, dtype=torch.int32, device=dev) if strand else None
        if n:
            p, u = c_engine(t)
            with torch.cuda.device(dev):
                _cuda.KERNELS[t.QUERY].launch(
                    p, u, None if codes is None else codes.data_ptr(),
                    None if valid is None else valid.data_ptr(),
                    None if ascii is None else ascii.data_ptr(), k, n, rule, tf.data_ptr(),
                    None if sl is None else sl.data_ptr(),
                    None if st is None else st.data_ptr(), _cuda.stream(dev))
    tf = tf.view(torch.uint32)
    if not slot:
        return tf
    return (tf, sl) if not strand else (tf, sl, st)


def coverage_plain(t, packed, vbits, rows: int, stride: int, k: int, cutoff: int,
                   rule: int = CANON) -> torch.Tensor:
    """Plain version of ``coverage``."""
    codes, valid = packed_window_codes(packed, vbits, k)
    pos = (torch.arange(rows, device=packed.device)[:, None] * stride
           + torch.arange(stride - k, device=packed.device)[None, :]).reshape(-1)
    hit, tf, _, _ = resolve_plain(t, codes[pos], k, rule)
    tf = torch.where(hit & valid[pos], tf, 0)
    tf = torch.where(tf >= cutoff, tf, 0)
    return as_u32(tf).reshape(rows, stride - k)


def coverage(t, packed: torch.Tensor, vbits: torch.Tensor, rows: int, stride: int,
             k: int = 23, cutoff: int = 0, rule: int = CANON) -> torch.Tensor:
    """uint32[rows, stride - k] coverage of ``rows`` packed rows of
    ``stride`` bases (``packed``/``vbits`` as ``codec.pack_ascii_chunk``
    makes them): the verified tf of every valid window under ``rule``
    (CANON or FWD_RC), 0 for invalid or absent windows and for values below
    ``cutoff``.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    engine's coverage kernel (K7, K10 or K11)."""
    t.check()
    t.check_k(k)
    check_packed(packed, vbits)
    if rule not in (CANON, FWD_RC):
        raise ValueError(f"coverage takes the CANON or FWD_RC rule, got {rule}")
    if stride <= k or rows < 0 or 16 * packed.numel() < rows * stride:
        raise ValueError(f"packed holds {16 * packed.numel()} bases, fewer than "
                         f"rows * stride = {rows} * {stride} (stride > {k})")
    if not 0 <= cutoff < 1 << 32:
        raise ValueError(f"cutoff {cutoff} is not a uint32")
    if not _cuda.on_cuda(*t.tensors(), packed, vbits):
        return coverage_plain(t, packed, vbits, rows, stride, k, cutoff, rule)
    dev = t.device
    out = torch.empty((rows, stride - k), dtype=torch.int32, device=dev)
    if out.numel():
        p, u = c_engine(t)
        with torch.cuda.device(dev):
            _cuda.KERNELS[t.COVERAGE].launch(
                p, u, packed.data_ptr(), vbits.data_ptr(), packed.numel(), rows, stride, k,
                rule, cutoff, out.data_ptr(), _cuda.stream(dev))
    return out.view(torch.uint32)
