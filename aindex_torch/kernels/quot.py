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
``QuotTables``: the table's rows as bucketed records
(``kernels/buckets.py``), each key recovered from its row by inverting
the bijection; ``quot23_plain``, ``quotcov23_plain`` and
``quot_tf_windows_plain`` are their plain PyTorch versions. Codes and keys
are int64 tensors holding uint64 bit patterns. The bijection masks to 2k
bits after each multiply, so its int64 products, which wrap modulo 2^64,
keep their low bits exact; the empty-row marker 0xFFFFFFFF reads -1 in the
int32 storage and never equals a fingerprint of 31 bits or fewer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from aindex_torch.kernels import _cuda, probe
from aindex_torch.kernels.buckets import BucketTables, build_records
from aindex_torch.kernels.encode import ascii_to_base_codes, window_codes
from aindex_torch.kernels.probe import CANON
from aindex_torch.trace import span, to_device

KERNEL_ROWS = _cuda.KERNELS["quotcov23_rows"]


#: the level-0 seed of the quotient table's buckets (any constant serves:
#: the keys are a bijection's preimages, not the hashes)
QUOT_SEED = 0x5851F42D4C957F2D


@dataclasses.dataclass(frozen=True)
class QuotTables(BucketTables):
    """The quotient cuckoo table on one device as bucketed records
    (``kernels/buckets.py``), keys masked to the table's w = 2k bits as
    its bijection masks them."""

    QUERY = "quot23"
    COVERAGE = "quotcov23"
    FILL = "posfill"

    @classmethod
    def from_host(cls, fp_tf: np.ndarray, slot: np.ndarray, m: int, lb: int, w: int,
                  mults, device) -> "QuotTables":
        """The records of the host table (index/quotcuckoo.py: ``fp_tf``
        uint32[2m, 2] rows (fingerprint, tf), ``slot`` int32[2m]), built on
        ``device``: each occupied row's key is its bijection inverted at
        (fingerprint << lb) | row, checked to probe back to that row; in the
        timed span ``aindex.index.upload``."""
        with span("aindex.index.upload", timed=True):
            fp_tf = to_device(torch.from_numpy(np.ascontiguousarray(fp_tf).view(np.int32)),
                              device)
            slot = to_device(torch.from_numpy(np.ascontiguousarray(slot, dtype=np.int32)),
                             device)
            fp = fp_tf[:, 0].to(torch.int64) & 0xFFFFFFFF
            rows = torch.nonzero(fp != 0xFFFFFFFF).reshape(-1)
            h = (fp[rows] << lb) | (rows & (m - 1))
            second = rows >= m
            m1, m2 = tuple(int(x) for x in mults[:2]), tuple(int(x) for x in mults[2:])
            keys = torch.where(second, bij_inverse(h, *m2, w), bij_inverse(h, *m1, w))
            if not bool((torch.where(second, bij(keys, *m2, w), bij(keys, *m1, w)) == h).all()):
                raise RuntimeError("a quotient row's key does not probe back to its row")
            records, levels = build_records(keys, fp_tf[rows, 1], slot[rows], QUOT_SEED)
            return cls(records, levels, QUOT_SEED, w)

    def check_k(self, k: int) -> None:
        if not 1 <= k <= 31 or 2 * k != self.w:
            raise ValueError(f"k={k} does not match the table's code width w={self.w}")


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


def bij_inverse(x: torch.Tensor, ma: int, mb: int, w: int) -> torch.Tensor:
    """The inverse of ``bij`` on values below 2^w (w <= 62): each xorshift
    by s = (w + 1) / 2 >= w / 2 is its own inverse, and each odd
    multiplier has one modulo 2^w."""
    mask = (1 << w) - 1
    s = (w + 1) // 2
    x = x ^ (x >> s)
    x = (x * pow(mb, -1, 1 << w)) & mask
    x = x ^ (x >> s)
    x = (x * pow(ma, -1, 1 << w)) & mask
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
