"""K4: per-position forward 13-mer coverage of many sequences at once.

Coverage of a sequence = tf of the 13-mer starting at each position
(aindex/core/aindex.py:314-322). Counterpart of
aindex_tpu/kernels/coverage.py: the kernel ``csrc/coverage13.cu`` replaces
``_coverage_dense_packed`` (:32) and ``_coverage_dense_kernel`` (:22);
``coverage13_packed_plain`` is its plain PyTorch version.

Host layout: the sequences of one batch become rows of a ``[rows,
stride]`` ASCII matrix padded with newlines (invalid bases), packed with
``codec.pack_ascii_chunk``. The kernel writes the ``stride - 13`` windows
of every row; row i's coverage is the first ``len(seq_i) - 12`` of them.
"""

from __future__ import annotations

import numpy as np
import torch

from aindex_torch.constants import K13, SPACE_13
from aindex_torch.core import codec
from aindex_torch.kernels import _cuda
from aindex_torch.kernels.encode import check_packed, packed_window_codes, table_values
from aindex_torch.kernels.lookup import WIDTHS, as_u32

KERNEL = _cuda.KERNELS["coverage13_packed"]

_NP_DTYPES = {torch.uint8: np.uint8, torch.uint16: np.uint16, torch.uint32: np.uint32}


def _check(table, packed, vbits, rows, stride, cutoff) -> None:
    if table.dtype not in WIDTHS or table.shape != (SPACE_13,) \
            or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous uint8/uint16/uint32"
                         f"[{SPACE_13}], got {table.dtype}{tuple(table.shape)}")
    check_packed(packed, vbits)
    if stride <= K13 or rows < 0 or 16 * packed.numel() < rows * stride:
        raise ValueError(f"packed holds {16 * packed.numel()} bases, fewer than "
                         f"rows * stride = {rows} * {stride} (stride > {K13})")
    if not 0 <= cutoff < 1 << 32:
        raise ValueError(f"cutoff {cutoff} is not a uint32")


def coverage13_packed_plain(table, packed, vbits, rows: int, stride: int,
                            cutoff: int) -> torch.Tensor:
    """Plain version of ``coverage13_packed``."""
    codes, valid = packed_window_codes(packed, vbits, K13)
    pos = (torch.arange(rows, device=table.device)[:, None] * stride
           + torch.arange(stride - K13, device=table.device)[None, :])
    tf = table_values(table, codes[pos])
    tf = torch.where(valid[pos], tf, 0)
    return as_u32(torch.where(tf >= cutoff, tf, 0))


def coverage13_packed(table: torch.Tensor, packed: torch.Tensor, vbits: torch.Tensor,
                      rows: int, stride: int, cutoff: int) -> torch.Tensor:
    """uint32[rows, stride - 13] forward coverage of ``rows`` packed rows of
    ``stride`` bases (``packed``/``vbits`` as ``codec.pack_ascii_chunk``
    makes them): the table entry of every valid window, 0 for invalid
    windows and for entries below ``cutoff``.

    A CPU tensor runs the plain version; a CUDA tensor launches K4."""
    _check(table, packed, vbits, rows, stride, cutoff)
    if not _cuda.on_cuda(table, packed, vbits):
        return coverage13_packed_plain(table, packed, vbits, rows, stride, cutoff)
    out = torch.empty((rows, stride - K13), dtype=torch.int32, device=table.device)
    if out.numel():
        with torch.cuda.device(table.device):
            KERNEL.launch(table.data_ptr(), WIDTHS[table.dtype], packed.data_ptr(),
                          vbits.data_ptr(), packed.numel(), rows, stride, cutoff,
                          out.data_ptr(), _cuda.stream(table.device))
    return out.view(torch.uint32)


def coverage_dense(table: torch.Tensor, seq: str, cutoff: int = 0) -> np.ndarray:
    """Forward coverage of one sequence: one packed row through K4. The
    result has the table's dtype, as aindex_tpu's has."""
    return coverage_dense_batch(table, [seq], cutoff)[0]


def coverage_dense_batch(table: torch.Tensor, seqs: list[str],
                         cutoff: int = 0) -> list[np.ndarray]:
    """Coverage of many sequences, one K4 launch per length class
    (``codec.coverage_row_batches``). Results have the table's dtype (empty
    uint32 below 13 bases)."""
    raws = [s.encode("ascii") for s in seqs]
    out = [np.zeros(0, dtype=np.uint32)] * len(seqs)
    dtype = _NP_DTYPES[table.dtype]
    dev = table.device
    for members, stride, packed, vbits in codec.coverage_row_batches(raws, K13):
        cov = coverage13_packed(table, torch.from_numpy(packed.view(np.int32)).to(dev),
                                torch.from_numpy(vbits).to(dev), len(members), stride,
                                cutoff)
        cov = cov.view(torch.int32).cpu().numpy().view(np.uint32)
        for row, i in enumerate(members):
            out[i] = cov[row, :len(raws[i]) - K13 + 1].astype(dtype)
    return out
