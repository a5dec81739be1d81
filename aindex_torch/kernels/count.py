"""K1: count the 13-mers of one packed ingest chunk into the dense table.

Counterpart of aindex_tpu/kernels/count.py:69 ``count_batch_13_packed``.
The kernel is ``csrc/count13.cu``; ``count13_packed_plain`` is its plain
PyTorch version. Unlike the JAX function, which returns a new table, both
add into ``counts`` in place: the table is 256 MB and has one owner.
"""

from __future__ import annotations

import torch

from aindex_torch.constants import K13, SPACE_13
from aindex_torch.kernels import _cuda
from aindex_torch.kernels.encode import check_packed, packed_window_codes

KERNEL = _cuda.KERNELS["count13_packed"]


def _check(counts: torch.Tensor, packed: torch.Tensor, vbits: torch.Tensor) -> None:
    if counts.dtype not in (torch.int32, torch.uint32) or counts.shape != (SPACE_13,) \
            or not counts.is_contiguous():
        raise ValueError(f"counts must be a contiguous int32/uint32[{SPACE_13}] "
                         f"table, got {counts.dtype}{tuple(counts.shape)}")
    check_packed(packed, vbits)


def count13_packed_plain(counts: torch.Tensor, packed: torch.Tensor,
                         vbits: torch.Tensor) -> torch.Tensor:
    """Plain version: every valid window adds 1 at its code (int32, so the
    sum wraps modulo 2^32 as uint32 does)."""
    codes, valid = packed_window_codes(packed, vbits, K13)
    hits = codes[valid]
    counts.view(torch.int32).index_add_(
        0, hits, torch.ones(hits.numel(), dtype=torch.int32, device=counts.device))
    return counts


def count13_packed(counts: torch.Tensor, packed: torch.Tensor,
                   vbits: torch.Tensor) -> torch.Tensor:
    """Add every valid 13-mer window of a packed chunk (uint32[W] words,
    uint8[2W] validity bits, ``codec.pack_ascii_chunk``) into ``counts``
    (uint32 or int32 storage of uint32[4^13]); returns ``counts``.

    A CPU tensor runs the plain version; a CUDA tensor launches K1."""
    _check(counts, packed, vbits)
    cuda = _cuda.on_cuda(counts, packed, vbits)
    if packed.numel() == 0:
        return counts
    if not cuda:
        return count13_packed_plain(counts, packed, vbits)
    with torch.cuda.device(counts.device):
        KERNEL.launch(counts.data_ptr(), packed.data_ptr(), vbits.data_ptr(),
                      packed.numel(), _cuda.stream(counts.device))
    return counts
