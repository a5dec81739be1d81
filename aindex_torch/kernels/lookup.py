"""K3: batched lookups in a dense 13-mer table.

One wrapper, ``gather13``, covers every gather of aindex_tpu's dense query
path (kernels/lookup.py:32 ``gather_tf_valid``, :49 ``gather_tf_both_13``;
index/dense13.py:103 ``_gather_total``, :109 ``_gather_codes_u32``, :115
``_gather_codes_valid_u32``, with :92 ``_encode_batch_dev`` for ASCII rows).
The kernel is ``csrc/gather13.cu``; ``gather13_plain`` is its plain PyTorch
version.

Codes are uint32 bit patterns (int32 or uint32 storage). A code outside
[0, 4^13) reads what JAX's ``table[code.astype(int32)]`` reads: the int32
value, plus 4^13 if negative, clamped into the table.
"""

from __future__ import annotations

import torch

from aindex_torch.constants import K13, SPACE_13
from aindex_torch.kernels import _cuda
from aindex_torch.kernels.encode import (ascii_to_base_codes, revcomp_code13,
                                         table_values, window_codes)

KERNEL = _cuda.KERNELS["gather13"]

#: table dtype -> bits per entry (the narrowed widths of ``_narrow``)
WIDTHS = {torch.uint8: 8, torch.uint16: 16, torch.uint32: 32}


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> uint32 tensor of their low 32 bits."""
    return x.to(torch.int32).view(torch.uint32)


def jax_index(codes: torch.Tensor) -> torch.Tensor:
    """The table index JAX's gather reads for each uint32 code (int64)."""
    i = codes.view(torch.int32).to(torch.int64)
    return torch.where(i < 0, i + SPACE_13, i).clamp_(0, SPACE_13 - 1)


def _check(table, codes, valid, ascii) -> None:
    if table.dtype not in WIDTHS or table.shape != (SPACE_13,) \
            or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous uint8/uint16/uint32"
                         f"[{SPACE_13}], got {table.dtype}{tuple(table.shape)}")
    if (codes is None) == (ascii is None):
        raise ValueError("give exactly one of codes and ascii")
    if ascii is not None:
        if ascii.dtype != torch.uint8 or ascii.dim() != 2 \
                or ascii.shape[1] != K13 or not ascii.is_contiguous():
            raise ValueError(f"ascii must be a contiguous uint8[B, {K13}] tensor")
        if valid is not None:
            raise ValueError("ASCII rows carry their own validity")
        return
    if codes.dtype not in (torch.int32, torch.uint32) or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous int32/uint32 tensor")
    if valid is not None and (valid.dtype != torch.bool or valid.shape != codes.shape
                              or not valid.is_contiguous()):
        raise ValueError("valid must be a contiguous bool tensor shaped like codes")


def gather13_plain(table, codes=None, valid=None, ascii=None, both=False):
    """Plain version of ``gather13``, same arguments and results."""
    if ascii is not None:
        code, valid = window_codes(ascii_to_base_codes(ascii), K13)
        code, valid = code.reshape(-1), valid.reshape(-1)
        idx = code
    else:
        idx = jax_index(codes)
        code = codes
    fwd = table_values(table, idx)
    if valid is not None:
        fwd = torch.where(valid, fwd, 0)
    if not both:
        return as_u32(fwd)
    rc = table_values(table, revcomp_code13(code))
    if valid is not None:
        rc = torch.where(valid, rc, 0)
    return as_u32(fwd), as_u32(rc)


def gather13(table: torch.Tensor, codes: torch.Tensor | None = None,
             valid: torch.Tensor | None = None, ascii: torch.Tensor | None = None,
             both: bool = False):
    """uint32 lookups of 13-mers in ``table`` (uint8/16/32[4^13]).

    Queries are either ``codes`` (int32/uint32 of any shape, optionally
    masked by a bool ``valid`` of the same shape) or ``ascii`` rows
    (uint8[B, 13], invalid where a byte is not ACGT/acgt). Invalid queries
    give 0. Returns the forward lookups shaped like the codes (``[B]`` for
    ASCII), or with ``both`` the pair (forward, reverse complement).

    A CPU tensor runs the plain version; a CUDA tensor launches K3."""
    _check(table, codes, valid, ascii)
    query = ascii if ascii is not None else codes
    extra = (valid,) if valid is not None else ()
    if not _cuda.on_cuda(table, query, *extra):
        return gather13_plain(table, codes, valid, ascii, both)
    shape = (ascii.shape[0],) if ascii is not None else tuple(codes.shape)
    out = torch.empty(shape, dtype=torch.int32, device=table.device)
    out_rc = torch.empty_like(out) if both else None
    if out.numel():
        with torch.cuda.device(table.device):
            KERNEL.launch(
                table.data_ptr(), WIDTHS[table.dtype],
                None if codes is None else codes.data_ptr(),
                None if valid is None else valid.data_ptr(),
                None if ascii is None else ascii.data_ptr(),
                out.numel(), out.data_ptr(),
                None if out_rc is None else out_rc.data_ptr(),
                _cuda.stream(table.device))
    if both:
        return out.view(torch.uint32), out_rc.view(torch.uint32)
    return out.view(torch.uint32)

