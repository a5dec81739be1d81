"""Plain PyTorch encoding, window extraction and reverse complements.

Counterparts of aindex_tpu/kernels/encode.py. On the device these steps run
inside the CUDA kernels (``csrc/dna13.cuh``: ``ascii_code``,
``packed_window``, ``revcomp13``, ``half_index``; ``csrc/dna23.cuh``:
``revcomp64``, ``canonical64``, ``packed_window64``); the functions here are the plain
versions that the kernels' plain twins are built from, and they run on any
device.

CPU PyTorch has no ``>>`` on uint32 and few uint32 ops at all, so codes are
carried as int64 (a k <= 16 code fits in 32 bits) and packed words, which
may arrive as int32 or uint32 storage of the same bits, are widened to
int64 and masked to their unsigned value first. 64-bit codes (k <= 31) are
int64 holding uint64 bit patterns: every right shift is masked, since
``>>`` on int64 sign-extends.
"""

from __future__ import annotations

import torch

from aindex_torch.constants import INVALID_CODE

_U32 = 0xFFFFFFFF


def as_unsigned(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor holding uint32 bit patterns -> int64 unsigned values.
    A uint32 tensor is read through its int32 view: PyTorch's bare unsigned
    dtypes support views and copies but few operators."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & _U32


def int32_value(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 value of the same bits, as
    int64 (what JAX's ``astype(int32)`` of a uint32 gives)."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u)


def table_values(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` as int64 for a uint8/uint16/uint32 table, gathered
    through the signed view of the same width and masked back."""
    if table.dtype == torch.uint8:
        return table[idx].to(torch.int64)
    signed = table.view(torch.int16 if table.dtype == torch.uint16 else torch.int32)
    return signed[idx].to(torch.int64) & ((1 << (8 * signed.element_size())) - 1)


def check_packed(packed: torch.Tensor, vbits: torch.Tensor) -> None:
    """Raise unless (packed, vbits) is one 1-D packed ingest chunk
    (``codec.pack_ascii_chunk``) as the kernels take it."""
    if packed.dtype not in (torch.int32, torch.uint32) or packed.dim() != 1 \
            or not packed.is_contiguous():
        raise ValueError("packed must be a contiguous 1-D int32/uint32 tensor")
    if vbits.dtype != torch.uint8 or vbits.shape != (2 * packed.numel(),) \
            or not vbits.is_contiguous():
        raise ValueError("vbits must be a contiguous uint8 tensor of "
                         "2 * packed.numel() bytes")


def ascii_to_base_codes(ascii_u8: torch.Tensor) -> torch.Tensor:
    """uint8 ASCII -> uint8 2-bit base codes, INVALID_CODE for non-ACGT
    (case-insensitive; ``x ^ (x >> 1)`` of bits 1-2 as in aindex_tpu)."""
    up = ascii_u8 & 0xDF
    valid = (up == 65) | (up == 67) | (up == 71) | (up == 84)
    x = (ascii_u8 >> 1) & 3
    code = x ^ (x >> 1)
    return torch.where(valid, code, torch.full_like(code, INVALID_CODE))


def unpack_base_codes(packed: torch.Tensor, validbits: torch.Tensor) -> torch.Tensor:
    """Packed ingest (codec.pack_ascii_chunk: uint32[..., W] words of 16
    bases, uint8[..., 2W] validity bits, both little-endian) -> uint8[...,
    16W] base codes with INVALID_CODE where the bit is clear."""
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=packed.device)
    b = ((as_unsigned(packed)[..., :, None] >> shifts) & 3).to(torch.uint8)
    b = b.reshape(*packed.shape[:-1], -1)
    bit = torch.arange(8, dtype=torch.uint8, device=validbits.device)
    v = (validbits[..., :, None] >> bit) & 1
    v = v.reshape(*validbits.shape[:-1], -1).to(torch.bool)
    return torch.where(v, b, torch.full_like(b, INVALID_CODE))


def window_codes(base_codes: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes, valid) of every k-window of uint8[..., L] base codes: k
    shift-or steps, and a prefix-sum difference that marks a window valid
    when none of its bases is INVALID_CODE. codes are int64[..., L-k+1]."""
    L = base_codes.shape[-1]
    n_win = L - k + 1
    if n_win <= 0:
        raise ValueError(f"sequence length {L} shorter than k={k}")
    invalid = (base_codes >= 4).to(torch.int32)
    csum = torch.cumsum(invalid, dim=-1, dtype=torch.int32)
    csum = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
    valid = (csum[..., k:] - csum[..., :-k]) == 0
    b = (base_codes & 3).to(torch.int64)
    acc = b[..., :n_win]
    for j in range(1, k):
        acc = (acc << 2) | b[..., j:j + n_win]
    return acc, valid


def packed_window_codes(packed: torch.Tensor, validbits: torch.Tensor,
                        k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``window_codes`` over the packed ingest format."""
    return window_codes(unpack_base_codes(packed, validbits), k)


def revcomp_code13(codes: torch.Tensor, k: int = 13) -> torch.Tensor:
    """Reverse complement of <=16-mer codes held in 32 bits -> int64.

    Complement every 2-bit field, mirror the 16 fields of the 32-bit word,
    shift down to the low 2k bits; each step is masked to 32 bits, so any
    uint32 bit pattern gives aindex_tpu's result."""
    x = as_unsigned(codes) ^ _U32
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    x = ((x >> 16) | (x << 16)) & _U32
    return x >> (32 - 2 * k)


#: bit 13 of a 13-mer code: the high bit of its middle base
_MID_HIGH = 1 << 13


def half_index13(codes: torch.Tensor) -> torch.Tensor:
    """Slot of each 13-mer code (int64 in [0, 4^13)) in the half total
    table (``csrc/dna13.cuh`` ``half_index``): of the code and its reverse
    complement, the one whose middle base is A or C (bit 13 clear; for odd
    k exactly one of the two), with that bit dropped -> int64 in [0, 2^25)."""
    c = torch.where((codes & _MID_HIGH) != 0, revcomp_code13(codes), codes)
    return ((c >> 14) << 13) | (c & (_MID_HIGH - 1))


def half_code13(slots: torch.Tensor) -> torch.Tensor:
    """The code with bit 13 clear that ``half_index13`` maps to each slot
    (int64 in [0, 2^25)) -> int64 code."""
    return ((slots >> 13) << 14) | (slots & (_MID_HIGH - 1))


_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_M8 = 0x00FF00FF00FF00FF
_M16 = 0x0000FFFF0000FFFF


def revcomp_code64(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of <=32-mer codes held in 64 bits
    (aindex_tpu/kernels/encode.py:125): complement every 2-bit field,
    mirror the 32 fields of the word, shift down to the low 2k bits.

    ``codes`` is int64 holding uint64 bit patterns; the result depends only
    on their low 2k bits and is below 4^k. Each right shift is masked, so
    the sign bits an int64 shift brings in never reach the result."""
    x = ~codes.to(torch.int64)
    x = ((x >> 2) & _M2) | ((x & _M2) << 2)
    x = ((x >> 4) & _M4) | ((x & _M4) << 4)
    x = ((x >> 8) & _M8) | ((x & _M8) << 8)
    x = ((x >> 16) & _M16) | ((x & _M16) << 16)
    x = ((x >> 32) & _U32) | (x << 32)
    return (x >> (64 - 2 * k)) & ((1 << (2 * k)) - 1 if k < 32 else -1)


def u64_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a <= b`` as uint64 for int64 tensors whose ``b`` is non-negative:
    a negative ``a`` is at least 2^63 unsigned, so never below ``b``."""
    return (a >= 0) & (a <= b)


def canonical_code64(codes: torch.Tensor, k: int) -> torch.Tensor:
    """min(code, revcomp) as uint64 (aindex_tpu/kernels/encode.py:141) on
    int64 storage, for k <= 31 (the revcomp is then non-negative)."""
    codes = codes.to(torch.int64)
    rc = revcomp_code64(codes, k)
    return torch.where(u64_le(codes, rc), codes, rc)
