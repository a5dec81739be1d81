"""The dense count kernels and the device zero fill.

Counterparts of aindex_tpu/kernels/count.py, each adding into a uint32
count table:

* ``count13_packed`` (K1, ``csrc/count13.cu``) replaces
  ``count_batch_13_packed`` (:69): packed ingest chunks' 13-mers added into
  a table, on K15's partition; ``PackedCounter`` gathers a build's chunks
  into one buffer and counts them at once, so the table is swept once a
  build and not once a chunk;
* ``scatter_count`` (K15, same source) replaces ``scatter_count`` (:31):
  given codes under a valid mask, into a fresh table: the codes are
  partitioned into bins of 2^15 table entries, and each bin is counted in
  shared memory and written once (the source's notes);
* ``count_batch_13`` (K16 ``count13_rows``, same source) replaces
  ``count_batch_13`` (:54): the forward k-mers (k <= 16) of ASCII rows,
  one add a valid window, made by every block in order of the table's
  slices, so the blocks sweep a table larger than L2 together (a table L2
  holds takes the adds straight from the rows);
* ``zeros_dev`` (:23) is a device memset (``torch.zeros`` on the device),
  as XLA lowers ``jnp.zeros`` under jit: no kernel of its own.

``count13_packed_plain``, ``scatter_count_plain`` and
``count_batch_13_plain`` are the plain PyTorch versions. Unlike the JAX
functions, which return a new table, K1 and K16 and their plain versions
add into ``counts`` in place: the table is 256 MB and has one owner.

K15 and K16 index as JAX's ``counts.at[code.astype(int32)].add(w,
mode="drop")``: the code's int32 value, plus the table length if negative,
and dropped if it then lies outside the table.
"""

from __future__ import annotations

import torch

from aindex_torch.constants import K13, SPACE_13
from aindex_torch.kernels import _cuda
from aindex_torch.kernels.encode import (as_unsigned, ascii_to_base_codes, check_packed,
                                         int32_value, packed_window_codes, window_codes)

KERNEL = _cuda.KERNELS["count13_packed"]
KERNEL_SCATTER = _cuda.KERNELS["scatter_count"]
KERNEL_ROWS = _cuda.KERNELS["count13_rows"]

#: the kernels index tables with int32
_SPACE_LIMIT = 1 << 31
#: K15's partition (csrc/count13.cu, namespace bins): table entries a bin,
#: bins a round, codes a piece, and the ranges of a piece (at most
#: MAX_RANGES, of at least MIN_RANGE codes)
BIN_W = 1 << 15
MAX_BINS = 1 << 13
PIECE = 1 << 27
MAX_RANGES, MIN_RANGE = 128, 1 << 14

#: windows a plain count takes at once: a CPU ``PackedCounter`` counts
#: when more would come (bounds the plain version's int64 temporaries)
PLAIN_PIECE = 1 << 22

#: the signed dtype of each unsigned one (PyTorch's bare unsigned dtypes
#: take views and copies, not fills)
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def _check_table(counts: torch.Tensor) -> None:
    if counts.dtype not in (torch.int32, torch.uint32) or counts.shape != (SPACE_13,) \
            or not counts.is_contiguous():
        raise ValueError(f"counts must be a contiguous int32/uint32[{SPACE_13}] "
                         f"table, got {counts.dtype}{tuple(counts.shape)}")


def count13_packed_plain(counts: torch.Tensor, packed: torch.Tensor,
                         vbits: torch.Tensor) -> torch.Tensor:
    """Plain version: every valid window adds 1 at its code (int32, so the
    sum wraps modulo 2^32 as uint32 does)."""
    codes, valid = packed_window_codes(packed, vbits, K13)
    hits = codes[valid]
    counts.view(torch.int32).index_add_(
        0, hits, torch.ones(hits.numel(), dtype=torch.int32, device=counts.device))
    return counts


def _windows(n_words: int) -> int:
    """Window positions of ``n_words`` packed words (the kernel's n)."""
    return 16 * n_words - (K13 - 1)


def _count_buffer(counts: torch.Tensor, packed: torch.Tensor, vbits: torch.Tensor) -> None:
    """Add every valid window of one packed buffer into ``counts``: the
    plain version on the CPU, K1 on the card."""
    if not _cuda.on_cuda(counts, packed, vbits):
        count13_packed_plain(counts, packed, vbits)
        return
    dev = counts.device
    if vbits.data_ptr() % 2:     # K1 reads the validity bits 16 at a time
        vbits = vbits.clone()
    scratch = torch.empty(max(8, scatter_scratch_bytes(_windows(packed.numel()), SPACE_13)),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        KERNEL.launch(counts.data_ptr(), packed.data_ptr(), vbits.data_ptr(), packed.numel(),
                      scratch.data_ptr(), _cuda.stream(dev))


class PackedCounter:
    """Counts the 13-mer windows of a build's packed chunks into one table.

    ``add`` copies a chunk's words and validity bytes (0.375 bytes a base)
    into a buffer on the table's device, after one word whose validity bits
    are all 0, so no window crosses from one chunk into the next. The
    buffer holds one piece: ``PIECE`` (K15's 2^27) window positions on the
    card, ``PLAIN_PIECE`` on the CPU, read when the counter is made, and is
    allocated at the first ``add``. ``finish`` counts the buffer into
    ``counts`` in one K1 call (its plain version on the CPU) and empties it;
    ``add`` also counts first when the chunk would take the buffer past the
    piece, and counts a chunk larger than a piece by itself, without the
    copy. The table holds the sum of the chunks' counts, wrapping modulo
    2^32, after ``finish`` only."""

    def __init__(self, counts: torch.Tensor):
        _check_table(counts)
        self.counts = counts
        self.piece = PIECE if _cuda.on_cuda(counts) else PLAIN_PIECE
        self._packed = self._vbits = None
        self._words = 0

    def add(self, packed: torch.Tensor, vbits: torch.Tensor) -> None:
        """Take one packed chunk (``codec.pack_ascii_chunk``): int32/uint32[W]
        words and uint8[2W] validity bits on the table's device. On the card
        the copy is queued on the current stream: the caller may write the
        chunk's tensors again only in that stream's order after this call
        (or after an event recorded on it)."""
        check_packed(packed, vbits)
        _cuda.on_cuda(self.counts, packed, vbits)
        n = packed.numel()
        if not n:
            return
        if self._words and _windows(self._words + 1 + n) > self.piece:
            self.finish()
        if _windows(n) > self.piece:
            _count_buffer(self.counts, packed, vbits)
            return
        if self._packed is None:
            words = (self.piece + K13 - 1) // 16
            self._packed = torch.empty(words, dtype=torch.int32, device=self.counts.device)
            self._vbits = torch.empty(2 * words, dtype=torch.uint8, device=self.counts.device)
        at = self._words + (1 if self._words else 0)
        self._packed[self._words:at] = 0               # the separator word
        self._vbits[2 * self._words:2 * at] = 0
        self._packed[at:at + n] = packed.view(torch.int32)
        self._vbits[2 * at:2 * (at + n)] = vbits
        self._words = at + n

    def finish(self) -> torch.Tensor:
        """Count the buffered chunks into the table; returns the table."""
        if self._words:
            _count_buffer(self.counts, self._packed[:self._words],
                          self._vbits[:2 * self._words])
            self._words = 0
        return self.counts


def count13_packed(counts: torch.Tensor, packed: torch.Tensor,
                   vbits: torch.Tensor) -> torch.Tensor:
    """Add every valid 13-mer window of a packed chunk (uint32[W] words,
    uint8[2W] validity bits, ``codec.pack_ascii_chunk``) into ``counts``
    (uint32 or int32 storage of uint32[4^13]); returns ``counts``: a
    ``PackedCounter`` of one chunk, counted without the copy.

    A CPU tensor runs the plain version; a CUDA tensor launches K1."""
    _check_table(counts)
    check_packed(packed, vbits)
    _cuda.on_cuda(counts, packed, vbits)
    if packed.numel():
        _count_buffer(counts, packed, vbits)
    return counts


def zeros_dev(shape, dtype=torch.uint32, *, device="cuda") -> torch.Tensor:
    """Zeros of ``shape`` and ``dtype`` allocated on ``device``
    (aindex_tpu/kernels/count.py:23): a device memset, never a host buffer
    copied over. Unsigned dtypes are filled through their signed view."""
    from aindex_torch.index.common import resolve_device
    signed = _SIGNED.get(dtype)
    out = torch.zeros(shape, dtype=signed or dtype, device=resolve_device(device))
    return out.view(dtype) if signed is not None else out


def _scatter_add_plain(counts: torch.Tensor, codes: torch.Tensor, weights: torch.Tensor,
                       space: int) -> torch.Tensor:
    """``counts.at[int32(codes)].add(weights, mode="drop")`` in place on
    int32 storage; codes are int64 unsigned values below 2^32."""
    idx = int32_value(codes)
    idx = torch.where(idx < 0, idx + space, idx)
    keep = (idx >= 0) & (idx < space) & (weights != 0)
    counts.view(torch.int32).index_add_(0, idx[keep], weights[keep].to(torch.int32))
    return counts


def _check_space(space: int) -> None:
    if not 1 <= space < _SPACE_LIMIT:
        raise ValueError(f"space {space} outside 1 .. 2^31 - 1")


def scatter_count_plain(codes: torch.Tensor, valid: torch.Tensor,
                        space: int = SPACE_13) -> torch.Tensor:
    """Plain version of ``scatter_count``, same arguments and result."""
    counts = torch.zeros(space, dtype=torch.int32, device=codes.device)
    _scatter_add_plain(counts, as_unsigned(codes.reshape(-1)),
                       valid.reshape(-1).view(torch.uint8).to(torch.int64), space)
    return counts.view(torch.uint32)


def scatter_scratch_bytes(n: int, space: int) -> int:
    """Bytes of K15's scratch for ``n`` codes into ``space`` entries
    (csrc/count13.cu ``bins::carve``): none without a partition (space <=
    BIN_W); else, for a piece of min(n, PIECE) codes in ranges and a round
    of nb bins, a 4-byte record a code, a count (then prefix) per (range,
    bin), and each bin's total and start, all uint32."""
    if n <= 0 or space <= BIN_W:
        return 0
    piece = min(n, PIECE)
    nb = min(MAX_BINS, -(-space // BIN_W))
    return 4 * (piece + min(MAX_RANGES, -(-piece // MIN_RANGE)) * nb + 2 * nb + 1)


def scatter_count(codes: torch.Tensor, valid: torch.Tensor,
                  space: int = SPACE_13) -> torch.Tensor:
    """Dense histogram of codes (aindex_tpu/kernels/count.py:31): a fresh
    uint32[space] table in which each code adds its ``valid`` value (1 for
    True; a uint8 weight adds itself) at its JAX scatter index (see the
    module docstring). ``codes``: int32/uint32 (uint32 bit patterns) of any
    shape; ``valid``: bool or uint8 of the same shape. As in JAX, the table
    is uint32 only.

    A CPU tensor runs the plain version; a CUDA tensor launches K15."""
    if codes.dtype not in (torch.int32, torch.uint32) or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous int32/uint32 tensor")
    if valid.dtype not in (torch.bool, torch.uint8) or valid.shape != codes.shape \
            or not valid.is_contiguous():
        raise ValueError("valid must be a contiguous bool/uint8 tensor shaped like codes")
    _check_space(space)
    if not _cuda.on_cuda(codes, valid):
        return scatter_count_plain(codes, valid, space)
    dev = codes.device
    n = codes.numel()
    if not n:
        return zeros_dev(space, torch.uint32, device=dev)
    counts = torch.empty(space, dtype=torch.int32, device=dev)   # K15 writes every entry
    scratch = torch.empty(max(8, scatter_scratch_bytes(n, space)), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        KERNEL_SCATTER.launch(counts.data_ptr(), codes.data_ptr(), valid.data_ptr(), n, space,
                              scratch.data_ptr(), _cuda.stream(dev))
    return counts.view(torch.uint32)


def _check_rows(counts: torch.Tensor, ascii_batch: torch.Tensor, k: int, space: int) -> None:
    if counts.dtype not in (torch.int32, torch.uint32) or counts.shape != (space,) \
            or not counts.is_contiguous():
        raise ValueError(f"counts must be a contiguous int32/uint32[{space}] table, got "
                         f"{counts.dtype}{tuple(counts.shape)}")
    if ascii_batch.dtype != torch.uint8 or ascii_batch.dim() < 1 \
            or not ascii_batch.is_contiguous():
        raise ValueError("ascii_batch must be a contiguous uint8 [..., L] tensor")
    if not 1 <= k <= 16:
        raise ValueError(f"k={k} outside 1..16 (codes are uint32)")
    _check_space(space)
    if ascii_batch.shape[-1] < k:
        raise ValueError(f"sequence length {ascii_batch.shape[-1]} shorter than k={k}")


def count_batch_13_plain(counts: torch.Tensor, ascii_batch: torch.Tensor, k: int = K13,
                         space: int = SPACE_13) -> torch.Tensor:
    """Plain version of ``count_batch_13``, same arguments and result."""
    codes, valid = window_codes(ascii_to_base_codes(ascii_batch), k)
    return _scatter_add_plain(counts, codes.reshape(-1), valid.reshape(-1).to(torch.int64),
                              space)


def count_batch_13(counts: torch.Tensor, ascii_batch: torch.Tensor, k: int = K13,
                   space: int = SPACE_13) -> torch.Tensor:
    """Add the forward k-mer windows (k <= 16) of ASCII rows into
    ``counts`` (uint32 or int32 storage of uint32[space]) in place; returns
    ``counts`` (aindex_tpu/kernels/count.py:54).

    ``ascii_batch`` is uint8 [..., L]: each row's L - k + 1 windows, those
    with a byte outside ACGT/acgt (newlines, N, padding) left out, so rows
    may be padded with any such byte. Codes index as JAX's scatter does
    (module docstring): at k < 13 every code fits the 4^13 table, at larger
    k with a smaller ``space`` the codes beyond it drop.

    A CPU tensor runs the plain version; a CUDA tensor launches K16."""
    _check_rows(counts, ascii_batch, k, space)
    if not _cuda.on_cuda(counts, ascii_batch):
        return count_batch_13_plain(counts, ascii_batch, k, space)
    length = ascii_batch.shape[-1]
    rows = ascii_batch.numel() // length
    if rows:
        with torch.cuda.device(counts.device):
            KERNEL_ROWS.launch(counts.data_ptr(), ascii_batch.data_ptr(), rows, length, k,
                               space, _cuda.stream(counts.device))
    return counts
