"""K8 and K9: the device steps of the positional index's build.

Counterparts of aindex_tpu/index/positional.py's jitted functions:

* ``csr_offsets`` (kernel ``csrc/csr.cu``, K8) replaces ``_csr_offsets``
  (:39): the exclusive int64 prefix sum of a uint32 per-slot table;
* ``posfill`` (kernel ``csrc/posfill.cu``, K9) replaces ``_scatter_chunk``
  (:47, :77) with the window -> slot step of its callers fused in: it
  takes one packed chunk, computes each window's slot (dense: the forward
  code; sparse: the verified canonical slot of the quotient cuckoo table)
  and places the chunk's occurrences into their final CSR cells.

``csr_offsets_plain``, ``scatter_chunk_plain`` (same arguments as JAX's
``_scatter_chunk``) and ``chunk_slots_plain`` are the plain PyTorch
versions. Offsets and positions are int64 tensors (JAX's uint64 positions
never reach 2^63); the cursor is int32, as JAX's. ``posfill`` and
``scatter_chunk_plain`` update ``positions`` and ``cursor`` in place, where
JAX donates and replaces them.
"""

from __future__ import annotations

import torch

from aindex_torch.kernels import _cuda
from aindex_torch.kernels.encode import as_unsigned, check_packed, packed_window_codes
from aindex_torch.kernels.quot import QuotTables, _check_tables, quot23_plain
from aindex_torch.kernels.spectrum import INT32_LIMIT, SCAN_TILE, sort_scratch

KERNEL_CSR = _cuda.KERNELS["csr_offsets"]
KERNEL_FILL = _cuda.KERNELS["posfill"]


# -- K8 -----------------------------------------------------------------------

def csr_offsets_plain(tf: torch.Tensor) -> torch.Tensor:
    """Plain version of ``csr_offsets``: ``torch.cumsum`` in int64 with a
    leading zero."""
    c = torch.cumsum(as_unsigned(tf), 0)
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=tf.device), c])


def csr_offsets(tf: torch.Tensor) -> torch.Tensor:
    """int64[n + 1] CSR offsets of a 1-D uint32 (or int32 storage of
    uint32) per-slot occurrence table: offsets[0] = 0, offsets[i + 1] =
    offsets[i] + tf[i] (aindex_tpu/index/positional.py:39 ``_csr_offsets``).

    A CPU tensor runs the plain version; a CUDA tensor launches K8."""
    if tf.dtype not in (torch.int32, torch.uint32) or tf.dim() != 1 or not tf.is_contiguous():
        raise ValueError("tf must be a contiguous 1-D uint32 tensor")
    if not _cuda.on_cuda(tf):
        return csr_offsets_plain(tf)
    dev = tf.device
    n = tf.numel()
    out = torch.empty(n + 1, dtype=torch.int64, device=dev)
    sums = torch.empty(max(1, -(-n // SCAN_TILE)), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        KERNEL_CSR.launch(tf.data_ptr(), n, out.data_ptr(), sums.data_ptr(), _cuda.stream(dev))
    return out


# -- K9 -----------------------------------------------------------------------

def scatter_chunk_plain(positions: torch.Tensor, cursor: torch.Tensor,
                        offsets: torch.Tensor, slots: torch.Tensor, pos: torch.Tensor,
                        valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Place one chunk's (slot, position) occurrences into their final CSR
    cells, as aindex_tpu's ``_scatter_chunk`` does: a stable sort by slot,
    each occurrence's rank in its slot's run, ``pos + 1`` written at
    ``offsets[slot] + cursor[slot] + rank`` (cells outside ``positions``
    dropped), then ``cursor`` advanced by the runs' lengths (int32, wrapping).

    positions int64[total], cursor int32[n_slots], offsets int64[n_slots],
    slots int64[n], pos int64[n], valid bool[n]; ``positions`` and
    ``cursor`` are updated in place and returned."""
    n_slots = cursor.shape[0]
    key = torch.where(valid, slots, n_slots)
    order = torch.argsort(key, stable=True)      # pos ascending within a slot
    s = key[order]
    p = pos[order]
    first = torch.searchsorted(s, s, side="left")
    rank = torch.arange(s.shape[0], dtype=torch.int64, device=s.device) - first
    live = s < n_slots
    safe = torch.where(live, s, 0)
    out_idx = offsets[safe] + cursor[safe].to(torch.int64) + rank
    keep = live & (out_idx >= 0) & (out_idx < positions.shape[0])
    positions[out_idx[keep]] = p[keep] + 1
    cursor.index_add_(0, safe, live.to(cursor.dtype))
    return positions, cursor


def chunk_slots_plain(packed: torch.Tensor, vbits: torch.Tensor, k: int,
                      tables: QuotTables | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot int64, valid bool) of every window of a packed chunk: the
    forward code of a valid window (dense, ``tables`` None), or the
    verified canonical slot of the quotient cuckoo table, valid when the
    k-mer is present (sparse)."""
    codes, valid = packed_window_codes(packed, vbits, k)
    if tables is None:
        return codes, valid
    _, slot = quot23_plain(tables, codes, valid, k=k, slot=True)
    slot = slot.to(torch.int64)
    return slot, slot >= 0


def fill_scratch(n_win: int, device) -> tuple[torch.Tensor, ...]:
    """K9's scratch for chunks of up to ``n_win`` windows: (counters,
    keys_a, keys_b, idx, hist, sums). A build allocates it once and passes
    it to every ``posfill`` call."""
    n_hist, n_sums = sort_scratch(n_win)

    def ints(n):
        return torch.empty(n, dtype=torch.int32, device=device)

    return (ints(1), torch.empty(n_win, dtype=torch.int64, device=device),
            torch.empty(n_win, dtype=torch.int64, device=device), ints(n_win + 1),
            ints(n_hist), ints(n_sums))


def _bits(n: int) -> int:
    """Bits that hold 0 .. n - 1 (at least one)."""
    return max(1, (n - 1).bit_length())


def posfill(positions: torch.Tensor, cursor: torch.Tensor, offsets: torch.Tensor,
            packed: torch.Tensor, vbits: torch.Tensor, k: int, off: int,
            tables: QuotTables | None = None,
            scratch: tuple[torch.Tensor, ...] | None = None) -> None:
    """Fill one packed chunk's occurrences into the CSR: every valid window
    i, at blob position ``off + i``, with slot s (the forward code of a
    k <= 16 window when ``tables`` is None; the verified canonical slot of
    the quotient cuckoo table ``tables`` otherwise, absent windows dropped)
    writes ``off + i + 1`` to ``positions[offsets[s] + cursor[s] + rank]``,
    rank being its order among the chunk's windows of slot s; then
    ``cursor`` advances. The counterpart of aindex_tpu's ``_scatter_chunk``
    over its callers' (slots, pos0, valid) chunks.

    positions int64[total] and cursor int32[n_slots] are updated in place;
    offsets int64[n_slots] (the CSR offsets without their last entry);
    ``scratch`` (``fill_scratch``) is allocated per call when not given.

    A CPU tensor runs the plain version; a CUDA tensor launches K9."""
    check_packed(packed, vbits)
    for name, t, dtype in (("positions", positions, torch.int64),
                           ("cursor", cursor, torch.int32), ("offsets", offsets, torch.int64)):
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor")
    n_slots = cursor.numel()
    if offsets.numel() != n_slots or n_slots == 0:
        raise ValueError(f"offsets ({offsets.numel()}) and cursor ({n_slots}) must hold "
                         "one entry per slot, at least one")
    if tables is None:
        if not 1 <= k <= 16 or n_slots != 4 ** k:
            raise ValueError(f"dense fill takes k <= 16 and 4^k slots, got k={k}, "
                             f"{n_slots} slots")
    else:
        _check_tables(tables)
        if not 1 <= k <= 31 or 2 * k != tables.w:
            raise ValueError(f"k={k} does not match the table's code width w={tables.w}")
    n_win = 16 * packed.numel() - k + 1
    if not 0 < n_win < INT32_LIMIT:
        raise ValueError(f"a chunk of {16 * packed.numel()} bases gives {n_win} windows "
                         f"of k={k}; the kernel takes 1 .. 2^31 - 2")
    slot_bits, idx_bits = _bits(n_slots), _bits(n_win)
    if slot_bits + idx_bits > 64:
        raise ValueError(f"{slot_bits} slot bits + {idx_bits} window bits exceed the "
                         "64-bit sort key")
    extra = () if tables is None else (tables.half0, tables.half1, tables.slot0, tables.slot1)
    if not _cuda.on_cuda(positions, cursor, offsets, packed, vbits, *extra):
        slots, valid = chunk_slots_plain(packed, vbits, k, tables)
        pos = torch.arange(slots.numel(), dtype=torch.int64, device=slots.device) + off
        scatter_chunk_plain(positions, cursor, offsets, slots, pos, valid)
        return
    dev = positions.device
    if scratch is None:
        scratch = fill_scratch(n_win, dev)
    counters, keys_a, keys_b, idx, hist, sums = scratch
    n_hist, n_sums = sort_scratch(n_win)
    if keys_a.numel() < n_win or idx.numel() < n_win + 1 or hist.numel() < n_hist \
            or sums.numel() < n_sums:
        raise ValueError(f"scratch too small for {n_win} windows")
    if tables is None:
        table_args = (None, None, None, None, 0, 0, 0, 0, 0, 0, 0)
    else:
        table_args = (tables.half0.data_ptr(), tables.half1.data_ptr(),
                      tables.slot0.data_ptr(), tables.slot1.data_ptr(), *tables.args())
    with torch.cuda.device(dev):
        KERNEL_FILL.launch(
            packed.data_ptr(), vbits.data_ptr(), packed.numel(), k, off, *table_args,
            n_slots, slot_bits, idx_bits, offsets.data_ptr(), cursor.data_ptr(),
            positions.data_ptr(), positions.numel(), *(t.data_ptr() for t in scratch),
            _cuda.stream(dev))
