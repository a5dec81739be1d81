"""K8 and K9: the device steps of the positional index's build.

Counterparts of aindex_tpu/index/positional.py's jitted functions:

* ``csr_offsets`` (kernel ``csrc/csr.cu``, K8) replaces ``_csr_offsets``
  (:39): the exclusive int64 prefix sum of a uint32 per-slot table;
* ``posfill`` (kernel ``csrc/posfill.cu``, K9, or the fill entries of K10
  and K11 on the wide cuckoo and MPHF engines) replaces ``_scatter_chunk``
  (:47, :77) with the window -> slot step of its callers fused in: it
  takes one packed chunk, computes each window's slot (dense: the forward
  code; sparse: the verified slot of the index's engine under its query
  rule) and places the chunk's occurrences into their final CSR cells.

The mesh build (``parallel/positional.py``) adds two more:

* ``posbucket`` (kernel ``csrc/posbucket.cu``, K14) replaces the send side
  of aindex_tpu/parallel/positional.py:133-172 ``local_alltoall``: each
  window's slot, its destination shard, its rank among the chunk's windows
  of that destination, and the packed record ((slot + 1) << 24) | window
  in a fixed-capacity bucket per destination, with the overflow count;
* ``posfill_pairs`` (K9's pairs-in entry, ``csrc/posfill.cu``) fills a
  shard's slot range from the records it receives (alltoall) or the slots
  it gathers (allgather), in (source, window) order.

``csr_offsets_plain``, ``scatter_chunk_plain`` (same arguments as JAX's
``_scatter_chunk``), ``chunk_slots_plain``, ``posbucket_plain`` and
``posfill_pairs_plain`` are the plain PyTorch versions. Offsets and positions are int64 tensors (JAX's uint64 positions
never reach 2^63); the cursor is int32, as JAX's. ``posfill`` and
``scatter_chunk_plain`` update ``positions`` and ``cursor`` in place, where
JAX donates and replaces them.
"""

from __future__ import annotations

import torch

from aindex_torch.kernels import _cuda, probe
from aindex_torch.kernels.encode import as_unsigned, check_packed, packed_window_codes
from aindex_torch.kernels.probe import CANON
from aindex_torch.kernels.spectrum import (INT32_LIMIT, ONESWEEP_TILE, onesweep_scratch,
                                           sort_passes)

KERNEL_CSR = _cuda.KERNELS["csr_offsets"]
KERNEL_FILL = _cuda.KERNELS["posfill"]
KERNEL_BUCKET = _cuda.KERNELS["posbucket"]
KERNEL_PAIRS = _cuda.KERNELS["posfill_pairs"]

#: in-chunk window offsets are packed into this many low bits of a record
DELTA_BITS = 24
#: posbucket's engine ids (csrc/posbucket.cu), by the engine's fill entry
_ENGINE = {"posfill": 1, "cuckoofill64": 1, "mphffill": 2}
#: K8 scans at most this many items a launch (csrc/csr.cu PIECE)
CSR_PIECE = 1 << 30
#: windows a tile of K14's pass (csrc/posbucket.cu: 256 threads, eight each)
BUCKET_TILE = 2048


# -- K8 -----------------------------------------------------------------------

def csr_offsets_plain(tf: torch.Tensor) -> torch.Tensor:
    """Plain version of ``csr_offsets``: ``torch.cumsum`` in int64 with a
    leading zero."""
    c = torch.cumsum(as_unsigned(tf), 0)
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=tf.device), c])


def csr_scratch_bytes(n: int) -> int:
    """Bytes of K8's scratch for a table of ``n`` slots: a tile counter word
    per launch (pieces of ``CSR_PIECE`` items), then a look-back word per
    tile of ``ONESWEEP_TILE`` items; csrc/csr.cu carves the same layout."""
    return 8 * (-(-n // CSR_PIECE) + -(-n // ONESWEEP_TILE))


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
    if tf.data_ptr() % 16:           # the kernel reads 16-byte vectors
        tf = tf.clone()
    out = torch.empty(n + 1, dtype=torch.int64, device=dev)
    scratch = torch.empty(max(8, csr_scratch_bytes(n)), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        KERNEL_CSR.launch(tf.data_ptr(), n, out.data_ptr(), scratch.data_ptr(),
                          _cuda.stream(dev))
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


def chunk_slots_plain(packed: torch.Tensor, vbits: torch.Tensor, k: int, tables=None,
                      rule: int = CANON) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot int64, valid bool) of every window of a packed chunk: the
    forward code of a valid window (dense, ``tables`` None), or the
    verified slot of the engine ``tables`` under ``rule``, valid when the
    k-mer is present (sparse)."""
    codes, valid = packed_window_codes(packed, vbits, k)
    if tables is None:
        return codes, valid
    _, slot = probe.query_plain(tables, codes, valid, k=k, rule=rule, slot=True)
    slot = slot.to(torch.int64)
    return slot, slot >= 0


def _bits(n: int) -> int:
    """Bits that hold 0 .. n - 1 (at least one)."""
    return max(1, (n - 1).bit_length())


def fill_scratch_bytes(n_win: int, n_slots: int) -> int:
    """Bytes of the fill's scratch (K9, the K10/K11 fill entries) for up to
    ``n_win`` windows (or records) of ``n_slots`` slots: the onesweep
    sort's, keys alone, one pass per 8 slot bits (csrc/fill.cuh
    sort_and_fill carves it)."""
    return onesweep_scratch(n_win, sort_passes(_bits(n_slots)), 0)


def fill_scratch(n_win: int, n_slots: int, device) -> torch.Tensor:
    """The fill's scratch for chunks of up to ``n_win`` windows (or records)
    of ``n_slots`` slots, one byte buffer. A build allocates it once and
    passes it to every ``posfill`` or ``posfill_pairs`` call."""
    return torch.empty(fill_scratch_bytes(n_win, n_slots), dtype=torch.uint8, device=device)


def _check_fill_scratch(scratch: torch.Tensor, n: int, n_slots: int) -> None:
    if scratch.dtype != torch.uint8 or scratch.numel() < fill_scratch_bytes(n, n_slots):
        raise ValueError(f"scratch must be a uint8 tensor of at least "
                         f"{fill_scratch_bytes(n, n_slots)} bytes for {n} items of "
                         f"{n_slots} slots")


def posfill(positions: torch.Tensor, cursor: torch.Tensor, offsets: torch.Tensor,
            packed: torch.Tensor, vbits: torch.Tensor, k: int, off: int, tables=None,
            scratch: torch.Tensor | None = None, rule: int = CANON) -> None:
    """Fill one packed chunk's occurrences into the CSR: every valid window
    i, at blob position ``off + i``, with slot s (the forward code of a
    k <= 16 window when ``tables`` is None; otherwise the verified slot of
    the sparse engine ``tables`` (``kernels/probe.py``) under ``rule``,
    CANON or FWD_RC, absent windows dropped)
    writes ``off + i + 1`` to ``positions[offsets[s] + cursor[s] + rank]``,
    rank being its order among the chunk's windows of slot s; then
    ``cursor`` advances. The counterpart of aindex_tpu's ``_scatter_chunk``
    over its callers' (slots, pos0, valid) chunks.

    positions int64[total] and cursor int32[n_slots] are updated in place;
    offsets int64[n_slots] (the CSR offsets without their last entry);
    ``scratch`` (``fill_scratch(n_win, n_slots)``) is allocated per call
    when not given.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    engine's fill kernel (K9 dense or quotient, K10, K11)."""
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
        tables.check()
        tables.check_k(k)
        if rule not in (probe.CANON, probe.FWD_RC):
            raise ValueError(f"the sparse fill takes the CANON or FWD_RC rule, got {rule}")
    n_win = 16 * packed.numel() - k + 1
    if not 0 < n_win < INT32_LIMIT:
        raise ValueError(f"a chunk of {16 * packed.numel()} bases gives {n_win} windows "
                         f"of k={k}; the kernel takes 1 .. 2^31 - 2")
    slot_bits, idx_bits = _bits(n_slots), _bits(n_win)
    if slot_bits + idx_bits > 64:
        raise ValueError(f"{slot_bits} slot bits + {idx_bits} window bits exceed the "
                         "64-bit sort key")
    extra = () if tables is None else tables.tensors()
    if not _cuda.on_cuda(positions, cursor, offsets, packed, vbits, *extra):
        slots, valid = chunk_slots_plain(packed, vbits, k, tables, rule)
        pos = torch.arange(slots.numel(), dtype=torch.int64, device=slots.device) + off
        scatter_chunk_plain(positions, cursor, offsets, slots, pos, valid)
        return
    dev = positions.device
    if scratch is None:
        scratch = fill_scratch(n_win, n_slots, dev)
    _check_fill_scratch(scratch, n_win, n_slots)
    p, u = (None, None) if tables is None else probe.c_engine(tables)
    kernel = KERNEL_FILL if tables is None else _cuda.KERNELS[tables.FILL]
    with torch.cuda.device(dev):
        kernel.launch(
            p, u, packed.data_ptr(), vbits.data_ptr(), packed.numel(), k, off, rule,
            n_slots, slot_bits, idx_bits, offsets.data_ptr(), cursor.data_ptr(),
            positions.data_ptr(), positions.numel(), scratch.data_ptr(), _cuda.stream(dev))


# -- K14 and K9's pairs-in entry: the mesh build's exchange ------------------------

def posbucket_plain(packed, vbits, k: int, tables=None, rule: int = CANON, n_slots: int = 0,
                    m: int = 1, n_dest: int = 0, cap: int = 0):
    """Plain version of ``posbucket``, same arguments and results, the
    formulation of aindex_tpu's ``local_alltoall``: a stable argsort by
    destination and each window's rank from the start of its run."""
    slot, ok = chunk_slots_plain(packed, vbits, k, tables, rule)
    slot = torch.where(ok & (slot < n_slots), slot, -1)
    if not n_dest:
        return slot, None, torch.zeros((), dtype=torch.int32, device=slot.device)
    dest = torch.where(slot >= 0, slot // m, n_dest)
    order = torch.argsort(dest, stable=True)
    dest_s, slot_s = dest[order], slot[order]
    start = torch.searchsorted(dest_s, torch.arange(n_dest + 1, device=dest.device))
    rank = torch.arange(dest.numel(), device=dest.device) - start[dest_s]
    keep = (rank < cap) & (dest_s < n_dest)
    overflow = ((rank >= cap) & (dest_s < n_dest)).sum().to(torch.int32)
    buckets = torch.zeros((n_dest, cap), dtype=torch.int64, device=dest.device)
    buckets[dest_s[keep], rank[keep]] = ((slot_s[keep] + 1) << DELTA_BITS) | order[keep]
    return slot, buckets, overflow


def bucket_status_words(n_win: int, n_dest: int) -> int:
    """int64 words K14 takes behind the buckets for a chunk of ``n_win``
    windows: its tile counter, then a look-back status word per (tile of
    ``BUCKET_TILE`` windows, destination). One memset zeroes them with the
    buckets (csrc/posbucket.cu)."""
    return 1 + n_dest * -(-n_win // BUCKET_TILE)


def bucket_scratch(device) -> torch.Tensor:
    """K14's scratch: the counters int32[2] it writes (n_win, overflow). A
    build allocates it once and passes it to every ``posbucket`` call; the
    overflow ``posbucket`` returns is a view of it. (The look-back status
    words ride behind each call's buckets, ``bucket_status_words``.)"""
    return torch.empty(2, dtype=torch.int32, device=device)


def posbucket(packed: torch.Tensor, vbits: torch.Tensor, k: int, tables=None,
              rule: int = CANON, n_slots: int = 0, m: int = 1, n_dest: int = 0, cap: int = 0,
              scratch: torch.Tensor | None = None):
    """The send side of the positional exchange for one packed chunk.

    Every window's slot (the forward code of a k <= 16 window when
    ``tables`` is None, else the verified slot of the sparse engine under
    ``rule``; -1 when invalid, absent or not below ``n_slots``). With
    ``n_dest`` > 0, also the records ``((slot + 1) << 24) | window`` of the
    windows bound for each destination shard d (the slots of [d * m, (d +
    1) * m)), in window order, in ``buckets[d, :cap]``, zero past the end,
    and the count of windows that found their bucket full.

    Returns (slots int64[n_win], buckets int64[n_dest, cap] or None,
    overflow int32 scalar tensor). ``scratch`` (``bucket_scratch``) is
    allocated per call when not given. A CPU tensor runs the plain
    version; a CUDA tensor launches K14: one pass that probes, ranks each
    destination's windows by a look-back over the chunk's tiles and writes
    the records, after one memset of the buckets."""
    check_packed(packed, vbits)
    n_win = 16 * packed.numel() - k + 1
    if not 0 < n_win < INT32_LIMIT:
        raise ValueError(f"a chunk of {16 * packed.numel()} bases gives {n_win} windows "
                         f"of k={k}; the kernel takes 1 .. 2^31 - 2")
    if n_slots <= 0 or m <= 0:
        raise ValueError(f"n_slots {n_slots} and m {m} must be positive")
    if tables is None:
        if not 1 <= k <= 16:
            raise ValueError(f"the dense slot step takes k <= 16, got k={k}")
    else:
        tables.check()
        tables.check_k(k)
        if rule not in (probe.CANON, probe.FWD_RC):
            raise ValueError(f"the sparse slot step takes the CANON or FWD_RC rule, got {rule}")
    if n_dest and not (n_dest < 256 and cap > 0 and n_win <= 1 << DELTA_BITS
                       and n_slots < 1 << (63 - DELTA_BITS)):
        raise ValueError(f"buckets take 1..255 destinations, cap > 0, at most 2^{DELTA_BITS} "
                         f"windows and slots below 2^{63 - DELTA_BITS}; got {n_dest}, {cap}, "
                         f"{n_win}, {n_slots}")
    extra = () if tables is None else tables.tensors()
    if not _cuda.on_cuda(packed, vbits, *extra):
        return posbucket_plain(packed, vbits, k, tables, rule, n_slots, m, n_dest, cap)
    dev = packed.device
    counters = bucket_scratch(dev) if scratch is None else scratch
    if counters.dtype != torch.int32 or counters.numel() < 2 or counters.device != dev:
        raise ValueError("scratch must be bucket_scratch's int32[2] counters on the chunk's device")
    slots = torch.empty(n_win, dtype=torch.int64, device=dev)
    words = buckets = None
    if n_dest:
        # the buckets, then the pass's tile counter and status words: one memset
        words = torch.empty(n_dest * cap + bucket_status_words(n_win, n_dest), dtype=torch.int64,
                            device=dev)
        buckets = words[:n_dest * cap].view(n_dest, cap)
    p, u = (None, None) if tables is None else probe.c_engine(tables)
    with torch.cuda.device(dev):
        KERNEL_BUCKET.launch(
            0 if tables is None else _ENGINE[tables.FILL], p, u, rule, packed.data_ptr(),
            vbits.data_ptr(), packed.numel(), k, n_slots, m, n_dest, cap, slots.data_ptr(),
            None if words is None else words.data_ptr(), counters.data_ptr(), _cuda.stream(dev))
    return slots, buckets, counters[1]


def _pair_positions(rec: torch.Tensor, roff: torch.Tensor, packed: bool):
    """(slot int64, position int64) of every record of rec[n_src, cols]."""
    cols = rec.shape[1]
    if packed:
        slot = (rec >> DELTA_BITS) - 1
        delta = rec & ((1 << DELTA_BITS) - 1)
    else:
        slot = rec
        delta = torch.arange(cols, device=rec.device).expand_as(rec)
    return slot.reshape(-1), (roff[:, None] + delta).reshape(-1)


def posfill_pairs_plain(positions, cursor, offsets, rec, roff, lo: int, packed: bool = True):
    """Plain version of ``posfill_pairs``: ``scatter_chunk_plain`` over the
    records in (source, column) order, as aindex_tpu's ``_scatter_chunk``
    takes them."""
    slot, pos = _pair_positions(rec, roff, packed)
    local = slot - lo
    sel = (slot >= 0) & (local >= 0) & (local < cursor.numel())
    return scatter_chunk_plain(positions, cursor, offsets, local, pos, sel)


def posfill_pairs(positions: torch.Tensor, cursor: torch.Tensor, offsets: torch.Tensor,
                  rec: torch.Tensor, roff: torch.Tensor, lo: int, packed: bool = True,
                  scratch: torch.Tensor | None = None) -> None:
    """Fill a data shard's slot range [lo, lo + len(cursor)) of the CSR from
    the exchange's records ``rec`` (int64[n_src, cols], row r from source
    r, whose first window lies at blob position ``roff[r]``): packed
    records ((slot + 1) << 24) | window (``packed``), or the slot of every
    window in window order. Each record in the range writes its position +
    1 at ``offsets[s] + cursor[s] + rank``, rank counted in (source,
    column) order, then ``cursor`` advances: aindex_tpu's ``_scatter_chunk``
    over the received (alltoall) or gathered (allgather) pairs.

    positions int64[seg] and cursor int32[n] are updated in place; offsets
    int64[n] (the range's CSR offsets from its first cell); ``scratch``
    (``fill_scratch(n_src * cols, n)``) is allocated per call when not
    given. A CPU tensor runs the plain version; a CUDA tensor launches K9's
    pairs-in entry."""
    for name, t, dtype in (("positions", positions, torch.int64),
                           ("cursor", cursor, torch.int32), ("offsets", offsets, torch.int64),
                           ("roff", roff, torch.int64)):
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor")
    if rec.dtype != torch.int64 or rec.dim() != 2 or not rec.is_contiguous() \
            or rec.shape[0] != roff.numel():
        raise ValueError("rec must be a contiguous int64[n_src, cols] tensor, one roff a row")
    n_slots = cursor.numel()
    if offsets.numel() != n_slots or n_slots == 0:
        raise ValueError(f"offsets ({offsets.numel()}) and cursor ({n_slots}) must hold "
                         "one entry per slot, at least one")
    n = rec.numel()
    if not 0 < n < INT32_LIMIT:
        raise ValueError(f"{n} records: the kernel takes 1 .. 2^31 - 2")
    slot_bits, idx_bits = _bits(n_slots), _bits(n)
    if slot_bits + idx_bits > 64:
        raise ValueError(f"{slot_bits} slot bits + {idx_bits} record bits exceed the "
                         "64-bit sort key")
    if not _cuda.on_cuda(positions, cursor, offsets, rec, roff):
        posfill_pairs_plain(positions, cursor, offsets, rec, roff, lo, packed)
        return
    dev = positions.device
    if scratch is None:
        scratch = fill_scratch(n, n_slots, dev)
    _check_fill_scratch(scratch, n, n_slots)
    with torch.cuda.device(dev):
        KERNEL_PAIRS.launch(
            rec.data_ptr(), rec.shape[0], rec.shape[1], int(packed), roff.data_ptr(), lo,
            n_slots, slot_bits, idx_bits, offsets.data_ptr(), cursor.data_ptr(),
            positions.data_ptr(), positions.numel(), scratch.data_ptr(), _cuda.stream(dev))
