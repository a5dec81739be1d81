"""Mesh-parallel positional-index build: the slot-range-sharded CSR fill.

Counterpart of aindex_tpu/parallel/positional.py. The reference fills this
phase with per-slot atomic write cursors over threads
(lu_compressed_worker, reference: src/hash.cpp:960-1060). The mesh build
keeps the deterministic sort-based fill of ``index/positional.py`` and
adds two axes of parallelism:

* data: each rank computes the slots of its own chunk of every batch;
* the CSR positions are sharded by equal slot ranges over ``data``: shard
  d owns slots [d*m, (d+1)*m) and their segment of the positions.

Pair exchange, per batch: each rank buckets its windows' records
``((slot + 1) << 24) | window`` by destination shard into fixed-capacity
buckets (K14, ``kernels/positional.py`` ``posbucket``), and one
``all_to_all_single`` delivers to every shard exactly the records it owns,
which K9's pairs-in entry (``posfill_pairs``) fills in (source, window)
order, so the assembled CSR is byte-identical to the single-device build.
Slots are hash-uniform, so a 2x-mean capacity overflows only on skew (one
hub k-mer dominating a chunk); the overflow is counted on the devices,
summed over ``data``, and the build then re-runs with the always-correct
all-gather exchange (every rank gathers every rank's slots), which is
also the exchange for chunks of 2^24 windows or more. ``exchange=`` (or
the ``AINDEX_TORCH_POSITIONAL_EXCHANGE`` environment variable) picks one.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from aindex_torch.kernels.positional import (DELTA_BITS, bucket_scratch, csr_offsets,
                                             fill_scratch, posbucket, posfill_pairs)
from aindex_torch.kernels.probe import CANON
from aindex_torch.parallel.mesh import DATA_AXIS, axis_group, axis_rank, axis_size, mesh_device
from aindex_torch.trace import span

logger = logging.getLogger(__name__)

EXCHANGE_ENV = "AINDEX_TORCH_POSITIONAL_EXCHANGE"
EXCHANGES = ("alltoall", "allgather")
#: bucket capacity = ceil(slack * windows / n_data) + 64: 2x the uniform mean
BUCKET_SLACK = 2.0


def range_layout(offsets, n_slots: int, n_data: int):
    """Equal slot ranges per shard: d owns [bounds[d], bounds[d + 1]), m
    slots wide but for the last. ``offsets`` are the CSR offsets, a host
    array or a tensor. Returns (m, bounds int64[n_data + 1], seg_len
    int64[n_data]), seg_len[d] the positions of d's range
    (aindex_tpu/parallel/positional.py:54 _range_layout)."""
    m = max(1, -(-n_slots // n_data))
    bounds = np.minimum(np.arange(n_data + 1, dtype=np.int64) * m, n_slots)
    at = offsets[bounds]
    at = at.cpu().numpy() if isinstance(at, torch.Tensor) else at
    return m, bounds, (at[1:] - at[:-1]).astype(np.int64)


def bucket_cap(n_win: int, n_data: int) -> int:
    """Capacity of one destination's bucket for a chunk of ``n_win``
    windows."""
    return int(np.ceil(BUCKET_SLACK * n_win / n_data)) + 64


class ShardFill:
    """One data shard's slice of the CSR fill: its slot range [lo, hi), the
    range's offsets from its first cell (``offsets``, the CSR offsets, a
    host array or a tensor), its cursor and positions on the device.
    ``fill`` takes the records every source sent this shard, in source
    order, and their sources' first window positions."""

    def __init__(self, offsets, lo: int, hi: int, device: torch.device):
        self.lo, self.hi = int(lo), int(hi)
        base = int(offsets[lo])
        self.offsets = torch.as_tensor(offsets[lo:hi] - base, device=device).contiguous()
        self.cursor = torch.zeros(hi - lo, dtype=torch.int32, device=device)
        self.positions = torch.zeros(int(offsets[hi]) - base, dtype=torch.int64, device=device)
        self.scratch = None

    def fill(self, rec: torch.Tensor, roff: torch.Tensor, packed: bool) -> None:
        if self.hi == self.lo:
            return
        if self.scratch is None and rec.is_cuda:
            self.scratch = fill_scratch(rec.numel(), self.hi - self.lo, rec.device)
        posfill_pairs(self.positions, self.cursor, self.offsets, rec, roff, self.lo, packed,
                      self.scratch)


def build_positional_sharded(blob: np.ndarray, n_slots: int, tf, tables, mesh, k: int,
                             chunk: int = 1 << 22, on_progress=None, exchange: str | None = None,
                             rule: int = CANON):
    """Data-parallel, slot-range-sharded positional CSR build; every rank
    returns the whole ``PositionalIndex``.

    Each window's slot is the forward code of a k <= 16 window (``tables``
    None: the dense index) or the verified slot of the sparse engine
    ``tables`` under ``rule`` (the single-device engine's probe, as
    aindex_tpu's ``resolve_slots``). ``tf`` is the per-slot occurrence
    histogram from the counting phase (a uint32 tensor or a host array);
    the CSR offsets are its prefix sum on the rank's device (K8).
    ``exchange``: "alltoall" (the default) or "allgather" (see
    the module docstring); the environment variable ``EXCHANGE_ENV``
    overrides the default."""
    from aindex_torch.index.common import packed_chunks
    from aindex_torch.index.positional import PositionalIndex, tf_tensor
    from aindex_torch.parallel import distributed as pdist

    mode = exchange or os.environ.get(EXCHANGE_ENV, "alltoall")
    if mode not in EXCHANGES:
        raise ValueError(f"unknown positional exchange {mode!r}")
    n_data = axis_size(mesh, DATA_AXIS)
    d = axis_rank(mesh, DATA_AXIS)
    group = axis_group(mesh, DATA_AXIS)
    dev = mesh_device(mesh)
    if tables is not None and tables.device != dev:
        raise ValueError(f"the engine's tables lie on {tables.device}, the mesh's rank on {dev}")
    with span("aindex.positional.offsets"):
        offsets = csr_offsets(tf_tensor(tf, n_slots, dev))
        if int(offsets[-1]) == 0 or blob.size < k:
            return PositionalIndex(offsets.cpu().numpy().view(np.uint64),
                                   np.zeros(0, np.uint64))
        m, bounds, seg_len = range_layout(offsets, n_slots, n_data)

    def row_chunks():
        """This rank's rows, each with (bytes done, windows per row)."""
        return ((row, (done, row.size - (k - 1)))
                for row, done in pdist.local_row_chunks(blob, k, chunk, mesh))

    def run(step_mode: str):
        """The fill with one exchange; None when the chunk is too wide for
        the records' window field, else the overflow summed over data."""
        shard = ShardFill(offsets, bounds[d], bounds[d + 1], dev)
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
        scratch = None
        for b, (packed, vbits, (done, stride)) in enumerate(packed_chunks(row_chunks(), dev)):
            if b == 0:
                if step_mode == "alltoall" and stride >= 1 << DELTA_BITS:
                    return shard, None
                cap = bucket_cap(stride, n_data)
                if dev.type == "cuda":
                    scratch = bucket_scratch(dev)
            # every source's first window: its row's place in the chunk grid
            roff = (b * n_data + torch.arange(n_data, device=dev)) * stride
            if step_mode == "alltoall":
                _, buckets, over = posbucket(packed, vbits, k, tables, rule, n_slots, m, n_data,
                                             cap, scratch)
                recv = torch.empty_like(buckets)
                dist.all_to_all_single(recv, buckets, group=group)
                overflow += over
                shard.fill(recv, roff, True)
            else:
                slots, _, _ = posbucket(packed, vbits, k, tables, rule, n_slots, m, 0, 0,
                                        scratch)
                shard.fill(pdist.all_gather(slots[None], group), roff, False)
            if on_progress is not None:
                on_progress(done)
        dist.all_reduce(overflow, group=group)
        return shard, int(overflow)

    with span("aindex.positional.fill"):
        shard, out = run(mode)
        if mode == "alltoall" and (out is None or out > 0):
            # bucket overflow (skewed slots) or an oversized chunk: redo
            # with the always-correct full-gather exchange
            logger.info("positional alltoall exchange fell back to allgather (%s)",
                        "chunk too large" if out is None else f"{out} overflow pairs")
            del shard
            shard, _ = run("allgather")
    # each rank holds its slot range's segment; the concat over data (the
    # ranges ascend with the data row) is the whole positions array
    with span("aindex.positional.copy"):
        local = shard.positions[:seg_len[d]].cpu().numpy()
        positions = pdist.allgather_concat(local, group).view(np.uint64)
        offsets = offsets.cpu().numpy().view(np.uint64)
    return PositionalIndex(offsets, positions)
