"""Data-parallel dense 13-mer counting over a device mesh.

Counterpart of aindex_tpu/parallel/count13.py, the replacement for the
reference's atomic shared-table counting (reference:
src/count_kmers13.cpp:141-160): each rank adds the windows of its own rows
into a local table (K1, ``kernels/count.py``), then one ``all_reduce``
over the ``data`` axis merges the partials into the replicated table.
Deterministic: integer sums in any order give the same bits.

The uint32 table crosses the collective as the bit pattern of its int32
storage (gloo takes no unsigned types): an int32 sum wraps modulo 2^32
exactly as JAX's uint32 psum does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from aindex_torch.constants import SPACE_13
from aindex_torch.kernels.count import PackedCounter
from aindex_torch.parallel.mesh import DATA_AXIS, axis_group


def count13_local(packed: torch.Tensor, vbits: torch.Tensor,
                  counts: torch.Tensor | None = None) -> torch.Tensor:
    """Add the forward 13-mers of every row of a packed [rows, W] + [rows,
    2W] batch (``codec.pack_ascii_chunk``) into ``counts`` (a new int32
    storage of uint32[4^13] table when None; windows never cross rows):
    the rows through one ``PackedCounter``, counted at once (K1). Returns
    the table."""
    if counts is None:
        counts = torch.zeros(SPACE_13, dtype=torch.int32, device=packed.device)
    counter = PackedCounter(counts)
    for r in range(packed.shape[0]):
        counter.add(packed[r], vbits[r])
    return counter.finish()


def merge_counts(counts: torch.Tensor, mesh) -> torch.Tensor:
    """Sum the ranks' tables over ``data`` in place (int32 bit patterns,
    wrapping as uint32 does); returns ``counts``."""
    dist.all_reduce(counts.view(torch.int32), group=axis_group(mesh, DATA_AXIS))
    return counts


def count13_sharded(packed: torch.Tensor, vbits: torch.Tensor, *, mesh) -> torch.Tensor:
    """Count the forward 13-mers of this rank's rows of a packed batch and
    merge over ``data``: the whole batch's table (int32 storage of uint32)
    on every rank (aindex_tpu/parallel/count13.py:35)."""
    return merge_counts(count13_local(packed, vbits), mesh)


def count13_sharded_accumulate(counts: torch.Tensor, packed: torch.Tensor,
                               vbits: torch.Tensor, *, mesh) -> torch.Tensor:
    """Streaming variant: add this batch's merged counts into ``counts`` in
    place (aindex_tpu/parallel/count13.py:53)."""
    counts.view(torch.int32).add_(count13_sharded(packed, vbits, mesh=mesh))
    return counts


def pack_reads_batch(reads: list[str], n_shards: int, length: int | None = None
                     ) -> np.ndarray:
    """Host-side packing of variable-length reads into a [B, L] uint8 batch.

    Reads are newline-padded (invalid windows) to a common length and the
    batch is padded to a multiple of ``n_shards`` rows so the ``data`` axis
    divides evenly: the static-shape analogue of the reference's
    per-thread byte ranges.
    """
    if length is None:
        length = max((len(r) for r in reads), default=1)
    pad_byte = ord("\n")
    rows = len(reads)
    b = -(-rows // n_shards) * n_shards if rows else n_shards
    out = np.full((b, length), pad_byte, dtype=np.uint8)
    for i, r in enumerate(reads):
        enc = np.frombuffer(r[:length].encode("ascii"), dtype=np.uint8)
        out[i, :len(enc)] = enc
    return out
