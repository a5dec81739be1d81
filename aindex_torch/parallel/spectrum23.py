"""Multi-device sparse k-mer spectrum: a key-range-sharded reduction.

Counterpart of aindex_tpu/parallel/spectrum23.py. The reference merges
per-thread ``unordered_map`` spectra under a lock (reference:
src/count_kmers.cpp:47-64,334-341). On the mesh:

  1. each rank reduces its own chunk to a local sorted unique (key, count)
     spectrum (K5, ``kernels/spectrum.py``);
  2. one all-gather over ``data`` exchanges the already deduplicated
     partials (far smaller than the raw window stream);
  3. each rank keeps the keys of its range of the 2k-bit code space (a
     static, uniform partition, ceil(4^k / n_data) wide) and merges the
     weighted pairs into its shard of the global spectrum (K13).

The ranges are disjoint and ascend with the data row, so the global
spectrum is the in-order concatenation of the shard spectra: sorted,
deterministic, never materialised on one rank until the end. Keys cross
the collective as int64 bit patterns and counts as int32 bit patterns of
uint32 (gloo takes no unsigned types); the sentinel key (2^64 - 1, -1 as
int64) lies outside every range.
"""

from __future__ import annotations

import numpy as np
import torch

from aindex_torch.kernels.spectrum import (chunk_spectrum_packed, merge_spectra,
                                           sorted_spectrum_weighted)
from aindex_torch.parallel.mesh import DATA_AXIS, axis_group, axis_rank, axis_size, mesh_device


def key_range(d: int, n_data: int, k: int) -> tuple[int, int]:
    """[lo, hi) of the 2k-bit codes data shard ``d`` of ``n_data`` owns."""
    size = -(-(4 ** k) // n_data)
    return d * size, (d + 1) * size


def merge_range(all_keys: torch.Tensor, all_counts: torch.Tensor, d: int, n_data: int,
                k: int):
    """Data shard ``d``'s part of the global spectrum from every shard's
    partial spectrum, concatenated (int64 keys with sentinel padding,
    uint32 counts): the keys of its range, sorted, with their summed counts
    (keys int64[n], counts int64[n] of uint64 bits, n_unique), as
    aindex_tpu's ``spectrum23_sharded`` returns one shard of. K13."""
    lo, hi = key_range(d, n_data, k)
    return sorted_spectrum_weighted(all_keys, all_counts, lo, hi)


def spectrum23_sharded(packed: torch.Tensor, vbits: torch.Tensor, *, mesh, k: int):
    """This rank's key range of the global canonical spectrum of a packed
    batch whose ``data`` rows the ranks hold one each (``packed`` [1, W],
    ``vbits`` [1, 2W]: this rank's row). Returns (keys int64[n], counts
    int64[n] (uint64 bits), n_unique int32), n = n_data x the row's window
    count, the unique keys of the range first (aindex_tpu/parallel/
    spectrum23.py:39, one shard of its output)."""
    from aindex_torch.parallel.distributed import all_gather
    if packed.shape[0] != 1:
        raise ValueError(f"one row a rank, got {packed.shape[0]}")
    keys_l, counts_l, _ = chunk_spectrum_packed(packed[0], vbits[0], k)
    group = axis_group(mesh, DATA_AXIS)
    all_k = all_gather(keys_l, group)
    all_c = all_gather(counts_l.view(torch.int32), group)
    return merge_range(all_k, all_c, axis_rank(mesh, DATA_AXIS), axis_size(mesh, DATA_AXIS), k)


def count_canonical_kmers_sharded(blob: np.ndarray, mesh, k: int, chunk: int = 1 << 20,
                                  on_progress=None) -> tuple[np.ndarray, np.ndarray]:
    """(unique canonical codes uint64, counts uint64) over the blob, reduced
    on the mesh.

    Streams [n_data, chunk] batches, each rank packing only its own row
    (double-buffered on a card, ``index.common.packed_chunks``);
    per batch the cross-rank dedup runs on the devices (one all-gather),
    so the host only merges this rank's range spectra across batches. One
    variable-size all-gather over ``data`` at the end concatenates the
    ranges into the same globally sorted spectrum on every rank
    (aindex_tpu/parallel/spectrum23.py:83)."""
    from aindex_torch.index.common import packed_chunks
    from aindex_torch.parallel import distributed as dist

    parts: list[tuple[np.ndarray, np.ndarray]] = []
    for packed, vbits, done in packed_chunks(dist.local_row_chunks(blob, k, chunk, mesh),
                                             mesh_device(mesh)):
        keys, counts, n_u = spectrum23_sharded(packed[None], vbits[None], mesh=mesh, k=k)
        n = int(n_u)
        if n:
            parts.append((keys[:n].cpu().numpy().view(np.uint64),
                          counts[:n].cpu().numpy().view(np.uint64)))
        if on_progress is not None:
            on_progress(done)
    local_keys, local_counts = merge_spectra(parts)
    # key ranges ascend with the data row: the concat is globally sorted
    group = axis_group(mesh, DATA_AXIS)
    return dist.allgather_concat(local_keys, group), dist.allgather_concat(local_counts, group)
