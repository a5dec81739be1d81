"""Positional "aindex": CSR mapping k-mer slot -> every blob position.

Counterpart of aindex_tpu/index/positional.py. The reference fills this
with per-slot atomic write cursors, whose order races (reference:
src/hash.cpp:1024-1051, src/compute_aindex13.cpp:206-215). This build is
sort-based and deterministic, streaming on one device:

  phase 1: CSR offsets = exclusive prefix sum of the tf histogram that the
           counting phase produced (K8, kernels/positional.py);
  phase 2: per blob chunk, K9 computes each window's slot, sorts the
           chunk's occurrences by slot (stable), ranks each within its
           slot's run and writes its position straight into its final CSR
           cell at offsets[slot] + cursor[slot] + rank; a device cursor
           array carries the per-slot fill counts across chunks.

Positions within a slot come out ascending, bit for bit as aindex_tpu's.
The offsets and positions stay on the device until the fill ends and
cross to the host once, as ``np.uint64``.

On-disk format matches the reference: ``.index.bin`` = uint64 positions
(1-based, 0 = empty), ``.indices.bin`` = uint64 CSR offsets[n_slots+1]
(reference: src/hash.hpp:470-486; queries at src/python_wrapper.cpp:800-822
return 0-based and skip zeros).

The build runs on one device: the card (``"cuda"``) unless the caller asks
for the CPU, where K8 and K9 run their plain versions. The host arrays
serve persistence and the by-slot queries (host numpy, as aindex_tpu's).
"""

from __future__ import annotations

import numpy as np
import torch

from aindex_torch.constants import K13, SUFFIX_INDEX, SUFFIX_INDICES
from aindex_torch.core.reads import blob_chunks
from aindex_torch.index.common import packed_chunks, resolve_device
from aindex_torch.index.sparse23 import Sparse23Index
from aindex_torch.kernels.count import zeros_dev
from aindex_torch.kernels.positional import csr_offsets, fill_scratch, posfill
from aindex_torch.kernels.probe import CANON
from aindex_torch.trace import span


def tf_tensor(tf, n_slots: int, device: torch.device) -> torch.Tensor:
    """The per-slot tf table as a uint32 tensor on ``device``: a uint32 (or
    int32 storage) tensor as it is, or a host array of unsigned counts that
    fit in uint32."""
    if isinstance(tf, torch.Tensor):
        if tf.dtype not in (torch.int32, torch.uint32):
            raise ValueError(f"tf tensor must be uint32, got {tf.dtype}")
        t = tf.reshape(-1).view(torch.int32).to(device)
    else:
        arr = np.asarray(tf).reshape(-1)
        if arr.dtype.kind not in "iu" or (arr.size and (arr.min() < 0
                                                        or arr.max() > np.iinfo(np.uint32).max)):
            raise ValueError("tf must hold counts in 0 .. 2^32 - 1")
        t = torch.from_numpy(arr.astype(np.uint32).view(np.int32)).to(device)
    if t.numel() != n_slots:
        raise ValueError(f"tf holds {t.numel()} counts for {n_slots} slots")
    return t.contiguous().view(torch.uint32)


class PositionalIndex:
    def __init__(self, offsets: np.ndarray, positions: np.ndarray):
        self.offsets = np.asarray(offsets, dtype=np.uint64)    # [n_slots + 1]
        self.positions = np.asarray(positions, dtype=np.uint64)  # 1-based

    @property
    def n_slots(self) -> int:
        return len(self.offsets) - 1

    @property
    def total(self) -> int:
        return len(self.positions)

    @property
    def max_tf(self) -> int:
        if self.n_slots == 0:
            return 0
        return int(np.max(np.diff(self.offsets.astype(np.int64))))

    # -- construction ------------------------------------------------------

    @classmethod
    def from_slot_positions(cls, slots: np.ndarray, positions0: np.ndarray,
                            n_slots: int) -> "PositionalIndex":
        """slots int64[n] (slot per occurrence), positions0 int64[n] 0-based."""
        order = np.argsort(slots, kind="stable")
        sorted_pos = positions0[order].astype(np.uint64) + np.uint64(1)
        counts = np.bincount(slots, minlength=n_slots).astype(np.uint64)
        offsets = np.zeros(n_slots + 1, dtype=np.uint64)
        np.cumsum(counts, out=offsets[1:])
        return cls(offsets, sorted_pos)

    @classmethod
    def _build_streaming(cls, n_slots: int, tf, chunk_iter, k: int,
                         tables, device: torch.device, on_progress=None,
                         rule: int = CANON) -> "PositionalIndex":
        """Device-streaming CSR fill over ``(ASCII piece, (off, bytes_done))``
        chunks of the blob.

        ``tf`` is the per-slot occurrence histogram from the counting phase;
        the positions array is allocated once at its sum, and K9 places
        every chunk's occurrences directly into their final cells. The
        chunks cross to the device packed (``common.packed_chunks``); K9's
        scratch is allocated once, at the first chunk. The stages are
        spans (``aindex.positional.offsets``, ``.fill``, ``.copy``) for a
        profiler trace; the fill's ends when the device has finished it."""
        with span("aindex.positional.offsets"):
            offsets = csr_offsets(tf_tensor(tf, n_slots, device))
            total = int(offsets[-1])
        if total == 0:
            return cls(offsets.cpu().numpy().view(np.uint64), np.zeros(0, np.uint64))
        with span("aindex.positional.fill"):
            positions = zeros_dev(total, torch.int64, device=device)
            cursor = zeros_dev(n_slots, torch.int32, device=device)
            starts = offsets[:-1]
            scratch = None
            for packed, vbits, (off, done) in packed_chunks(chunk_iter, device):
                if scratch is None and device.type == "cuda":
                    scratch = fill_scratch(16 * packed.numel() - k + 1, n_slots, device)
                posfill(positions, cursor, starts, packed, vbits, k, off, tables, scratch, rule)
                if on_progress is not None:
                    on_progress(done)
            del scratch, cursor
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        with span("aindex.positional.copy"):
            return cls(offsets.cpu().numpy().view(np.uint64),
                       positions.cpu().numpy().view(np.uint64))

    @classmethod
    def build_dense13(cls, blob: np.ndarray, k: int = K13,
                      chunk: int = 1 << 22, tf=None, mesh=None, on_progress=None,
                      *, device="cuda") -> "PositionalIndex":
        """k-mer positional index keyed by the forward 2-bit code (the
        reference does a forward-only MPHF lookup per position, reference:
        src/compute_aindex13.cpp:137-149).

        ``tf`` is the dense forward-count table (4^k entries, uint32 tensor
        or host array) when already built, as the pipeline's phase 2
        output; with None the 13-mer table is counted in a first streaming
        pass (``Dense13Index.build_from_blob``), mirroring the reference,
        whose CSR sizing also reads the counting phase's .tf.bin
        (reference: src/compute_aindex13.cpp:59-64).

        With ``mesh``, the fill runs data-parallel with the positions
        sharded by slot range (``parallel/positional.py``) on the mesh's
        device; the result is byte-identical to the single-device build."""
        if mesh is not None:
            from aindex_torch.parallel.mesh import mesh_device
            device = mesh_device(mesh)
        device = resolve_device(device)
        if tf is None:
            if k != K13:
                raise ValueError(f"tf=None counts 13-mers; give the 4^{k} table for k={k}")
            from aindex_torch.index.dense13 import Dense13Index
            tf = Dense13Index.build_from_blob(blob, chunk=chunk, mesh=mesh, device=device).tf
        if mesh is not None:
            from aindex_torch.parallel.positional import build_positional_sharded
            return build_positional_sharded(blob, 4 ** k, tf, None, mesh, k, chunk,
                                            on_progress)
        return cls._build_streaming(4 ** k, tf, _chunk_iter(blob, k, chunk), k, None,
                                    device, on_progress)

    @classmethod
    def build_sparse23(cls, blob: np.ndarray, index: Sparse23Index,
                       chunk: int = 1 << 22, mesh=None, on_progress=None
                       ) -> "PositionalIndex":
        """Sparse positional index keyed by the verified slot of each
        window under the index's query rule (reference:
        src/hash.cpp:960-1060 lu_compressed_worker), built on the index's
        device, on whichever engine serves its queries (quotient table,
        wide cuckoo table or MPHF walk). The index's own tf array sizes the
        CSR; absent and invalid windows are dropped on the device. The
        engine's tables are built first (``index.tables``), in a range of
        their own, ``aindex.positional.tables``.

        With ``mesh``, the fill runs data-parallel and slot-range-sharded
        (see ``build_dense13``); the verified slot probe is the index's own
        engine on the rank's device, which must be the mesh's."""
        with span("aindex.positional.tables"):
            tables = index.tables
        if mesh is not None:
            from aindex_torch.parallel.positional import build_positional_sharded
            return build_positional_sharded(blob, index.n, index.tf_host, tables, mesh, index.k,
                                            chunk, on_progress, rule=index.rule)
        return cls._build_streaming(index.n, index.tf_host, _chunk_iter(blob, index.k, chunk),
                                    index.k, tables, index.device, on_progress, index.rule)

    def reorder(self, old_slot_for_new: np.ndarray) -> "PositionalIndex":
        """CSR with rows permuted: new slot j holds old slot
        ``old_slot_for_new[j]``'s positions. Used to reorder a reference-built
        13-mer positional index (MPHF-slot keyed, reference:
        src/compute_aindex13.cpp:206-215) into k-mer code order at load time."""
        old = np.asarray(old_slot_for_new, dtype=np.int64)
        off = self.offsets.astype(np.int64)
        lens = (off[1:] - off[:-1])[old]
        new_off = np.zeros(len(old) + 1, dtype=np.int64)
        np.cumsum(lens, out=new_off[1:])
        total = int(new_off[-1])
        # vectorised segment gather: absolute source index per output element
        src = (np.arange(total, dtype=np.int64)
               - np.repeat(new_off[:-1], lens)
               + np.repeat(off[:-1][old], lens))
        return PositionalIndex(new_off.astype(np.uint64), self.positions[src])

    # -- persistence ---------------------------------------------------

    def save(self, prefix: str) -> None:
        self.positions.tofile(prefix + SUFFIX_INDEX)
        self.offsets.tofile(prefix + SUFFIX_INDICES)

    @classmethod
    def load(cls, index_path: str, indices_path: str) -> "PositionalIndex":
        positions = np.fromfile(index_path, dtype=np.uint64)
        offsets = np.fromfile(indices_path, dtype=np.uint64)
        return cls(offsets, positions)

    # -- queries ---------------------------------------------------------

    def positions_by_slot(self, slot: int) -> np.ndarray:
        """0-based blob positions for a slot (zeros skipped, as in
        reference: src/python_wrapper.cpp:800-822)."""
        if slot < 0 or slot >= self.n_slots:
            return np.zeros(0, dtype=np.uint64)
        s, e = int(self.offsets[slot]), int(self.offsets[slot + 1])
        chunk = self.positions[s:e]
        return chunk[chunk > 0] - np.uint64(1)

    def positions_by_slots(self, slots: np.ndarray
                           ) -> tuple[np.ndarray, np.ndarray]:
        """Batch form: one vectorised gather for many slots.

        Returns (positions, lengths): ``positions`` is the 0-based positions
        of slot[0], then slot[1], ... concatenated; ``lengths[i]`` is the
        count for slot[i] (split with ``np.split(positions,
        np.cumsum(lengths)[:-1])``). Out-of-range slots contribute length 0.
        The reference has no batch path: its per-call loop is the position
        analysis bottleneck (reference: src/python_wrapper.cpp:800-822).
        """
        slots = np.asarray(slots, dtype=np.int64)
        ok = (slots >= 0) & (slots < self.n_slots)
        safe = np.where(ok, slots, 0)
        # index first, then cast: converting the full offsets array would
        # copy gigabytes per call for the dense 4^13 CSR
        starts = np.where(ok, self.offsets[safe].astype(np.int64), 0)
        ends = np.where(ok, self.offsets[safe + 1].astype(np.int64), 0)
        lens = ends - starts
        out_off = np.zeros(len(slots) + 1, dtype=np.int64)
        np.cumsum(lens, out=out_off[1:])
        src = (np.arange(int(out_off[-1]), dtype=np.int64)
               - np.repeat(out_off[:-1], lens)
               + np.repeat(starts, lens))
        pos = self.positions[src]
        keep = pos > 0
        csum = np.zeros(len(pos) + 1, dtype=np.int64)
        np.cumsum(keep, out=csum[1:])
        kept_lens = csum[out_off[1:]] - csum[out_off[:-1]]
        return pos[keep] - np.uint64(1), kept_lens


def _chunk_iter(blob: np.ndarray, k: int, chunk: int):
    """``(ASCII piece, (blob offset, bytes done))`` over the blob's
    overlapping chunks (``core.reads.blob_chunks``)."""
    return ((piece, (off, min(off + chunk, blob.size)))
            for piece, off in blob_chunks(blob, k, chunk))
