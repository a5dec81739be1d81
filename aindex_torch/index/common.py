"""What the indexes share: device selection, host copies of uint32 tensors
and the packed-chunk ingest.

On a CUDA device the ingest is double-buffered: while the caller's kernels
work on chunk i on the compute stream, the host packs chunk i+1 into the
other pinned buffer and a copy stream moves it to the device. A pinned
buffer is rewritten only after its previous copy has completed, and a
device buffer only after the kernels that read it have.
"""

from __future__ import annotations

import numpy as np
import torch

from aindex_torch.core import codec
from aindex_torch.trace import note_h2d


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device when CUDA is
    not available (no fallback to the CPU) and for anything but cpu/cuda."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}: aindex_torch runs on cpu or cuda")
    return device


def host_u32(t: torch.Tensor) -> np.ndarray:
    """uint32 (or int32 storage) tensor -> numpy uint32 on the host, moved
    through its int32 view."""
    return t.view(torch.int32).cpu().numpy().view(np.uint32)


class _Slot:
    """One half of the CUDA ingest double buffer: pinned host and device
    buffers for a packed chunk, the event that marks the host-to-device
    copy done, and the event that marks the caller's kernels done with it."""

    def __init__(self, n_words: int, device: torch.device):
        self.n_words = n_words
        self.host_packed = torch.empty(n_words, dtype=torch.int32, pin_memory=True)
        self.host_vbits = torch.empty(2 * n_words, dtype=torch.uint8, pin_memory=True)
        self.dev_packed = torch.empty(n_words, dtype=torch.int32, device=device)
        self.dev_vbits = torch.empty(2 * n_words, dtype=torch.uint8, device=device)
        self.copied = torch.cuda.Event()
        self.consumed = torch.cuda.Event()


def _packed_chunks_cuda(chunk_iter, device: torch.device):
    compute = torch.cuda.current_stream(device)
    copy = torch.cuda.Stream(device)
    slots: list[_Slot | None] = [None, None]
    for i, (piece, done) in enumerate(chunk_iter):
        packed, vbits = codec.pack_ascii_chunk(piece)
        n = packed.size
        if slots[i % 2] is None:
            slots[i % 2] = _Slot(n, device)
        slot = slots[i % 2]
        if n > slot.n_words:
            # both chunkers cut every piece of one stream to one size
            raise ValueError(f"chunk of {n} words after chunks of {slot.n_words}")
        slot.copied.synchronize()
        slot.host_packed.numpy()[:n] = packed.view(np.int32)
        slot.host_vbits.numpy()[:2 * n] = vbits
        note_h2d(slot.host_packed[:n])
        note_h2d(slot.host_vbits[:2 * n])
        with torch.cuda.stream(copy):
            copy.wait_event(slot.consumed)
            slot.dev_packed[:n].copy_(slot.host_packed[:n], non_blocking=True)
            slot.dev_vbits[:2 * n].copy_(slot.host_vbits[:2 * n], non_blocking=True)
            slot.copied.record(copy)
        compute.wait_event(slot.copied)
        yield slot.dev_packed[:n], slot.dev_vbits[:2 * n], done
        slot.consumed.record(compute)


def packed_chunks(chunk_iter, device: torch.device):
    """Yield ``(packed int32[W], vbits uint8[2W], done)`` on ``device`` for
    every ``(ASCII piece, bytes_done)`` of ``chunk_iter``: the chunk in the
    packed ingest format (``codec.pack_ascii_chunk``, 0.375 bytes a base).

    The caller launches the kernels that read a chunk on the device's
    current stream before it asks for the next one; on CUDA the chunk's
    buffers are reused two chunks later, after those kernels."""
    if device.type == "cuda":
        yield from _packed_chunks_cuda(chunk_iter, device)
        return
    for piece, done in chunk_iter:
        packed, vbits = codec.pack_ascii_chunk(piece)
        yield torch.from_numpy(packed.view(np.int32)), torch.from_numpy(vbits), done
