"""K5: the canonical k-mer spectrum of one chunk, on the device.

Counterpart of aindex_tpu/kernels/spectrum.py. The kernel
``csrc/spectrum23.cu`` replaces ``chunk_spectrum_packed`` (:48) and
``sorted_spectrum`` (:121): windows -> canonical -> drop invalid -> sort
-> run-length reduce, the sort written by hand (an LSD radix sort over
the code's 2k significant bits). ``spectrum23_plain`` is its plain PyTorch
version. ``SENTINEL`` and ``merge_spectra`` (host numpy) are copied as they
are.

Keys are int64 tensors holding uint64 bit patterns. Results are padded to
the input's window (or key) count as aindex_tpu's are: the unique keys
ascending in the first ``n_unique`` entries, then the sentinel key
(2^64 - 1, which reads -1 in int64) with count 0, so the keys reach the
host as ``np.uint64`` bit for bit equal to aindex_tpu's.
"""

from __future__ import annotations

import numpy as np
import torch

from aindex_torch.kernels import _cuda
from aindex_torch.kernels.encode import canonical_code64, check_packed, packed_window_codes

KERNEL = _cuda.KERNELS["spectrum23"]

#: Sort key for ignored entries (> any 2k-bit k-mer code, k <= 31).
SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)
#: SENTINEL's bits as an int64
SENTINEL_I64 = -1

#: shapes of the scratch of the sort and the scans (csrc/radix.cuh,
#: csrc/scan.cuh), which K5 and K9 share
RADIX = 256
WARP_TILE = 1024
SCAN_TILE = 2048
#: the kernels index keys with int32
INT32_LIMIT = (1 << 31) - 1

_I64_MIN = -(1 << 63)


def sort_scratch(cap: int) -> tuple[int, int]:
    """int32 lengths (hist, sums) of the radix sort's scratch for up to
    ``cap`` keys, ``sums`` also serving the scans of ``cap + 1`` flags."""
    n_hist = RADIX * -(-cap // WARP_TILE)
    return n_hist, -(-max(cap + 1, n_hist) // SCAN_TILE)


def _flip(keys: torch.Tensor) -> torch.Tensor:
    """uint64 order <-> int64 order: toggling the top bit maps one onto the
    other, so a signed sort of flipped keys is an unsigned sort."""
    return keys ^ _I64_MIN


def _reduce_sorted_plain(keys: torch.Tensor, cap: int):
    """(keys[cap], counts[cap], n_unique) from live keys in any order."""
    s = _flip(torch.sort(_flip(keys)).values)
    uniq, counts = torch.unique_consecutive(s, return_counts=True)
    n = uniq.numel()
    out_keys = torch.full((cap,), SENTINEL_I64, dtype=torch.int64, device=keys.device)
    out_counts = torch.zeros(cap, dtype=torch.int32, device=keys.device)
    out_keys[:n] = uniq
    out_counts[:n] = counts.to(torch.int32)
    return out_keys, out_counts.view(torch.uint32), torch.tensor(n, dtype=torch.int32,
                                                                 device=keys.device)


def spectrum23_plain(packed=None, vbits=None, k: int = 23, keys=None):
    """Plain version of ``spectrum23``, same arguments and results."""
    if packed is not None:
        codes, valid = packed_window_codes(packed, vbits, k)
        canon = canonical_code64(codes, k)
        return _reduce_sorted_plain(canon[valid], canon.numel())
    return _reduce_sorted_plain(keys[keys != SENTINEL_I64], keys.numel())


def _check(packed, vbits, k, keys) -> int:
    """Validate the inputs; returns the padded output length."""
    if (packed is None) == (keys is None):
        raise ValueError("give exactly one of packed (with vbits) and keys")
    if packed is not None:
        check_packed(packed, vbits)
        if not 1 <= k <= 31:
            raise ValueError(f"k={k} outside 1..31")
        cap = 16 * packed.numel() - k + 1
        if cap <= 0:
            raise ValueError(f"chunk of {16 * packed.numel()} bases shorter than k={k}")
    else:
        if keys.dtype != torch.int64 or keys.dim() != 1 or not keys.is_contiguous():
            raise ValueError("keys must be a contiguous 1-D int64 tensor (uint64 bits)")
        cap = keys.numel()
        if cap == 0:
            raise ValueError("empty key array")
    if cap >= INT32_LIMIT:
        raise ValueError(f"{cap} windows exceed the kernel's int32 positions")
    return cap


def spectrum23(packed: torch.Tensor | None = None, vbits: torch.Tensor | None = None,
               k: int = 23, keys: torch.Tensor | None = None):
    """(keys int64[cap], counts uint32[cap], n_unique int32 scalar tensor):
    the sorted unique keys and their multiplicities, padded with the
    sentinel key and count 0.

    Either the packed ingest chunk (``packed``/``vbits`` as
    ``codec.pack_ascii_chunk`` makes them), whose valid k-windows are
    canonicalised (cap = window count), or a flat int64 ``keys`` array of
    uint64 bit patterns in which the sentinel (-1) means "ignore"
    (cap = its length).

    A CPU tensor runs the plain version; a CUDA tensor launches K5."""
    cap = _check(packed, vbits, k, keys)
    tensors = (packed, vbits) if packed is not None else (keys,)
    if not _cuda.on_cuda(*tensors):
        return spectrum23_plain(packed, vbits, k, keys)
    dev = tensors[0].device
    n_hist, n_sums = sort_scratch(cap)

    def ints(n):
        return torch.empty(n, dtype=torch.int32, device=dev)

    keys_out = torch.empty(cap, dtype=torch.int64, device=dev)
    counts = ints(cap)
    counters = ints(2)
    scratch = (torch.empty(cap, dtype=torch.int64, device=dev),
               torch.empty(cap, dtype=torch.int64, device=dev),
               ints(cap + 1), ints(cap), ints(n_hist), ints(n_sums))
    with torch.cuda.device(dev):
        KERNEL.launch(
            None if packed is None else packed.data_ptr(),
            None if vbits is None else vbits.data_ptr(),
            0 if packed is None else packed.numel(), k,
            None if keys is None else keys.data_ptr(), 0 if keys is None else cap, 64,
            keys_out.data_ptr(), counts.data_ptr(), counters.data_ptr(),
            *(t.data_ptr() for t in scratch), _cuda.stream(dev))
    return keys_out, counts.view(torch.uint32), counters[1]


def chunk_spectrum_packed(packed: torch.Tensor, vbits: torch.Tensor, k: int):
    """(keys, counts, n_unique) of every valid canonical k-mer of one packed
    chunk (aindex_tpu/kernels/spectrum.py:48): K5 in its packed mode."""
    return spectrum23(packed, vbits, k)


def sorted_spectrum(keyed: torch.Tensor):
    """Segment-reduce a flat int64 array of uint64 keys, SENTINEL = ignore
    (aindex_tpu/kernels/spectrum.py:121): K5 in its keys mode."""
    return spectrum23(keys=keyed)


def merge_spectra(parts: list[tuple[np.ndarray, np.ndarray]]
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Merge per-chunk (sorted unique keys, counts) partial spectra.

    Each part is already unique-sorted, so the merge works on far less data
    than the raw window stream. Host-side numpy: the partial spectra are the
    natural host<->device boundary.
    """
    if not parts:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    if len(parts) == 1:
        return parts[0][0].astype(np.uint64), parts[0][1].astype(np.uint64)
    all_keys = np.concatenate([p[0] for p in parts])
    all_counts = np.concatenate([p[1] for p in parts]).astype(np.uint64)
    keys, inv = np.unique(all_keys, return_inverse=True)
    counts = np.zeros(keys.size, dtype=np.uint64)
    np.add.at(counts, inv, all_counts)
    return keys, counts
