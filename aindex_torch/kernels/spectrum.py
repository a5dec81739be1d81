"""K5: the canonical k-mer spectrum of one chunk, on the device; K13: the
weighted merge of partial spectra.

Counterpart of aindex_tpu/kernels/spectrum.py. The kernel
``csrc/spectrum23.cu`` replaces ``chunk_spectrum_packed`` (:48) and
``sorted_spectrum`` (:121): windows -> canonical -> drop invalid -> sort
-> run-length reduce, the sort written by hand (a onesweep LSD radix sort,
``csrc/onesweep.cuh``, over the code's 2k significant bits).
``spectrum23_plain`` is its plain PyTorch version. K5's entry
``spectrum23_ascii`` replaces ``chunk_spectrum`` (:33) with the same steps
from ASCII bytes (``chunk_spectrum``, plain version
``chunk_spectrum_plain``), and its entry ``canonical23_ascii`` replaces
index/sparse23.py:38 ``_extract_canonical``, the first step alone
(``ascii_canonical``, plain version ``ascii_canonical_plain``). The kernel ``csrc/merge23.cu`` (K13) replaces
``sorted_spectrum_weighted`` (:149; the TPU's pair-sort form :81): sort the
keys of a key range, add their weights per run; its plain version is
``sorted_spectrum_weighted_plain``. ``SENTINEL`` and ``merge_spectra``
(host numpy) are copied as they are.

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
from aindex_torch.kernels.encode import (as_unsigned, ascii_to_base_codes, canonical_code64,
                                         check_packed, packed_window_codes, window_codes)

KERNEL = _cuda.KERNELS["spectrum23"]
KERNEL_ASCII = _cuda.KERNELS["spectrum23_ascii"]
KERNEL_CANONICAL = _cuda.KERNELS["canonical23_ascii"]
KERNEL_MERGE = _cuda.KERNELS["spectrummerge"]

#: Sort key for ignored entries (> any 2k-bit k-mer code, k <= 31).
SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)
#: SENTINEL's bits as an int64
SENTINEL_I64 = -1

#: the onesweep sort's digit radix, tile and counter words
#: (csrc/onesweep.cuh), which K5, K13 and the positional fill (K9, the
#: K10/K11 fill entries) use
RADIX = 256
ONESWEEP_TILE = 4096
ONESWEEP_COUNTERS = 16
#: the kernels index keys with int32
INT32_LIMIT = (1 << 31) - 1

_I64_MIN = -(1 << 63)


def sort_passes(bits: int) -> int:
    """8-bit digit passes of a sort on ``bits`` bits."""
    return -(-bits // 8)


def onesweep_scratch(cap: int, passes: int, value_bytes: int) -> int:
    """Bytes of the onesweep sort's scratch for up to ``cap`` keys sorted in
    ``passes`` passes, each key with a value of ``value_bytes`` (0, 4 or
    8): two key buffers, two value buffers, then the words one memset
    zeroes (digit histograms, counter words, the look-back words of the
    compaction, the runs and each pass). csrc/onesweep.cuh
    ``scratch_bytes`` carves the same layout."""
    tiles = -(-cap // ONESWEEP_TILE)
    status = passes * RADIX // 2 + ONESWEEP_COUNTERS // 2 + 2 * tiles + passes * tiles * RADIX
    return 8 * (2 * cap + 2 * -(-cap * value_bytes // 8) + status)


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


def _launch_reduce(kernel, dev, cap: int, bits: int, *args) -> tuple:
    """Allocate K5's outputs and scratch for ``cap`` windows or keys sorted
    on ``bits`` bits and launch one of its reducing entries with ``args``
    before them."""
    keys_out = torch.empty(cap, dtype=torch.int64, device=dev)
    counts = torch.empty(cap, dtype=torch.int32, device=dev)
    counters = torch.empty(2, dtype=torch.int32, device=dev)
    scratch = torch.empty(onesweep_scratch(cap, sort_passes(bits), 0), dtype=torch.uint8,
                          device=dev)
    with torch.cuda.device(dev):
        kernel.launch(*args, keys_out.data_ptr(), counts.data_ptr(), counters.data_ptr(),
                      scratch.data_ptr(), _cuda.stream(dev))
    return keys_out, counts.view(torch.uint32), counters[1]


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
    bits = 64 if packed is None else 2 * k
    return _launch_reduce(
        KERNEL, tensors[0].device, cap, bits, None if packed is None else packed.data_ptr(),
        None if vbits is None else vbits.data_ptr(), 0 if packed is None else packed.numel(),
        k, None if keys is None else keys.data_ptr(), 0 if keys is None else cap, 64)


def chunk_spectrum_packed(packed: torch.Tensor, vbits: torch.Tensor, k: int):
    """(keys, counts, n_unique) of every valid canonical k-mer of one packed
    chunk (aindex_tpu/kernels/spectrum.py:48): K5 in its packed mode."""
    return spectrum23(packed, vbits, k)


def sorted_spectrum(keyed: torch.Tensor):
    """Segment-reduce a flat int64 array of uint64 keys, SENTINEL = ignore
    (aindex_tpu/kernels/spectrum.py:121): K5 in its keys mode."""
    return spectrum23(keys=keyed)


# -- K5's ASCII entries: chunk_spectrum and _extract_canonical ----------------------

def _check_ascii(ascii_chunk: torch.Tensor, k: int) -> tuple[int, int]:
    """Validate ASCII rows; returns (rows, L) of the [..., L] input."""
    if ascii_chunk.dtype != torch.uint8 or ascii_chunk.dim() < 1 \
            or not ascii_chunk.is_contiguous():
        raise ValueError("ascii_chunk must be a contiguous uint8 [..., L] tensor")
    if not 1 <= k <= 31:
        raise ValueError(f"k={k} outside 1..31")
    length = ascii_chunk.shape[-1]
    if length < k:
        raise ValueError(f"sequence length {length} shorter than k={k}")
    rows = ascii_chunk.numel() // length
    if rows * (length - k + 1) >= INT32_LIMIT:
        raise ValueError(f"{rows * (length - k + 1)} windows exceed the kernel's int32 "
                         f"positions")
    return rows, length


def ascii_canonical_plain(ascii_chunk: torch.Tensor, k: int):
    """Plain version of ``ascii_canonical``."""
    codes, valid = window_codes(ascii_to_base_codes(ascii_chunk), k)
    return canonical_code64(codes, k), valid


def ascii_canonical(ascii_chunk: torch.Tensor, k: int):
    """(canonical int64 [..., L-k+1] (uint64 bits), valid bool) of every
    k-window (k <= 31) of uint8 [..., L] ASCII rows
    (aindex_tpu/index/sparse23.py:38 ``_extract_canonical``). Invalid
    windows keep the canonical code of their bases with a non-ACGT byte read
    as 3, as aindex_tpu computes it.

    A CPU tensor runs the plain version; a CUDA tensor launches K5's
    ``canonical23_ascii``."""
    rows, length = _check_ascii(ascii_chunk, k)
    if not _cuda.on_cuda(ascii_chunk):
        return ascii_canonical_plain(ascii_chunk, k)
    shape = (*ascii_chunk.shape[:-1], length - k + 1)
    dev = ascii_chunk.device
    canon = torch.empty(shape, dtype=torch.int64, device=dev)
    valid = torch.empty(shape, dtype=torch.bool, device=dev)
    if canon.numel():
        with torch.cuda.device(dev):
            KERNEL_CANONICAL.launch(ascii_chunk.data_ptr(), rows, length, k, canon.data_ptr(),
                                    valid.data_ptr(), _cuda.stream(dev))
    return canon, valid


def chunk_spectrum_plain(ascii_chunk: torch.Tensor, k: int):
    """Plain version of ``chunk_spectrum``."""
    canon, valid = ascii_canonical_plain(ascii_chunk, k)
    return _reduce_sorted_plain(canon[valid], canon.numel())


def chunk_spectrum(ascii_chunk: torch.Tensor, k: int):
    """(keys, counts, n_unique) of every valid canonical k-mer (k <= 31) of
    an ASCII chunk (aindex_tpu/kernels/spectrum.py:33): uint8 1-D, or
    [B, L] rows whose windows stay in their row. As ``spectrum23``'s, the
    results are padded to the window count: the unique keys ascending
    (int64 holding uint64 bits), then the sentinel key with count 0.

    A CPU tensor runs the plain version; a CUDA tensor launches K5's
    ``spectrum23_ascii``."""
    rows, length = _check_ascii(ascii_chunk, k)
    if not rows:
        raise ValueError("no rows: the chunk has no windows")
    if not _cuda.on_cuda(ascii_chunk):
        return chunk_spectrum_plain(ascii_chunk, k)
    return _launch_reduce(KERNEL_ASCII, ascii_chunk.device, rows * (length - k + 1), 2 * k,
                          ascii_chunk.data_ptr(), rows, length, k)


# -- K13 -------------------------------------------------------------------------

_U64_MAX = (1 << 64) - 1


def _u64_bits(x: int) -> int:
    """A uint64 value as the int64 of the same bits."""
    return x - (1 << 64) if x >> 63 else x


def _weights_u64(weights: torch.Tensor) -> torch.Tensor:
    """uint32 weights (uint32 or int32 storage) widened to int64; int64
    weights (uint64 bits) as they are."""
    return weights if weights.dtype == torch.int64 else as_unsigned(weights)


def sorted_spectrum_weighted_plain(keys: torch.Tensor, weights: torch.Tensor, lo: int = 0,
                                   hi: int = _U64_MAX):
    """Plain version of ``sorted_spectrum_weighted``, same arguments and
    results: a stable sort of the live keys in uint64 order, then the
    weight sums of each run in int64 (wrapping as uint64 adds do)."""
    flipped = _flip(keys)
    live = ((keys != SENTINEL_I64) & (flipped >= (_u64_bits(lo) ^ _I64_MIN))
            & (flipped < (_u64_bits(hi) ^ _I64_MIN)))
    k = keys[live]
    w = _weights_u64(weights)[live]
    order = torch.sort(_flip(k), stable=True).indices
    s, w = k[order], w[order]
    uniq, inverse = torch.unique_consecutive(s, return_inverse=True)
    n = uniq.numel()
    cap = keys.numel()
    out_keys = torch.full((cap,), SENTINEL_I64, dtype=torch.int64, device=keys.device)
    out_counts = torch.zeros(cap, dtype=torch.int64, device=keys.device)
    out_keys[:n] = uniq
    out_counts.index_add_(0, inverse, w)
    return out_keys, out_counts, torch.tensor(n, dtype=torch.int32, device=keys.device)


def sorted_spectrum_weighted(keys: torch.Tensor, weights: torch.Tensor, lo: int = 0,
                             hi: int = _U64_MAX):
    """Segment-reduce (key, weight) pairs: the keys of [lo, hi) other than
    the sentinel, sorted ascending in uint64 order, each with the sum of
    its weights (aindex_tpu/kernels/spectrum.py:149; the default range
    takes every key). The merge step of the sharded spectrum
    (``parallel/spectrum23.py``): a data shard's range of the gathered
    partial spectra.

    keys: contiguous 1-D int64 (uint64 bit patterns, -1 the sentinel);
    weights: uint32 (uint32 or int32 storage) or int64 (uint64 bits) of the
    same length. Returns (keys int64[n], counts int64[n] (uint64 bits),
    n_unique int32 scalar tensor), the unique keys first, padded with the
    sentinel and count 0.

    A CPU tensor runs the plain version; a CUDA tensor launches K13."""
    if keys.dtype != torch.int64 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous 1-D int64 tensor (uint64 bits)")
    if weights.dtype not in (torch.int32, torch.uint32, torch.int64) \
            or weights.shape != keys.shape or not weights.is_contiguous():
        raise ValueError("weights must be a contiguous uint32/int32/int64 tensor shaped "
                         "like keys")
    n = keys.numel()
    if not 0 < n < INT32_LIMIT:
        raise ValueError(f"{n} keys: the kernel takes 1 .. 2^31 - 2")
    if not 0 <= lo <= _U64_MAX or not 0 <= hi <= _U64_MAX:
        raise ValueError(f"range [{lo}, {hi}) is not of uint64 values")
    if not _cuda.on_cuda(keys, weights):
        return sorted_spectrum_weighted_plain(keys, weights, lo, hi)
    dev = keys.device
    key_bits = max(1, (max(hi, 1) - 1).bit_length())
    keys_out = torch.empty(n, dtype=torch.int64, device=dev)
    counts_out = torch.empty(n, dtype=torch.int64, device=dev)
    counters = torch.empty(2, dtype=torch.int32, device=dev)
    scratch = torch.empty(onesweep_scratch(n, sort_passes(key_bits), weights.element_size()),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        KERNEL_MERGE.launch(keys.data_ptr(), weights.data_ptr(), weights.element_size(), n, lo,
                            hi, key_bits, keys_out.data_ptr(), counts_out.data_ptr(),
                            counters.data_ptr(), scratch.data_ptr(), _cuda.stream(dev))
    return keys_out, counts_out, counters[1]


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


def host_window_codes(ascii_chunk: np.ndarray, k: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(codes uint64, valid) for every window of an ASCII byte chunk, on the
    host: the numpy version of kernels/encode.py's ``window_codes`` (the
    same k-step shift-or; aindex_tpu/kernels/spectrum.py:175)."""
    from aindex_torch.core import codec
    base = codec.bytes_to_base_codes(ascii_chunk)
    n_win = base.size - k + 1
    if n_win <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    invalid = (base >= 4).astype(np.int32)
    csum = np.concatenate([np.zeros(1, np.int32), np.cumsum(invalid, dtype=np.int32)])
    valid = (csum[k:] - csum[:-k]) == 0
    b = (base & 3).astype(np.uint64)
    acc = b[:n_win].copy()
    for j in range(1, k):
        acc <<= np.uint64(2)
        acc |= b[j:j + n_win]
    return acc, valid
