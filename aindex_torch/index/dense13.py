"""Dense 13-mer index: the complete 4^13 k-mer space as one device table.

Counterpart of aindex_tpu/index/dense13.py ``Dense13Index``. The k-mer's
own 2-bit code is the slot: the table is a dense uint32[67,108,864] tensor
(256 MB), counting adds every valid forward window of a build's chunks
at once (K1, ``kernels/count.py`` ``PackedCounter``), the fused forward +
reverse-complement table is one pass of paired tiles (K2, ``total13``
below), and every query family is one or two gathers (K3,
kernels/lookup.py) or the fused coverage pass (K4, kernels/coverage.py).

Counting is forward-strand only, as reference count_kmers13 does; fwd and
rc are combined once, in the total table. That table holds the same value
at a code and at its reverse complement, so the index holds only its half
(``tf_total_half``: the totals of the 2^25 codes whose middle base is A or
C, K2's half mode ``total13_half``), and each total query is one gather
there that folds the code to its slot (K3's ``gather13_half``); the full
``tf_total`` is built on request and not held.

The index lives on one device, named by every constructor: the card
(``"cuda"``) unless the caller asks for the CPU. On a CUDA device every
build and query step runs the CUDA kernels; on the CPU it runs their plain
PyTorch versions. Tables are held as uint32 (uint16,
uint8 for the narrowed query tables) in PyTorch's bare unsigned dtypes;
the kernels read their bits and the plain versions widen to int64.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from aindex_torch.constants import HALF_13, K13, SPACE_13
from aindex_torch.core.reads import blob_chunks, stream_blob_chunks
from aindex_torch.index.common import host_u32, packed_chunks, resolve_device
from aindex_torch.kernels import _cuda
from aindex_torch.kernels import coverage as cov_kernels
from aindex_torch.kernels.count import PackedCounter, count_batch_13, zeros_dev
from aindex_torch.kernels.encode import half_code13, revcomp_code13
from aindex_torch.kernels.lookup import gather13
from aindex_torch.trace import span, to_device

KERNEL_TOTAL = _cuda.KERNELS["total13"]
KERNEL_TOTAL_HALF = _cuda.KERNELS["total13_half"]

#: codes per step of the plain total tables (bounds their int64 temporaries)
_TOTAL_BLOCK = 1 << 22


def _total_plain(tf: torch.Tensor, n: int, codes_of) -> torch.Tensor:
    """out[i] = tf[c] + tf[revcomp(c)] with c = codes_of(i), for i < n, in
    blocks of codes, wrapping as uint32."""
    s = tf.view(torch.int32)
    out = torch.empty(n, dtype=torch.int32, device=s.device)
    for lo in range(0, n, _TOTAL_BLOCK):
        codes = codes_of(torch.arange(lo, lo + _TOTAL_BLOCK, dtype=torch.int64,
                                      device=s.device))
        out[lo:lo + _TOTAL_BLOCK] = s[codes] + s[revcomp_code13(codes)]
    return out.view(torch.uint32)


def total13_plain(tf: torch.Tensor) -> torch.Tensor:
    """Plain version of ``total13``."""
    return _total_plain(tf, SPACE_13, lambda codes: codes)


def total13_half_plain(tf: torch.Tensor) -> torch.Tensor:
    """Plain version of ``total13_half``: ``total13(tf)`` at the codes
    ``half_code13`` gives, slot by slot."""
    return _total_plain(tf, HALF_13, half_code13)


def _total(tf: torch.Tensor, n: int, kernel, plain) -> torch.Tensor:
    if tf.dtype not in (torch.int32, torch.uint32) or tf.shape != (SPACE_13,) \
            or not tf.is_contiguous():
        raise ValueError(f"tf must be a contiguous uint32[{SPACE_13}] table")
    if not _cuda.on_cuda(tf):
        return plain(tf)
    out = torch.empty(n, dtype=torch.int32, device=tf.device)
    with torch.cuda.device(tf.device):
        kernel.launch(tf.data_ptr(), out.data_ptr(), _cuda.stream(tf.device))
    return out.view(torch.uint32)


def total13(tf: torch.Tensor) -> torch.Tensor:
    """tf_total[c] = tf[c] + tf[revcomp(c)] for every code, modulo 2^32
    (aindex_tpu/index/dense13.py:83 ``_build_total_table``).

    A CPU tensor runs the plain version; a CUDA tensor launches K2."""
    return _total(tf, SPACE_13, KERNEL_TOTAL, total13_plain)


def total13_half(tf: torch.Tensor) -> torch.Tensor:
    """The half total table, uint32[2^25]: slot h holds ``total13(tf)`` at
    the code whose middle base is A or C and whose ``half_index13`` is h,
    so ``half[half_index13(c)] == total13(tf)[c]`` for every code.

    A CPU tensor runs the plain version; a CUDA tensor launches K2's half
    mode (the leading tiles alone)."""
    return _total(tf, HALF_13, KERNEL_TOTAL_HALF, total13_half_plain)


def _narrow(table: torch.Tensor) -> torch.Tensor:
    """The table at the smallest exact width (uint8, uint16 or uint32):
    random gathers move fewer bytes, and a narrower table holds more of its
    entries in the H100's 50 MB L2 (PERF.md §6 gives the card's random-read
    rate by footprint). Exact, never saturating."""
    s = table.view(torch.int32)
    if bool((s < 0).any()):
        return table
    max_v = int(s.max())
    if max_v < (1 << 8):
        return s.to(torch.uint8)
    if max_v < (1 << 16):
        return s.to(torch.int16).view(torch.uint16)
    return table


def _count_step(counts: torch.Tensor, ascii: torch.Tensor) -> torch.Tensor:
    """``count_batch_13`` at k = 13 over the 4^13 table, in place
    (aindex_tpu/index/dense13.py:29, which jits it with donation): K16 on a
    CUDA tensor. No build calls it; the builds count packed chunks (K1)."""
    return count_batch_13(counts, ascii, K13, SPACE_13)


def _count(counts: torch.Tensor, chunk_iter, on_progress) -> None:
    """Every packed chunk (double-buffered on CUDA, see
    ``common.packed_chunks``) into a ``PackedCounter`` of ``counts``, then
    one count of them all (K1), in the timed span ``aindex.build.count``."""
    with span("aindex.build.count", timed=True):
        counter = PackedCounter(counts)
        for packed, vbits, done in packed_chunks(chunk_iter, counts.device):
            counter.add(packed, vbits)
            if on_progress is not None:
                on_progress(done)
        counter.finish()
        if counts.device.type == "cuda":
            torch.cuda.synchronize(counts.device)


def _count_blob_sharded(blob: np.ndarray, mesh, chunk: int, on_progress=None) -> torch.Tensor:
    """Mesh-streamed dense count (aindex_tpu/index/dense13.py:39): this
    rank's row of every [n_data, chunk] batch counted at once (K1,
    double-buffered, ``_count``), then one all_reduce over ``data``.
    Summing each rank's whole table once after the last batch gives the
    bits of a sum per batch: uint32 addition wraps associatively."""
    from aindex_torch.parallel.count13 import merge_counts
    from aindex_torch.parallel.distributed import local_row_chunks
    from aindex_torch.parallel.mesh import mesh_device

    counts = torch.zeros(SPACE_13, dtype=torch.int32, device=mesh_device(mesh))
    _count(counts, local_row_chunks(blob, K13, chunk, mesh), on_progress)
    return merge_counts(counts, mesh).view(torch.uint32)


class Dense13Index:
    """Complete dense 13-mer frequency table on one device."""

    k = K13
    space = SPACE_13

    def __init__(self, tf: torch.Tensor, tf_host: np.ndarray | None = None):
        """``tf``: uint32 (or int32 storage of uint32) [4^13] on the index's
        device; ``tf_host``: an optional host copy (uint32, or the exact
        uint64 table when ``tf`` saturated)."""
        if tf.shape != (SPACE_13,) or tf.dtype not in (torch.int32, torch.uint32):
            raise ValueError(f"expected a uint32[{SPACE_13}] table, got "
                             f"{tf.dtype}{tuple(tf.shape)}")
        self._tf = tf.contiguous().view(torch.int32)
        self._tf_host: np.ndarray | None = tf_host
        self._tf_total_half: torch.Tensor | None = None
        self._tf_query: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self._tf.device

    @property
    def tf(self) -> torch.Tensor:
        """The uint32[4^13] count table on the index's device."""
        return self._tf.view(torch.uint32)

    @property
    def tf_total(self) -> torch.Tensor:
        """Fused fwd+rc table over every code, tf_total[c] = tf[c] +
        tf[revcomp(c)] (K2), at the smallest exact width (see ``_narrow``).
        Built on each access and not held: the total queries read
        ``tf_total_half``."""
        return _narrow(total13(self.tf))

    @property
    def tf_total_half(self) -> torch.Tensor:
        """``tf_total`` at one code of each reverse-complement pair
        (``total13_half``), built once (K2's half mode) so that each total
        query is one gather (K3 folds the code); the same values at the
        same width as ``tf_total``, in half its bytes."""
        if self._tf_total_half is None:
            with span("aindex.index.total", timed=True):
                self._tf_total_half = _narrow(total13_half(self.tf))
        return self._tf_total_half

    @property
    def tf_query(self) -> torch.Tensor:
        """Smallest-width copy of tf for forward-strand query gathers."""
        if self._tf_query is None:
            with span("aindex.index.total", timed=True):
                self._tf_query = _narrow(self.tf)
        return self._tf_query

    # -- construction --------------------------------------------------

    @classmethod
    def build_from_blob(cls, blob: np.ndarray, chunk: int = 1 << 22, mesh=None,
                        on_progress=None, *, device="cuda") -> "Dense13Index":
        """Count all forward-strand 13-mers of a concatenated sequence blob,
        streamed through the device in overlapping chunks (newlines and
        non-ACGT bytes invalidate their windows).

        With ``mesh``, each rank counts its own ``data`` row of every batch
        of chunks and one all_reduce merges the tables
        (``_count_blob_sharded``); the table lives on the mesh's device on
        every rank."""
        if mesh is not None:
            return cls(_count_blob_sharded(blob, mesh, chunk, on_progress))
        total = blob.size
        return cls._count_chunk_iter(
            ((p, min(o + chunk, total)) for p, o in blob_chunks(blob, K13, chunk)),
            on_progress, device=device)

    @classmethod
    def _count_chunk_iter(cls, chunk_iter, on_progress=None, *,
                          device="cuda") -> "Dense13Index":
        """Count over (chunk, bytes_done) pairs; chunks cross to the device
        in the packed ingest format (codec.pack_ascii_chunk, 0.375
        bytes/base)."""
        counts = zeros_dev(SPACE_13, torch.int32, device=device)
        _count(counts, chunk_iter, on_progress)
        return cls(counts)

    @classmethod
    def build_from_stream(cls, pieces, chunk: int = 1 << 22, on_progress=None,
                          *, device="cuda") -> "Dense13Index":
        """Count from a stream of newline-terminated sequence byte pieces in
        constant host memory (the CLI ``count`` path for multi-GB inputs)."""
        return cls._count_chunk_iter(
            ((p, o + chunk) for p, o in stream_blob_chunks(pieces, K13, chunk)),
            on_progress, device=device)

    @classmethod
    def build_from_sequences(cls, sequences: list[str], chunk: int = 1 << 22,
                             *, device="cuda") -> "Dense13Index":
        text = "".join(s + "\n" for s in sequences)
        blob = np.frombuffer(text.encode("ascii"), dtype=np.uint8)
        return cls.build_from_blob(blob, chunk, device=device)

    @classmethod
    def from_numpy(cls, tf: np.ndarray, device="cuda") -> "Dense13Index":
        """Index over a host table, e.g. ``np.asarray(jax_index.tf)`` or a
        ``tf_host`` of either package: uint32 as it is, uint64 under
        ``load``'s saturate-and-keep-exact rule."""
        tf = np.asarray(tf)
        if tf.shape != (SPACE_13,):
            raise ValueError(f"expected shape ({SPACE_13},), got {tf.shape}")
        if tf.dtype == np.uint64:
            return cls._from_raw_u64(tf, "from_numpy", device)
        if tf.dtype != np.uint32:
            raise ValueError(f"expected a uint32 or uint64 table, got {tf.dtype}")
        return cls._from_host_u32(tf, tf, device)

    @classmethod
    def _from_host_u32(cls, tf: np.ndarray, tf_host: np.ndarray,
                       device) -> "Dense13Index":
        device = resolve_device(device)
        # a copy: the index's table must not alias the caller's array
        dev_tf = torch.from_numpy(np.array(tf, dtype=np.uint32).view(np.int32))
        with span("aindex.index.upload", timed=True):
            return cls(to_device(dev_tf, device), tf_host=tf_host)

    # -- persistence (.tf.bin = uint64 x 4^13 in code order, the same file
    #    aindex_tpu writes and reads) ---------------------------------------

    def save(self, tf_path: str) -> None:
        np.asarray(self.tf_host, dtype=np.uint64).tofile(tf_path)

    @classmethod
    def load(cls, tf_path: str, pf_path: str | None = None, *,
             device="cuda") -> "Dense13Index":
        """Load a dense uint64 x 4^13 table.

        Tables of this package and of aindex_tpu are in k-mer code order.
        Reference-built tables (count_kmers13, reference:
        src/count_kmers13.cpp:358-388) are in MPHF-slot order; pass the
        matching emphf ``pf_path`` (the reference's 13-mer ``.pf``) to
        reorder them on load: 4^13 Jenkins lookups on the host, once
        (``emphf.dense_slot_permutation`` caches the permutation)."""
        raw = np.fromfile(tf_path, dtype=np.uint64, count=SPACE_13)
        if raw.size != SPACE_13:
            raise ValueError(f"{tf_path}: expected {SPACE_13} uint64 entries, got {raw.size}")
        if pf_path is not None:
            from aindex_torch.index.emphf import EmphfPF, unpermute_dense_tf
            raw = unpermute_dense_tf(raw, EmphfPF.load(pf_path), K13)
        return cls._from_raw_u64(raw, tf_path, device)

    @classmethod
    def _from_raw_u64(cls, raw: np.ndarray, origin: str, device) -> "Dense13Index":
        u32max = np.iinfo(np.uint32).max
        over = raw > u32max
        if over.any():
            # counts beyond uint32 (a >600 Gbp corpus): the device table
            # saturates, the uint64 host table stays exact, so save() and
            # the host-table reads keep full precision
            logging.getLogger(__name__).warning(
                "%s: %d of %d counts exceed uint32 (max %d); device-path "
                "queries saturate at %d, host-path queries stay exact",
                origin, int(over.sum()), raw.size, int(raw.max()), u32max)
            clipped = np.minimum(raw, u32max).astype(np.uint32)
            return cls._from_host_u32(clipped, raw, device)
        clipped = raw.astype(np.uint32)
        return cls._from_host_u32(clipped, clipped, device)

    # -- host table ------------------------------------------------------

    @property
    def tf_host(self) -> np.ndarray:
        """Host copy of the table (pulled from the device once)."""
        if self._tf_host is None:
            self._tf_host = host_u32(self._tf)
        return self._tf_host

    # -- queries (batch-first) -------------------------------------------

    def _ascii_rows(self, kmers: list[str]) -> torch.Tensor:
        raw = "".join(kmers).encode("ascii")
        if len(raw) % K13:
            raise ValueError(
                f"batch byte length {len(raw)} is not a multiple of k={K13} "
                "(mixed-length or ragged k-mer batch)")
        rows = np.frombuffer(bytearray(raw), dtype=np.uint8).reshape(-1, K13)
        return to_device(torch.from_numpy(rows), self.device)

    def get_tf_values(self, kmers: list[str]) -> np.ndarray:
        """Forward-strand tf per k-mer (get_tf_value_13mer semantics), uint32;
        0 for a k-mer with a non-ACGT base."""
        return host_u32(gather13(self.tf_query, ascii=self._ascii_rows(kmers)))

    def get_total_tf_values(self, kmers: list[str]) -> np.ndarray:
        """fwd + rc tf per k-mer: one gather in ``tf_total_half``, uint32."""
        return host_u32(gather13(self.tf_total_half, ascii=self._ascii_rows(kmers)))

    def get_tf_both_directions(self, kmers: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """(fwd tf, rc tf) per k-mer, uint32 each."""
        fwd, rc = gather13(self.tf_query, ascii=self._ascii_rows(kmers), both=True)
        return host_u32(fwd), host_u32(rc)

    def _codes_in(self, codes, valid):
        """Codes (tensor, array or list; any integer dtype, read as uint32
        bit patterns as JAX's int32 cast does) and an optional mask, as
        contiguous int32/bool tensors on the index's device."""
        with span("aindex.index.codes_in"):
            if isinstance(codes, torch.Tensor):
                if codes.dtype == torch.uint32:
                    codes = codes.view(torch.int32)
                elif codes.dtype != torch.int32:
                    codes = codes.to(torch.int32)
            else:
                arr = np.asarray(codes)
                if arr.dtype.kind not in "iu":
                    raise TypeError(f"codes must be integers, got {arr.dtype}")
                codes = torch.from_numpy(arr.astype(np.uint32).view(np.int32))
            codes = to_device(codes, self.device).contiguous()
            if valid is not None:
                valid = to_device(torch.as_tensor(valid, dtype=torch.bool), self.device)
                if valid.shape != codes.shape:
                    raise ValueError(f"valid shape {tuple(valid.shape)} differs "
                                     f"from codes shape {tuple(codes.shape)}")
                valid = valid.contiguous()
            return codes, valid

    def get_tf_values_codes(self, codes, valid=None) -> torch.Tensor:
        """Forward-strand tf per pre-encoded 2-bit 13-mer code: uint32 on
        the index's device, one gather, no string encode. ``valid=None``
        asserts every code is valid (no mask)."""
        with span("aindex.index.query"):
            codes, valid = self._codes_in(codes, valid)
            return gather13(self.tf_query, codes, valid)

    def get_total_tf_values_codes(self, codes, valid=None) -> torch.Tensor:
        """fwd + rc tf per pre-encoded code, one gather in
        ``tf_total_half``."""
        with span("aindex.index.query"):
            codes, valid = self._codes_in(codes, valid)
            return gather13(self.tf_total_half, codes, valid)

    def get_tf_by_index(self, index: int) -> int:
        """tf by raw table index (get_tf_by_index_13mer)."""
        return int(self.tf_host[index])

    def get_tf_array(self) -> np.ndarray:
        return self.tf_host

    def sequence_coverage(self, seq: str, cutoff: int = 0) -> np.ndarray:
        """Per-position forward tf vector over a sequence."""
        return cov_kernels.coverage_dense(self.tf_query, seq, K13, cutoff)

    def sequence_coverage_batch(self, seqs: list[str], cutoff: int = 0
                                ) -> list[np.ndarray]:
        """Coverage for many sequences in few launches (length classes)."""
        return cov_kernels.coverage_dense_batch(self.tf_query, seqs, K13, cutoff)

    # -- statistics ------------------------------------------------------

    def set_stats(self, coverage: int) -> dict:
        """Coverage-profile statistics over the table (set_stats)."""
        from aindex_torch.core.stats import coverage_stats
        return coverage_stats(self.tf_host, coverage)

    def save_values(self, path: str, skip_zeros: bool = True
                    ) -> tuple[int, int, int]:
        """Code-ordered ``kmer\\ttf`` text dump; returns (zeros, ones,
        other)."""
        from aindex_torch.core.stats import save_values
        codes = np.arange(SPACE_13, dtype=np.uint64)
        return save_values(path, codes, self.tf_host, K13, skip_zeros)

    def stats(self) -> dict:
        """total/non_zero/max/total_count (get_13mer_statistics). Served
        from the host table when there is one (it is exact when the device
        table saturated), else computed on the device without a pull."""
        if self._tf_host is not None:
            tf = self._tf_host
            return {
                "total_kmers": SPACE_13,
                "non_zero_kmers": int(np.count_nonzero(tf)),
                "max_frequency": int(tf.max()) if tf.size else 0,
                "total_count": int(tf.sum(dtype=np.uint64)),
            }
        s = self._tf                  # int32 storage of uint32 counts
        neg = s < 0                   # counts >= 2^31
        n_neg = int(neg.sum())
        if n_neg:
            max_v = int(torch.where(neg, s, torch.iinfo(torch.int32).min).max()) + (1 << 32)
        else:
            max_v = int(s.max())
        return {
            "total_kmers": SPACE_13,
            "non_zero_kmers": int(torch.count_nonzero(s)),
            "max_frequency": max_v,
            "total_count": int(s.sum(dtype=torch.int64)) + (n_neg << 32),
        }
