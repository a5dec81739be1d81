"""Sparse canonical 23-mer index: MPHF + checker + tf, queried on one
device through one of three engines.

Counterpart of aindex_tpu/index/sparse23.py, the redesign of PHASH_MAP
(reference: src/hash.hpp:82-353):

* counting is canonical (min of the forward and reverse-complement code,
  reference: src/count_kmers.cpp:132-136) and sort-based: each chunk's
  spectrum is one K5 call on the device (kernels/spectrum.py) instead of
  the reference's thread-local hash maps and merge (reference:
  src/count_kmers.cpp:47-64,334-341); the chunks' partial spectra merge on
  the host;
* the MPHF (index/mphf.py, host numpy + native peel) maps canonical code
  -> slot; ``checker`` holds the canonical code of every slot and ``tf``
  its count, both slot-ordered, as the reference's (reference:
  src/hash.hpp:123-140);
* every query is a verified probe on the device, on the engine that
  aindex_tpu's ``_query`` chooses (aindex_tpu/index/sparse23.py:313-369):
  the quotient cuckoo table (index/quotcuckoo.py; K6 for k-mers and codes,
  K7 for coverage) when ``quotcuckoo.eligible(n, k)``, else the wide
  cuckoo table for k <= 30 (index/cuckoo.py, K10), else the MPHF walk
  (K11). ``kernels/probe.py`` holds the query and coverage wrappers of
  all three.

The index lives on one device, named by every constructor: the card
(``"cuda"``) unless the caller asks for the CPU. On a CUDA device every
build and query step runs the kernels; on the CPU their plain versions.
Host arrays (``checker_host``, ``tf_host``) serve persistence, statistics
and the by-slot lookups.

Indexes built here or by aindex_tpu (ATPF ``.pf``) are keyed by the true
canonical code: one probe of min(code, revcomp) answers a query.
Reference-built indexes (emphf ``.pf``, index/emphf.py) are keyed by
kmer_counter's own canonical form, which the query cannot predict; they
take the reference's query rule, the forward code else its reverse
complement (reference: src/hash.hpp:123-140), and have no MPHF walk, so
k > 30 raises for them.

Note on lexicographic vs numeric canonical order: ASCII 'A'<'C'<'G'<'T' is
monotone with the 2-bit encoding, so string-min (reference get_pfid,
src/hash.hpp:150-170) equals numeric code-min.
"""

from __future__ import annotations

import numpy as np
import torch

from aindex_torch.constants import K23, SUFFIX_KMERS_BIN, SUFFIX_PF, SUFFIX_TF
from aindex_torch.core import codec
from aindex_torch.core.reads import blob_chunks, stream_blob_chunks
from aindex_torch.index import quotcuckoo
from aindex_torch.index.common import host_u32, packed_chunks, resolve_device
from aindex_torch.index.cuckoo import CuckooTable
from aindex_torch.index.emphf import EmphfMPHFAdapter, EmphfPF
from aindex_torch.index.mphf import MPHF
from aindex_torch.kernels import probe
from aindex_torch.kernels.lookup import MphfTables
from aindex_torch.kernels.spectrum import ascii_canonical, chunk_spectrum_packed, merge_spectra
from aindex_torch.trace import span, to_device


#: aindex_tpu/index/sparse23.py:38's name for kernels/spectrum.py's
#: ``ascii_canonical`` (K5's ``canonical23_ascii`` on a CUDA tensor)
_extract_canonical = ascii_canonical


def _is_reference_mphf(mphf) -> bool:
    return isinstance(mphf, EmphfMPHFAdapter)


def _spectrum_parts(chunk_iter, k: int, device: torch.device, on_progress=None
                    ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per-chunk (sorted unique keys uint64, counts uint32) on the host: K5
    on every packed chunk, its result fetched right after the launch."""
    parts: list[tuple[np.ndarray, np.ndarray]] = []
    for packed, vbits, done in packed_chunks(chunk_iter, device):
        keys, counts, n_unique = chunk_spectrum_packed(packed, vbits, k)
        n = int(n_unique)
        if n:
            parts.append((keys[:n].cpu().numpy().view(np.uint64),
                          host_u32(counts[:n])))
        if on_progress is not None:
            on_progress(done)
    return parts


def _blob_iter(blob: np.ndarray, k: int, chunk: int):
    return ((p, min(o + chunk, blob.size)) for p, o in blob_chunks(blob, k, chunk))


def _stream_iter(pieces, k: int, chunk: int):
    return ((p, o + chunk) for p, o in stream_blob_chunks(pieces, k, chunk))


def count_canonical_kmers(blob: np.ndarray, k: int = K23, chunk: int = 1 << 22,
                          reduce: str = "auto", mesh=None, on_progress=None, *,
                          device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """(unique canonical codes uint64, counts uint64) over all valid
    windows of the blob: aindex_tpu's ``count_canonical_kmers``.

    * ``mesh`` given: the data-parallel reduction, key-range sharded with
      one all-gather per batch (``parallel/spectrum23.py``), on the mesh's
      device;
    * otherwise per-chunk K5 on ``device`` and a host merge.

    ``reduce`` takes aindex_tpu's values ("auto", "device", "host") and
    raises ValueError for others; all three run the device reduce, since
    the port does not route chunk spectra between host and device (the
    result is the same bits)."""
    if reduce not in ("auto", "device", "host"):
        raise ValueError(f"reduce must be 'auto', 'device' or 'host', got {reduce!r}")
    if mesh is not None:
        from aindex_torch.parallel.spectrum23 import count_canonical_kmers_sharded
        return count_canonical_kmers_sharded(blob, mesh, k, chunk, on_progress=on_progress)
    device = resolve_device(device)
    return merge_spectra(_spectrum_parts(_blob_iter(blob, k, chunk), k, device,
                                         on_progress))


def count_canonical_kmers_stream(pieces, k: int = K23, chunk: int = 1 << 22,
                                 on_progress=None, *, device="cuda"
                                 ) -> tuple[np.ndarray, np.ndarray]:
    """Streaming spectrum over newline-terminated sequence byte pieces, in
    constant host memory (about one chunk plus the partial spectra)."""
    device = resolve_device(device)
    return merge_spectra(_spectrum_parts(_stream_iter(pieces, k, chunk), k, device,
                                         on_progress))


def codes_tensor(codes, valid, device: torch.device):
    """Codes (tensor, array or list of integers, read as uint64 bit
    patterns as aindex_tpu's ``astype(uint64)`` reads them) and an optional
    mask, as 1-D int64 / bool tensors on ``device``, and the codes' shape."""
    with span("aindex.index.codes_in"):
        if isinstance(codes, torch.Tensor):
            if codes.dtype == torch.uint64:
                codes = codes.view(torch.int64)
            elif codes.dtype == torch.uint32:
                codes = codes.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
            elif codes.dtype.is_floating_point or codes.dtype == torch.bool:
                raise TypeError(f"codes must be integers, got {codes.dtype}")
            else:
                codes = codes.to(torch.int64)
        else:
            arr = np.asarray(codes)
            if arr.dtype.kind not in "iu":
                raise TypeError(f"codes must be integers, got {arr.dtype}")
            codes = torch.from_numpy(np.ascontiguousarray(arr.astype(np.uint64)).view(np.int64))
        shape = tuple(codes.shape)
        codes = to_device(codes, device).reshape(-1).contiguous()
        if valid is not None:
            valid = to_device(torch.as_tensor(valid, dtype=torch.bool), device)
            if tuple(valid.shape) != shape:
                raise ValueError(f"valid shape {tuple(valid.shape)} differs from codes shape "
                                 f"{shape}")
            valid = valid.reshape(-1).contiguous()
        return codes, valid, shape


class SharedQueryOps:
    """Coverage + continuation-query surface (the part of aindex_tpu's
    ``SharedQueryOps`` this index uses). Requires ``self.k``,
    ``self._encode(kmers)``, ``self._ext_tf(ext_codes, cutoff)`` and
    ``self._coverage_rows(packed, vbits, rows, stride, cutoff)``."""

    # -- coverage -----------------------------------------------------------

    def sequence_coverage(self, seq: str, cutoff: int = 0) -> np.ndarray:
        return self.sequence_coverage_batch([seq], cutoff)[0]

    def sequence_coverage_batch(self, seqs: list[str], cutoff: int = 0
                                ) -> list[np.ndarray]:
        """Coverage for many sequences, one launch per length class
        (``codec.coverage_row_batches``); empty below k bases."""
        raws = [s.encode("ascii") for s in seqs]
        out = [np.zeros(0, dtype=np.uint32)] * len(seqs)
        for members, stride, packed, vbits in codec.coverage_row_batches(raws, self.k):
            cov = self._coverage_rows(packed, vbits, len(members), stride, cutoff)
            for row, i in enumerate(members):
                out[i] = cov[row, :len(raws[i]) - self.k + 1]
        return out

    # -- De Bruijn continuation queries ------------------------------------

    def _next_codes(self, kmers: list[str]) -> np.ndarray:
        codes, _ = self._encode(kmers)
        mask = np.uint64((1 << (2 * self.k)) - 1)
        return ((codes[:, None] << np.uint64(2)) | np.arange(4, dtype=np.uint64)) & mask

    def _prev_codes(self, kmers: list[str]) -> np.ndarray:
        codes, _ = self._encode(kmers)
        shift = np.uint64(2 * (self.k - 1))
        return (codes[:, None] >> np.uint64(2)) | (np.arange(4, dtype=np.uint64) << shift)

    def debruijn_next(self, kmers: list[str], cutoff: int = 0) -> np.ndarray:
        """tf of the 4 right extensions of each k-mer, shape (B, 4) in ACGT
        order (reference: src/debrujin.cpp:30-75). cutoff zeroes counts
        <= cutoff, as in the reference (:44-49)."""
        return self._ext_tf(self._next_codes(kmers), cutoff)

    def debruijn_prev(self, kmers: list[str], cutoff: int = 0) -> np.ndarray:
        """tf of the 4 left extensions, shape (B, 4) in ACGT order
        (reference: src/debrujin.cpp:120-170)."""
        return self._ext_tf(self._prev_codes(kmers), cutoff)

    def _cont_info(self, ext_codes: np.ndarray, cutoff: int) -> dict:
        """Batched CONT record (reference: src/debrujin.hpp:14-34): per
        k-mer the 4 extension tfs plus n (nonzero count), sum, and the best
        hit. The reference's if-chain takes the LAST base in ACGT order
        among the maxima (debrujin.cpp:56-75: every comparison is >=, later
        ifs overwrite), so ties resolve toward T, the all-zero case
        included (best_hit = 'T', tf 0)."""
        tf = self._ext_tf(ext_codes, cutoff).astype(np.uint32)
        best = 3 - np.argmax(tf[:, ::-1], axis=1)  # last argmax in ACGT
        rows = np.arange(tf.shape[0])
        return {
            "tf": tf,
            "n": (tf > 0).sum(axis=1).astype(np.uint32),
            "sum": tf.sum(axis=1, dtype=np.uint64).astype(np.uint32),
            "best_hit": np.array(list("ACGT"))[best],
            "best_hit_tf": tf[rows, best],
            "best_ukmer": ext_codes[rows, best].astype(np.uint64),
        }

    def debruijn_next_info(self, kmers: list[str], cutoff: int = 0) -> dict:
        """print_next's full CONT, batched (reference:
        src/debrujin.cpp:30-76): arrays ``tf`` [B, 4] in ACGT order,
        ``n``, ``sum``, ``best_hit`` (char), ``best_hit_tf``,
        ``best_ukmer`` (the code of the winning right extension)."""
        return self._cont_info(self._next_codes(kmers), cutoff)

    def debruijn_prev_info(self, kmers: list[str], cutoff: int = 0) -> dict:
        """print_prev's full CONT, batched (reference:
        src/debrujin.cpp:120-167; its shift is hard-coded to k=23,
        generalised here to this index's k)."""
        return self._cont_info(self._prev_codes(kmers), cutoff)


class Sparse23Index(SharedQueryOps):
    """Sparse canonical k-mer index (default k=23) with device queries."""

    def __init__(self, mphf, checker: np.ndarray, tf: np.ndarray,
                 k: int = K23, *, device="cuda"):
        if not isinstance(mphf, (MPHF, EmphfMPHFAdapter)):
            raise TypeError(f"expected an ATPF or emphf MPHF, got {type(mphf).__name__}")
        if _is_reference_mphf(mphf) and k > 30:
            # the cuckoo tables need keys < 2^62 and the emphf MPHF has no
            # device walk: fail at construction, not at the first query
            raise ValueError(
                f"k={k} with a reference emphf MPHF is unsupported: no "
                f"device query path exists for k > 30")
        self.k = k
        self.mphf = mphf  # MPHF or emphf.EmphfMPHFAdapter (duck-typed)
        self.checker_host = np.asarray(checker, dtype=np.uint64)
        self.tf_host = np.asarray(tf, dtype=np.uint32)
        self.device = resolve_device(device)
        # True-canonical keys (built here or by aindex_tpu) take one probe
        # of the canonical form; reference-built keys the reference's own
        # query rule (see the module docstring)
        self.canonical_keys = not _is_reference_mphf(mphf)
        self._quot: quotcuckoo.QuotCuckoo | None = None
        self._cuckoo: CuckooTable | None = None
        self._walk: MphfTables | None = None
        self._device_released = False
        #: seconds per build stage, filled by the builders
        self.build_seconds: dict[str, float] = {}

    @property
    def n(self) -> int:
        return self.mphf.n

    @property
    def rule(self) -> int:
        """The query rule of this index's keys (``kernels/probe.py``)."""
        return probe.CANON if self.canonical_keys else probe.FWD_RC

    @property
    def quot(self) -> quotcuckoo.QuotCuckoo | None:
        """The preferred engine (index/quotcuckoo.py), built on first use:
        the quotient cuckoo table (its device form: kernels/quot.py
        ``QuotTables``); None when the fingerprint-width floor makes the layout wasteful
        for this (n, k), or k > 30."""
        if self._quot is None and self.k <= 30 and quotcuckoo.eligible(self.n, self.k):
            with span("aindex.build.quot", timed=True):
                self._quot = quotcuckoo.QuotCuckoo.build(
                    self.checker_host, self.tf_host, np.arange(self.n, dtype=np.int32), self.k)
        return self._quot

    @property
    def cuckoo(self) -> CuckooTable | None:
        """The wide engine (index/cuckoo.py), built on first use: the wide
        cuckoo table (its device form: kernels/cuckoo.py ``CuckooTables``);
        None for k > 30."""
        if self._cuckoo is None and self.k <= 30:
            self._cuckoo = CuckooTable.build(
                self.checker_host, self.tf_host, np.arange(self.n, dtype=np.int32))
        return self._cuckoo

    @property
    def engine(self) -> str:
        """Which engine serves the queries: "quot", "cuckoo" or "walk"."""
        if self.quot is not None:
            return "quot"
        return "cuckoo" if self.k <= 30 else "walk"

    @property
    def tables(self):
        """The serving engine's tables on the index's device, as
        aindex_tpu's ``_query`` chooses them: the quotient table when
        eligible, else the wide cuckoo table (k <= 30), else the MPHF walk
        over the ATPF MPHF's g-values and the node records of the checker
        and tf (``MphfTables.from_host``), built once, in the timed span
        ``aindex.build.walk``. Raises after ``release_device``."""
        if self._device_released:
            raise RuntimeError(
                "device arrays were released by shard_to(); query through the sharded "
                "engine (AIndex facade) or the host paths")
        qc = self.quot
        if qc is not None:
            return qc.tables(self.device)
        ck = self.cuckoo
        if ck is not None:
            return ck.tables(self.device)
        if self._walk is None:
            if not isinstance(self.mphf, MPHF):
                raise RuntimeError(
                    f"no device query path for k={self.k}: the cuckoo tables "
                    "need k <= 30 and the emphf MPHF has no device walk")
            with span("aindex.build.walk", timed=True):
                self._walk = MphfTables.from_host(self.mphf, self.checker_host,
                                                  self.tf_host, self.device)
        return self._walk

    def release_device(self) -> None:
        """Drop every device-resident table (the quotient or wide cuckoo
        table, the MPHF walk's arrays) and pin the device paths shut
        (aindex_tpu/index/sparse23.py:535).

        Called by ``AIndex.shard_to`` once the mesh-sharded engine owns the
        queries: without it every rank would keep a whole replica of the
        index on its device and sharding would save nothing. Host arrays
        stay (save, iteration, statistics, host lookups)."""
        if self._quot is not None:
            self._quot.release_device()
        if self._cuckoo is not None:
            self._cuckoo.release_device()
        self._walk = None
        self._device_released = True

    # -- construction --------------------------------------------------

    @classmethod
    def _build(cls, chunk_iter, k: int, min_tf: int, on_progress, device
               ) -> "Sparse23Index":
        device = resolve_device(device)
        with span("aindex.build.spectrum", timed=True) as spectrum:
            parts = _spectrum_parts(chunk_iter, k, device, on_progress)
        with span("aindex.build.merge", timed=True) as merge:
            keys, counts = merge_spectra(parts)
            del parts
            if min_tf > 1:
                keep = counts >= min_tf
                keys, counts = keys[keep], counts[keep]
        with span("aindex.build.mphf", timed=True) as mphf:
            index = cls.from_spectrum(keys, counts, k, device=device)
        index.build_seconds = {"spectrum": spectrum.seconds, "merge": merge.seconds,
                               "mphf": mphf.seconds}
        return index

    @classmethod
    def build_from_blob(cls, blob: np.ndarray, k: int = K23, min_tf: int = 1,
                        chunk: int = 1 << 22, mesh=None, *, on_progress=None,
                        device="cuda") -> "Sparse23Index":
        """Count every valid canonical k-mer of a concatenated sequence blob
        (newlines and non-ACGT bytes invalidate their windows), keep those
        seen at least ``min_tf`` times, and index them. With ``mesh``, the
        count runs data-parallel over the mesh (``count_canonical_kmers``)
        and the index lives on the mesh's device."""
        if mesh is not None:
            from aindex_torch.parallel.mesh import mesh_device
            keys, counts = count_canonical_kmers(blob, k, chunk, mesh=mesh,
                                                 on_progress=on_progress)
            if min_tf > 1:
                keep = counts >= min_tf
                keys, counts = keys[keep], counts[keep]
            return cls.from_spectrum(keys, counts, k, device=mesh_device(mesh))
        return cls._build(_blob_iter(blob, k, chunk), k, min_tf, on_progress, device)

    @classmethod
    def build_from_stream(cls, pieces, k: int = K23, min_tf: int = 1,
                          chunk: int = 1 << 22, on_progress=None, *,
                          device="cuda") -> "Sparse23Index":
        """``build_from_blob`` over a stream of newline-terminated sequence
        byte pieces (``io.fastq.iter_sequence_bytes``), in constant host
        memory for the input."""
        return cls._build(_stream_iter(pieces, k, chunk), k, min_tf, on_progress, device)

    @classmethod
    def build_from_sequences(cls, sequences: list[str], k: int = K23,
                             min_tf: int = 1, *, device="cuda") -> "Sparse23Index":
        text = "".join(s + "\n" for s in sequences)
        blob = np.frombuffer(text.encode("ascii"), dtype=np.uint8)
        return cls.build_from_blob(blob, k, min_tf, device=device)

    @classmethod
    def from_spectrum(cls, keys: np.ndarray, counts: np.ndarray, k: int = K23, *,
                      device="cuda") -> "Sparse23Index":
        """Build the MPHF and the slot-ordered arrays from a (key, count)
        spectrum, the analogue of index_hash_pp (reference:
        src/hash.cpp:779-881). The per-key slots come out of the peel; keys
        that ascend strictly are distinct without the MPHF's re-sort check."""
        ks = np.ascontiguousarray(keys, dtype=np.uint64)
        ascending = ks.size < 2 or bool(np.all(ks[1:] > ks[:-1]))
        mphf, slot = MPHF.build_with_slots(ks, assume_unique=ascending)
        n = mphf.n
        checker = np.zeros(n, dtype=np.uint64)
        tf = np.zeros(n, dtype=np.uint32)
        if n:
            checker[slot] = keys
            tf[slot] = np.minimum(counts, np.iinfo(np.uint32).max).astype(np.uint32)
        return cls(mphf, checker, tf, k, device=device)

    @classmethod
    def from_numpy(cls, mphf_fields: dict, checker: np.ndarray, tf: np.ndarray,
                   k: int = K23, *, device="cuda") -> "Sparse23Index":
        """Index over another index's host arrays, e.g. aindex_tpu's:
        ``mphf_fields`` maps ``n``, ``domain``, ``seed``, ``g_packed`` and
        ``slots`` (the ATPF MPHF's fields, ``vars(index.mphf)``)."""
        f = mphf_fields
        mphf = MPHF(int(f["n"]), int(f["domain"]), int(f["seed"]),
                    np.array(f["g_packed"], dtype=np.uint32),
                    np.array(f["slots"], dtype=np.int32))
        return cls(mphf, np.array(checker, dtype=np.uint64),
                   np.array(tf, dtype=np.uint32), k, device=device)

    # -- persistence -----------------------------------------------------

    def save(self, prefix: str) -> None:
        """Write <prefix>.pf (ATPF) + .tf.bin (uint32 per slot) + .kmers.bin
        (uint64 per slot), the artifact triple of compute_index (reference:
        src/compute_index.cpp:59-67), byte-identical to aindex_tpu's."""
        self.mphf.save(prefix + SUFFIX_PF)
        self.tf_host.tofile(prefix + SUFFIX_TF)
        self.checker_host.tofile(prefix + SUFFIX_KMERS_BIN)

    def export_reference(self, prefix: str) -> None:
        """Write a fully reference-compatible artifact set: an emphf-layout
        .pf (loadable by the reference C++, reference:
        src/emphf/mphf.hpp:99-113) plus .tf.bin/.kmers.bin permuted into ITS
        slot order, so reference tooling can consume an index built here."""
        if _is_reference_mphf(self.mphf):
            self.save(prefix)  # already in reference slot order and format
            return
        keys = self.checker_host
        adapter = EmphfMPHFAdapter.build(keys, self.k)
        new_slot = adapter.lookup(keys)  # slot i here -> reference slot
        tf = np.zeros_like(self.tf_host)
        checker = np.zeros_like(self.checker_host)
        tf[new_slot] = self.tf_host
        checker[new_slot] = keys
        adapter.save(prefix + SUFFIX_PF)
        tf.tofile(prefix + SUFFIX_TF)
        checker.tofile(prefix + SUFFIX_KMERS_BIN)

    @classmethod
    def load(cls, prefix: str, k: int = K23, *, device="cuda") -> "Sparse23Index":
        """Load an artifact triple by prefix (see ``load_files``)."""
        return cls.load_files(prefix + SUFFIX_PF, prefix + SUFFIX_TF,
                              prefix + SUFFIX_KMERS_BIN, k, device=device)

    @classmethod
    def load_files(cls, pf_path: str, tf_path: str, kmers_path: str,
                   k: int = K23, *, device="cuda") -> "Sparse23Index":
        """Load from explicit artifact paths (the reference wrapper's
        ``load(hash, tf, kmers_bin, ...)`` form, reference:
        src/python_wrapper.cpp:228-245). The .pf may be either the ATPF
        format or the reference's emphf layout (auto-detected):
        reference-built index files load as they are, with the reference's
        own slot ids."""
        with open(pf_path, "rb") as f:
            magic = f.read(8)
        if magic == MPHF.MAGIC:
            mphf = MPHF.load(pf_path)
        elif EmphfPF.is_emphf_file(pf_path):
            mphf = EmphfMPHFAdapter.load(pf_path, k)
        else:
            raise ValueError(f"{pf_path}: neither ATPF nor emphf .pf format")
        tf = np.fromfile(tf_path, dtype=np.uint32)
        checker = np.fromfile(kmers_path, dtype=np.uint64)
        if tf.size != mphf.n or checker.size != mphf.n:
            raise ValueError(
                f"artifact size mismatch for {pf_path}: n={mphf.n}, "
                f"tf={tf.size}, kmers={checker.size}")
        return cls(mphf, checker, tf, k, device=device)

    # -- query plumbing ------------------------------------------------------

    def _encode(self, kmers: list[str]):
        return codec.encode_kmers(kmers, self.k)

    def _ascii_rows(self, kmers: list[str]) -> torch.Tensor:
        raw = "".join(kmers).encode("ascii")
        if len(raw) % self.k:
            raise ValueError(
                f"batch byte length {len(raw)} is not a multiple of k={self.k} "
                "(mixed-length or ragged k-mer batch)")
        rows = np.frombuffer(bytearray(raw), dtype=np.uint8).reshape(-1, self.k)
        return to_device(torch.from_numpy(rows), self.device)

    def _resolve_ascii(self, kmers: list[str]):
        """(tf uint32, slot int32, strand int32) per k-mer string: the
        engine's query kernel on the ASCII rows, under the index's rule."""
        tf, slot, strand = probe.query(self.tables, ascii=self._ascii_rows(kmers), k=self.k,
                                       rule=self.rule, slot=True, strand=True)
        return host_u32(tf), slot.cpu().numpy(), strand.cpu().numpy()

    def _ext_tf(self, ext_codes: np.ndarray, cutoff: int) -> np.ndarray:
        flat = to_device(torch.from_numpy(np.ascontiguousarray(ext_codes, dtype=np.uint64)
                                          .reshape(-1).view(np.int64)), self.device)
        tf = host_u32(probe.query(self.tables, flat, k=self.k, rule=self.rule))
        tf = tf.reshape(ext_codes.shape)
        if cutoff > 0:
            tf = np.where(tf <= cutoff, 0, tf)
        return tf

    def _coverage_rows(self, packed: np.ndarray, vbits: np.ndarray, rows: int,
                       stride: int, cutoff: int) -> np.ndarray:
        """Coverage of packed [rows, stride] rows: the engine's coverage
        kernel computes windows, the rule's probes and the cutoff in one
        launch; returns uint32[rows, stride - k] on the host."""
        cov = probe.coverage(self.tables,
                             to_device(torch.from_numpy(packed.view(np.int32)), self.device),
                             to_device(torch.from_numpy(vbits), self.device), rows, stride,
                             self.k, cutoff, self.rule)
        return host_u32(cov)

    # -- queries -----------------------------------------------------------

    def get_tf_values(self, kmers: list[str]) -> np.ndarray:
        """tf per k-mer, uint32 (get_freq semantics, reference:
        src/hash.hpp:123-140): verified probe of the canonical form (or the
        forward code, else its reverse complement, for reference-keyed
        indexes); 0 for absent k-mers and those with a non-ACGT base."""
        tf = probe.query(self.tables, ascii=self._ascii_rows(kmers), k=self.k, rule=self.rule)
        return host_u32(tf)

    def get_tf_values_codes(self, codes, valid=None) -> torch.Tensor:
        """Verified tf per pre-encoded 2-bit k-mer code: a ``torch.uint32``
        tensor shaped like ``codes`` on the index's device, one launch of
        the engine's query kernel (on the quotient table: revcomp +
        canonical + one bucket probe, no slot output). ``valid=None``
        asserts every code is a valid k-mer."""
        with span("aindex.index.query"):
            codes, valid, shape = codes_tensor(codes, valid, self.device)
            return probe.query(self.tables, codes, valid, k=self.k,
                               rule=self.rule).reshape(shape)

    def get_tf_both_directions(self, kmers: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """(fwd tf, rc tf). Both equal the verified canonical tf: the
        reference's per-direction probe applies fwd-else-rc itself
        (get_tf_value_23mer, reference: src/python_wrapper.cpp:610-627), so
        get_tf_both_directions_23mer (:1258-1273) returns (tf, tf) for a
        present k-mer and (0, 0) otherwise.

        A reference-keyed index may store both strands as distinct keys
        with different counts; the reference then returns (tf[kmer],
        tf[revcomp]), so there the second probe is resolved on its own."""
        tf = self.get_tf_values(kmers)
        if self.canonical_keys:
            return tf, tf.copy()
        return tf, self.get_tf_values([codec.revcomp(km) for km in kmers])

    def get_pfids(self, kmers: list[str]) -> np.ndarray:
        """Slot id per k-mer (int64); n (the invalid marker) when absent
        (get_pfid, reference: src/hash.hpp:150-170)."""
        _, slot, _ = self._resolve_ascii(kmers)
        slot = slot.astype(np.int64)
        return np.where(slot < 0, self.n, slot)

    def get_hash_values(self, kmers: list[str]) -> np.ndarray:
        """Raw (unverified) MPHF ids of the literal k-mer strings
        (reference: src/python_wrapper.cpp:629-641), on the host."""
        codes, _ = codec.encode_kmers(kmers, self.k)
        return np.asarray(self.mphf.lookup(codes)).astype(np.int64)

    def get_strands(self, kmers: list[str]) -> np.ndarray:
        """0 = not found, 1 = stored forward, 2 = stored as revcomp (int32;
        reference: src/python_wrapper.cpp:726-742)."""
        _, _, strand = self._resolve_ascii(kmers)
        return strand

    def get_kmer_by_kid(self, kid: int) -> str:
        if kid >= self.n or kid < 0:
            return ""
        return codec.decode_kmer(int(self.checker_host[kid]), self.k)

    def get_kmer_info(self, kid: int) -> tuple[int, str, str]:
        """(tf, kmer, rkmer), reference: src/python_wrapper.cpp:744-755."""
        if kid >= self.n or kid < 0:
            return 0, "", ""
        code = int(self.checker_host[kid])
        kmer = codec.decode_kmer(code, self.k)
        rkmer = codec.decode_kmer(codec.revcomp_code(code, self.k), self.k)
        return int(self.tf_host[kid]), kmer, rkmer

    # -- statistics ------------------------------------------------------

    def set_stats(self, coverage: int) -> dict:
        """Coverage-profile statistics record: zero/unique/distinct/total/
        max_count plus the clamped tf histogram ``profile`` (set_stats,
        reference: src/hash.hpp:297-323)."""
        from aindex_torch.core.stats import coverage_stats
        return coverage_stats(self.tf_host, coverage)

    def save_values(self, path: str, skip_zeros: bool = True
                    ) -> tuple[int, int, int]:
        """Slot-ordered ``kmer\\ttf`` text dump; returns (zeros, ones,
        other) tallies (save_values, reference: src/hash.hpp:261-289)."""
        from aindex_torch.core.stats import save_values
        return save_values(path, self.checker_host, self.tf_host, self.k, skip_zeros)

    def stats(self) -> dict:
        """zero/unique/distinct/total/max spectrum statistics
        (Stats, reference: src/hash.hpp:38-80)."""
        tf = self.tf_host
        return {
            "total_kmers": int(self.n),
            "non_zero_kmers": int(np.count_nonzero(tf)),
            "unique_kmers": int(np.count_nonzero(tf == 1)),
            "max_frequency": int(tf.max()) if tf.size else 0,
            "total_count": int(tf.sum(dtype=np.uint64)),
        }

