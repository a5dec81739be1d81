"""Reads storage: the concatenated reads blob plus offset indexes.

Mirrors the on-disk reads model of the reference: a ``.reads`` file with one
sequence per line (paired-end reads joined as ``r1 ~ revcomp(r2)``,
reference: src/compute_reads.cpp:89-98) and a tab-separated ``.ridx``
(rid, start, end). Unlike the reference's linear interval scan for
position->read resolution (reference: src/python_wrapper.cpp:65-73),
rid lookup here is a binary search over the sorted start offsets
(SURVEY.md section 7.5).

The blob itself is the unit of device streaming: k-mer positions are *global
byte offsets* into this blob, exactly as in the reference, so window
extraction can run on fixed-size overlapping chunks of the blob with no
read-boundary bookkeeping (separators invalidate windows by themselves).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from aindex_torch.core.codec import revcomp


@dataclasses.dataclass
class ReadsStore:
    blob: np.ndarray                 # uint8, full .reads file contents (with newlines)
    starts: np.ndarray               # int64[n_reads], byte offset of each read
    ends: np.ndarray                 # int64[n_reads], end offset (exclusive)
    headers: list[str] | None = None

    @property
    def n_reads(self) -> int:
        return len(self.starts)

    @property
    def reads_size(self) -> int:
        return int(self.blob.size)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_reads_file(cls, reads_path: str, ridx_path: str | None = None,
                        header_path: str | None = None,
                        mmap: bool = False) -> "ReadsStore":
        """``mmap=True`` maps the blob instead of reading it: pages load on
        first touch, so a multi-host build that only materialises its own
        mesh rows (blob_chunk_batches row_range) never reads other hosts'
        bytes from the filesystem."""
        if mmap:
            blob = np.memmap(reads_path, dtype=np.uint8, mode="r")
        else:
            blob = np.fromfile(reads_path, dtype=np.uint8)
        if ridx_path:
            rows = np.loadtxt(ridx_path, dtype=np.int64, ndmin=2)
            starts, ends = rows[:, 1].copy(), rows[:, 2].copy()
        else:
            starts, ends = cls._scan_newlines(blob)
        headers = None
        if header_path:
            headers = []
            with open(header_path) as fh:
                for line in fh:
                    headers.append(line.rstrip("\n").split("\t")[0])
        return cls(blob, starts, ends, headers)

    @classmethod
    def from_sequences(cls, sequences: list[str]) -> "ReadsStore":
        text = "".join(s + "\n" for s in sequences)
        blob = np.frombuffer(text.encode("ascii"), dtype=np.uint8)
        starts, ends = cls._scan_newlines(blob)
        return cls(blob.copy(), starts, ends)

    @staticmethod
    def _scan_newlines(blob: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        nl = np.flatnonzero(blob == ord("\n"))
        ends = nl.astype(np.int64)
        starts = np.empty_like(ends)
        starts[0] = 0
        starts[1:] = ends[:-1] + 1
        # trailing data without newline
        if blob.size and blob[-1] != ord("\n"):
            starts = np.append(starts, ends[-1] + 1 if ends.size else 0)
            ends = np.append(ends, blob.size)
        return starts, ends

    # -- queries -----------------------------------------------------------

    def get_read_by_rid(self, rid: int) -> str:
        s, e = int(self.starts[rid]), int(self.ends[rid])
        return self.blob[s:e].tobytes().decode("ascii")

    def get_read(self, start: int, end: int, rc: bool = False) -> str:
        seq = self.blob[start:end].tobytes().decode("ascii")
        return revcomp(seq) if rc else seq

    def rid_by_pos(self, pos: int | np.ndarray) -> int | np.ndarray:
        """read id containing blob offset ``pos`` (binary search, not the
        reference's O(n_reads) interval scan)."""
        idx = np.searchsorted(self.starts, np.asarray(pos), side="right") - 1
        return int(idx) if np.isscalar(pos) else idx

    def start_by_pos(self, pos: int) -> int:
        return int(self.starts[self.rid_by_pos(pos)])

    def iter_reads(self) -> Iterator[tuple[int, str]]:
        for rid in range(self.n_reads):
            yield rid, self.get_read_by_rid(rid)

    def iter_reads_se(self) -> Iterator[tuple[int, int, str]]:
        """Paired reads split at '~' (aindex/core/aindex.py:280-290)."""
        for rid, read in self.iter_reads():
            for idx, subread in enumerate(read.split("~")):
                yield rid, idx, subread

    # -- persistence -------------------------------------------------------

    def save(self, prefix: str) -> tuple[str, str]:
        reads_path = prefix + ".reads"
        ridx_path = prefix + ".ridx"
        self.blob.tofile(reads_path)
        with open(ridx_path, "w") as f:
            for rid in range(self.n_reads):
                f.write(f"{rid}\t{self.starts[rid]}\t{self.ends[rid]}\n")
        return reads_path, ridx_path


def blob_chunks(blob: np.ndarray, k: int, chunk: int = 1 << 22
                ) -> Iterator[tuple[np.ndarray, int]]:
    """Fixed-size overlapping chunks of the reads blob for device streaming.

    Consecutive chunks overlap by k-1 bytes so every k-window is produced
    exactly once — the functional analogue of the reference's worker start
    pull-back (reference: src/hash.hpp:414-423). The final chunk is
    padded with newline bytes (invalid windows) to keep shapes static.

    Yields (ascii_chunk[chunk], global_start_offset).
    """
    for lazy, off in blob_chunks_lazy(blob, k, chunk):
        yield lazy.materialise(), off


def stream_blob_chunks(pieces: Iterator[np.ndarray], k: int,
                       chunk: int = 1 << 22
                       ) -> Iterator[tuple[np.ndarray, int]]:
    """``blob_chunks`` semantics over a byte-piece stream, constant memory.

    ``pieces`` yields uint8 arrays (e.g. one newline-terminated sequence
    each); chunks come out overlapping by k-1 bytes exactly as if the
    pieces had been concatenated into one blob first — but only ~one chunk
    of buffer is ever resident, so counting a multi-GB input holds steady
    memory (the streaming analogue of the reference's producer thread,
    reference: src/count_kmers13.cpp:166-183).
    """
    step = chunk - (k - 1)
    pad_byte = ord("\n")
    # (buf, cursor): pending pieces + a read cursor into buf[0], so a huge
    # single piece (whole-chromosome FASTA) is never re-concatenated per
    # chunk — consuming it is O(N), not O(N^2 / chunk)
    buf: list[np.ndarray] = []
    buffered = 0
    off = 0
    for piece in pieces:
        buf.append(piece)
        buffered += piece.size
        while buffered >= chunk:
            if buf[0].size >= chunk:
                head = buf[0]
            else:
                head = np.concatenate(buf)  # only the small-piece prefix
                buf = [head]
            yield head[:chunk], off
            off += step
            buf[0] = head[step:]
            buffered -= step
    if buffered:
        tail = buf[0] if len(buf) == 1 else np.concatenate(buf)
        if tail.size > k - 1 or off == 0:
            if off == 0:
                # single-chunk stream: tighten like blob_chunks does
                chunk = 1 << max(max(tail.size, k + 127) - 1,
                                 255).bit_length()
            padded = np.concatenate(
                [tail, np.full(chunk - tail.size, pad_byte, dtype=np.uint8)])
            yield padded, off


@dataclasses.dataclass
class _LazyChunk:
    """A blob chunk that is sliced (and padded) only when materialised —
    so a host can skip other hosts' rows without touching their bytes."""
    blob: np.ndarray
    off: int
    width: int

    def materialise(self) -> np.ndarray:
        piece = np.asarray(self.blob[self.off:self.off + self.width])
        if piece.size < self.width:
            piece = np.concatenate(
                [piece, np.full(self.width - piece.size, ord("\n"),
                                dtype=np.uint8)])
        return piece


def blob_chunks_lazy(blob: np.ndarray, k: int,
                     chunk: int) -> Iterator[tuple[_LazyChunk, int]]:
    """``blob_chunks`` grid without materialising pieces (see _LazyChunk).

    Small blobs tighten the (single) chunk to the next power of two
    (>= 256): padding a 3 MB blob out to a 16 MB default chunk would spend
    5x the kernel time on newline filler, while power-of-two quantisation
    keeps the chunk grid identical to aindex_tpu's (same pieces, same
    offsets) and 128-aligned for the packed ingest's 16-base words.
    NOTE: when the requested ``chunk`` is not itself a power of two, the
    quantised single chunk may be LARGER than requested (chunk=3MB over a
    2.5MB blob yields one 4MB piece) — callers sizing buffers from
    ``chunk`` should round it up to a power of two themselves.
    """
    if blob.size == 0:
        return
    if blob.size < chunk:
        chunk = 1 << max(max(blob.size, k + 127) - 1, 255).bit_length()
    step = chunk - (k - 1)
    for off in range(0, max(blob.size - (k - 1), 1), step):
        yield _LazyChunk(blob, off, chunk), off
