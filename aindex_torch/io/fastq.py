"""Sequence file parsing and reads preparation.

Host-side I/O layer: FASTA/FASTQ/plain parsing with format sniffing
(reference: src/count_kmers13.cpp:194-206, aindex/cli.py:380-399) and
the compute_reads transformation (paired-end reads joined as
``r1 ~ revcomp(r2)``; reference: src/compute_reads.cpp:20-225).
"""

from __future__ import annotations

import gzip
import os

import numpy as np

from aindex_torch.core.codec import revcomp


def is_gzip(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def open_text(path: str):
    """Text handle with transparent gzip decompression (detected by magic,
    not extension). The reference requires a separate destructive
    ``gzip -d`` pass (reference: scripts/compute_aindex.py:104-107);
    here every reader streams .gz inputs in place."""
    if is_gzip(path):
        return gzip.open(path, "rt")
    return open(path)


def sniff_format(path: str) -> str:
    """'fasta' | 'fastq' | 'reads' by first byte ('>' / '@' / other);
    gzipped inputs are sniffed on the decompressed stream."""
    if is_gzip(path):
        with gzip.open(path, "rb") as f:
            first = f.read(1)
    else:
        with open(path, "rb") as f:
            first = f.read(1)
    if first == b">":
        return "fasta"
    if first == b"@":
        return "fastq"
    return "reads"


def iter_fasta(path: str):
    """Yield (header, sequence) with multi-line sequences concatenated."""
    header, parts = None, []
    with open_text(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if header is not None and parts:
                    yield header, "".join(parts)
                header, parts = line[1:], []
            else:
                parts.append(line)
    if header is not None and parts:
        yield header, "".join(parts)


def iter_fastq(path: str):
    """Yield (header, sequence) from a 4-line-record FASTQ."""
    with open_text(path) as f:
        while True:
            head = f.readline()
            if not head:
                return
            seq = f.readline().rstrip("\n")
            f.readline()  # +
            f.readline()  # quality
            yield head.rstrip("\n")[1:], seq


def read_sequences(path: str, fmt: str | None = None) -> list[str]:
    """All sequences of a FASTA/FASTQ/plain-reads file (auto-sniffed)."""
    fmt = fmt or sniff_format(path)
    if fmt == "fasta":
        return [seq for _, seq in iter_fasta(path)]
    if fmt == "fastq":
        return [seq for _, seq in iter_fastq(path)]
    seqs = []
    with open_text(path) as f:
        for line in f:
            line = line.strip()
            if line:
                seqs.append(line)
    return seqs


def iter_sequence_bytes(path: str, fmt: str | None = None):
    """Yield each sequence as a newline-terminated uint8 array, streaming.

    The constant-memory feed for ``stream_blob_chunks`` — counting a
    multi-GB input never materialises the sequence list (unlike
    ``read_sequences``)."""
    fmt = fmt or sniff_format(path)
    if fmt == "fasta":
        it = (seq for _, seq in iter_fasta(path))
    elif fmt == "fastq":
        it = (seq for _, seq in iter_fastq(path))
    else:
        def plain():
            with open_text(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield line
        it = plain()
    for seq in it:
        yield np.frombuffer((seq + "\n").encode("ascii"), dtype=np.uint8)


def compute_reads(input1, input2: str | None, read_type: str,
                  output_prefix: str, use_native: bool | None = None) -> dict:
    """FASTQ(PE/SE)/FASTA/plain -> <prefix>.reads + .ridx (+ .header).

    Semantics of reference: src/compute_reads.cpp:
      * fastq (paired): each record pair becomes ``seq1 ~ revcomp(seq2)``
        on one line (:89-96);
      * se: one sequence line per FASTQ record;
      * fasta: one line per (multi-line) record + ``.header`` file with
        ``header \\t start \\t length`` rows (:170-217);
      * reads: input already is a reads file — only the offset index is
        (re)built.
    ``.ridx`` rows are ``rid \\t start \\t end`` byte offsets into ``.reads``.

    For se/fasta/reads, ``input1`` may be a LIST of files: they are
    stream-concatenated into one reads set, as the reference pipeline does
    for comma-separated inputs (scripts/compute_aindex.py:125-131). Paired
    fastq takes exactly two files (the R1/R2 pairing is positional).

    A single uncompressed input goes through the native reader
    (``aindex_torch.native``, the repository's ``native/aindex_host.cpp``)
    unless ``use_native`` is False; it writes the same files as the Python
    reader. ``use_native=True`` raises when the native library cannot be
    built or does not take the input; ``None`` then uses the Python reader.
    """
    inputs = list(input1) if isinstance(input1, (list, tuple)) else [input1]
    if read_type != "fastq" and input2 is not None:
        inputs.append(input2)
        input2 = None
    if read_type == "fastq":
        if len(inputs) != 1 or not input2:
            raise ValueError("paired fastq requires exactly two input files")
    out_dir = os.path.dirname(output_prefix)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    reads_path = output_prefix + ".reads"
    ridx_path = output_prefix + ".ridx"
    header_path = output_prefix + ".header"

    gz_input = any(is_gzip(p) for p in inputs) or bool(input2 and is_gzip(input2))
    if use_native is not False and not gz_input and len(inputs) == 1:
        # the native reader streams raw files; gzipped and multi-file
        # inputs take the Python path (decompression, concatenation)
        from aindex_torch import native
        n = (native.compute_reads_native(inputs[0], input2, read_type, output_prefix)
             if use_native or native.available() else None)
        if n is not None:
            result = {"reads": reads_path, "ridx": ridx_path, "n_reads": n}
            if read_type == "fasta":
                result["header"] = header_path
            return result
    if use_native:
        raise RuntimeError("the native reader does not take this input "
                           f"({read_type}, {len(inputs)} file(s), gzip {gz_input})")

    n_reads = 0
    start = 0

    def _write(fout, fidx, seq):
        nonlocal n_reads, start
        end = start + len(seq)
        fout.write(seq)
        fout.write("\n")
        fidx.write(f"{n_reads}\t{start}\t{end}\n")
        start = end + 1
        n_reads += 1

    if read_type == "fastq":
        with open(reads_path, "w") as fout, open(ridx_path, "w") as fidx:
            for (_, s1), (_, s2) in zip(iter_fastq(inputs[0]),
                                        iter_fastq(input2)):
                _write(fout, fidx, s1 + "~" + revcomp(s2))
    elif read_type == "se":
        with open(reads_path, "w") as fout, open(ridx_path, "w") as fidx:
            for path in inputs:
                for _, s in iter_fastq(path):
                    _write(fout, fidx, s)
    elif read_type == "fasta":
        with open(reads_path, "w") as fout, open(ridx_path, "w") as fidx, \
                open(header_path, "w") as fhead:
            for path in inputs:
                for head, s in iter_fasta(path):
                    fhead.write(f"{head}\t{start}\t{len(s)}\n")
                    _write(fout, fidx, s)
    elif read_type == "reads":
        aliased = [p for p in inputs
                   if os.path.abspath(p) == os.path.abspath(reads_path)]
        same_file = len(inputs) == 1 and bool(aliased)
        if aliased and not same_file:
            # with >1 input the loop streams lines while writing reads_path;
            # reading and rewriting the same file concurrently would corrupt
            # it, so only the in-place single-input form is allowed
            raise ValueError(
                f"input {aliased[0]!r} is the output .reads file; in-place "
                f"indexing requires it to be the only input")
        with open(ridx_path, "w") as fidx:
            fout = None if same_file else open(reads_path, "w")
            try:
                for path in inputs:
                    with open_text(path) as fin:
                        for ln in fin:
                            ln = ln.rstrip("\n")
                            if fout is not None:
                                fout.write(ln + "\n")
                            end = start + len(ln)
                            fidx.write(f"{n_reads}\t{start}\t{end}\n")
                            start = end + 1
                            n_reads += 1
            finally:
                if fout is not None:
                    fout.close()
    else:
        raise ValueError(f"unknown read type: {read_type!r}")

    result = {"reads": reads_path, "ridx": ridx_path, "n_reads": n_reads}
    if read_type == "fasta":
        result["header"] = header_path
    return result


def reads_to_fasta(reads_path: str, fasta_path: str) -> int:
    """reads file -> '>i\\nseq' FASTA (scripts/reads_to_fasta.py:20-23)."""
    n = 0
    with open(reads_path) as fin, open(fasta_path, "w") as fout:
        for line in fin:
            line = line.strip()
            if line:
                fout.write(f">{n}\n{line}\n")
                n += 1
    return n


def load_blob(reads_path: str) -> np.ndarray:
    return np.fromfile(reads_path, dtype=np.uint8)
