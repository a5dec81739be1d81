"""Standalone k-mer analysis: canonical counts with per-occurrence
(read id, in-read position, direction) detail.

Library form of the reference's analyze_kmers.py script
(reference: analyze_kmers.py:62-146), a host copy of aindex_tpu/analysis.py
with the same record and summary semantics, vectorised: windows come from
the shift-or scan, grouping from one lexsort, read attribution from the
binary-search rid index. The CLI ``analyze`` subcommand is argument
plumbing over this module.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from aindex_torch.core import codec
from aindex_torch.core.reads import ReadsStore
from aindex_torch.kernels.spectrum import host_window_codes


@dataclasses.dataclass
class KmerAnalysis:
    """Grouped occurrence records, sorted by count desc then k-mer.

    ``order`` indexes into the per-key arrays; occurrences of key j live
    at rows ``starts[j] : starts[j] + counts[j]`` of the per-occurrence
    arrays, position-ascending. ``direction[i]`` is 0 when the window at
    occurrence i equals its canonical form, 1 when it is the reverse
    complement (reference convention)."""

    k: int
    n_sequences: int
    keys: np.ndarray        # uint64 canonical codes, unique
    counts: np.ndarray      # per-key occurrence count
    starts: np.ndarray      # per-key first row in the occurrence arrays
    order: np.ndarray       # report order: count desc, then k-mer asc
    rid: np.ndarray         # per-occurrence read id
    in_read: np.ndarray     # per-occurrence position within the read
    direction: np.ndarray   # per-occurrence 0=canonical-as-is, 1=revcomp

    def iter_records(self):
        """Yield (kmer, count, [(rid, pos, direction), ...]) in report
        order."""
        kmers = codec.decode_kmers(self.keys[self.order], self.k)
        for j, km in zip(self.order, kmers):
            s, c = int(self.starts[j]), int(self.counts[j])
            yield km, c, [(int(self.rid[i]), int(self.in_read[i]),
                           int(self.direction[i])) for i in range(s, s + c)]

    def summary(self) -> dict:
        """The statistics block of the reference's .summary file."""
        total = int(self.counts.sum())
        uniq = len(self.keys)
        out = {
            "input_sequences": self.n_sequences,
            "kmer_size": self.k,
            "total_kmers": total,
            "unique_kmers": uniq,
            "singleton_kmers": int((self.counts == 1).sum()),
            "max_frequency": int(self.counts.max()) if uniq else 0,
        }
        if uniq:
            out["average_frequency"] = total / uniq
            out["space_coverage_pct"] = 100.0 * uniq / 4 ** self.k
        return out


def analyze_kmers(sequences: list[str], k: int,
                  min_count: int = 1) -> KmerAnalysis:
    """Analyse all valid k-mers of the sequences (canonical counting)."""
    store = ReadsStore.from_sequences(sequences)
    codes, valid = host_window_codes(store.blob, k)
    pos = np.flatnonzero(valid)
    codes = codes[pos]
    canon = codec.canonical_code(codes, k)
    direction = (codes != canon).astype(np.int64)
    rid = store.rid_by_pos(pos)
    in_read = pos - store.starts[rid]

    order = np.lexsort((pos, canon))  # canonical primary, position secondary
    canon, rid, in_read, direction = (a[order] for a in
                                      (canon, rid, in_read, direction))
    keys, starts, counts = np.unique(canon, return_index=True,
                                     return_counts=True)
    keep = counts >= min_count
    keys, starts, counts = keys[keep], starts[keep], counts[keep]
    # count desc, then k-mer ascending (code order == lexicographic)
    rank = np.lexsort((keys, -counts.astype(np.int64)))
    return KmerAnalysis(k=k, n_sequences=len(sequences), keys=keys,
                        counts=counts, starts=starts, order=rank, rid=rid,
                        in_read=in_read, direction=direction)


def write_report(analysis: KmerAnalysis, output: str) -> None:
    """Write the report + .summary files in the reference's exact format
    (``kmer<TAB>count<TAB>rid,pos,dir ...``)."""
    with open(output, "w") as f:
        for km, count, occ in analysis.iter_records():
            occ_txt = "\t".join(f"{r},{p},{d}" for r, p, d in occ)
            f.write(f"{km}\t{count}\t{occ_txt}\n")
    s = analysis.summary()
    with open(output + ".summary", "w") as f:
        f.write("=== K-mer Analysis Summary ===\n")
        f.write(f"Input sequences: {s['input_sequences']}\n")
        f.write(f"K-mer size: {s['kmer_size']}\n")
        f.write(f"Total k-mers: {s['total_kmers']}\n")
        f.write(f"Unique k-mers: {s['unique_kmers']}\n")
        f.write(f"Singleton k-mers: {s['singleton_kmers']}\n")
        f.write(f"Max k-mer frequency: {s['max_frequency']}\n")
        if s["unique_kmers"]:
            f.write(f"Average frequency: {s['average_frequency']:.2f}\n")
            f.write(f"K-mer space coverage: "
                    f"{s['space_coverage_pct']:.6f}%\n")
