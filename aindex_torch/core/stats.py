"""Coverage-profile statistics + slot-ordered value dumps.

Twin of the reference's ``Stats`` record and text dump
(reference: src/hash.hpp:38-80 ``Stats``/``init``, :297-323
``set_stats``, :325-349 ``print_stats``/``print_stats_profile``, :261-289
``save_values``), vectorised: one ``np.bincount`` replaces the reference's
per-slot loop.
"""

from __future__ import annotations

import numpy as np

from aindex_torch.core import codec


def coverage_stats(tf: np.ndarray, coverage: int) -> dict:
    """zero/unique/distinct/total/max_count + clamped tf histogram.

    ``profile[i]`` = number of slots with tf == i, for i < coverage +
    coverage//2; larger tf values land in the last bucket — exactly
    set_stats' clamping (reference: src/hash.hpp:297-323).
    """
    if coverage < 1:
        raise ValueError("coverage must be >= 1")
    tf = np.asarray(tf)
    max_cov = coverage + coverage // 2
    clamped = np.minimum(tf.astype(np.int64), max_cov - 1)
    profile = np.bincount(clamped, minlength=max_cov).astype(np.int64)
    return {
        "zero": int(np.count_nonzero(tf == 0)),
        "unique": int(np.count_nonzero(tf == 1)),
        "distinct": int(np.count_nonzero(tf)),
        "total": int(tf.sum(dtype=np.uint64)),
        "max_count": int(tf.max()) if tf.size else 0,
        "coverage": int(coverage),
        "profile": profile,
    }


def format_stats(stats: dict) -> str:
    """The reference's one-line summary (print_and_set_coverage,
    reference: src/hash.hpp:337-349)."""
    return (f"Z: {stats['zero']} U: {stats['unique']} "
            f"D: {stats['distinct']} T: {stats['total']} "
            f"C: {stats['coverage']} M: {stats['max_count']}")


def save_values(path: str, codes: np.ndarray, tf: np.ndarray, k: int,
                skip_zeros: bool = True, block: int = 1 << 18
                ) -> tuple[int, int, int]:
    """Slot-ordered ``kmer\\ttf`` text dump (save_values,
    reference: src/hash.hpp:261-289). Returns (zeros, ones, other)
    tallies, which the reference prints. Streams in blocks — a 10^8-key
    dump never materialises the full string list.
    """
    tf = np.asarray(tf)
    zeros = int(np.count_nonzero(tf == 0))
    ones = int(np.count_nonzero(tf == 1))
    other = int(np.count_nonzero(tf > 1))
    with open(path, "w") as fh:
        for s in range(0, len(codes), block):
            c = np.asarray(codes[s:s + block])
            t = tf[s:s + block]
            if skip_zeros:
                keep = t > 0
                c, t = c[keep], t[keep]
            kmers = codec.decode_kmers(c, k)
            fh.writelines(f"{km}\t{v}\n" for km, v in zip(kmers, t.tolist()))
    return zeros, ones, other
