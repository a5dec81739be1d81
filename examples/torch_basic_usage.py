"""Basic aindex_torch usage: build both index modes, query, profile coverage.

The port's counterpart of examples/basic_usage.py: the same reads, the same
calls and the same printed lines. Every index lives on ``device``, the card
unless the caller asks for the CPU; asking for the card on a machine with
none raises.

Run: python examples/torch_basic_usage.py [--device cpu]
"""

import argparse

import numpy as np

from aindex_torch import AIndex, get_revcomp


def main(device="cuda"):
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = [bytes(bases[rng.integers(0, 4, size=100)]).decode()
             for _ in range(200)]

    # --- dense 13-mer mode -------------------------------------------------
    idx13 = AIndex.build_from_sequences(reads, kmer_size=13, device=device)
    km = reads[0][:13]
    print(f"tf({km}) = {idx13[km]}")
    print(f"total (fwd+rc) = {idx13.get_total_tf_value_13mer(km)}")
    print(f"coverage[:10] = {idx13.get_sequence_coverage(reads[0], k=13)[:10]}")
    print(f"positions = {idx13.get_positions(km)[:5]}")
    print(f"stats = {idx13.get_13mer_statistics()}")

    # --- sparse canonical 23-mer mode -------------------------------------
    idx23 = AIndex.build_from_sequences(reads, kmer_size=23, device=device)
    km = reads[0][:23]
    print(f"\ntf({km}) = {idx23[km]}  (same as revcomp: {idx23[get_revcomp(km)]})")
    print(f"strand = {idx23.get_strand(km).name}")
    print(f"read hits = {idx23.get_rid2poses(km)}")
    print(f"de bruijn next = {idx23.debruijn_next(km)}")
    print(f"top kmers = {idx23.get_top_kmers(3)}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
