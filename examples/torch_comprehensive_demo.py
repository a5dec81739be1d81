"""Comprehensive API walkthrough: every query family of aindex_torch.

The port's counterpart of examples/comprehensive_demo.py (itself the
analogue of the reference's tests/comprehensive_demo.py, a smoke pass over
the whole surface): builds both index modes in-process on ``device``,
persists and reloads them, and exercises each API family once. The index
lives on the card unless the caller asks for the CPU; asking for the card
on a machine with none raises.

Run: python examples/torch_comprehensive_demo.py [--device cpu]
"""

import argparse
import tempfile

import numpy as np

from aindex_torch import AIndex, AindexWrapper, get_revcomp, hamming_distance


def section(title):
    print(f"\n=== {title} ===")


def main(device="cuda"):
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = [bytes(bases[rng.integers(0, 4, size=120)]).decode()
             for _ in range(150)]
    reads.append(reads[0])                      # a duplicate read
    reads.append("ACGTN" + "ACGT" * 20)         # an N-containing read

    section("build (both modes, positional indexes included)")
    idx13 = AIndex.build_from_sequences(reads, kmer_size=13, device=device)
    idx23 = AIndex.build_from_sequences(reads, kmer_size=23, device=device)
    print(f"13-mer: n_kmers={idx13.n_kmers}, aindex={idx13.aindex_loaded}")
    print(f"23-mer: n_kmers={idx23.n_kmers}, n_reads={idx23.n_reads}")

    section("dict protocol + scalar queries")
    km13, km23 = reads[0][:13], reads[0][:23]
    print(f"idx13[{km13}] = {idx13[km13]}; contained: {km13 in idx13}")
    print(f"idx23[{km23}] = {idx23[km23]} "
          f"(revcomp agrees: {idx23[get_revcomp(km23)] == idx23[km23]})")
    print(f"hamming(ACGT, ACGA) = {hamming_distance('ACGT', 'ACGA')}")

    section("batched tf queries (one device engine)")
    batch = [r[i:i + 23] for r in reads[:20] for i in (0, 31, 77)]
    tf = idx23.get_tf_values(batch)
    print(f"{len(batch)} queries -> tf[:8] = {list(map(int, tf[:8]))}")
    pairs = idx13.get_tf_both_directions_13mer_batch(
        [r[:13] for r in reads[:8]])
    print(f"directional (fwd, rc) pairs[:4] = {pairs[:4]}")

    section("identity / strand / info")
    print(f"kid = {idx23.get_kid_by_kmer(km23)}, "
          f"strand = {idx23.get_strand(km23).name}")
    print(f"kmer_info = {idx23.get_kmer_info_by_kid(idx23.get_kid_by_kmer(km23))}")

    section("coverage profiling")
    cov = idx13.get_sequence_coverage(reads[0])
    print(f"13-mer coverage[:12] = {cov[:12]}")
    covs = idx23.get_sequence_coverage_batch(reads[:4])
    print(f"batch coverage lens = {[len(c) for c in covs]}")

    section("positions -> reads resolution")
    poses = idx23.get_positions(km23)
    print(f"positions({km23[:8]}...) = {poses}")
    print(f"rid2poses = {idx23.get_rid2poses(km23)}")
    print(f"reads containing it: {len(idx23.get_reads_by_kmer(km23))}")

    section("codes-in device queries (the full-rate path)")
    from aindex_torch.core import codec
    codes13, _ = codec.encode_kmers([r[:13] for r in reads[:32]], 13)
    dev_tf = idx13.get_total_tf_values_codes_13mer(codes13)  # device tensor
    print(f"device total-tf[:6] = {dev_tf[:6].cpu().tolist()}")
    codes23, _ = codec.encode_kmers(batch, 23)
    dev23 = idx23.get_tf_values_codes_23mer(codes23)
    same_as_ascii = bool((dev23.cpu().numpy() == np.asarray(tf)).all())
    print(f"codes-in == ASCII-in: {same_as_ascii}")
    assert same_as_ascii

    section("De Bruijn continuation")
    print(f"next = {idx23.debruijn_next(km23)}")
    print(f"prev = {idx23.debruijn_prev(km23)}")
    info = idx23.debruijn_next_info(km23)
    print(f"next CONT: best_hit={info['best_hit']} "
          f"tf={info['best_hit_tf']} n={info['n']} sum={info['sum']}")

    section("frequency iteration / stats")
    top = idx23.get_top_kmers(3)
    print(f"top-3 = {top}")
    print(f"stats = {idx23.get_23mer_statistics()}")

    section("persistence round-trip")
    with tempfile.TemporaryDirectory() as td:
        idx23.save(td + "/demo.23")
        again = AindexWrapper.load_from_prefix(td + "/demo.23",
                                               load_reads=True, device=device)
        same = list(map(int, again.get_tf_values(batch))) == \
            list(map(int, tf))
        print(f"reloaded index answers identically: {same}")
        assert same

    section("read iteration")
    n_iter = sum(1 for _ in idx23.iter_reads())
    print(f"iter_reads count = {n_iter} (n_reads = {idx23.n_reads})")
    print("\nAll API families exercised.")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
