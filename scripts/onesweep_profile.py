#!/usr/bin/env python3
"""Per-launch device times of the kernels built on csrc/onesweep.cuh at the
shape of one ingest chunk, on one CUDA card.

    python3 scripts/onesweep_profile.py [--edges] [--count-bucket]

Builds the kernels, takes chip_smoke.py's ``onesweep_calls`` (K5's packed
and ASCII entries and K13 on a 2^22-byte chunk of a coverage-1 corpus of
scripts/make_scale_corpus.py's genome) and ``fill_calls`` (K8 on that
chunk's 4^13 counts; K9's chunk and pairs-in entries and the K10 and K11
fills on the same chunk), checks each against its plain version, and
prints its CUDA-event time a call, its launches a call, the device
memory a call allocates at its peak (its outputs and scratch) and the
torch.profiler device time of each of its launches (memset, compaction,
passes, runs or fill, scan). ``--edges`` first runs
chip_smoke.py's edge-shape checks of the sort. ``--count-bucket`` profiles
K15, K1 and K14 instead: K15 on 106,757,904 random 13-mer codes (the
corpus window count, 90% valid) into the 4^13 table, and on the same codes
with 90% set to 0 at weight 255; K1 on chip_smoke.py's corpus (25x) as the
dense build counts it, its 28 packed 2^22-byte chunks through one
PackedCounter, and on the coverage-1 chunk alone; K14 at one shard on the
coverage-1 chunk's k = 23 windows over an index built from the chunk, and
its slots-only call (the probe alone). Exits nonzero without a card.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def count_bucket_calls(dev) -> dict:
    """K15 on the corpus window count of random codes and skewed, K1 on the
    corpus's chunks and on one chunk, K14 with buckets and slots only: name
    -> (kernel call, plain call)."""
    import torch

    import chip_smoke as c
    from aindex_torch import Sparse23Index
    from aindex_torch.core import codec
    from aindex_torch.core.reads import blob_chunks
    from aindex_torch.kernels.count import (PackedCounter, count13_packed,
                                            count13_packed_plain, scatter_count,
                                            scatter_count_plain)
    from aindex_torch.kernels.positional import posbucket, posbucket_plain
    from aindex_torch.parallel.positional import bucket_cap
    gen = torch.Generator(device=dev).manual_seed(79)
    n = 106_757_904
    codes = torch.randint(0, c.SPACE, (n,), dtype=torch.int32, device=dev, generator=gen)
    valid = torch.rand(n, device=dev, generator=gen) < 0.9
    skew = torch.where(torch.rand(n, device=dev, generator=gen) < 0.9, 0, codes)
    w255 = torch.full((n,), 255, dtype=torch.uint8, device=dev)
    chunk = c.coverage1_chunk()
    packed, vbits = c.upload(dev, *codec.pack_ascii_chunk(chunk))
    index = Sparse23Index.build_from_blob(chunk, k=c.K23, device=dev)
    n_win = 16 * packed.numel() - c.K23 + 1
    one = (packed, vbits, c.K23, index.tables, index.rule, index.n, index.n)
    _, reads = c.scale_corpus(c.COVERAGE, 1)
    chunks = [c.upload(dev, *codec.pack_ascii_chunk(piece))
              for piece, _ in blob_chunks(c.corpus_blob(reads), c.K, c.CHUNK_BYTES)]
    del reads
    tables = [torch.zeros(c.SPACE, dtype=torch.int32, device=dev) for _ in range(4)]

    def build(t):
        counter = PackedCounter(t)
        for p, v in chunks:
            counter.add(p, v)
        return (counter.finish().view(torch.uint32),)

    def plain_build(t):
        for p, v in chunks:
            count13_packed_plain(t, p, v)
        return (t.view(torch.uint32),)
    return {
        f"count13_packed, the corpus's {len(chunks)} chunks through one counter": (
            lambda: build(tables[0]), lambda: plain_build(tables[1])),
        "count13_packed, one chunk alone": (
            lambda: (count13_packed(tables[2], packed, vbits).view(torch.uint32),),
            lambda: (count13_packed_plain(tables[3], packed, vbits).view(torch.uint32),)),
        "scatter_count": (lambda: (scatter_count(codes, valid),),
                          lambda: (scatter_count_plain(codes, valid),)),
        "scatter_count, 90% zeros at weight 255": (lambda: (scatter_count(skew, w255),),
                                                   lambda: (scatter_count_plain(skew, w255),)),
        "posbucket, 1 shard": (lambda: posbucket(*one, 1, bucket_cap(n_win, 1)),
                               lambda: posbucket_plain(*one, 1, bucket_cap(n_win, 1))),
        "posbucket, slots only": (lambda: posbucket(*one)[:1], lambda: posbucket_plain(*one)[:1]),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("onesweep_profile: CUDA is not available", file=sys.stderr)
        return 1
    from torch import profiler

    import chip_smoke as c
    from aindex_torch.kernels import _cuda
    dev = torch.device("cuda", 0)
    card = c.card_line()
    print(card)
    print(f"kernels built in {_cuda.build_all():.1f} s")
    if "--edges" in sys.argv:
        c.sort_edges_vs_plain(dev, card)
    if "--count-bucket" in sys.argv:
        calls = count_bucket_calls(dev)
    else:
        calls = {**c.onesweep_calls(dev), **c.fill_calls(dev)}
    for name, (fn, plain) in calls.items():
        err = max(c.max_abs_err(a, b) for a, b in zip(fn(), plain()))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize()
        held = torch.cuda.max_memory_allocated(dev) - base
        ms = c.cuda_ms(fn, 50)
        torch.cuda.synchronize()
        with profiler.profile(activities=[profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        print(f"{name}: {ms:.4f} ms a call (CUDA events, 50 calls), max_abs_err {err}, "
              f"{c.launches_per_call(fn):.2f} launches a call, {held} bytes allocated at its peak")
        for ev in sorted(prof.key_averages(), key=lambda e: -e.device_time_total):
            if ev.device_time_total > 0:
                name = ev.key.replace("(anonymous namespace)::", "").split("(")[0]
                print(f"  {ev.device_time_total / 10:8.1f} us a call, {ev.count // 10} "
                      f"launch(es): {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
