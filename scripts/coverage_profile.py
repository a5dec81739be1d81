#!/usr/bin/env python3
"""The packed coverage entries on one CUDA card, each timed four ways
beside a checkout's and its random-read floor.

    python3 scripts/coverage_profile.py [parent=DIR]

Builds the kernels, times random reads by width (chip_smoke.py
``width_test``: the floors' rates), then times K4 ``coverage13_packed``
(u8, u16 and u32 random 4^13 tables, 8 random ASCII matrices of 10,000 x
151, 1% N), K7 ``quotcov23``, ``cuckoocov64`` and ``mphfcov`` (on
chip_smoke.py's corpus indexed at k = 23, 29 and 31, which give the
quotient table, the wide table and the MPHF walk; 8 batches of 10,000
corpus reads each), each first held exactly to its plain version at
chip_smoke.py's coverage edge shapes, then timed with its ``clocks``: warm and cold CUDA
events, torch.profiler device time a launch (cold and warm), the host
clock a call. With ``parent=DIR`` (a checkout, e.g. ``git archive`` of
the parent unpacked into ``dist/parent``), that checkout's ``coverage13.cu``,
``quotcov23.cu``, ``cuckoo64.cu`` and ``mphfwalk.cu`` are built and each
entry runs beside this tree's, in turns, after equal answers on every
batch. Exits nonzero without a card.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("coverage_profile: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as c
    from aindex_torch import Sparse23Index
    from aindex_torch.kernels import _cuda
    for arg in sys.argv[1:]:
        c.check(arg.startswith(c.PARENT_ARG), f"argument {arg!r} (takes only parent=DIR)")
        c.PARENT = os.path.abspath(arg[len(c.PARENT_ARG):])
    dev = torch.device("cuda", 0)
    card = c.card_line()
    print(card)
    t_start = time.perf_counter()
    print(f"kernels built in {_cuda.build_all():.1f} s")
    names = ("coverage13_packed", "quotcov23", "cuckoocov64", "mphfcov")
    for name in names:
        log = _cuda.KERNELS[name].build_log.splitlines()
        regs = sorted({int(line.split("Used ")[1].split()[0]) for line in log
                       if "registers" in line})
        print(f"  {name}: registers per thread {regs}")
    if c.PARENT is not None:
        c.parent_engines(c.PARENT)
    c.width_test(dev, card)

    c.dense_coverage_edges_vs_plain(dev, card, np.random.default_rng(11))
    gen = torch.Generator(device=dev).manual_seed(7)
    batches = c.dense_coverage_batches(dev, np.random.default_rng(7))
    for dtype, view in ((torch.uint8, None), (torch.int16, torch.uint16),
                        (torch.int32, torch.uint32)):
        table = torch.randint(0, 64, (c.SPACE,), dtype=dtype, device=dev, generator=gen)
        c.dense_coverage_clocks(card, table.view(view) if view is not None else table, batches)
    del batches, table

    _, reads = c.scale_corpus(c.COVERAGE, 1)
    blob = c.corpus_blob(reads)
    for k, name in ((c.K23, "quotcov23"), (29, "cuckoocov64"), (31, "mphfcov")):
        t0 = time.perf_counter()
        index = Sparse23Index.build_from_blob(blob, k=k, device=dev)
        t = index.tables
        torch.cuda.synchronize()
        c.check(t.COVERAGE == name, f"k={k} serves coverage by {t.COVERAGE}, not {name}")
        print(f"k={k}: {index.n} keys, engine {index.engine}, built in "
              f"{time.perf_counter() - t0:.1f} s")
        c.engine_coverage_edges_vs_plain(dev, card, index, reads)
        c.engine_coverage_clocks(card, index, name, c.coverage_batches(dev, reads, k))
        del index, t
        torch.cuda.empty_cache()
    print(f"coverage_profile: {time.perf_counter() - t_start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
