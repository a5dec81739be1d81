#!/usr/bin/env python3
"""Per-launch device times of the kernels built on csrc/onesweep.cuh at the
shape of one ingest chunk, on one CUDA card.

    python3 scripts/onesweep_profile.py [--edges]

Builds the kernels, takes chip_smoke.py's ``onesweep_calls`` (K5's packed
and ASCII entries and K13 on a 2^22-byte chunk of a coverage-1 corpus of
scripts/make_scale_corpus.py's genome) and ``fill_calls`` (K8 on that
chunk's 4^13 counts; K9's chunk and pairs-in entries and the K10 and K11
fills on the same chunk), checks each against its plain version, and
prints its CUDA-event time a call, its launches a call and the
torch.profiler device time of each of its launches (memset, compaction,
passes, runs or fill, scan). ``--edges`` first runs
chip_smoke.py's edge-shape checks of the sort. Exits nonzero without a
card.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


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
    calls = {**c.onesweep_calls(dev), **c.fill_calls(dev)}
    for name, (fn, plain) in calls.items():
        err = max(c.max_abs_err(a, b) for a, b in zip(fn(), plain()))
        ms = c.cuda_ms(fn, 50)
        torch.cuda.synchronize()
        with profiler.profile(activities=[profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        print(f"{name}: {ms:.4f} ms a call (CUDA events, 50 calls), max_abs_err {err}, "
              f"{c.launches_per_call(fn):.2f} launches a call")
        for ev in sorted(prof.key_averages(), key=lambda e: -e.device_time_total):
            if ev.device_time_total > 0:
                print(f"  {ev.device_time_total / 10:8.1f} us a call, {ev.count // 10} "
                      f"launch(es): {ev.key.split('(')[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
