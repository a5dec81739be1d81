#!/usr/bin/env python3
"""K16 (``count13_rows``, csrc/count13.cu) on one CUDA card: its routes and
the constants of its sweep, beside another checkout's.

    python3 scripts/count_profile.py [parent=DIR]

Measures the read-modify-write floor first (chip_smoke.py ``rmw_test``:
4-byte adds at hashed entries of the 4^13 table in random, bin and sorted
order, and of a 2^22-entry table). Then builds csrc/count13.cu as it is
and in variants that change one constant of it (``VARIANTS``: the slices
that rank a sweep tile ``SWEEP_BITS``, the sweep's blocks ``SWEEP_BLOCK``
and ``SWEEP_GRID``,
the rounds that combine a warp row's equal keys ``ROUNDS``, and the table
sizes that choose K16's route, ``RED_SPACE`` and ``SMALL_SPACE``), one
nvcc each, all started together, with the checkout's ``count13.cu`` at
DIR. Each build's ``count13_rows`` is held exactly to
``count_batch_13_plain`` and timed in turns (the order, then the order
reversed) by CUDA events warm (one batch, back to back), cold (8 batches
in rotation) and by torch.profiler's device time a call, on:

* 27,962 x 150 reads of chip_smoke.py's corpus recipe (its timed batch's
  shape), k = 13 into the 4^13 table: every build; and 4 x 27,962 reads
  (a sweep block's 4 tiles): this tree's route beside the rows' REDs;
* the same reads at k = 16 into a 2^22-entry table (16 MB, which L2
  holds): this tree's route (the rows' REDs) beside the sweep;
* the same reads at k = 7 into the 4^7 table: this tree's route (a shared
  histogram) beside the rows' REDs.

Prints each build's registers and the functions that spill (ptxas). Exits
nonzero without a card.
"""

import ctypes
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT_DIR = os.path.join(ROOT, "build", "count_profile")

#: name -> constants of csrc/count13.cu edited in that build
VARIANTS = {
    "this tree": {},
    "64 slices": {"SWEEP_BITS": "6"},
    "1024 slices": {"SWEEP_BITS": "10"},
    "one sweep block an SM": {"SWEEP_GRID": "132"},
    "sweep blocks of 512": {"SWEEP_BLOCK": "512", "SWEEP_GRID": "528"},
    "sweep blocks of 256": {"SWEEP_BLOCK": "256", "SWEEP_GRID": "1056"},
    "no combining of equal keys": {"ROUNDS": "0"},
    "rows' REDs at every size": {"RED_SPACE": "1LL << 31"},
    "sweep above 2^15": {"RED_SPACE": "0"},
    "rows' REDs above 0": {"SMALL_SPACE": "0"},
}
ROWS, LEN = 27_962, 150
N_BATCHES = 8
REPS = 48


def build(trees: dict) -> dict:
    """name -> count13_rows of that build: this tree's variants, and each
    checkout's count13.cu."""
    from aindex_torch.kernels import _cuda
    csrc = os.path.join(ROOT, "aindex_torch", "csrc")
    procs = {}
    for name, edits in {**VARIANTS, **{n: None for n in trees}}.items():
        out = os.path.join(OUT_DIR, re.sub(r"\W+", "_", name))
        os.makedirs(out, exist_ok=True)
        src_dir = os.path.join(trees[name], "aindex_torch", "csrc") if edits is None else csrc
        with open(os.path.join(src_dir, "count13.cu")) as f:
            src = f.read()
        for const, value in (edits or {}).items():
            src, n = re.subn(rf"(constexpr \w+(?: \w+)? {const} = )[^;]*;", rf"\g<1>{value};", src)
            assert n == 1, (name, const)
        path = os.path.join(out, "count13.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(out, "count13.so")
        procs[name] = (lib, subprocess.Popen(
            [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", src_dir, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        log = log.decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        regs = sorted({int(x) for x in re.findall(r"Used (\d+) registers", log)})
        spills = re.findall(r"Function properties for (\S+)\s+(\d+) bytes stack frame, "
                            r"(\d+) bytes spill stores", log)
        fn = getattr(ctypes.CDLL(lib), "count13_rows")
        fn.argtypes = _cuda.KERNELS["count13_rows"].argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
        print(f"{name}: registers per thread {regs}; spilling: "
              + (", ".join(f"{f} ({st} B stores, {fr} B frame)" for f, fr, st in spills
                           if int(st)) or "none"))
    return fns


def device_ms(fn, calls: int) -> float:
    """torch.profiler's device time of ``calls`` calls of fn, a call."""
    import torch
    from torch import profiler
    torch.cuda.synchronize()
    with profiler.profile(activities=[profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / calls


def compare(dev, card: str, label: str, fns: dict, names, batches, k: int, space: int) -> None:
    import torch

    import chip_smoke as c
    from aindex_torch.kernels import _cuda
    from aindex_torch.kernels.count import count_batch_13_plain
    st = _cuda.stream(dev)
    table = torch.zeros(space, dtype=torch.int32, device=dev)

    def call(name, b, into):
        x = batches[b]
        c.check(fns[name](into.data_ptr(), x.data_ptr(), x.shape[0], x.shape[1], k, space,
                          st) == 0, f"{name} count13_rows")

    want = count_batch_13_plain(torch.zeros(space, dtype=torch.int32, device=dev), batches[0],
                                k, space)
    for name in names:
        got = torch.zeros(space, dtype=torch.int32, device=dev)
        call(name, 0, got)
        c.max_abs_err(got.view(torch.uint32), want.view(torch.uint32))
    times = {name: {"warm": [], "cold": [], "device": []} for name in names}
    for order in (list(names), list(names)[::-1]):
        for name in order:
            t = times[name]
            t["warm"].append(c.cuda_ms(lambda: call(name, 0, table), REPS))
            turn = iter(range(10 ** 9))
            t["cold"].append(c.cuda_ms(lambda: call(name, next(turn) % N_BATCHES, table), REPS))
            turn = iter(range(10 ** 9))
            t["device"].append(device_ms(lambda: call(name, next(turn) % N_BATCHES, table), REPS))
    for name, t in times.items():
        print(f"count13_rows {label}, {name}: == plain; " + ", ".join(
            f"{clock} " + " / ".join(f"{v:.4f}" for v in vals) for clock, vals in t.items())
            + f" ms ({card})")


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("count_profile: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as c
    from aindex_torch.constants import SPACE_13
    trees = dict(arg.split("=", 1) for arg in sys.argv[1:])
    dev = torch.device("cuda", 0)
    card = c.card_line()
    print(card)
    t0 = time.perf_counter()
    c.rmw_test(dev, card)
    fns = build(trees)
    _, reads = c.scale_corpus(N_BATCHES * ROWS * LEN / c.GENOME_BP + 0.01, 1)
    batches = [torch.from_numpy(np.ascontiguousarray(reads[b * ROWS:(b + 1) * ROWS])).to(dev)
               for b in range(N_BATCHES)]
    every = list(VARIANTS) + list(trees)
    compare(dev, card, f"{ROWS} x {LEN} reads, k=13, 4^13 table", fns, every, batches, 13,
            SPACE_13)
    fours = [torch.cat([batches[(b + i) % N_BATCHES] for i in range(4)])
             for b in range(N_BATCHES)]
    compare(dev, card, f"{4 * ROWS} x {LEN} reads, k=13, 4^13 table", fns,
            ["this tree", "rows' REDs at every size"] + list(trees), fours, 13, SPACE_13)
    del fours
    compare(dev, card, f"{ROWS} x {LEN} reads, k=16, 2^22 table", fns,
            ["this tree", "sweep above 2^15"] + list(trees), batches, 16, 1 << 22)
    compare(dev, card, f"{ROWS} x {LEN} reads, k=7, 4^7 table", fns,
            ["this tree", "rows' REDs above 0"] + list(trees), batches, 7, 4 ** 7)
    print(f"count_profile: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
