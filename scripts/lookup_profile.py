#!/usr/bin/env python3
"""Device times of K3 (the dense 13-mer gather) beside the K3 of other
checkouts, and of K11 (the MPHF walk and its fill), on one CUDA card.

    python3 scripts/lookup_profile.py [NAME=DIR ...]

Each DIR is a checkout of the repo (e.g. ``git archive`` of the parent
unpacked into ``dist/parent``); its ``aindex_torch/csrc/gather13.cu`` is
built beside this tree's. Prints CUDA-event times (20 calls after one
warm-up; each kernel twice, in turns: first to last, then last to first),
after checking that every kernel's answers equal this tree's:

* K3 ``gather13`` on a u8 4^13 table (64 MiB), 4 x 2^24 codes in range
  (the dense path's traffic) and chip_smoke.py's mixed batch (half over
  the whole uint32 range), beside ``torch.take``; then ``gather13_table``
  and ``gather13_total`` (with a mask) on a u32 4^13 table (256 MiB) and
  the mixed codes.
* K11's query (canonical rule, tf out) on 4 x 2^24 keys, half members,
  over an MPHF of 10,861,460 random canonical 31-mers (the k = 31 corpus
  index's n) and over one of 2^18 keys, whose g-vector and records L2
  holds (the walk without its DRAM reads).
* the K11 fill of chip_smoke.py's ``fill_calls``, with the device time of
  each of its launches (torch.profiler).

Exits nonzero without a card.
"""

import ctypes
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT_DIR = os.path.join(ROOT, "build", "lookup_profile")


def build_trees(trees: dict) -> dict:
    """name -> the K3 library of the checkout at trees[name], built by one
    nvcc each, all started together; "this tree" -> this tree's."""
    from aindex_torch.kernels import _cuda
    from aindex_torch.kernels.lookup import KERNEL, KERNEL_TABLE, KERNEL_TOTAL
    procs = {}
    for name, root in trees.items():
        csrc = os.path.join(root, "aindex_torch", "csrc")
        lib = os.path.join(OUT_DIR, f"{name}.so")
        os.makedirs(OUT_DIR, exist_ok=True)
        procs[name] = lib, subprocess.Popen(
            [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", csrc, "-o", lib,
             os.path.join(csrc, "gather13.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {"this tree": KERNEL._lib}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{log.decode(errors='replace')}")
        libs[name] = ctypes.CDLL(lib)
    for lib in libs.values():
        lib.gather13.argtypes = KERNEL.argtypes
        lib.gather13_table.argtypes = KERNEL_TABLE.argtypes
        lib.gather13_total.argtypes = KERNEL_TOTAL.argtypes
    return libs


def in_turns(card: str, label: str, calls: dict, outs) -> None:
    """Each call (name -> function writing its argument) equal to the
    first's, then timed twice in turns; prints the times."""
    import torch

    import chip_smoke as c
    names = list(calls)
    calls[names[0]](outs[1])
    for name in names:
        calls[name](outs[0])
        c.max_abs_err(outs[0], outs[1])
    times = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            times[name].append(c.cuda_ms(lambda: calls[name](outs[0]), 20))
    torch.cuda.synchronize()
    print(f"{label}: " + "; ".join(f"{k} {a:.4f} / {b:.4f} ms" for k, (a, b) in times.items())
          + f" ({card})")


def k3_times(dev, card: str, libs: dict) -> None:
    import torch

    import chip_smoke as c
    from aindex_torch.kernels import _cuda
    from aindex_torch.kernels.lookup import jax_index
    gen = torch.Generator(device=dev).manual_seed(7)
    n = c.N_CODES
    u8 = torch.randint(0, 256, (c.SPACE,), dtype=torch.uint8, device=dev, generator=gen)
    inside = torch.randint(0, c.SPACE, (n,), dtype=torch.int32, device=dev, generator=gen)
    mixed = torch.randint(-2 ** 31, 2 ** 31, (n,), dtype=torch.int32, device=dev, generator=gen)
    mixed[n // 2:] &= c.SPACE - 1
    valid = torch.rand(n, device=dev, generator=gen) < 0.9
    outs = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)]
    st = _cuda.stream(dev)

    def u8_call(name, codes):
        return lambda o: c.check(libs[name].gather13(u8.data_ptr(), 8, codes.data_ptr(), None,
                                                     None, n, o.data_ptr(), None, st) == 0,
                                 f"gather13 {name}")
    for label, codes in (("in range", inside), ("mixed", mixed)):
        index = jax_index(codes)
        print(f"K3 u8 codes ({label}, {n}): torch.take "
              f"{c.cuda_ms(lambda: torch.take(u8, index), 20):.4f} ms ({card})")
        del index
        in_turns(card, f"K3 u8 codes ({label}, {n})",
                 {name: u8_call(name, codes) for name in libs}, outs)
    del u8
    u32 = torch.randint(-2 ** 31, 2 ** 31, (c.SPACE,), dtype=torch.int32, device=dev,
                        generator=gen).view(torch.uint32)

    def table(name):
        return lambda o: c.check(libs[name].gather13_table(
            u32.data_ptr(), 32, c.SPACE, mixed.data_ptr(), n, o.data_ptr(), st) == 0,
            f"gather13_table {name}")

    def total(name):
        return lambda o: c.check(libs[name].gather13_total(
            u32.data_ptr(), 32, c.SPACE, mixed.data_ptr(), valid.data_ptr(), 13, n,
            o.data_ptr(), st) == 0, f"gather13_total {name}")
    in_turns(card, f"K3 gather13_table u32, mixed codes ({n})",
             {name: table(name) for name in libs}, outs)
    in_turns(card, f"K3 gather13_total u32, mixed codes + mask ({n})",
             {name: total(name) for name in libs}, outs)


def walk_times(dev, card: str) -> None:
    import torch

    import chip_smoke as c
    from aindex_torch.core import codec
    from aindex_torch.index.mphf import MPHF
    from aindex_torch.kernels import probe
    from aindex_torch.kernels.lookup import MphfTables
    rng = np.random.default_rng(31)
    for n_keys in (10_861_460, 1 << 18):
        keys = rng.integers(0, 1 << 62, int(n_keys * 1.01), dtype=np.uint64)
        keys = np.unique(np.minimum(keys, codec.revcomp_code(keys, 31)))
        keys = rng.permutation(keys)[:n_keys]
        mphf, slot = MPHF.build_with_slots(keys)
        checker = np.zeros(n_keys, np.uint64)
        checker[slot] = keys
        tf = rng.integers(1, 1 << 32, n_keys, dtype=np.uint64).astype(np.uint32)
        t = MphfTables.from_host(mphf, checker, tf, dev)
        half = c.N_CODES // 2
        q = np.concatenate([keys[rng.integers(0, n_keys, half)],
                            rng.integers(0, 1 << 62, half, dtype=np.uint64)])
        q = torch.from_numpy(rng.permutation(q).view(np.int64)).to(dev)
        want = probe.query_plain(t, q, k=31, rule=probe.CANON)
        c.check(int((want.view(torch.int32) != 0).sum()) >= half, "members hit")
        c.max_abs_err(probe.query(t, q, k=31, rule=probe.CANON), want)
        ms = [c.cuda_ms(lambda: probe.query(t, q, k=31, rule=probe.CANON), 20) for _ in range(2)]
        print(f"K11 mphfwalk, n = {n_keys} ({t.records.numel() * 4 / 1e6:.1f} MB of records, "
              f"{t.g_packed.numel() * 4 / 1e6:.2f} MB of g), {q.numel()} keys, canonical, tf: "
              f"{ms[0]:.4f} / {ms[1]:.4f} ms ({card})")
        del t, q, want
        torch.cuda.empty_cache()


def fill_profile(dev, card: str) -> None:
    import torch
    from torch import profiler

    import chip_smoke as c
    fn, plain = c.fill_calls(dev)["mphffill"]
    c.max_abs_err(fn()[0], plain()[0])
    ms = c.cuda_ms(fn, 50)
    torch.cuda.synchronize()
    with profiler.profile(activities=[profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    print(f"mphffill: {ms:.4f} ms a call ({card})")
    for ev in sorted(prof.key_averages(), key=lambda e: -e.device_time_total):
        if ev.device_time_total > 0:
            print(f"  {ev.device_time_total / 10:8.1f} us a call, {ev.count // 10} "
                  f"launch(es): {ev.key.split('(')[0]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("lookup_profile: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as c
    from aindex_torch.kernels import _cuda
    trees = dict(arg.split("=", 1) for arg in sys.argv[1:])
    dev = torch.device("cuda", 0)
    card = c.card_line()
    print(card)
    t0 = time.perf_counter()
    print(f"kernels built in {_cuda.build_all():.1f} s")
    k3_times(dev, card, build_trees(trees))
    walk_times(dev, card)
    fill_profile(dev, card)
    print(f"lookup_profile: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
