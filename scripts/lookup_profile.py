#!/usr/bin/env python3
"""Device times of the random-read widths, of K6 and K10 (the bucketed
cuckoo engines) and K3 (the dense 13-mer gather) beside those of other
checkouts, and of K11 (the MPHF walk and its fill), on one CUDA card.

    python3 scripts/lookup_profile.py [PART ...] [NAME=DIR ...]

PART is any of widths, rmw, engines, k3, walk and fill (all of them when none
is named). Each DIR is a checkout of the repo (e.g. ``git archive`` of the
parent unpacked into ``dist/parent``); its ``aindex_torch/csrc/gather13.cu``
(and, for engines, ``quot23.cu`` and ``cuckoo64.cu``) is built beside this
tree's. Prints CUDA-event times (20 calls after one warm-up; each kernel
twice, in turns: first to last, then last to first), after checking that
every kernel's answers equal this tree's:

* widths: 2^26 random reads of 16, 32, 64 and 128 bytes over 512 MiB
  (chip_smoke.py ``width_test``, ``scripts/randread.cu``);
* rmw: 4-byte adds (REDs) at hashed entries of the 4^13 uint32 table in
  random, bin and sorted order and of a 2^22-entry table in random order,
  at K16's n and 2^24 (chip_smoke.py ``rmw_test``);
* engines: K6 and K10 on tables of random canonical keys at the
  E. coli-scale n (9,602,528 at k = 23; 10,568,899 at k = 29), 4 x 2^24
  codes, half stored keys: every rule against the plain version, the edge
  keys, the probes' mix and the device bytes, then beside each checkout's
  K6 and K10 on the layout it uploads;

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


#: the E. coli-scale key counts of chip_smoke.py's quotient (k = 23) and
#: wide (k = 29) indexes
ENGINE_CONFIGS = (("quot", 23, 9_602_528), ("cuckoo", 29, 10_568_899))


def engine_times(dev, card: str, trees: dict) -> None:
    """K6 and K10 on tables of random canonical keys at the E. coli-scale
    index's n, built by the host builds (index/quotcuckoo.py,
    index/cuckoo.py): the query on 4 x 2^24 codes, half stored keys, every
    rule against its plain version, the edge keys (chip_smoke.py
    engine_edges_vs_plain), the probes' mix and the device bytes; then
    codes, tf (and for K6 tf + slot + strand and forward-else-revcomp)
    beside each checkout's K6 and K10 on its own layout, each twice in
    turns."""
    import types

    import torch

    import chip_smoke as c
    from aindex_torch.core import codec
    from aindex_torch.index.cuckoo import CuckooTable
    from aindex_torch.index.quotcuckoo import QuotCuckoo
    from aindex_torch.kernels import probe
    from aindex_torch.kernels.encode import canonical_code64, packed_window_codes
    rng = np.random.default_rng(23)
    for engine, k, n in ENGINE_CONFIGS:
        t0 = time.perf_counter()
        reads = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (10_000, 150))]
        [(_, stride, packed, vbits)] = codec.coverage_row_batches(
            [row.tobytes() for row in reads], k)
        packed, vbits = c.upload(dev, packed, vbits)
        wc, wv = packed_window_codes(packed, vbits, k)
        windows = np.unique(canonical_code64(wc[wv], k).cpu().numpy().view(np.uint64))
        keys = rng.integers(0, 1 << (2 * k), int(n * 1.01), dtype=np.uint64)
        keys = np.setdiff1d(np.unique(np.minimum(keys, codec.revcomp_code(keys, k))), windows)
        keys = rng.permutation(np.concatenate([windows, keys[:n - windows.size]]))
        tf = rng.integers(1, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        slot = np.arange(n, dtype=np.int32)
        host = (QuotCuckoo.build(keys, tf, slot, k) if engine == "quot"
                else CuckooTable.build(keys, tf, slot))
        index = types.SimpleNamespace(engine=engine, k=k, n=n, quot=host, cuckoo=host,
                                      tables=host.tables(dev))
        t = index.tables
        print(f"{engine} k={k}: host build and upload {time.perf_counter() - t0:.1f} s")
        half = c.N_CODES // 2
        q = np.concatenate([keys[rng.integers(0, n, half)],
                            rng.integers(0, 1 << (2 * k), half, dtype=np.uint64)])
        codes = torch.from_numpy(rng.permutation(q).view(np.int64)).to(dev)
        for rule in probe.RULES:
            kw = {"k": k, "rule": rule, "slot": True, "strand": rule != probe.KEYS}
            for a, b in zip(probe.query(t, codes, **kw), probe.query_plain(t, codes, **kw)):
                c.max_abs_err(a, b)
        c.engine_edges_vs_plain(dev, card, index)
        c.sector_mix(card, f"{t.QUERY} batch ({codes.numel()} codes, canonical, half present)",
                     index, canonical_code64(codes, k))
        c.device_table_bytes(card, index)
        runs = [("codes, tf", probe.CANON, False)]
        if engine == "quot":
            runs += [("codes, tf+slot+strand", probe.CANON, True),
                     ("codes, fwd-rc, tf+slot+strand", probe.FWD_RC, True)]
        present = torch.from_numpy(keys[rng.integers(0, n, 1 << 20)].view(np.int64)).to(dev)
        cov = (packed, vbits, len(reads), stride)
        for name, root in trees.items():
            root = os.path.abspath(root)
            with open(os.path.join(root, "aindex_torch", "csrc", "probe.cuh")) as f:
                same_layout = "struct Buckets" in f.read()
            old = (*probe.c_engine(t), ()) if same_layout else c.parent_tables(dev, index)
            fns = c.parent_engines(root)
            for tag, rule, with_slot in runs:
                c.parent_vs_this(dev, card, f"{t.QUERY} {tag}, {codes.numel()} codes, beside "
                                 f"{name}", fns[t.QUERY], old, t, codes, k, rule, with_slot,
                                 with_slot, name)
            warm_and_cold(dev, card, f"{t.QUERY} codes, tf, 2^20 stored keys", name,
                          fns[t.QUERY], old, t, present, k)
            coverage_beside(dev, card, f"{t.COVERAGE} cutoff 0, {len(reads)} x {stride} "
                            f"(stored windows)", name, fns[t.COVERAGE], old, t, cov, k)
            del old
        if not trees:
            for tag, rule, with_slot in runs:
                ms = c.cuda_ms(lambda: probe.query(t, codes, k=k, rule=rule, slot=with_slot,
                                                   strand=with_slot), 20)
                print(f"{t.QUERY} {tag}, {codes.numel()} codes: {ms:.4f} ms ({card})")
        del index, t, codes, host
        torch.cuda.empty_cache()


def warm_and_cold(dev, card: str, label: str, other: str, fn, old, t, keys, k: int) -> None:
    """A batch as small as a coverage call's (K7, K10's coverage: ~1.3M
    windows), this tree's and a checkout's query on it: warm (twenty calls
    back to back on the same keys, as chip_smoke.py times the coverage
    rows) and cold (each launch timed alone after 256 MiB of writes that
    evict L2)."""
    import torch

    import chip_smoke as c
    from aindex_torch.kernels import _cuda, probe
    p, u, _ = old
    out = torch.empty(keys.numel(), dtype=torch.int32, device=dev)
    flush = torch.empty(1 << 26, dtype=torch.int32, device=dev)
    calls = {"this tree": lambda: probe.query(t, keys, k=k, rule=probe.CANON),
             other: lambda: c.check(fn(p, u, keys.data_ptr(), None, None, k, keys.numel(),
                                          probe.CANON, out.data_ptr(), None, None,
                                          _cuda.stream(dev)) == 0, "the parent's query")}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for name, call in calls.items():
        warm = c.cuda_ms(call, 20)
        cold = 0.0
        for _ in range(20):
            flush.zero_()
            start.record()
            call()
            end.record()
            end.synchronize()
            cold += start.elapsed_time(end) / 20
        print(f"{label}: {name} warm {warm:.4f} ms, cold {cold:.4f} ms ({card})")


def coverage_beside(dev, card: str, label: str, other: str, fn, old, t, cov, k: int) -> None:
    """This tree's coverage kernel (K7 or K10's) and a checkout's ``fn``
    on its layout ``old``, on the packed rows ``cov`` (packed, vbits, rows,
    stride): equal answers, then each timed twice in turns."""
    import torch

    import chip_smoke as c
    from aindex_torch.kernels import _cuda, probe
    packed, vbits, rows, stride = cov
    p, u, _ = old
    out = torch.empty((rows, stride - k), dtype=torch.int32, device=dev)

    def call():
        c.check(fn(p, u, packed.data_ptr(), vbits.data_ptr(), packed.numel(), rows, stride, k,
                   probe.CANON, 0, out.data_ptr(), _cuda.stream(dev)) == 0, "coverage entry")
        return out
    c.max_abs_err(probe.coverage(t, packed, vbits, rows, stride, k).view(torch.int32), call())
    calls = {"this tree": lambda: probe.coverage(t, packed, vbits, rows, stride, k),
             other: call}
    times = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            times[name].append(c.cuda_ms(calls[name], 50))
    print(f"{label}: this tree {times['this tree'][0]:.4f} / {times['this tree'][1]:.4f} ms, "
          f"{other} {times[other][0]:.4f} / {times[other][1]:.4f} ms ({card})")


#: what a call runs, by name (all of them when none is named)
PARTS = ("widths", "rmw", "engines", "k3", "walk", "fill")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("lookup_profile: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as c
    from aindex_torch.kernels import _cuda
    trees = dict(arg.split("=", 1) for arg in sys.argv[1:] if "=" in arg)
    parts = [arg for arg in sys.argv[1:] if "=" not in arg] or list(PARTS)
    check_parts = set(parts) - set(PARTS)
    if check_parts:
        print(f"lookup_profile: unknown parts {sorted(check_parts)}; parts: {PARTS}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = c.card_line()
    print(card)
    t0 = time.perf_counter()
    print(f"kernels built in {_cuda.build_all():.1f} s")
    for name in ("quot23", "quotcov23", "cuckoo64", "posfill"):
        regs = sorted({int(line.split("Used ")[1].split()[0])
                       for line in _cuda.KERNELS[name].build_log.splitlines()
                       if "registers" in line})
        print(f"  {name}: registers per thread {regs}")
    if "widths" in parts:
        c.width_test(dev, card)
    if "rmw" in parts:
        c.rmw_test(dev, card)
    if "engines" in parts:
        engine_times(dev, card, trees)
    if "k3" in parts:
        k3_times(dev, card, build_trees(trees))
    if "walk" in parts:
        walk_times(dev, card)
    if "fill" in parts:
        fill_profile(dev, card)
    print(f"lookup_profile: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
