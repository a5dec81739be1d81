#!/usr/bin/env python3
"""Smoke run of aindex_torch's main paths on one CUDA card: the dense
13-mer index, the sparse canonical 23-mer index and the positional index
built by the compute-aindex pipeline.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

1. Checks for a card, prints its name and power limit (nvidia-smi) and
   builds the nine CUDA kernels from aindex_torch/csrc.
2. Holds K1-K4 (the dense kernels) against their plain PyTorch versions on
   the card, at the shapes the dense path gives them, with exact equality
   (all outputs are integers), and times both with CUDA events.
3. Generates the corpus once: scripts/make_scale_corpus.py's (seed 1, 25x:
   773,608 reads of 150 bp over a 4.64 Mbp genome, 0.3% substitutions), as
   a FASTA file and a read matrix that the numpy oracles read.
4. Drives the dense path at E. coli scale, as ``aindex-tpu count -k 13``
   does (iter_sequence_bytes -> build_from_stream -> save -> stats), then
   loads the table back and makes the query and coverage calls that AIndex
   makes for k = 13, each checked against a numpy oracle.
5. Holds K5 (the chunk spectrum) against its plain version on a 2^22-byte
   chunk of the corpus and on a chunk with N runs and newlines, beside
   ``torch.unique``.
6. Drives the sparse path: ``Sparse23Index.build_from_stream`` over the
   FASTA file (stage times and the device's idle share of the build), then
   every query family, coverage, De Bruijn CONT and a save/load round
   trip, each checked against an independent numpy oracle (canonical
   windows of the read matrix + np.unique).
7. Holds K6 (quotient cuckoo queries, every mode) and K7 (coverage) against
   their plain versions on the index built in step 6.
8. Holds K8 (CSR offsets) against its plain version on the dense 4^13 table
   and the sparse index's tf, beside ``torch.cumsum``, and K9 (the
   positional fill of one chunk) on a 2^22-byte corpus chunk of each kind
   from a nonzero cursor, beside ``torch.sort(stable=True)`` of its keys.
9. Drives the positional path: ``pipeline.build_all`` on the corpus FASTA
   for k = 13 and k = 23 under the profiler (stage seconds, MB/s of bases,
   the device's idle share of the fill), then checks the artifacts against
   the numpy oracle: offsets, every position, ``positions_by_slots`` on
   2^16 slots and ``rid_by_pos``. Fails unless K9's launches there ran at
   the chunk shape step 8 checks.
10. Prints the kernels line (launch counts of steps 4, 6 and 9, each path
   run with the counts set to 0 just before it), the card line and the
   result line.

Exits nonzero, with no result line, when CUDA is not available or any
check fails. Imports nothing of JAX or aindex_tpu.
"""

import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

GENOME_BP = 4_641_652     # scripts/make_scale_corpus.py: E. coli K-12 MG1655
READ_LEN = 150
ERR = 0.003
K = 13
SPACE = 4 ** K
K23 = 23
MASK23 = (1 << (2 * K23)) - 1
#: published H100 SXM memory rate at 700 W (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12

#: shapes of the checks: the main paths' (smaller only in a CPU rehearsal)
COVERAGE = 25.0
N_CODES = 4 << 24          # codes-in batches
N_ASCII = 1 << 20          # ASCII query batches
CHUNK_BYTES = 1 << 22      # one ingest chunk
N_SEQ = 10_000             # coverage batches
N_DB = 1 << 16             # De Bruijn batch

DENSE_KERNELS = ("count13_packed", "total13", "gather13", "coverage13_packed")
SPARSE_KERNELS = ("spectrum23", "quot23", "quotcov23")
POSITIONAL_KERNELS = ("csr_offsets", "posfill")


# -- corpus and oracles (numpy only, independent of aindex_torch) ------------

def scale_corpus(coverage: float = 25.0, seed: int = 1):
    """(genome, reads uint8[n_reads, 150]) by scripts/make_scale_corpus.py's
    recipe: the same generator calls in the same order."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, size=GENOME_BP)]
    n_reads = int(GENOME_BP * coverage / READ_LEN)
    starts = rng.integers(0, GENOME_BP - READ_LEN, size=n_reads)
    reads = np.empty((n_reads, READ_LEN), dtype=np.uint8)
    for i in range(0, n_reads, 4096):
        chunk = starts[i:i + 4096]
        mat = genome[chunk[:, None] + np.arange(READ_LEN)[None, :]].copy()
        errs = rng.random(mat.shape) < ERR
        mat[errs] = bases[rng.integers(0, 4, size=int(errs.sum()))]
        reads[i:i + 4096] = mat
    return genome, reads


def write_fasta(reads: np.ndarray, path: str) -> None:
    """The FASTA make_scale_corpus.py writes: '>r<i>' headers, one line each."""
    with open(path, "wb") as f:
        for i in range(0, len(reads), 4096):
            f.write(b"".join(b">r%d\n%s\n" % (i + j, row.tobytes())
                             for j, row in enumerate(reads[i:i + 4096])))


_LUT = np.full(256, 4, dtype=np.uint32)
for _i, _b in enumerate(b"ACGT"):
    _LUT[_b] = _i
    _LUT[_b + 32] = _i


def oracle_codes(mat: np.ndarray):
    """(code, valid) of the 13-mer windows of each row of an ASCII matrix."""
    b = _LUT[mat]
    n_win = mat.shape[1] - K + 1
    code = np.zeros((mat.shape[0], n_win), dtype=np.uint32)
    bad = np.zeros((mat.shape[0], n_win), dtype=bool)
    for j in range(K):
        code = (code << np.uint32(2)) | (b[:, j:j + n_win] & np.uint32(3))
        bad |= b[:, j:j + n_win] > 3
    return code, ~bad


def oracle_rc(code: np.ndarray) -> np.ndarray:
    """Reverse complement of 13-mer codes, field by field."""
    out = np.zeros_like(code)
    for j in range(K):
        out = (out << np.uint32(2)) | (np.uint32(3) - ((code >> np.uint32(2 * j)) & np.uint32(3)))
    return out


def oracle_table(reads: np.ndarray) -> np.ndarray:
    """uint32[4^13]: a bincount of every 13-mer window of every read."""
    counts = np.zeros(SPACE, dtype=np.uint64)
    for i in range(0, len(reads), 1 << 17):
        code, valid = oracle_codes(reads[i:i + (1 << 17)])
        counts += np.bincount(code[valid], minlength=SPACE).astype(np.uint64)
    if counts.max() > np.iinfo(np.uint32).max:
        raise RuntimeError("oracle counts exceed uint32")
    return counts.astype(np.uint32)


def oracle_windows23(mat: np.ndarray):
    """(forward code, reverse-complement code, valid) of the 23-mer windows
    of each row of an ASCII matrix, uint64. The reverse complement is built
    base by base: base j of a window lands complemented in field j."""
    b = _LUT[mat].astype(np.uint64)
    n_win = mat.shape[1] - K23 + 1
    fwd = np.zeros((mat.shape[0], n_win), dtype=np.uint64)
    rc = np.zeros((mat.shape[0], n_win), dtype=np.uint64)
    bad = np.zeros((mat.shape[0], n_win), dtype=bool)
    for j in range(K23):
        bj = b[:, j:j + n_win]
        fwd = (fwd << np.uint64(2)) | (bj & np.uint64(3))
        rc |= (np.uint64(3) - (bj & np.uint64(3))) << np.uint64(2 * j)
        bad |= bj > 3
    return fwd, rc, ~bad


def oracle_spectrum23(reads: np.ndarray):
    """(sorted unique canonical 23-mer codes, counts) of every valid window."""
    parts = []
    for i in range(0, len(reads), 1 << 16):
        fwd, rc, ok = oracle_windows23(reads[i:i + (1 << 16)])
        parts.append(np.minimum(fwd, rc)[ok])
    return np.unique(np.concatenate(parts), return_counts=True)


def oracle_lookup(keys: np.ndarray, counts: np.ndarray, canon: np.ndarray) -> np.ndarray:
    """tf of each canonical code in the oracle spectrum (0 when absent)."""
    at = np.minimum(np.searchsorted(keys, canon), keys.size - 1)
    return np.where(keys[at] == canon, counts[at], 0).astype(np.uint32)


# -- helpers -----------------------------------------------------------------

def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bits64(t):
    """An integer tensor's unsigned values as int64 (uint32 via its int32 view)."""
    import torch
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int64) & 0xFFFF
    return t.to(torch.int64)


def max_abs_err(a, b) -> int:
    """Largest |a - b| over unsigned values; raises when they differ."""
    check(a.shape == b.shape, f"kernel shape {tuple(a.shape)} != plain {tuple(b.shape)}")
    if not a.numel():
        return 0
    x, y = bits64(a), bits64(b)
    err = int((x - y).abs().max()) if bool((x != y).any()) else 0
    check(err == 0, f"kernel != plain (max |err| {err})")
    return err


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` runs, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float) -> float:
    """The least time to move ``n_bytes`` at the published memory rate."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def record(err, ms, plain_ms, n_bytes, library_ms=None) -> dict:
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(n_bytes), "bound_by": "bytes", "library_ms": library_ms}


def random_ascii(rng, n: int, alphabet: bytes, weights) -> np.ndarray:
    p = np.asarray(weights, dtype=np.float64)
    return np.frombuffer(alphabet, dtype=np.uint8)[rng.choice(len(alphabet), size=n, p=p / p.sum())]


def device_busy_ms(prof) -> tuple[float, int]:
    """(union of the device intervals of a torch.profiler trace in ms, the
    number of device events)."""
    import torch
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3, len(spans)


def report(card, name, shape, rec):
    lib = "" if rec["library_ms"] is None else f", library {rec['library_ms']:.4f} ms"
    print(f"kernel {name} [{shape}]: max_abs_err {rec['max_abs_err']}, kernel "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}){lib}, plain/kernel "
          f"{rec['plain_ms'] / rec['ms']:.1f}x ({card})")


def distinct_probed_rows(t, keys) -> int:
    """Distinct rows of the quotient table ``t`` that the probes of the
    canonical ``keys`` read (the second half only for first-half misses)."""
    import torch
    from aindex_torch.kernels.quot import bij
    h1 = bij(keys, *t.mults[:2], t.w)
    r1 = h1 & (t.m - 1)
    miss = t.half0[r1][:, 0].to(torch.int64) != (h1 >> t.lb)
    r2 = bij(keys[miss], *t.mults[2:], t.w) & (t.m - 1)
    return int(torch.unique(r1).numel()) + int(torch.unique(r2).numel())


def upload(dev, packed, vbits):
    import torch
    return (torch.from_numpy(packed.reshape(-1).view(np.int32)).to(dev),
            torch.from_numpy(vbits.reshape(-1)).to(dev))


# -- phase 2: dense kernels against plain versions -----------------------------

def dense_kernels_vs_plain(dev, card: str) -> dict:
    import torch
    from aindex_torch.core import codec
    from aindex_torch.index.dense13 import total13, total13_plain
    from aindex_torch.kernels.count import count13_packed, count13_packed_plain
    from aindex_torch.kernels.coverage import coverage13_packed, coverage13_packed_plain
    from aindex_torch.kernels.encode import (ascii_to_base_codes, packed_window_codes,
                                             revcomp_code13, window_codes)
    from aindex_torch.kernels.lookup import gather13, gather13_plain, jax_index

    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev).manual_seed(7)
    res = {}

    def touched(codes, valid):
        return int(torch.unique(codes[valid]).numel())

    # K1: one 2^22-byte chunk, reads of 150 bases with N, lowercase and '~'
    chunk = random_ascii(rng, CHUNK_BYTES, b"ACGTacgtN~",
                         [0.24, 0.24, 0.24, 0.24, 0.005, 0.005, 0.005, 0.005, 0.005, 0.005])
    chunk[150::151] = ord("\n")
    packed, vbits = upload(dev, *codec.pack_ascii_chunk(chunk))
    kern = torch.zeros(SPACE, dtype=torch.int32, device=dev)
    plain = torch.zeros(SPACE, dtype=torch.int32, device=dev)
    count13_packed(kern, packed, vbits)
    count13_packed_plain(plain, packed, vbits)
    err = max_abs_err(kern.view(torch.uint32), plain.view(torch.uint32))
    scratch = torch.zeros(SPACE, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: count13_packed(scratch, packed, vbits), 50)
    pms = cuda_ms(lambda: count13_packed_plain(scratch, packed, vbits), 5)
    # the chunk in, and each table entry its windows touch read and written once
    n_bytes = packed.numel() * 4 + vbits.numel() + 8 * touched(*packed_window_codes(packed, vbits, K))
    res["count13_packed"] = record(err, ms, pms, n_bytes)
    report(card, "count13_packed", "chunk 2^22 B", res["count13_packed"])
    del kern, plain, scratch

    # K2: a random full table, wrapping adds included
    tf = torch.randint(-2 ** 31, 2 ** 31, (SPACE,), dtype=torch.int32, device=dev,
                       generator=gen).view(torch.uint32)
    err = max_abs_err(total13(tf), total13_plain(tf))
    ms = cuda_ms(lambda: total13(tf), 20)
    pms = cuda_ms(lambda: total13_plain(tf), 3)
    res["total13"] = record(err, ms, pms, 2 * 4 * SPACE)
    report(card, "total13", "4^13 table", res["total13"])
    del tf

    # K3: every mode on u8/u16/u32 tables; 4 x 2^24 codes over the whole
    # uint32 range with the edge codes first, 2^20 ASCII rows
    n_codes = N_CODES
    codes = torch.randint(-2 ** 31, 2 ** 31, (n_codes,), dtype=torch.int32, device=dev,
                          generator=gen)
    codes[n_codes // 2:] &= SPACE - 1           # half in range
    edges = torch.tensor([SPACE - 1, SPACE, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                         dtype=torch.int64).to(torch.int32)
    codes[:edges.numel()] = edges.to(dev)
    valid = torch.rand(n_codes, device=dev, generator=gen) < 0.9
    valid[:edges.numel()] = True
    rows = torch.from_numpy(random_ascii(
        rng, N_ASCII * K, b"ACGTacgtN\n~",
        [0.245, 0.245, 0.245, 0.245, 0.004, 0.004, 0.004, 0.004, 0.002, 0.001, 0.001]
    ).reshape(-1, K)).to(dev)
    index = jax_index(codes)
    # the table entries each mode reaches (forward, and with the revcomp)
    rc_index = revcomp_code13(codes)
    row_codes, row_valid = window_codes(ascii_to_base_codes(rows), K)
    row_codes = row_codes.reshape(-1)[row_valid.reshape(-1)]
    n_touched = {}
    for mode, fwd in (("codes", index), ("codes+mask", index[valid]), ("ascii", row_codes)):
        rc = revcomp_code13(fwd) if mode == "ascii" else rc_index[valid] \
            if mode == "codes+mask" else rc_index
        n_touched[mode, False] = int(torch.unique(fwd).numel())
        n_touched[mode, True] = int(torch.unique(torch.cat([fwd, rc])).numel())
    del rc_index
    k3 = []
    for bits, dtype, view in ((8, torch.uint8, None), (16, torch.int16, torch.uint16),
                              (32, torch.int32, torch.uint32)):
        lo, hi = (0, 256) if bits == 8 else (-2 ** (bits - 1), 2 ** (bits - 1))
        table = torch.randint(lo, hi, (SPACE,), dtype=dtype, device=dev, generator=gen)
        table = table.view(view) if view is not None else table
        modes = [("codes", {"codes": codes}), ("codes+mask", {"codes": codes, "valid": valid}),
                 ("ascii", {"ascii": rows})]
        for mode, kw in modes:
            for both in (False, True):
                got = gather13(table, both=both, **kw)
                ref = gather13_plain(table, both=both, **kw)
                pairs = zip(got, ref) if both else [(got, ref)]
                err = max(max_abs_err(a, b) for a, b in pairs)
                ms = cuda_ms(lambda: gather13(table, both=both, **kw), 20)
                pms = cuda_ms(lambda: gather13_plain(table, both=both, **kw), 2)
                tag = f"u{bits} {mode}{' both' if both else ''}, " \
                      f"{'2^20 rows' if mode == 'ascii' else '4x2^24 codes'}"
                lib = None
                if bits == 8 and mode == "codes" and not both:
                    # the gather alone, on the index each code reads
                    lib = cuda_ms(lambda: torch.take(table, index), 20)
                # queries in, answers out, each table entry they reach read once
                n_out = n_codes if mode != "ascii" else rows.shape[0]
                n_in = {"codes": 4 * n_codes, "codes+mask": 5 * n_codes,
                        "ascii": rows.numel()}[mode]
                n_bytes = n_in + n_out * 4 * (2 if both else 1) \
                    + n_touched[mode, both] * bits // 8
                rec = record(err, ms, pms, n_bytes, lib)
                report(card, "gather13", tag, rec)
                k3.append((tag, rec))
        del table
    head = dict(k3)["u8 codes, 4x2^24 codes"]
    res["gather13"] = {**head, "max_abs_err": max(r["max_abs_err"] for _, r in k3)}
    del codes, valid, rows, index

    # K4: 10,000 rows x stride 151 (150 bp reads), cutoff 0 and 10
    n_rows, stride = N_SEQ, READ_LEN + 1
    mat = random_ascii(rng, n_rows * stride, b"ACGTN",
                       [0.2475, 0.2475, 0.2475, 0.2475, 0.01]).reshape(n_rows, stride)
    mat[:, -1] = ord("\n")
    packed, vbits = upload(dev, *codec.pack_ascii_chunk(mat.reshape(-1)))
    n_touched = touched(*packed_window_codes(packed, vbits, K))
    k4 = []
    for bits, dtype, view in ((8, torch.uint8, None), (16, torch.int16, torch.uint16),
                              (32, torch.int32, torch.uint32)):
        table = torch.randint(0, 64, (SPACE,), dtype=dtype, device=dev, generator=gen)
        table = table.view(view) if view is not None else table
        for cutoff in (0, 10):
            args = (table, packed, vbits, n_rows, stride, cutoff)
            err = max_abs_err(coverage13_packed(*args), coverage13_packed_plain(*args))
            ms = cuda_ms(lambda: coverage13_packed(*args), 50)
            pms = cuda_ms(lambda: coverage13_packed_plain(*args), 5)
            n_bytes = packed.numel() * 4 + vbits.numel() + n_rows * (stride - K) * 4 \
                + n_touched * bits // 8
            rec = record(err, ms, pms, n_bytes)
            report(card, "coverage13_packed", f"u{bits} cutoff {cutoff}, 10000 x 151", rec)
            k4.append(rec)
    res["coverage13_packed"] = {**k4[0], "max_abs_err": max(r["max_abs_err"] for r in k4)}
    return res


# -- phase 4: the dense path end to end ----------------------------------------

def dense_path(dev, card: str, tmp: str, genome: np.ndarray, reads: np.ndarray,
               fasta: str, table: np.ndarray) -> None:
    import torch
    from aindex_torch import Dense13Index
    from aindex_torch.io.fastq import iter_sequence_bytes

    n_bases = reads.size

    # count, as `aindex-tpu count -k 13` does
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    built = Dense13Index.build_from_stream(iter_sequence_bytes(fasta), device=dev)
    t_build = time.perf_counter() - t0
    tf_path = os.path.join(tmp, "ecoli_25x.tf.bin")
    built.save(tf_path)
    s = built.stats()
    print(f"dense build_from_stream: {t_build:.3f} s, {n_bases / t_build / 1e6:.2f} MB/s "
          f"of bases, FASTA parse included ({card})")
    check(np.array_equal(built.tf_host, table), "built table == oracle table")
    check(s["non_zero_kmers"] == int(np.count_nonzero(table))
          and s["total_count"] == len(reads) * (READ_LEN - K + 1)
          and s["max_frequency"] == int(table.max()), f"stats {s}")
    print(f"dense stats: {s}")
    del built

    index = Dense13Index.load(tf_path, device=dev)
    check(np.array_equal(index.tf.view(torch.int32).cpu().numpy().view(np.uint32), table),
          "loaded device table == oracle table")
    rc_all = oracle_rc(np.arange(SPACE, dtype=np.uint32))
    total = table + table[rc_all]

    # ASCII queries: 2^20 k-mers sampled from the reads, 1/16 of them
    # random (mostly absent) and 1/64 with an N
    rng = np.random.default_rng(11)
    n_q = N_ASCII
    r = rng.integers(0, len(reads), size=n_q)
    o = rng.integers(0, READ_LEN - K + 1, size=n_q)
    mat = reads[r[:, None], o[:, None] + np.arange(K)[None, :]]
    mat[::16] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(len(mat[::16]), K))]
    mat[::64, 5] = ord("N")
    text = mat.tobytes().decode("ascii")
    kmers = [text[i:i + K] for i in range(0, len(text), K)]
    code, ok = oracle_codes(mat)
    code, ok = code[:, 0], ok[:, 0]
    want_fwd = np.where(ok, table[code], 0)
    want_rc = np.where(ok, table[oracle_rc(code)], 0)
    for name, call, want in (
            ("get_tf_values", lambda: index.get_tf_values(kmers), want_fwd),
            ("get_total_tf_values", lambda: index.get_total_tf_values(kmers),
             np.where(ok, total[code], 0)),
            ("get_tf_both_directions", lambda: index.get_tf_both_directions(kmers),
             (want_fwd, want_rc))):
        call()
        t0 = time.perf_counter()
        got = call()
        dt = time.perf_counter() - t0
        if isinstance(want, tuple):
            check(all(g.dtype == np.uint32 and np.array_equal(g, w)
                      for g, w in zip(got, want)), name)
        else:
            check(got.dtype == np.uint32 and np.array_equal(got, want), name)
        print(f"dense {name}: {n_q} ASCII k-mers, {n_q / dt / 1e6:.2f} M queries/s "
              f"(host clock, encode and copies included) ({card})")

    # codes-in total on 4 x 2^24 device codes
    gen = torch.Generator(device=dev).manual_seed(13)
    codes = torch.randint(0, SPACE, (N_CODES,), dtype=torch.int32, device=dev, generator=gen)
    got = index.get_total_tf_values_codes(codes)
    check(np.array_equal(got.view(torch.int32).cpu().numpy().view(np.uint32),
                         total[codes.cpu().numpy()]), "get_total_tf_values_codes")
    ms = cuda_ms(lambda: index.get_total_tf_values_codes(codes), 20)
    print(f"dense get_total_tf_values_codes: {codes.numel()} device codes, "
          f"{codes.numel() / ms / 1e6:.2f} G queries/s ({ms:.4f} ms, CUDA events; "
          f"table {index.tf_total.dtype}) ({card})")

    # coverage of 10,000 reads, cutoff 0 and 10; one 100 kbp sequence
    n_seq = N_SEQ
    seqs = [row.tobytes().decode("ascii") for row in reads[:n_seq]]
    wcode, wok = oracle_codes(reads[:n_seq])
    want = np.where(wok, table[wcode], 0)
    for cutoff in (0, 10):
        index.sequence_coverage_batch(seqs, cutoff)
        t0 = time.perf_counter()
        covs = index.sequence_coverage_batch(seqs, cutoff)
        dt = time.perf_counter() - t0
        exp = np.where(want >= cutoff, want, 0)
        check(all(np.array_equal(c, e) for c, e in zip(covs, exp)),
              f"sequence_coverage_batch cutoff {cutoff}")
        print(f"dense sequence_coverage_batch cutoff {cutoff}: {n_seq} x {READ_LEN} bp, "
              f"{n_seq / dt:.0f} sequences/s (host clock) ({card})")
    seq = genome[:100_000]
    cov = index.sequence_coverage(seq.tobytes().decode("ascii"))
    gcode, gok = oracle_codes(seq[None, :])
    check(np.array_equal(cov, np.where(gok, table[gcode], 0)[0]), "sequence_coverage")
    check(index.sequence_coverage("ACGT").size == 0, "short sequence coverage")


# -- phase 5: K5 against its plain version -------------------------------------

def spectrum_vs_plain(dev, card: str, reads: np.ndarray) -> dict:
    import torch
    from aindex_torch.core import codec
    from aindex_torch.kernels.encode import canonical_code64, packed_window_codes
    from aindex_torch.kernels.spectrum import spectrum23, spectrum23_plain

    rng = np.random.default_rng(17)
    n_rows = CHUNK_BYTES // (READ_LEN + 1) + 1
    corpus_chunk = np.hstack([reads[:n_rows], np.full((n_rows, 1), ord("\n"), np.uint8)]
                             ).ravel()[:CHUNK_BYTES]
    n_runs = random_ascii(rng, CHUNK_BYTES, b"ACGTacgtN~",
                          [0.24, 0.24, 0.24, 0.24, 0.005, 0.005, 0.01, 0.005, 0.005, 0.005])
    n_runs[150::151] = ord("\n")
    for start in rng.integers(0, n_runs.size - 64, size=CHUNK_BYTES >> 10):
        n_runs[start:start + rng.integers(1, 64)] = ord("N")
    out = None
    for tag, chunk in (("corpus chunk 2^22 B", corpus_chunk),
                       ("N runs + newlines 2^22 B", n_runs)):
        packed, vbits = upload(dev, *codec.pack_ascii_chunk(chunk))
        got = spectrum23(packed, vbits, K23)
        ref = spectrum23_plain(packed, vbits, K23)
        err = max(max_abs_err(a, b) for a, b in zip(got, ref))
        check(int(got[2]) > 0, "K5 found k-mers")
        ms = cuda_ms(lambda: spectrum23(packed, vbits, K23), 20)
        pms = cuda_ms(lambda: spectrum23_plain(packed, vbits, K23), 3)
        codes, valid = packed_window_codes(packed, vbits, K23)
        live = canonical_code64(codes, K23)[valid]
        lib = cuda_ms(lambda: torch.unique(live, sorted=True, return_counts=True), 20)
        # the chunk in; padded keys (8 B) and counts (4 B) out
        n_bytes = packed.numel() * 4 + vbits.numel() + got[0].numel() * 12
        rec = record(err, ms, pms, n_bytes, lib)
        report(card, "spectrum23", f"{tag}, {int(got[2])} unique of {live.numel()} valid", rec)
        if out is None:
            out = rec
        else:
            out["max_abs_err"] = max(out["max_abs_err"], rec["max_abs_err"])
    return out


# -- phase 6: the sparse path end to end ---------------------------------------

def _torch_canonical(codes):
    """Canonical 23-mer codes on the card, the reverse complement built
    field by field (independent of aindex_torch's bit tricks)."""
    import torch
    rc = torch.zeros_like(codes)
    for j in range(K23):
        rc |= (3 - ((codes >> (2 * (K23 - 1 - j))) & 3)) << (2 * j)
    return torch.minimum(codes, rc)


def sparse_path(dev, card: str, tmp: str, reads: np.ndarray, fasta: str, oracle) -> object:
    import torch
    from torch import profiler
    from aindex_torch import Sparse23Index
    from aindex_torch.index import sparse23
    from aindex_torch.io.fastq import iter_sequence_bytes

    keys, counts = oracle
    n_bases = reads.size

    # build, as `aindex-tpu count -k 23` does, under the profiler
    torch.cuda.synchronize()
    with profiler.profile(activities=[profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        index = Sparse23Index.build_from_stream(iter_sequence_bytes(fasta), device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
    busy_ms, n_events = device_busy_ms(prof)
    t0 = time.perf_counter()
    tables = index.tables
    torch.cuda.synchronize()
    t_quot = time.perf_counter() - t0
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in index.build_seconds.items())
    print(f"sparse build_from_stream: {t_build:.3f} s, {n_bases / t_build / 1e6:.2f} MB/s of "
          f"bases, FASTA parse included ({stages}); quot build + upload {t_quot:.3f} s; "
          f"with it {n_bases / (t_build + t_quot) / 1e6:.2f} MB/s ({card})")
    if n_events:
        print(f"sparse build device time: busy {busy_ms:.3f} ms over {n_events} device "
              f"events, idle share {1 - busy_ms / (t_build * 1e3):.4f} of the build "
              f"(torch.profiler, profiler on) ({card})")
    else:
        print("sparse build device idle share: not measured (the profiler saw no device events)")
    print(f"sparse index: n {index.n}, quotient table m 2^{tables.lb} rows per half, "
          f"{index.quot.nbytes / 1e6:.1f} MB")

    check(index.n == keys.size, f"n {index.n} == oracle {keys.size}")
    order = np.argsort(index.checker_host)
    check(np.array_equal(index.checker_host[order], keys), "checker keys == oracle keys")
    check(np.array_equal(index.tf_host[order], counts.astype(np.uint32)), "tf == oracle counts")
    s = index.stats()
    check(s["total_count"] == int(counts.sum()) and s["max_frequency"] == int(counts.max())
          and s["unique_kmers"] == int((counts == 1).sum()), f"stats {s}")
    print(f"sparse stats: {s}")

    # ASCII queries: 2^20 k-mers, half windows of the reads, half random
    rng = np.random.default_rng(23)
    n_q = N_ASCII
    r = rng.integers(0, len(reads), size=n_q)
    o = rng.integers(0, READ_LEN - K23 + 1, size=n_q)
    mat = reads[r[:, None], o[:, None] + np.arange(K23)[None, :]]
    mat[1::2] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(n_q // 2, K23))]
    mat[::64, 7] = ord("N")
    text = mat.tobytes().decode("ascii")
    kmers = [text[i:i + K23] for i in range(0, len(text), K23)]
    fwd, rc, ok = oracle_windows23(mat)
    fwd, rc, ok = fwd[:, 0], rc[:, 0], ok[:, 0]
    canon = np.minimum(fwd, rc)
    want = np.where(ok, oracle_lookup(keys, counts, canon), 0).astype(np.uint32)
    print(f"sparse ASCII batch: {int((want > 0).sum())} of {n_q} present")
    for name, call, check_fn in (
            ("get_tf_values", lambda: index.get_tf_values(kmers),
             lambda g: g.dtype == np.uint32 and np.array_equal(g, want)),
            ("get_pfids", lambda: index.get_pfids(kmers),
             lambda g: g.dtype == np.int64
             and np.array_equal(g == index.n, want == 0)
             and np.array_equal(index.checker_host[g[want > 0]], canon[want > 0])),
            ("get_strands", lambda: index.get_strands(kmers),
             lambda g: g.dtype == np.int32
             and np.array_equal(g, np.where(want > 0, np.where(fwd <= rc, 1, 2), 0)))):
        call()
        t0 = time.perf_counter()
        got = call()
        dt = time.perf_counter() - t0
        check(check_fn(got), name)
        print(f"sparse {name}: {n_q} ASCII k-mers, {n_q / dt / 1e6:.2f} M queries/s "
              f"(host clock, encode and copies included) ({card})")

    # codes-in on 4 x 2^24 device codes: half windows of the reads, half random
    n_codes = N_CODES
    reads_dev = torch.from_numpy(reads).to(dev)
    lut = torch.from_numpy(_LUT.astype(np.int64)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(29)
    half = n_codes // 2
    rr = torch.randint(0, len(reads), (half,), device=dev, generator=gen)
    oo = torch.randint(0, READ_LEN - K23 + 1, (half,), device=dev, generator=gen)
    sampled = torch.zeros(half, dtype=torch.int64, device=dev)
    for j in range(K23):
        sampled = (sampled << 2) | lut[reads_dev[rr, oo + j].to(torch.int64)]
    codes = torch.cat([sampled, torch.randint(0, 1 << 46, (half,), dtype=torch.int64,
                                              device=dev, generator=gen)])
    del reads_dev, rr, oo, sampled
    keys_dev = torch.from_numpy(keys.view(np.int64)).to(dev)
    counts_dev = torch.from_numpy(counts.astype(np.int64)).to(dev)
    c = _torch_canonical(codes)
    at = torch.searchsorted(keys_dev, c).clamp_(max=keys.size - 1)
    want_codes = torch.where(keys_dev[at] == c, counts_dev[at], 0)
    del c, at
    got = index.get_tf_values_codes(codes)
    check(got.dtype == torch.uint32 and bool((bits64(got) == want_codes).all()),
          "get_tf_values_codes == oracle")
    ms = cuda_ms(lambda: index.get_tf_values_codes(codes), 20)
    print(f"sparse get_tf_values_codes: {n_codes} device codes "
          f"({int((want_codes > 0).sum())} present), {n_codes / ms / 1e6:.3f} G queries/s "
          f"({ms:.4f} ms, CUDA events) ({card})")
    del got, want_codes, keys_dev, counts_dev

    # coverage of 10,000 reads, cutoff 0 and 10
    n_seq = N_SEQ
    seqs = [row.tobytes().decode("ascii") for row in reads[:n_seq]]
    wf, wr, wok = oracle_windows23(reads[:n_seq])
    wtf = np.where(wok, oracle_lookup(keys, counts, np.minimum(wf, wr)), 0)
    # record the (rows, stride) of every K7 call, which quot_vs_plain checks
    k7_shapes = set()
    real_quotcov23 = sparse23.quotcov23

    def quotcov23_seen(t, packed, vbits, rows, stride, *args):
        k7_shapes.add((rows, stride))
        return real_quotcov23(t, packed, vbits, rows, stride, *args)

    sparse23.quotcov23 = quotcov23_seen
    for cutoff in (0, 10):
        index.sequence_coverage_batch(seqs, cutoff)
        t0 = time.perf_counter()
        covs = index.sequence_coverage_batch(seqs, cutoff)
        dt = time.perf_counter() - t0
        exp = np.where(wtf >= cutoff, wtf, 0)
        check(all(c.dtype == np.uint32 and np.array_equal(c, e) for c, e in zip(covs, exp)),
              f"sparse sequence_coverage_batch cutoff {cutoff}")
        print(f"sparse sequence_coverage_batch cutoff {cutoff}: {n_seq} x {READ_LEN} bp, "
              f"{n_seq / dt:.0f} sequences/s (host clock) ({card})")
    sparse23.quotcov23 = real_quotcov23
    check(k7_shapes == {(N_SEQ, READ_LEN + 1)},
          f"K7 ran at rows x stride {sorted(k7_shapes)}, the shape its check uses")
    print(f"sparse coverage: K7 launched at rows x stride {sorted(k7_shapes)}")

    # De Bruijn continuation with CONT on 2^16 k-mers of the reads
    n_db = N_DB
    dmat = mat[:2 * n_db:2].copy()
    dmat[:, 7] = reads[r[:2 * n_db:2], o[:2 * n_db:2] + 7]   # undo the N
    dtext = dmat.tobytes().decode("ascii")
    dkmers = [dtext[i:i + K23] for i in range(0, len(dtext), K23)]
    dfwd, _, _ = oracle_windows23(dmat)
    ext = ((dfwd[:, :1] << np.uint64(2)) | np.arange(4, dtype=np.uint64)) & np.uint64(MASK23)
    ext_rc = np.zeros_like(ext)
    for j in range(K23):
        ext_rc |= (np.uint64(3) - ((ext >> np.uint64(2 * (K23 - 1 - j))) & np.uint64(3))) \
            << np.uint64(2 * j)
    etf = oracle_lookup(keys, counts, np.minimum(ext, ext_rc).reshape(-1)).reshape(-1, 4)
    best = np.array([max(i for i in range(4) if row[i] == row.max()) for row in etf])
    info = index.debruijn_next_info(dkmers)
    check(np.array_equal(info["tf"], etf), "debruijn_next_info tf")
    check(np.array_equal(info["n"], (etf > 0).sum(axis=1))
          and np.array_equal(info["sum"], etf.sum(axis=1)), "debruijn_next_info n, sum")
    check(np.array_equal(info["best_hit"], np.array(list("ACGT"))[best])
          and np.array_equal(info["best_hit_tf"], etf[np.arange(n_db), best])
          and np.array_equal(info["best_ukmer"], ext[np.arange(n_db), best]),
          "debruijn_next_info best hit (ties to the last in ACGT)")
    print(f"sparse debruijn_next_info: {n_db} k-mers, {int((etf.sum(axis=1) > 0).sum())} "
          f"with a continuation")

    # save / load round trip
    prefix = os.path.join(tmp, "ecoli_25x.23")
    index.save(prefix)
    back = Sparse23Index.load(prefix, device=dev)
    check(np.array_equal(back.checker_host, index.checker_host)
          and np.array_equal(back.tf_host, index.tf_host)
          and np.array_equal(back.mphf.g_packed, index.mphf.g_packed), "save/load arrays")
    check(np.array_equal(back.get_tf_values(kmers[:4096]), want[:4096]), "loaded index queries")
    sizes = {ext: os.path.getsize(prefix + ext) for ext in (".pf", ".tf.bin", ".kmers.bin")}
    print(f"sparse save/load round trip: {sizes}")
    return index


# -- phase 7: K6 and K7 against their plain versions ---------------------------

def quot_vs_plain(dev, card: str, index, reads: np.ndarray) -> dict:
    import torch
    from aindex_torch.core import codec
    from aindex_torch.kernels.encode import (ascii_to_base_codes, canonical_code64,
                                             packed_window_codes, window_codes)
    from aindex_torch.kernels.quot import quot23, quot23_plain, quotcov23, quotcov23_plain

    t = index.tables

    gen = torch.Generator(device=dev).manual_seed(31)
    n_codes = N_CODES
    half = n_codes // 2
    sample = torch.from_numpy(index.checker_host.view(np.int64)).to(dev)
    picks = sample[torch.randint(0, sample.numel(), (half,), device=dev, generator=gen)]
    codes = torch.cat([picks, torch.randint(0, 1 << 46, (half,), dtype=torch.int64,
                                            device=dev, generator=gen)])
    codes = codes[torch.randperm(n_codes, device=dev, generator=gen)]
    valid = torch.rand(n_codes, device=dev, generator=gen) < 0.9
    rows_np = np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(37).integers(
        0, 4, size=(N_ASCII, K23))]
    r = np.random.default_rng(41).integers(0, len(reads), size=N_ASCII // 2)
    rows_np[::2] = reads[r, :K23]
    rows_np[::97, 3] = ord("N")
    rows = torch.from_numpy(rows_np).to(dev)
    canon = canonical_code64(codes, K23)
    # rows the probes read: a masked-off code reads none
    n_probe = {False: distinct_probed_rows(t, canon),
               True: distinct_probed_rows(t, canon[valid])}
    del canon
    res = {}
    k6 = []
    for tag, kw, n_in, n_out in (
            ("codes, tf", {"codes": codes}, 8, 4),
            ("codes+mask, tf", {"codes": codes, "valid": valid}, 9, 4),
            ("codes, tf+slot+strand", {"codes": codes, "slot": True, "strand": True}, 8, 12),
            ("codes+mask, tf+slot+strand",
             {"codes": codes, "valid": valid, "slot": True, "strand": True}, 9, 12)):
        got = quot23(t, k=K23, **kw)
        ref = quot23_plain(t, k=K23, **kw)
        pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
        err = max(max_abs_err(a, b) for a, b in pairs)
        ms = cuda_ms(lambda: quot23(t, k=K23, **kw), 20)
        pms = cuda_ms(lambda: quot23_plain(t, k=K23, **kw), 2)
        # codes (+ mask) in, outputs out, each probed row read once (and
        # its slot when the slot is asked for)
        n_bytes = n_codes * (n_in + n_out) \
            + n_probe["valid" in kw] * (12 if "slot" in kw else 8)
        rec = record(err, ms, pms, n_bytes)
        report(card, "quot23", f"{tag}, {n_codes} codes (half present)", rec)
        k6.append((tag, rec))
    row_codes, row_valid = window_codes(ascii_to_base_codes(rows), K23)
    ascii_probe = distinct_probed_rows(
        t, canonical_code64(row_codes.reshape(-1)[row_valid.reshape(-1)], K23))
    for tag, kw, n_out in (("ascii, tf", {}, 4),
                           ("ascii, tf+slot+strand", {"slot": True, "strand": True}, 12)):
        got = quot23(t, ascii=rows, k=K23, **kw)
        ref = quot23_plain(t, ascii=rows, k=K23, **kw)
        pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
        err = max(max_abs_err(a, b) for a, b in pairs)
        ms = cuda_ms(lambda: quot23(t, ascii=rows, k=K23, **kw), 20)
        pms = cuda_ms(lambda: quot23_plain(t, ascii=rows, k=K23, **kw), 2)
        n_bytes = rows.numel() + rows.shape[0] * n_out + ascii_probe * (12 if kw else 8)
        rec = record(err, ms, pms, n_bytes)
        report(card, "quot23", f"{tag}, {rows.shape[0]} rows", rec)
        k6.append((tag, rec))
    head = dict(k6)["codes, tf"]
    res["quot23"] = {**head, "max_abs_err": max(r["max_abs_err"] for _, r in k6)}
    del codes, valid, picks, sample

    # K7: 10,000 reads of the corpus, cutoff 0 and 10, packed as
    # sequence_coverage_batch packs them on the sparse path (one launch of
    # 10,000 rows of stride 151, which sparse_path checks)
    [(members, stride, packed, vbits)] = codec.coverage_row_batches(
        [row.tobytes() for row in reads[:N_SEQ]], K23)
    n_rows = len(members)
    packed, vbits = upload(dev, packed, vbits)
    wcodes, wvalid = packed_window_codes(packed, vbits, K23)
    n_probe = distinct_probed_rows(t, canonical_code64(wcodes[wvalid], K23))
    k7 = []
    for cutoff in (0, 10):
        args = (t, packed, vbits, n_rows, stride, K23, cutoff)
        err = max_abs_err(quotcov23(*args), quotcov23_plain(*args))
        ms = cuda_ms(lambda: quotcov23(*args), 50)
        pms = cuda_ms(lambda: quotcov23_plain(*args), 5)
        n_bytes = packed.numel() * 4 + vbits.numel() + n_rows * (stride - K23) * 4 + n_probe * 8
        rec = record(err, ms, pms, n_bytes)
        report(card, "quotcov23", f"cutoff {cutoff}, {n_rows} x {stride}", rec)
        k7.append(rec)
    res["quotcov23"] = {**k7[0], "max_abs_err": max(r["max_abs_err"] for r in k7)}
    return res


# -- phase 8: K8 and K9 against their plain versions ---------------------------

def corpus_blob(reads: np.ndarray) -> np.ndarray:
    """The .reads blob the pipeline writes for the corpus FASTA: each read
    and a newline, so read i starts at 151 i."""
    return np.hstack([reads, np.full((len(reads), 1), ord("\n"), np.uint8)]).ravel()


def positional_vs_plain(dev, card: str, reads: np.ndarray, table: np.ndarray, index) -> dict:
    import torch
    from aindex_torch.core import codec
    from aindex_torch.core.reads import blob_chunks
    from aindex_torch.kernels.encode import canonical_code64, packed_window_codes
    from aindex_torch.kernels.positional import (chunk_slots_plain, csr_offsets,
                                                 csr_offsets_plain, fill_scratch, posfill,
                                                 scatter_chunk_plain)

    res = {}
    # K8 over the path's two tables: the 4^13 dense counts and the sparse
    # index's per-slot tf
    k8 = []
    for tag, host in (("dense 4^13", table), (f"sparse n={index.n}", index.tf_host)):
        tf = torch.from_numpy(host.view(np.int32)).to(dev).view(torch.uint32)
        err = max_abs_err(csr_offsets(tf), csr_offsets_plain(tf))
        ms = cuda_ms(lambda: csr_offsets(tf), 20)
        pms = cuda_ms(lambda: csr_offsets_plain(tf), 5)
        # one call of the library's scan on the same counts (all < 2^31 here)
        lib = cuda_ms(lambda: torch.cumsum(tf.view(torch.int32), 0, dtype=torch.int64), 20)
        rec = record(err, ms, pms, 4 * tf.numel() + 8 * (tf.numel() + 1), lib)
        report(card, "csr_offsets", tag, rec)
        k8.append(rec)
        del tf
    res["csr_offsets"] = {**k8[0], "max_abs_err": max(r["max_abs_err"] for r in k8)}

    # K9 on the second 2^22-byte chunk of the corpus blob (a nonzero blob
    # offset), each kind, from a nonzero cursor; the offsets leave each slot
    # room for the cursor and the chunk's windows, so no two writes meet
    blob = corpus_blob(reads)
    k9 = []
    for tag, k, tables in (("dense k=13", K, None), ("sparse k=23", K23, index.tables)):
        piece, off = list(itertools.islice(blob_chunks(blob, k, CHUNK_BYTES), 2))[1]
        packed, vbits = upload(dev, *codec.pack_ascii_chunk(piece))
        n_slots = SPACE if tables is None else index.n
        slots, valid = chunk_slots_plain(packed, vbits, k, tables)
        live = slots[valid]
        n_valid, n_distinct = live.numel(), int(torch.unique(live).numel())
        gen = torch.Generator(device=dev).manual_seed(43)
        cursor = torch.randint(0, 4, (n_slots,), dtype=torch.int32, device=dev, generator=gen)
        tf = torch.bincount(live, minlength=n_slots).to(torch.int32) + cursor
        offsets = csr_offsets_plain(tf)
        total = int(offsets[-1])
        got = (torch.zeros(total, dtype=torch.int64, device=dev), cursor.clone())
        ref = (torch.zeros(total, dtype=torch.int64, device=dev), cursor.clone())
        scratch = fill_scratch(16 * packed.numel() - k + 1, dev)
        posfill(*got, offsets[:-1], packed, vbits, k, off, tables, scratch)
        scatter_chunk_plain(*ref, offsets[:-1], slots,
                            torch.arange(slots.numel(), device=dev) + off, valid)
        err = max(max_abs_err(a, b) for a, b in zip(got, ref))
        check(int((got[0] > 0).sum()) == n_valid, f"K9 {tag} wrote every valid window")
        # timed on copies: the cursor runs on from call to call, the work
        # per call stays the chunk's
        work = (got[0].clone(), got[1].clone())
        ms = cuda_ms(lambda: posfill(*work, offsets[:-1], packed, vbits, k, off, tables,
                                     scratch), 20)

        def plain():
            s, v = chunk_slots_plain(packed, vbits, k, tables)
            scatter_chunk_plain(*work, offsets[:-1], s,
                                torch.arange(s.numel(), device=dev) + off, v)
        pms = cuda_ms(plain, 3)
        idx_bits = max(1, (16 * packed.numel() - k).bit_length())
        keys = (live << idx_bits) | torch.nonzero(valid).reshape(-1)
        lib = cuda_ms(lambda: torch.sort(keys, stable=True), 20)
        # the chunk in; a position out per valid window; per distinct slot
        # its offset read and its cursor read and written (and, sparse, its
        # slot-column entry and the table rows the probes read)
        n_bytes = packed.numel() * 4 + vbits.numel() + 8 * n_valid + 16 * n_distinct
        if tables is not None:
            codes, wvalid = packed_window_codes(packed, vbits, k)
            n_bytes += 4 * n_distinct + 8 * distinct_probed_rows(
                tables, canonical_code64(codes[wvalid], k))
        rec = record(err, ms, pms, n_bytes, lib)
        report(card, "posfill", f"{tag}, corpus chunk 2^22 B at {off}, {n_valid} valid "
               f"windows, {n_distinct} slots", rec)
        k9.append(rec)
        del got, ref, work, scratch, cursor, tf, offsets
    res["posfill"] = {**k9[0], "max_abs_err": max(r["max_abs_err"] for r in k9)}
    return res


# -- phase 9: the positional path end to end -----------------------------------

def profile_ranges(prof) -> tuple[dict, list]:
    """(record_function name -> (start, end) us of its first range, sorted
    device intervals in us) of a torch.profiler trace."""
    import torch
    ranges, device = {}, []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(e)
        elif e.name not in ranges:
            ranges[e.name] = (e.time_range.start, e.time_range.end)
    # a record_function range also shows on the device timeline, under its
    # own name, spanning its kernels: not device work of its own
    spans = [(e.time_range.start, e.time_range.end) for e in device if e.name not in ranges]
    return ranges, sorted(spans)


def busy_in(spans, start: float, end: float) -> float:
    """us of the union of device intervals clipped to [start, end]."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        s, e = max(s, start), min(e, end)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def oracle_dense_positions(reads: np.ndarray) -> np.ndarray:
    """1-based blob positions of every valid 13-mer window, grouped by code
    ascending and by position ascending within a code: the stable argsort
    of the codes in blob order, as one sort of (code << 27 | position)."""
    parts = []
    stride = READ_LEN + 1
    for i in range(0, len(reads), 1 << 16):
        code, ok = oracle_codes(reads[i:i + (1 << 16)])
        pos = (np.arange(i, i + len(code), dtype=np.uint64)[:, None] * np.uint64(stride)
               + np.arange(code.shape[1], dtype=np.uint64)[None, :])
        parts.append((code.astype(np.uint64)[ok] << np.uint64(27)) | pos[ok])
    check(len(reads) * stride < 1 << 27, "blob positions fit in 27 bits")
    keys = np.concatenate(parts)
    keys.sort()
    return (keys & np.uint64((1 << 27) - 1)) + np.uint64(1)


def oracle_canon(reads: np.ndarray):
    """(canonical 23-mer code, valid) of every window, [n_reads, 128]."""
    n_win = READ_LEN - K23 + 1
    canon = np.empty((len(reads), n_win), np.uint64)
    ok = np.empty((len(reads), n_win), bool)
    for i in range(0, len(reads), 1 << 16):
        fwd, rc, v = oracle_windows23(reads[i:i + (1 << 16)])
        canon[i:i + len(v)] = np.minimum(fwd, rc)
        ok[i:i + len(v)] = v
    return canon, ok


def positional_path(dev, card: str, tmp: str, reads: np.ndarray, fasta: str,
                    table: np.ndarray, oracle) -> dict[str, int]:
    """build_all on the corpus FASTA for k = 13 and k = 23 under the
    profiler, each against the numpy oracle; returns the K8 and K9 launch
    counts of the two runs."""
    import torch
    from torch import profiler
    from aindex_torch import PositionalIndex, Sparse23Index
    from aindex_torch.core.reads import ReadsStore
    from aindex_torch.index import positional as tpos
    from aindex_torch.kernels import _cuda
    from aindex_torch.pipeline.build import BuildConfig, build_all

    keys, counts = oracle
    n_bases = reads.size
    stride = READ_LEN + 1
    launched = {name: 0 for name in POSITIONAL_KERNELS}
    # the (n_words, kind) of every K9 call of the path, checked against
    # the chunk positional_vs_plain checks
    k9_shapes = set()
    real_posfill = tpos.posfill

    def posfill_seen(positions, cursor, offsets, packed, vbits, k, off, tables=None,
                     scratch=None):
        k9_shapes.add((packed.numel(), "dense" if tables is None else "sparse"))
        return real_posfill(positions, cursor, offsets, packed, vbits, k, off, tables, scratch)

    tpos.posfill = posfill_seen
    try:
        for k in (K, K23):
            prefix = os.path.join(tmp, f"ecoli_25x.p{k}")
            cfg = BuildConfig(prefix=prefix, k=k, chunk=CHUNK_BYTES, device=str(dev))
            torch.cuda.synchronize()
            _cuda.reset_launches()
            acts = [profiler.ProfilerActivity.CPU, profiler.ProfilerActivity.CUDA]
            with profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                build_all([fasta], cfg)
                t_all = time.perf_counter() - t0
            runs = _cuda.launches()
            for name in launched:
                launched[name] += runs[name]
            ranges, spans = profile_ranges(prof)

            def sec(name):
                s, e = ranges[name]
                return (e - s) / 1e6
            stages = {name: sec(name) for name in (
                "build_all.reads", "build_all.count", "build_all.positional",
                "positional.tables", "positional.offsets", "positional.fill",
                "positional.copy", "positional.save") if name in ranges}
            t_pos = stages["build_all.positional"]
            print(f"positional build_all k={k}: {t_all:.3f} s in all (torch.profiler on); "
                  + ", ".join(f"{n} {v:.3f} s" for n, v in stages.items()) + f"; positional "
                  f"stage {n_bases / t_pos / 1e6:.2f} MB/s of bases; launches "
                  f"{ {n: c for n, c in runs.items() if c} } ({card})")
            fs, fe = ranges["positional.fill"]
            busy = busy_in(spans, fs, fe)
            if spans:
                print(f"positional fill k={k}: device busy {busy / 1e3:.3f} ms of "
                      f"{(fe - fs) / 1e3:.3f} ms, idle share {1 - busy / (fe - fs):.4f} "
                      f"(torch.profiler, profiler on) ({card})")
            else:
                print(f"positional fill k={k} device idle share: not measured (the "
                      "profiler saw no device events)")
            check(runs["posfill"] == -(-(len(reads) * stride - (k - 1)) // (CHUNK_BYTES - k + 1))
                  and runs["csr_offsets"] == 1, f"K8/K9 launches {runs}")

            t0 = time.perf_counter()
            store = ReadsStore.from_reads_file(prefix + ".reads", prefix + ".ridx")
            check(np.array_equal(store.blob, corpus_blob(reads))
                  and np.array_equal(store.starts, np.arange(len(reads)) * stride),
                  "the .reads blob holds the corpus reads, one a line")
            pos = PositionalIndex.load(prefix + ".index.bin", prefix + ".indices.bin")
            rng = np.random.default_rng(47 + k)
            if k == K:
                n_slots = SPACE
                want_off = np.zeros(SPACE + 1, np.uint64)
                np.cumsum(table, out=want_off[1:], dtype=np.uint64)
                check(np.array_equal(pos.offsets, want_off), "dense offsets == cumsum(table)")
                want_pos = oracle_dense_positions(reads)
                check(pos.total == want_pos.size and np.array_equal(pos.positions, want_pos),
                      "dense positions == stable argsort of the oracle codes + 1")

                def want_lists(slots):
                    return [want_pos[int(want_off[s]):int(want_off[s + 1])] - np.uint64(1)
                            for s in slots]
            else:
                index = Sparse23Index.load(prefix, K23, device="cpu")
                n_slots = index.n
                order = np.argsort(index.checker_host)
                check(np.array_equal(index.checker_host[order], keys)
                      and np.array_equal(index.tf_host[order], counts.astype(np.uint32)),
                      "sparse index == oracle spectrum")
                tf = pos.offsets[1:].astype(np.int64) - pos.offsets[:-1].astype(np.int64)
                check(pos.offsets[0] == 0 and np.array_equal(tf, index.tf_host.astype(np.int64)),
                      "sparse offset differences == tf_host")
                canon, ok = oracle_canon(reads)
                check(pos.total == int(ok.sum()), f"total {pos.total} == present windows")
                slot_of = np.repeat(np.arange(n_slots, dtype=np.int32), tf)
                p0 = pos.positions.astype(np.int64) - 1
                row, col = p0 // stride, p0 % stride
                good = (p0 >= 0) & (col < canon.shape[1])
                col = np.minimum(col, canon.shape[1] - 1)
                check(bool(good.all()) and bool(ok[row, col].all())
                      and np.array_equal(canon[row, col], index.checker_host[slot_of]),
                      "every listed window holds its slot's canonical k-mer")
                new_slot = np.zeros(pos.total, bool)
                new_slot[pos.offsets[:-1][tf > 0].astype(np.int64)] = True
                check(bool(((np.diff(p0) > 0) | new_slot[1:]).all()),
                      "positions strictly ascend within each slot")
                del slot_of, row, col, good, new_slot, p0

                def want_lists(slots):
                    # the oracle's windows of the asked slots' k-mers
                    u = np.unique(index.checker_host[slots])
                    flat = canon.reshape(-1)
                    at = np.minimum(np.searchsorted(u, flat), u.size - 1)
                    hit = np.flatnonzero((u[at] == flat) & ok.reshape(-1))
                    w = canon.shape[1]
                    p = (hit // w) * stride + hit % w
                    o = np.lexsort((p, at[hit]))
                    grp, p = at[hit][o], p[o].astype(np.uint64)
                    bounds = np.searchsorted(grp, np.arange(u.size + 1))
                    slot_u = np.searchsorted(u, index.checker_host[slots])
                    return [p[bounds[j]:bounds[j + 1]] for j in slot_u]
            slots = rng.integers(0, n_slots, size=1 << 16)
            flat, lens = pos.positions_by_slots(slots)
            want = want_lists(slots)
            check(np.array_equal(lens, [len(w) for w in want])
                  and np.array_equal(flat, np.concatenate(want)),
                  "positions_by_slots on 2^16 slots == oracle")
            rid = store.rid_by_pos(flat.astype(np.int64))
            check(np.array_equal(rid, flat.astype(np.int64) // stride)
                  and bool((store.starts[rid] <= flat.astype(np.int64)).all())
                  and bool((flat.astype(np.int64) < store.ends[rid]).all()),
                  "rid_by_pos resolves every position to its read")
            print(f"positional k={k}: {pos.total} positions over {pos.n_slots} slots (max tf "
                  f"{pos.max_tf}), == oracle; positions_by_slots on 2^16 slots -> "
                  f"{flat.size} positions, rid_by_pos resolved ({time.perf_counter() - t0:.1f} s)")
            del pos, store
            for sfx in (".reads", ".ridx", ".header", ".tf.bin", ".pf", ".kmers.bin",
                        ".index.bin", ".indices.bin"):
                if os.path.exists(prefix + sfx):
                    os.remove(prefix + sfx)
            torch.cuda.empty_cache()
    finally:
        tpos.posfill = real_posfill
    want_words = CHUNK_BYTES // 16
    check(k9_shapes == {(want_words, "dense"), (want_words, "sparse")},
          f"K9 ran at (words, kind) {sorted(k9_shapes)}, the chunk its check uses")
    print(f"positional path: K9 launched at (words, kind) {sorted(k9_shapes)}")
    return launched


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from aindex_torch.kernels import _cuda

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    t_start = time.perf_counter()
    t_build = _cuda.build_all()
    print(f"kernels built in {t_build:.1f} s")
    for k in _cuda.KERNELS.values():
        regs = sorted({int(line.split("Used ")[1].split()[0])
                       for line in k.build_log.splitlines() if "registers" in line})
        spills = sum("0 bytes spill stores" not in line
                     for line in k.build_log.splitlines() if "spill stores" in line)
        print(f"  {k.name}: registers per thread {regs}, instantiations with spills {spills}")

    t0 = time.perf_counter()
    measured = dense_kernels_vs_plain(dev, card)
    print(f"phase dense kernels-vs-plain: {time.perf_counter() - t0:.1f} s")

    counts: dict[str, int] = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        genome, reads = scale_corpus(COVERAGE, 1)
        fasta = os.path.join(tmp, "ecoli_25x.fasta")
        write_fasta(reads, fasta)
        print(f"corpus: {len(reads)} reads, {reads.size / 1e6:.1f} MB of bases, "
              f"{os.path.getsize(fasta) / 1e6:.1f} MB FASTA ({time.perf_counter() - t0:.1f} s)")

        t0 = time.perf_counter()
        table = oracle_table(reads)
        print(f"dense oracle table {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        _cuda.reset_launches()
        dense_path(dev, card, tmp, genome, reads, fasta, table)
        dense_counts = _cuda.launches()
        print(f"phase dense path: {time.perf_counter() - t0:.1f} s")
        counts.update({name: dense_counts[name] for name in DENSE_KERNELS})
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        measured["spectrum23"] = spectrum_vs_plain(dev, card, reads)
        print(f"phase spectrum kernel-vs-plain: {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        oracle = oracle_spectrum23(reads)
        print(f"sparse oracle spectrum: {oracle[0].size} distinct canonical 23-mers "
              f"({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        _cuda.reset_launches()
        index = sparse_path(dev, card, tmp, reads, fasta, oracle)
        sparse_counts = _cuda.launches()
        print(f"phase sparse path: {time.perf_counter() - t0:.1f} s")
        counts.update({name: sparse_counts[name] for name in SPARSE_KERNELS})

        t0 = time.perf_counter()
        measured.update(quot_vs_plain(dev, card, index, reads))
        print(f"phase quot kernels-vs-plain: {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        measured.update(positional_vs_plain(dev, card, reads, table, index))
        print(f"phase positional kernels-vs-plain: {time.perf_counter() - t0:.1f} s")
        del index
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        counts.update(positional_path(dev, card, tmp, reads, fasta, table, oracle))
        print(f"phase positional path: {time.perf_counter() - t0:.1f} s")
    for name in _cuda.KERNELS:
        check(counts[name] > 0, f"kernel {name} launched on its main path")
    print(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda",
         "source": "aindex_torch/csrc/" + os.path.basename(k.source),
         "replaces": k.replaces, "launches": counts[k.name], **measured[k.name]}
        for k in _cuda.KERNELS.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
