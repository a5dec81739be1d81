#!/usr/bin/env python3
"""Smoke run of aindex_torch's dense 13-mer main path on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

1. Checks for a card, prints its name and power limit (nvidia-smi) and
   builds the four CUDA kernels from aindex_torch/csrc.
2. Holds every kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it, with exact equality (all outputs
   are integers), and times both with CUDA events.
3. Drives the main path at E. coli scale, as ``aindex-tpu count -k 13``
   does (iter_sequence_bytes -> build_from_stream -> save -> stats), then
   loads the table back and makes the query and coverage calls that
   AIndex makes for k = 13. The corpus is scripts/make_scale_corpus.py's
   (seed 1, 25x: 773,608 reads of 150 bp over a 4.64 Mbp genome, 0.3%
   substitutions), and every answer is checked against an independent
   numpy oracle computed from the generated read matrix.
4. Prints the kernels line (launch counts of step 3) and the result line.

Exits nonzero, with no result line, when CUDA is not available or any
check fails. Imports nothing of JAX or aindex_tpu.
"""

from __future__ import annotations

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



# -- corpus and oracle (numpy only, independent of aindex_torch) -------------

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
    err = int((bits64(a) - bits64(b)).abs().max()) if a.numel() else 0
    check(a.shape == b.shape and err == 0, f"kernel != plain (max |err| {err})")
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


def random_ascii(rng, n: int, alphabet: bytes, weights) -> np.ndarray:
    p = np.asarray(weights, dtype=np.float64)
    return np.frombuffer(alphabet, dtype=np.uint8)[rng.choice(len(alphabet), size=n, p=p / p.sum())]


# -- phase 2: kernel against plain version -----------------------------------

def kernels_vs_plain(dev, card: str) -> dict:
    import torch
    from aindex_torch.core import codec
    from aindex_torch.index.dense13 import total13, total13_plain
    from aindex_torch.kernels.count import count13_packed, count13_packed_plain
    from aindex_torch.kernels.coverage import coverage13_packed, coverage13_packed_plain
    from aindex_torch.kernels.lookup import gather13, gather13_plain

    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev).manual_seed(7)
    res = {}

    def report(name, shape, err, ms, plain_ms):
        print(f"kernel {name} [{shape}]: max_abs_err {err}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, plain/kernel {plain_ms / ms:.1f}x ({card})")

    def upload(packed, vbits):
        return (torch.from_numpy(packed.reshape(-1).view(np.int32)).to(dev),
                torch.from_numpy(vbits.reshape(-1)).to(dev))

    # K1: one 2^22-byte chunk, reads of 150 bases with N, lowercase and '~'
    chunk = random_ascii(rng, 1 << 22, b"ACGTacgtN~",
                         [0.24, 0.24, 0.24, 0.24, 0.005, 0.005, 0.005, 0.005, 0.005, 0.005])
    chunk[150::151] = ord("\n")
    packed, vbits = upload(*codec.pack_ascii_chunk(chunk))
    kern = torch.zeros(SPACE, dtype=torch.int32, device=dev)
    plain = torch.zeros(SPACE, dtype=torch.int32, device=dev)
    count13_packed(kern, packed, vbits)
    count13_packed_plain(plain, packed, vbits)
    err = max_abs_err(kern.view(torch.uint32), plain.view(torch.uint32))
    scratch = torch.zeros(SPACE, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: count13_packed(scratch, packed, vbits), 50)
    pms = cuda_ms(lambda: count13_packed_plain(scratch, packed, vbits), 5)
    report("count13_packed", "chunk 2^22 B", err, ms, pms)
    res["count13_packed"] = (err, ms, pms)
    del kern, plain, scratch

    # K2: a random full table, wrapping adds included
    tf = torch.randint(-2 ** 31, 2 ** 31, (SPACE,), dtype=torch.int32, device=dev,
                       generator=gen).view(torch.uint32)
    err = max_abs_err(total13(tf), total13_plain(tf))
    ms = cuda_ms(lambda: total13(tf), 20)
    pms = cuda_ms(lambda: total13_plain(tf), 3)
    report("total13", "4^13 table", err, ms, pms)
    res["total13"] = (err, ms, pms)

    # K3: every mode on u8/u16/u32 tables; 4 x 2^24 codes over the whole
    # uint32 range with the edge codes first, 2^20 ASCII rows
    n_codes = 4 << 24
    codes = torch.randint(-2 ** 31, 2 ** 31, (n_codes,), dtype=torch.int32, device=dev,
                          generator=gen)
    codes[n_codes // 2:] &= SPACE - 1           # half in range
    edges = torch.tensor([SPACE - 1, SPACE, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                         dtype=torch.int64).to(torch.int32)
    codes[:edges.numel()] = edges.to(dev)
    valid = torch.rand(n_codes, device=dev, generator=gen) < 0.9
    valid[:edges.numel()] = True
    rows = torch.from_numpy(random_ascii(
        rng, (1 << 20) * K, b"ACGTacgtN\n~",
        [0.245, 0.245, 0.245, 0.245, 0.004, 0.004, 0.004, 0.004, 0.002, 0.001, 0.001]
    ).reshape(-1, K)).to(dev)
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
                report("gather13", tag, err, ms, pms)
                k3.append((tag, err, ms, pms))
        del table
    head = next(r for r in k3 if r[0].startswith("u8 codes+mask,"))
    res["gather13"] = (max(r[1] for r in k3), head[2], head[3])
    del codes, valid, rows

    # K4: 10,000 rows x stride 151 (150 bp reads), cutoff 0 and 10
    n_rows, stride = 10_000, READ_LEN + 1
    mat = random_ascii(rng, n_rows * stride, b"ACGTN",
                       [0.2475, 0.2475, 0.2475, 0.2475, 0.01]).reshape(n_rows, stride)
    mat[:, -1] = ord("\n")
    packed, vbits = upload(*codec.pack_ascii_chunk(mat.reshape(-1)))
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
            tag = f"u{bits} cutoff {cutoff}, 10000 x 151"
            report("coverage13_packed", tag, err, ms, pms)
            k4.append((tag, err, ms, pms))
    head = k4[0]
    res["coverage13_packed"] = (max(r[1] for r in k4), head[2], head[3])
    return res


# -- phase 3: the main path end to end ----------------------------------------

def main_path(dev, card: str, tmp: str) -> None:
    import torch
    from aindex_torch import Dense13Index
    from aindex_torch.io.fastq import iter_sequence_bytes

    t0 = time.perf_counter()
    genome, reads = scale_corpus(25.0, 1)
    fasta = os.path.join(tmp, "ecoli_25x.fasta")
    write_fasta(reads, fasta)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = oracle_table(reads)
    t_oracle = time.perf_counter() - t0
    n_bases = reads.size
    print(f"corpus: {len(reads)} reads, {n_bases / 1e6:.1f} MB of bases, "
          f"{os.path.getsize(fasta) / 1e6:.1f} MB FASTA ({t_gen:.1f} s); "
          f"oracle table {t_oracle:.1f} s")

    # count, as `aindex-tpu count -k 13` does
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    built = Dense13Index.build_from_stream(iter_sequence_bytes(fasta), device=dev)
    t_build = time.perf_counter() - t0
    tf_path = os.path.join(tmp, "ecoli_25x.tf.bin")
    built.save(tf_path)
    s = built.stats()
    print(f"build_from_stream: {t_build:.3f} s, {n_bases / t_build / 1e6:.2f} MB/s "
          f"of bases, FASTA parse included ({card})")
    check(np.array_equal(built.tf_host, table), "built table == oracle table")
    check(s["non_zero_kmers"] == int(np.count_nonzero(table))
          and s["total_count"] == len(reads) * (READ_LEN - K + 1)
          and s["max_frequency"] == int(table.max()), f"stats {s}")
    print(f"stats: {s}")
    del built

    index = Dense13Index.load(tf_path, device=dev)
    check(np.array_equal(index.tf.view(torch.int32).cpu().numpy().view(np.uint32), table),
          "loaded device table == oracle table")
    rc_all = oracle_rc(np.arange(SPACE, dtype=np.uint32))
    total = table + table[rc_all]

    # ASCII queries: 2^20 k-mers sampled from the reads, 1/16 of them
    # random (mostly absent) and 1/64 with an N
    rng = np.random.default_rng(11)
    n_q = 1 << 20
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
        print(f"{name}: {n_q} ASCII k-mers, {n_q / dt / 1e6:.2f} M queries/s "
              f"(host clock, encode and copies included) ({card})")

    # codes-in total on 4 x 2^24 device codes
    gen = torch.Generator(device=dev).manual_seed(13)
    codes = torch.randint(0, SPACE, (4 << 24,), dtype=torch.int32, device=dev, generator=gen)
    got = index.get_total_tf_values_codes(codes)
    check(np.array_equal(got.view(torch.int32).cpu().numpy().view(np.uint32),
                         total[codes.cpu().numpy()]), "get_total_tf_values_codes")
    ms = cuda_ms(lambda: index.get_total_tf_values_codes(codes), 20)
    print(f"get_total_tf_values_codes: {codes.numel()} device codes, "
          f"{codes.numel() / ms / 1e6:.2f} G queries/s ({ms:.4f} ms, CUDA events; "
          f"table {index.tf_total.dtype}) ({card})")

    # coverage of 10,000 reads, cutoff 0 and 10; one 100 kbp sequence
    n_seq = 10_000
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
        print(f"sequence_coverage_batch cutoff {cutoff}: {n_seq} x {READ_LEN} bp, "
              f"{n_seq / dt:.0f} sequences/s (host clock) ({card})")
    seq = genome[:100_000]
    cov = index.sequence_coverage(seq.tobytes().decode("ascii"))
    gcode, gok = oracle_codes(seq[None, :])
    check(np.array_equal(cov, np.where(gok, table[gcode], 0)[0]), "sequence_coverage")
    check(index.sequence_coverage("ACGT").size == 0, "short sequence coverage")


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
    t_build = _cuda.build_all()
    print(f"kernels built in {t_build:.1f} s")
    for k in _cuda.KERNELS.values():
        regs = sorted({int(line.split("Used ")[1].split()[0])
                       for line in k.build_log.splitlines() if "registers" in line})
        spills = sum("0 bytes spill stores" not in line
                     for line in k.build_log.splitlines() if "spill stores" in line)
        print(f"  {k.name}: registers per thread {regs}, instantiations with spills {spills}")

    t0 = time.perf_counter()
    measured = kernels_vs_plain(dev, card)
    print(f"phase kernels-vs-plain: {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _cuda.reset_launches()
        main_path(dev, card, tmp)
        counts = _cuda.launches()
        print(f"phase main path: {time.perf_counter() - t0:.1f} s")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} launched on the main path")

    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda",
         "source": "aindex_torch/csrc/" + os.path.basename(k.source),
         "replaces": k.replaces, "launches": counts[k.name],
         "max_abs_err": measured[k.name][0], "ms": measured[k.name][1],
         "plain_ms": measured[k.name][2]}
        for k in _cuda.KERNELS.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
