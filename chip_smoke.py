#!/usr/bin/env python3
"""Smoke run of aindex_torch's main paths on one CUDA card: the dense
13-mer index, the sparse canonical 23-mer index, the positional index
built by the compute-aindex pipeline, and the AIndex facade over the CLI's
k = 31 and k = 29 artifact sets (the MPHF walk and the wide cuckoo
engines) and over the reference-built golden sets.

Run from the repository root, with no arguments:

    python3 chip_smoke.py [parent=DIR]

``parent=DIR`` names a checkout of an earlier commit (``git archive`` of it
unpacked into ``dist/parent``): its K1, K2, K4, K15, K16, K6, K7 (both
entries), K10 and K11's coverage and K5's canonical23_ascii
(``count13.cu``, ``total13.cu``, ``coverage13.cu``, ``quot23.cu``,
``quotcov23.cu``, ``cuckoo64.cu``, ``mphfwalk.cu``, ``spectrum23.cu``) are
then built and timed beside this tree's (K6 and K10 on the layout that
checkout uploads; each coverage entry and canonical23_ascii through this
tree's wrapper) in steps 2, 4, 7, 9 and 13.

1. Checks for a card, prints its name and power limit (nvidia-smi) and
   builds the sixteen CUDA kernels (K1-K16, twenty-eight C entries) from
   aindex_torch/csrc, one nvcc per source, all started together; then
   times 2^26 random reads of 16, 32, 64 and 128 bytes from a 512 MiB
   buffer (scripts/randread.cu), the cost that sets K6's and K10's bucket
   width, 2^26 random 16-byte reads over footprints of 8 to 512 MiB
   (``footprint_test``: what K3's table size costs against the 50 MB L2),
   and 4-byte adds (REDs) at hashed entries of the 4^13 table in
   random, bin and sorted order and of a 2^22-entry table (``rmw_test``),
   K16's floors.
2. Holds K1-K4 (the dense kernels) against their plain PyTorch versions on
   the card, at the shapes the dense path gives them, with exact equality
   (all outputs are integers), and times both with CUDA events: K1 alone
   on one 2^22-byte chunk, and on chunks of 1, 15, 16 and 17 words, an
   empty one and a skewed one (90% poly-A: bin 0 split) alone and through
   one PackedCounter, from a table near 2^32; K2 and its half mode on a
   random table whose adds wrap; with ``parent=DIR``, the parent's K1 and
   K2 in turns; K3 on full and half tables of every width, and also on
   4 x 2^24 codes all in range (the dense path's own traffic) beside
   ``torch.take``, and in the two u8 total tables of one count table (full
   and half, equal answers) in turns, with ``parent=DIR`` the half beside
   the parent's K3 on the full table; and all four K3 entries at edge
   shapes (0-9 and 2^20 + 3 codes, offsets 0-3, masks at another offset,
   every width, tables of 1 entry to 4^13 and the half total table); K4 at
   u8, u16 and u32 on 10,000 x 151
   random rows timed four ways (``clocks``: warm and cold CUDA events,
   the cold ones over 8 distinct batches, torch.profiler device time a
   launch, the host clock a call) beside the parent's and its random-read
   floor, and exactly at the edge shapes of the tiled coverage kernels
   (``coverage_edges``: a 2^20-base row, one window a row, windows ending
   mid-tile, rows wider than a tile, all N, packed filled to its last
   word, unaligned buffers) at cutoffs 0, 10 and 2^32 - 1.
3. Generates the corpus once: scripts/make_scale_corpus.py's (seed 1, 25x:
   773,608 reads of 150 bp over a 4.64 Mbp genome, 0.3% substitutions), as
   a FASTA file and a read matrix that the numpy oracles read.
4. Drives the dense path at E. coli scale, as ``aindex-tpu count -k 13``
   does (iter_sequence_bytes -> build_from_stream -> save -> stats), then
   loads the table back and makes the query and coverage calls that AIndex
   makes for k = 13, each checked against a numpy oracle; the codes-in
   total calls must launch ``gather13_half`` once each and nothing else,
   from the 2^25-entry half table the index holds, and ``tf_total``, built
   on request, must equal the oracle's totals. Then holds K1 at
   the build's shape (the corpus's 28 packed chunks through one
   PackedCounter, and with a sixth of its windows a piece, several counts
   a build) to the plain version's sum over the same chunks, timed by CUDA
   events and by device busy time, with ``parent=DIR`` beside the parent's
   28 launches in turns; and K2 on the corpus table. Splits one dense
   coverage call of 10,000 corpus reads into its host and device stages
   (``coverage_stages``), with this tree's and the parent's K4.
5. Holds K5 (the chunk spectrum) against its plain version on a 2^22-byte
   chunk of the corpus and on a chunk with N runs and newlines, beside
   ``torch.unique``; then K5's keys mode and K13 against theirs at the
   shapes where the onesweep sort's tiles and look-back could break (one
   live key, all equal, none live, one tile of live keys and one tile +-
   1, a cap that is no multiple of the tile, 64-bit keys, 4 x 2^24 keys,
   weight sums past 2^32 and 2^64).
6. Drives the sparse path: ``Sparse23Index.build_from_stream`` over the
   FASTA file (stage times and the device's idle share of the build), then
   every query family, coverage, De Bruijn CONT and a save/load round
   trip, each checked against an independent numpy oracle (canonical
   windows of the read matrix + np.unique).
7. Holds K6 (quotient cuckoo queries, every mode, the forward-else-
   reverse-complement rule of reference-keyed indexes included) and K7
   (coverage) against their plain versions on the index built in step 6;
   prints the probes' mix on K6's batch (the share of present keys that
   JAX's second row answers, the buckets a query reads) and the device
   bytes of the bucketed records beside JAX's layout (at most 1.5x);
   holds K6 on the keys where the buckets could differ from JAX's rows
   (overflow levels, marked buckets, the first and last bucket, absent
   keys in a present key's bucket, codes above 2k bits, 0xFFFFFFFF_00000000,
   0, 2^62 - 1, 2^64 - 1) to its plain version and to the host table's own
   probe under every rule; with ``parent=DIR``, that checkout's K6 on its
   own layout, equal answers, each timed twice in turns; K7 timed four
   ways (``clocks``, 8 batches of 10,000 corpus reads) beside the
   parent's, held exactly at the edge shapes under both rules (with the
   probes that read a second bucket level counted), and one quotient
   coverage call split into its stages.
8. Drives the unpacked (ASCII-in and codes-in) functions on the corpus at
   full size: ``count_batch_13`` (and ``dense13._count_step``) over the read
   matrix in 28 row batches of ~2^22 bytes, equal to the oracle table;
   ``chunk_spectrum`` on the corpus blob's 28 ASCII chunks, each equal to K5
   on the same chunk packed, merged equal to the 9,602,528-key oracle, with
   ``sparse23._extract_canonical`` on the first; ``quot_tf_windows`` on
   10,000 reads, equal to K7 and the oracle; ``gather_tf`` and
   ``gather_tf_total_13`` on 4 x 2^24 codes, equal to K3 and to K3 on K2's
   total table; ``scatter_count`` of every 13-mer window of the corpus,
   equal to the oracle table.
9. Holds K15 (scatter_count), K16 (count13_rows), K3's table-length
   entries, K5's ASCII entries and K7's ASCII-rows entry against their
   plain versions at the shapes of step 8, beside ``torch.bincount``,
   ``torch.take`` and ``torch.unique`` where one call computes the same,
   and again on edge codes over the whole uint32 range, small tables,
   k = 16 codes that wrap, and a chunk with N runs, lowercase and every
   byte value; K15 also on the corpus codes skewed (90% of them 0 at
   weight 255, timed) and on codes at every bin edge of spaces 2^15 - 1,
   2^15, 2^15 + 1, 2^18 + 1, 4^13 and 2^26 + 1; with ``parent=DIR``, that
   checkout's K15 on the corpus codes, equal, each timed twice in turns.
   K16 also from a table near 2^32, beside its add floors, and exactly at
   the shapes where its routes and source could break (poly-A rows past
   2^18 windows, rows of exactly k bytes, views 1-15 bytes past
   alignment, spaces below and not a multiple of the bin width, k = 16
   codes that wrap on each route, more than 2^27 windows);
   with ``parent=DIR``, the parent's K16 on 8 row batches, equal tables,
   then both timed four ways in turns (``clocks``).
   Then the two kernels of the staged ASCII front end (csrc/dna23.cuh
   ``AsciiSource``), exactly at its edge shapes (``ascii_edges``: rows of
   k and k + 1 bytes, 64 rows of 30, one row of 2^16 + 5, all N,
   lowercase and N mixed, a last tile ending mid-run, a [4096, 1024] view
   3 bytes past alignment; canonical23_ascii at k = 11, 23 and 31,
   quotcov23_rows at k = 23 and on a corpus chunk as one row), each timed
   four ways (``clocks``): quotcov23_rows on 8 batches of 10,000 reads
   beside K7 and the random-read floor, canonical23_ascii on 8 corpus
   chunks beside its byte bound, with ``parent=DIR`` beside the parent's.
10. Holds K8 (CSR offsets) against its plain version on the dense 4^13 table
   and the sparse index's tf, beside ``torch.cumsum``, and K9 (the
   positional fill of one chunk) on a 2^22-byte corpus chunk of each kind
   from a nonzero cursor, beside ``torch.sort(stable=True)`` of its keys;
   then K8, K9's chunk entry (dense and quotient) and its pairs-in entry
   exactly against their plain versions at the shapes where the one-pass
   scan, the onesweep sort's tiles and the fill's run heads and cursors
   could break (K8 at n = 0, 1, tile +- 1 and 4 x 2^24 values 2^32 - 1;
   no valid window, one slot's run over five tiles, tile +- 1 valid
   windows, a cursor that wraps, cells past the end, 64-bit keys, 4 x
   2^24 records).
11. Drives the positional path: ``pipeline.build_all`` on the corpus FASTA
   for k = 13 and k = 23 under the profiler (stage seconds, MB/s of bases,
   the device's idle share of the fill), then checks the artifacts against
   the numpy oracle: offsets, every position, ``positions_by_slots`` on
   2^16 slots and ``rid_by_pos``. Fails unless K9's launches there ran at
   the chunk shape step 10 checks. Then (``examples_path``) runs the
   port's examples on the card: each examples/torch_*.py ``main()`` in
   this process, its output held to the strings tests/test_examples.py
   asserts and its own asserts, and examples/torch_pipeline_cli.sh as a
   subprocess; and loads the two artifact sets with ``AIndex.
   load_from_prefix(..., load_reads=True)`` for the facade families the
   examples reach, each against the numpy oracles at the corpus's size:
   ``iter_kmers_by_frequency`` (1,000,000 k-mers; at k = 13 in aindex_tpu's
   order), ``get_top_kmers``, the statistics and ``set_stats``,
   ``save_values`` (k = 23), ``get_rid2poses``, ``get_reads_by_kmer``,
   ``iter_reads``, ``get_kmer_info_by_kid`` (k = 23) on 4096 probes,
   ``get_tf_both_directions_13mer_batch`` on 2^20 13-mers and
   ``get_total_tf_values_codes_13mer`` on the same codes on the card,
   each timed by the host clock.
12. Drives the facade path for k = 31 and then k = 29: ``python -m
   aindex_torch compute-aindex -k <k>`` on the corpus FASTA as a
   subprocess (stage seconds and MB/s from its torch.profiler trace, its
   launch counts printed by the subprocess), then
   ``AIndex.load_from_prefix(..., kmer_size=k, load_reads=True)`` and tf,
   pfid, strand, codes-in, coverage, De Bruijn CONT and positions-by-slot
   queries through the facade, each against a numpy oracle of the corpus.
   Fails unless K11 (k = 31) or K10 (k = 29) launched on the path, with
   no K6, K7 or K9 launch.
13. Holds the configuration's engine kernels (K11 after k = 31, K10 after
   k = 29: query, coverage and fill) against their plain versions at the
   path's shapes, and the fill at step 10's edge shapes; the coverage
   entry also as step 7 holds and times K7; K11's query also
   on keys whose walk ends at an unassigned node, the key in slot 0, 0 and
   2^62 - 1, under the KEYS and CANON rules; K10 as step 7 holds K6 (the
   mix, the device bytes, the edge keys, the parent's K10).
14. Loads the reference-built tests/golden_ref sets through
   ``AIndex.load_from_prefix``: p.23 against p.23.dat and the positions
   of p.reads, p.13 (re-keyed by its emphf .pf) against counts of p.reads.
15. Drives the mesh path at world size 1 on NCCL (the chip host has one
   card; NCCL takes one rank a card): ``init_process_group("nccl")``,
   ``make_mesh(1, 1)``, ``build_all(BuildConfig(mesh=...))`` on the corpus
   FASTA for k = 13 and k = 23, every artifact's SHA-256 against step 11's
   single-device build, the k = 23 positional stage again through the
   allgather exchange (the same bytes), then ``AIndex.shard_to(mesh)`` and
   codes-in (4 x 2^24), ASCII tf, pfids, hash values and strands (2^20),
   coverage (10,000 reads) and next/prev (2^16) against the single-device
   engine's answers.
16. Holds K12 (the walk over a shard's node records), K13, K14 and K9's
   pairs-in entry against their plain versions at 1, 2, 4 and 8 simulated
   shards on the card (each shard called with its own slice; the
   collectives stood in for by sums and concatenations): K12 on 4 x 2^24
   codes, summed over the shards, also against K11's single-device walk; K13 on the concatenated K5 spectra of
   8 corpus chunks, per key range, also against ``merge_spectra``; K14 per
   source on corpus chunks (with a forced small cap that overflows, the
   dense k = 13 windows, chunks of one tile of its pass +- 1 windows and
   255 destinations, and the MPHF walk under FWD_RC) and the pairs-in fill
   per destination, at one shard also against K9's fill of the same chunk.
   Each is timed at the world-of-one path's shape.
17. Prints K3's four entries (the half-table entry beside the full u8
   table's earlier time), K11's three, the rows built on
   csrc/onesweep.cuh (K5, its ASCII entry, K13; K8, K9's two entries, the
   K10 fill), K14, K15, K6, K7's two entries, K10's query and coverage,
   K12, K1 (a build) and K2's two entries beside their earlier times, with
   their launches a call (the half-table entry's through a dense index's
   total query), from a torch.profiler trace of twenty calls in a fresh process
   (``chip_smoke.py --launches``); then
   the kernels line (launch counts of steps 4, 6, 8, 11, 12 and 15, each
   path run with the counts set to 0 just before it), the card line and
   the result line.

Exits nonzero, with no result line, when CUDA is not available or any
check fails. Imports nothing of JAX or aindex_tpu.
"""

import contextlib
import ctypes
import functools
import hashlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

GENOME_BP = 4_641_652     # scripts/make_scale_corpus.py: E. coli K-12 MG1655
READ_LEN = 150
ERR = 0.003
K = 13
SPACE = 4 ** K
HALF = SPACE // 2         # entries of a half total table
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

DENSE_KERNELS = ("count13_packed", "total13", "total13_half", "gather13", "gather13_half",
                 "coverage13_packed")
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


def oracle_rolled(mat: np.ndarray, k: int, t, want_rc: bool = True) -> list:
    """[forward code, reverse-complement code (``want_rc``), valid] of the
    k-mer windows of each row of an ASCII matrix, [rows, width - k + 1],
    in the unsigned type ``t``, rolled one column at a time: a window's
    forward code is the previous one's shifted up a base with the new base
    in field 0 (base i of a window in field k - 1 - i), its reverse
    complement the previous one's shifted down with the new base
    complemented in field k - 1 (base i in field i), and it is valid when
    no non-ACGT byte fell in its last k columns (its bases read as & 3)."""
    b = np.ascontiguousarray(_LUT[mat].T, dtype=t)      # [width, rows]
    width, rows = b.shape
    n_win = width - k + 1
    fwd = np.empty((n_win, rows), t)
    rc = np.empty((n_win, rows), t)
    bad = np.empty((n_win, rows), bool)
    f = np.zeros(rows, t)
    r = np.zeros(rows, t)
    last_bad = np.full(rows, -1, np.int64)
    mask, top, two, three = t((1 << (2 * k)) - 1), t(2 * (k - 1)), t(2), t(3)
    for j in range(width):
        base = b[j] & three
        f = ((f << two) | base) & mask
        if want_rc:
            r = (r >> two) | ((three - base) << top)
        last_bad[b[j] > three] = j
        s = j - k + 1
        if s >= 0:
            fwd[s] = f
            rc[s] = r
            bad[s] = last_bad >= s
    out = [fwd] + ([rc] if want_rc else []) + [~bad]
    return [np.ascontiguousarray(a.T) for a in out]


def oracle_codes(mat: np.ndarray):
    """(code, valid) of the 13-mer windows of each row of an ASCII matrix."""
    return tuple(oracle_rolled(mat, K, np.uint32, want_rc=False))


def oracle_rc(code: np.ndarray, k: int = K) -> np.ndarray:
    """Reverse complement of k-mer codes (uint32 or uint64; 13-mers unless
    asked), field by field."""
    t = code.dtype.type
    out = np.zeros_like(code)
    for j in range(k):
        out = (out << t(2)) | (t(3) - ((code >> t(2 * j)) & t(3)))
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


def oracle_windows23(mat: np.ndarray, k: int = K23):
    """(forward code, reverse-complement code, valid) of the k-mer windows
    (k <= 31; 23 unless asked) of each row of an ASCII matrix, uint64."""
    return tuple(oracle_rolled(mat, k, np.uint64))


def oracle_spectrum23(reads: np.ndarray, k: int = K23):
    """(sorted unique canonical k-mer codes, counts) of every valid window."""
    parts = []
    for i in range(0, len(reads), 1 << 16):
        fwd, rc, ok = oracle_windows23(reads[i:i + (1 << 16)], k)
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


#: the entries on the tiled front end (csrc/dna23.cuh tile_run), whose
#: kernels must keep their windows and buckets in registers
TILED = ("quotcov23", "quotcov23_rows", "cuckoocov64", "mphfcov", "canonical23_ascii")


def stack_frames(log: str) -> dict[str, int]:
    """Stack frame bytes of each function of an ``nvcc -Xptxas=-v`` log,
    by mangled name."""
    out, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[1].strip()
        elif name is not None and "bytes stack frame" in line:
            out[name] = int(line.split("bytes stack frame")[0].split()[-1])
            name = None
    return out


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


#: earlier chip_smoke times (ms) on NVIDIA H100 80GB HBM3, 700.00 W, as
#: PERF.md section 6 records them from the calls before the bucketed K6 and
#: K10: K3's and K11's three entries, the rows on the onesweep sort and the
#: positional build's fill and scan (K5, its ASCII entry, K13, K8, K9's two
#: entries, the K10 fill), and the rows on the quotient and wide tables'
#: two-row probes (K6, K7's ASCII-rows entry, K10's query); K12's,
#: the sum of its two entries (owner, verify) before the walk; K14's
#: and K15's before their partition and look-back designs; K1's, a build's
#: 28 corpus chunks at one launch a chunk (28 x 0.2284), and K2's, before
#: the count of a build's chunks and the tile pairs; the four packed
#: coverage entries' (K4, K7, K10's and K11's) from PR 14's final call
#: (K11's from PR 11's), before the bucket match kept in registers and the
#: tiled front end; K7's ASCII-rows entry and K5's canonical23_ascii as
#: PERF.md section 6 recorded them before the staged ASCII front end; K16's
#: before its sweep; the half-table entries of K3 and K2 beside the full
#: table's entries (K3's u8 table on the same codes, K2's whole table)
EARLIER_MS = {"gather13_half": 0.9181, "total13_half": 0.1924, "gather13": 0.9176, "gather13_table": 1.2516, "gather13_total": 2.9021,
              "mphfwalk": 2.5804, "mphfcov": 0.0531, "mphffill": 0.5682,
              "spectrum23": 0.4126, "spectrum23_ascii": 0.5283, "spectrummerge": 0.4433,
              "csr_offsets": 0.3750, "posfill": 0.7124, "cuckoofill64": 0.5099,
              "posbucket": 0.2792, "posfill_pairs": 0.5888, "quot23": 3.4678,
              "quotcov23": 0.0751, "quotcov23_rows": 0.0622, "canonical23_ascii": 0.1254, "cuckoo64": 3.6817,
              "cuckoocov64": 0.0724, "coverage13_packed": 0.0310, "shardwalk": 5.3189, "scatter_count": 6.9395,
              "count13_packed": 6.3952, "total13": 2.2774, "count13_rows": 0.2486}


#: times beside the kernels line's rows, printed with the summary: K15 and
#: K14 in turns with the parent's, K15 on a skewed input; label -> {tree:
#: [ms, ...]}
SIDE_MS: dict[str, dict] = {}


def launches_per_call(fn, calls: int = 20) -> float:
    """Device operations (kernels and memsets) a call of ``fn``: those of a
    torch.profiler trace of ``calls`` calls, over ``calls`` (a trace of one
    short call can come back short of its events)."""
    import torch
    from torch import profiler
    fn()
    torch.cuda.synchronize()
    with profiler.profile(activities=[profiler.ProfilerActivity.CPU,
                                      profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()) / calls


def coverage1_chunk() -> np.ndarray:
    """The first 2^22 bytes of a coverage-1 corpus of make_scale_corpus.py's
    genome, one read and a newline a line."""
    _, reads = scale_corpus(1.0, 1)
    n_rows = CHUNK_BYTES // (READ_LEN + 1) + 1
    return np.hstack([reads[:n_rows], np.full((n_rows, 1), ord("\n"), np.uint8)]
                     ).ravel()[:CHUNK_BYTES]


def onesweep_calls(dev) -> dict:
    """The onesweep rows at their paths' shapes, on one 2^22-byte chunk of
    a coverage-1 corpus: name -> (kernel call, plain call). K13 merges the
    chunk's spectrum over the whole key range, as the world-of-one mesh
    path does."""
    import torch
    from aindex_torch.core import codec
    from aindex_torch.kernels.spectrum import (chunk_spectrum, chunk_spectrum_plain,
                                               sorted_spectrum_weighted,
                                               sorted_spectrum_weighted_plain, spectrum23,
                                               spectrum23_plain)
    chunk = coverage1_chunk()
    packed, vbits = upload(dev, *codec.pack_ascii_chunk(chunk))
    ascii_chunk = torch.from_numpy(chunk).to(dev)
    keys, counts, _ = spectrum23_plain(packed, vbits, K23)
    counts = counts.view(torch.int32)
    hi = 4 ** K23
    return {
        "spectrum23": (lambda: spectrum23(packed, vbits, K23),
                       lambda: spectrum23_plain(packed, vbits, K23)),
        "spectrum23_ascii": (lambda: chunk_spectrum(ascii_chunk, K23),
                             lambda: chunk_spectrum_plain(ascii_chunk, K23)),
        "spectrummerge": (lambda: sorted_spectrum_weighted(keys, counts, 0, hi),
                          lambda: sorted_spectrum_weighted_plain(keys, counts, 0, hi)),
    }


def fill_state(dev, live, n_slots: int, seed: int):
    """(cursor int32[n_slots], offsets int64[n_slots], total) for a fill of
    the live slots ``live`` from a seeded cursor in 0..3: each slot has room
    for its cursor and its windows, so no two writes meet."""
    import torch
    from aindex_torch.kernels.positional import csr_offsets_plain
    gen = torch.Generator(device=dev).manual_seed(seed)
    cursor = torch.randint(0, 4, (n_slots,), dtype=torch.int32, device=dev, generator=gen)
    tf = torch.bincount(live, minlength=n_slots).to(torch.int32) + cursor
    offsets = csr_offsets_plain(tf)
    return cursor, offsets[:-1].contiguous(), int(offsets[-1])


def fill_pair(dev, fill, plain, cursor, offsets, total):
    """(kernel call, plain call) of a fill from ``cursor``: each call runs
    on its own work buffers, which carry the cursor on from call to call
    (the work a call does stays the same), and returns them."""
    import torch
    works = [(torch.zeros(total, dtype=torch.int64, device=dev), cursor.clone())
             for _ in range(2)]

    def call(f, w):
        def run():
            f(*w, offsets)
            return w
        return run
    return call(fill, works[0]), call(plain, works[1])


def fill_calls(dev) -> dict:
    """The rows on the positional build's fill and scan at their paths'
    shapes, on the chunk of ``onesweep_calls``: K8 on its 4^13 dense counts,
    K9 on the chunk (k = 13) from a seeded cursor, its pairs-in entry on
    the chunk's k = 31 windows as one source's slot ids, and the K10 and
    K11 fills on the chunk over engines built from the chunk itself (k =
    29 and 31: the wide cuckoo table and the MPHF walk): name -> (kernel
    call, plain call), each fill call on work buffers of its own."""
    import torch
    from aindex_torch import Sparse23Index
    from aindex_torch.core import codec
    from aindex_torch.kernels.positional import (chunk_slots_plain, csr_offsets,
                                                 csr_offsets_plain, fill_scratch, posfill,
                                                 posfill_pairs, posfill_pairs_plain,
                                                 scatter_chunk_plain)
    chunk = coverage1_chunk()
    packed, vbits = upload(dev, *codec.pack_ascii_chunk(chunk))
    tf = torch.bincount(chunk_slots_plain(packed, vbits, K)[0], minlength=SPACE)
    tf = tf.to(torch.int32).view(torch.uint32)
    calls = {"csr_offsets": (lambda: (csr_offsets(tf),), lambda: (csr_offsets_plain(tf),))}

    def chunk_fill(name, k, tables, rule, n_slots, seed):
        slots, valid = chunk_slots_plain(packed, vbits, k, tables, rule)
        cursor, offsets, total = fill_state(dev, slots[valid], n_slots, seed)
        scratch = fill_scratch(16 * packed.numel() - k + 1, n_slots, dev)
        pos = torch.arange(slots.numel(), device=dev) + CHUNK_BYTES
        calls[name] = fill_pair(
            dev, lambda p, c, o: posfill(p, c, o, packed, vbits, k, CHUNK_BYTES, tables,
                                         scratch, rule),
            lambda p, c, o: scatter_chunk_plain(p, c, o, slots, pos, valid),
            cursor, offsets, total)

    chunk_fill("posfill", K, None, 1, SPACE, 91)
    for k in (29, 31):
        index = Sparse23Index.build_from_blob(chunk, k=k, device=dev)
        chunk_fill(index.tables.FILL, k, index.tables, index.rule, index.n, 92 + k)
        if k == 31:
            rec = chunk_slots_plain(packed, vbits, k, index.tables, index.rule)[0][None]
            roff = torch.tensor([CHUNK_BYTES], device=dev)
            cursor, offsets, total = fill_state(dev, rec[rec >= 0], index.n, 97)
            scratch = fill_scratch(rec.numel(), index.n, dev)
            calls["posfill_pairs"] = fill_pair(
                dev, lambda p, c, o: posfill_pairs(p, c, o, rec, roff, 0, False, scratch),
                lambda p, c, o: posfill_pairs_plain(p, c, o, rec, roff, 0, False),
                cursor, offsets, total)
    check(set(calls) == {"csr_offsets", "posfill", "cuckoofill64", "mphffill",
                         "posfill_pairs"}, f"fill rows {sorted(calls)} at k = 29 and 31")
    return calls


def lookup_calls(dev) -> dict:
    """K3's four entries, K11's query and coverage and K12: name ->
    (kernel call, plain call), K3 on 2^22 codes over the whole uint32
    range (a u8 4^13 table; a u32 table for the table-length entries; the
    half table through a dense index's total query, which must launch
    ``gather13_half`` once and nothing else), K11 on 2^22 of the coverage-1
    chunk's k = 31 windows and on 1,000 of its rows, K12 as one shard of
    that index on the same windows."""
    import torch
    from aindex_torch import Dense13Index, Sparse23Index
    from aindex_torch.index.dense13 import _narrow, total13
    from aindex_torch.kernels import _cuda
    from aindex_torch.core import codec
    from aindex_torch.kernels import probe
    from aindex_torch.kernels.encode import packed_window_codes
    from aindex_torch.kernels.lookup import (gather13, gather13_plain, gather_tf,
                                             gather_tf_plain, gather_tf_total_13,
                                             gather_tf_total_13_plain, shard_walk,
                                             shard_walk_plain)
    gen = torch.Generator(device=dev).manual_seed(71)
    u8 = torch.randint(0, 256, (SPACE,), dtype=torch.uint8, device=dev, generator=gen)
    u32 = torch.randint(-2 ** 31, 2 ** 31, (SPACE,), dtype=torch.int32, device=dev,
                        generator=gen).view(torch.uint32)
    codes = torch.randint(-2 ** 31, 2 ** 31, (1 << 22,), dtype=torch.int32, device=dev,
                          generator=gen)
    valid = torch.rand(codes.numel(), device=dev, generator=gen) < 0.9
    dense = Dense13Index(torch.randint(0, 128, (SPACE,), dtype=torch.int32, device=dev,
                                       generator=gen))
    full = _narrow(total13(dense.tf))
    check(dense.tf_total_half.dtype == full.dtype == torch.uint8, "u8 total tables")

    def dense_total():
        before = _cuda.launches()
        got = dense.get_total_tf_values_codes(codes, valid)
        after = _cuda.launches()
        diff = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        check(diff == {"gather13_half": 1}, f"a dense total call launches {diff}")
        return (got,)
    chunk = coverage1_chunk()
    index = Sparse23Index.build_from_blob(chunk, k=31, device=dev)
    t = index.tables
    rows = np.ascontiguousarray(chunk[:1000 * (READ_LEN + 1)].reshape(1000, READ_LEN + 1))
    [(_, stride, packed, vbits)] = codec.coverage_row_batches(
        [row[:READ_LEN].tobytes() for row in rows], 31)
    packed, vbits = upload(dev, packed, vbits)
    cov = (t, packed, vbits, 1000, stride, 31, 0, index.rule)
    keys = packed_window_codes(*upload(dev, *codec.pack_ascii_chunk(chunk)), 31)[0][:1 << 22]
    shard = (t.g_packed, t.records, 0, t.n, t.seed, t.domain, keys)  # one shard: every node
    return {
        "gather13": (lambda: (gather13(u8, codes),), lambda: (gather13_plain(u8, codes),)),
        "gather13_half": (dense_total, lambda: (gather13_plain(full, codes, valid),)),
        "gather13_table": (lambda: (gather_tf(u32, codes),),
                           lambda: (gather_tf_plain(u32, codes),)),
        "gather13_total": (lambda: (gather_tf_total_13(u32, codes, valid),),
                           lambda: (gather_tf_total_13_plain(u32, codes, valid),)),
        "mphfwalk": (lambda: probe.query(t, keys, k=31, rule=index.rule, slot=True),
                     lambda: probe.query_plain(t, keys, k=31, rule=index.rule, slot=True)),
        "mphfcov": (lambda: (probe.coverage(*cov),), lambda: (probe.coverage_plain(*cov),)),
        "shardwalk": (lambda: shard_walk(*shard, k=31, canonical=True),
                      lambda: shard_walk_plain(*shard, k=31, canonical=True)),
    }


def dense_calls(dev) -> dict:
    """K1 alone on the coverage-1 chunk (into a table it adds to: the
    first calls from zeros) and K2's two entries on a random table: name ->
    (kernel call, plain call)."""
    import torch
    from aindex_torch.core import codec
    from aindex_torch.index.dense13 import (total13, total13_half, total13_half_plain,
                                            total13_plain)
    from aindex_torch.kernels.count import count13_packed, count13_packed_plain
    packed, vbits = upload(dev, *codec.pack_ascii_chunk(coverage1_chunk()))
    mine, ref = (torch.zeros(SPACE, dtype=torch.int32, device=dev) for _ in range(2))
    gen = torch.Generator(device=dev).manual_seed(71)
    tf = torch.randint(-2 ** 31, 2 ** 31, (SPACE,), dtype=torch.int32, device=dev,
                       generator=gen).view(torch.uint32)
    return {"count13_packed": (lambda: (count13_packed(mine, packed, vbits).view(torch.uint32),),
                               lambda: (count13_packed_plain(ref, packed, vbits)
                                        .view(torch.uint32),)),
            "total13": (lambda: (total13(tf),), lambda: (total13_plain(tf),)),
            "total13_half": (lambda: (total13_half(tf),), lambda: (total13_half_plain(tf),))}


def count_bucket_calls(dev) -> dict:
    """K15 on 2^24 random 13-mer codes (90% valid) into the 4^13 table, and
    K14 at one shard on the coverage-1 chunk's k = 23 windows over an index
    built from the chunk: name -> (kernel call, plain call)."""
    import torch
    from aindex_torch import Sparse23Index
    from aindex_torch.core import codec
    from aindex_torch.kernels.count import scatter_count, scatter_count_plain
    from aindex_torch.kernels.positional import bucket_scratch, posbucket, posbucket_plain
    from aindex_torch.parallel.positional import bucket_cap
    gen = torch.Generator(device=dev).manual_seed(73)
    codes = torch.randint(0, SPACE, (1 << 24,), dtype=torch.int32, device=dev, generator=gen)
    valid = torch.rand(codes.numel(), device=dev, generator=gen) < 0.9
    chunk = coverage1_chunk()
    packed, vbits = upload(dev, *codec.pack_ascii_chunk(chunk))
    index = Sparse23Index.build_from_blob(chunk, k=K23, device=dev)
    n_win = 16 * packed.numel() - K23 + 1
    args = (packed, vbits, K23, index.tables, index.rule, index.n, index.n, 1,
            bucket_cap(n_win, 1))
    scratch = bucket_scratch(dev)
    return {"scatter_count": (lambda: (scatter_count(codes, valid),),
                              lambda: (scatter_count_plain(codes, valid),)),
            "posbucket": (lambda: posbucket(*args, scratch), lambda: posbucket_plain(*args))}


LAUNCHES_FLAG = "--launches"
#: the rows whose launches a call the fresh process counts
LAUNCH_ROWS = ("gather13", "gather13_table", "gather13_total", "mphfwalk", "mphfcov",
               "shardwalk", "spectrum23", "spectrum23_ascii", "spectrummerge", "csr_offsets", "posfill",
               "posfill_pairs", "cuckoofill64", "mphffill", "scatter_count", "posbucket",
               "count13_packed", "total13", "gather13_half", "total13_half")


def fresh_launches() -> dict[str, float]:
    """Launches a call of LAUNCH_ROWS, traced in a fresh process: traces
    taken late in this one (after the paths' long traces and the NCCL
    group) came back short of device events."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__), LAUNCHES_FLAG],
                         capture_output=True, text=True, timeout=600, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def fresh_launches_main() -> int:
    """The fresh process of fresh_launches: each row's first call checked
    against its plain version's, then twenty calls traced."""
    import torch
    dev = torch.device("cuda", 0)
    launches = {}
    for name, (fn, plain) in {**lookup_calls(dev), **onesweep_calls(dev),
                              **fill_calls(dev), **count_bucket_calls(dev),
                              **dense_calls(dev)}.items():
        max(max_abs_err(a, b) for a, b in zip(fn(), plain()))
        launches[name] = launches_per_call(fn)
    check(set(launches) == set(LAUNCH_ROWS), f"launch rows {sorted(launches)}")
    print(json.dumps(launches))
    return 0


def distinct_probed_rows(index, keys) -> int:
    """Distinct rows of the quotient table's host layout (the index's
    ``QuotCuckoo``: JAX's two halves of (fingerprint, tf) rows) that the
    probes of the canonical ``keys`` read (the second half only for
    first-half misses): a K6 probe's work, whatever layout the device
    reads."""
    import torch
    from aindex_torch.kernels.quot import bij
    qc = index.quot
    mults = [int(x) for x in qc.mults]
    r1 = bij(keys, *mults[:2], qc.w) & (qc.m - 1)
    r2 = bij(keys[~old_first_hit(index, keys)], *mults[2:], qc.w) & (qc.m - 1)
    return int(torch.unique(r1).numel()) + int(torch.unique(r2).numel())


# -- the bucketed tables of K6 and K10 ----------------------------------------

#: the argument that names a checkout of the parent commit, whose K6 and
#: K10 are then timed beside this tree's (``parent=dist/parent``)
PARENT_ARG = "parent="
PARENT: str | None = None
WIDTHS = (16, 32, 64, 128)


@functools.lru_cache(maxsize=1)
def randread_lib():
    """``scripts/randread.cu`` built into build/measure/ and loaded."""
    from aindex_torch.kernels import _cuda
    out_dir = os.path.join(HERE, "build", "measure")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "randread.so")
    subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", lib_path,
                    os.path.join(HERE, "scripts", "randread.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.randread.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_longlong,
                             ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p]
    lib.hashed_indices.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_ulonglong, ctypes.c_void_p]
    lib.randrmw.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    return lib


def width_test(dev, card: str, n_reads: int = 1 << 26, n_bytes: int = 1 << 29) -> dict:
    """Random-read cost by width (``scripts/randread.cu``): ``n_reads``
    reads of 16, 32, 64 and 128 bytes, each as uint4 loads from one aligned
    block at a hashed address of an ``n_bytes`` device buffer, each width
    timed twice in turns. Prints reads/s and 32-byte sectors/s; returns
    width -> mean ms."""
    import torch
    from aindex_torch.kernels import _cuda
    lib = randread_lib()
    gen = torch.Generator(device=dev).manual_seed(3)
    buf = torch.randint(-2 ** 31, 2 ** 31, (n_bytes // 4,), dtype=torch.int32, device=dev,
                        generator=gen)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    st = _cuda.stream(dev)

    def call(width):
        return lambda: check(lib.randread(buf.data_ptr(), n_bytes // width, width, n_reads,
                                          0x5EED, out.data_ptr(), st) == 0, f"randread {width}")
    times = {w: [] for w in WIDTHS}
    for order in (WIDTHS, WIDTHS[::-1]):
        for w in order:
            times[w].append(cuda_ms(call(w), 20))
    torch.cuda.synchronize()
    res = {w: sum(t) / 2 for w, t in times.items()}
    READ_RATE.update({w: n_reads / ms * 1e3 for w, ms in res.items()})
    for w in WIDTHS:
        ms = res[w]
        sectors = n_reads * max(1, w // 32)
        print(f"random reads, {w} B a read ({w // 16} uint4 load(s)), {n_reads} reads over "
              f"{n_bytes >> 20} MiB: {times[w][0]:.4f} / {times[w][1]:.4f} ms, "
              f"{n_reads / ms / 1e6:.3f} G reads/s, {sectors / ms / 1e6:.3f} G sectors/s, "
              f"{ms / res[32]:.3f}x the 32-byte time ({card})")
    del buf
    torch.cuda.empty_cache()
    return res


#: footprints (MiB) of the random-read sweep across the L2's size: the full
#: uint8 total table is 64 MiB, its half 32 MiB
FOOTPRINTS_MIB = (8, 16, 20, 24, 28, 32, 40, 48, 64, 128, 512)


def footprint_test(dev, card: str, n_reads: int = 1 << 26) -> dict:
    """Random-read rate against footprint (``scripts/randread.cu``):
    ``n_reads`` 16-byte reads (one 32-byte sector each, as K3's 1-4-byte
    reads) at hashed blocks of the first FOOTPRINTS_MIB MiB of one buffer,
    each footprint timed twice in turns (ascending, then descending), after
    a warm-up call that fills the L2. Prints G reads/s; returns MiB ->
    reads a second."""
    import torch
    from aindex_torch.kernels import _cuda
    lib = randread_lib()
    gen = torch.Generator(device=dev).manual_seed(5)
    buf = torch.randint(-2 ** 31, 2 ** 31, (max(FOOTPRINTS_MIB) << 18,), dtype=torch.int32,
                        device=dev, generator=gen)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    st = _cuda.stream(dev)

    def call(mib):
        return lambda: check(lib.randread(buf.data_ptr(), mib << 16, 16, n_reads, 0x5EED,
                                          out.data_ptr(), st) == 0, f"randread {mib} MiB")
    times = {f: [] for f in FOOTPRINTS_MIB}
    for order in (FOOTPRINTS_MIB, FOOTPRINTS_MIB[::-1]):
        for f in order:
            times[f].append(cuda_ms(call(f), 20))
    torch.cuda.synchronize()
    rate = {f: n_reads / (sum(t) / 2) * 1e3 for f, t in times.items()}
    for f in FOOTPRINTS_MIB:
        print(f"random reads by footprint, 16 B a read, {n_reads} reads over {f} MiB: "
              f"{times[f][0]:.4f} / {times[f][1]:.4f} ms, {rate[f] / 1e9:.3f} G reads/s, "
              f"{rate[f] / rate[max(FOOTPRINTS_MIB)]:.3f}x the {max(FOOTPRINTS_MIB)} MiB rate "
              f"({card})")
    SIDE_MS["random 16-byte reads by footprint (MiB), 2^26 reads"] = {
        f"{f} MiB": t for f, t in times.items()}
    del buf
    torch.cuda.empty_cache()
    return rate


#: K16's windows on its timed batch (27,962 x 150 corpus rows, k = 13) and
#: a larger n, for rmw_test
RMW_NS = (3_858_756, 1 << 24)
#: table entries (log2): 4^13 (256 MB, 5x L2) and 2^22 (16 MB, in L2)
RMW_TABLES = (26, 22)
#: bin widths (log2 entries) of the bin orders
RMW_BINS = (12, 13, 14, 15)


def rmw_test(dev, card: str) -> dict:
    """Read-modify-write cost by order (``scripts/randread.cu`` randrmw):
    n adds of 1 at hashed entries (``hashed_indices``) of a uint32 table,
    a RED each, in three orders of the same entries: random; grouped by
    bins of 2^b entries in bin order, in random order within a bin (a
    stable sort by bin); sorted. Each n of RMW_NS into the 4^13 table in
    every order, and in random order into the 2^22-entry table; each order
    of a table and n timed twice in turns (CUDA events, 20 calls after a
    warm-up; the index array read too, as a count reads what it adds).
    Prints G adds/s; fills RMW_RATE (adds a second by (log2
    table, n, order)) and returns it."""
    import torch
    from aindex_torch.kernels import _cuda
    lib = randread_lib()
    st = _cuda.stream(dev)
    for lb in RMW_TABLES:
        table = torch.zeros(1 << lb, dtype=torch.int32, device=dev)
        for n in RMW_NS:
            idx = torch.empty(n, dtype=torch.int32, device=dev)
            check(lib.hashed_indices(idx.data_ptr(), n, lb, 0x5EED + n, st) == 0,
                  "hashed_indices")
            orders = {"random": idx}
            if lb == RMW_TABLES[0]:
                for b in RMW_BINS:
                    orders[f"bins of 2^{b}"] = idx[torch.sort(idx >> b, stable=True).indices]
                orders["sorted"] = torch.sort(idx).values
            times = {o: [] for o in orders}
            for names in (list(orders), list(orders)[::-1]):
                for o in names:
                    x = orders[o]
                    times[o].append(cuda_ms(lambda: check(
                        lib.randrmw(table.data_ptr(), x.data_ptr(), n, st) == 0, "randrmw"), 20))
            torch.cuda.synchronize()
            for o, t in times.items():
                ms = sum(t) / 2
                RMW_RATE[(lb, n, o)] = n / ms * 1e3
                print(f"random adds (RED), {o}, {n} adds into 2^{lb} uint32 entries "
                      f"({4 << lb >> 20} MiB): {t[0]:.4f} / {t[1]:.4f} ms, "
                      f"{n / ms / 1e6:.3f} G adds/s, {times['random'][0] / t[0]:.2f}x / "
                      f"{times['random'][1] / t[1]:.2f}x random's rate ({card})")
            del idx, orders
        del table
        torch.cuda.empty_cache()
    return RMW_RATE


def key_of(rec):
    """The keys (int64) of bucketed records (``kernels/buckets.py``), the
    mark bit cleared."""
    import torch
    return (rec[..., 0].to(torch.int64) & 0xFFFFFFFF) | ((rec[..., 1].to(torch.int64)
                                                          & 0x7FFFFFFF) << 32)


def bucket_reads(t, keys):
    """Buckets (int64 per key) that a K6 or K10 probe of ``keys`` reads on
    the bucketed table ``t``: one a level, on while the bucket is marked
    and the key not found."""
    import torch
    from aindex_torch.kernels.buckets import BUCKET, LEVEL_SALT, MARK, bucket_of
    from aindex_torch.kernels.lookup import _s64, _shr, mix64
    if t.w < 64:
        keys = keys & ((1 << t.w) - 1)
    active = (keys >> 62) == 0
    reads = torch.zeros_like(keys)
    buckets = t.records.view(-1, BUCKET, 4)
    h = mix64(keys ^ _s64(t.seed))
    lo, hi = keys & 0xFFFFFFFF, _shr(keys, 32)
    for first, lb in t.levels:
        reads += active.to(torch.int64)
        rec = buckets[first + bucket_of(h, lb)].to(torch.int64)
        found = (((rec[..., 0] & 0xFFFFFFFF) == lo[:, None])
                 & ((rec[..., 1] & 0x7FFFFFFF) == hi[:, None])).any(dim=1)
        active = active & ~found & ((rec[:, 0, 1] & MARK) != 0)
        h = mix64(h ^ LEVEL_SALT)
    return reads


def old_first_hit(index, keys):
    """Whether the first of the two rows JAX's layout reads holds each key
    (the quotient table's first half, or the wide table's), from the
    index's host table."""
    import torch
    from aindex_torch.kernels.lookup import _s64, mix64
    from aindex_torch.kernels.quot import bij
    if index.engine == "quot":
        qc = index.quot
        mults = [int(x) for x in qc.mults]
        fp0 = torch.from_numpy(np.ascontiguousarray(qc.fp_tf_host[:qc.m, 0]).view(np.int32))
        h1 = bij(keys, *mults[:2], qc.w)
        return fp0.to(keys.device)[h1 & (qc.m - 1)].to(torch.int64) == (h1 >> qc.lb)
    ct = index.cuckoo
    rows = torch.from_numpy(np.ascontiguousarray(ct.table_host[:ct.m, :2]).view(np.int64))
    r1 = mix64(keys ^ _s64(ct.seed1)) & (ct.m - 1)
    return rows.reshape(-1).to(keys.device)[r1] == keys


def device_table_bytes(card: str, index) -> int:
    """Prints and returns the bytes of the engine's device records beside
    the host table's (JAX's device layout), and checks them against 1.5x
    those."""
    t = index.tables
    new = t.records.numel() * 4
    old = (index.quot.fp_tf_host.nbytes + index.quot.slot_host.nbytes
           if index.engine == "quot" else index.cuckoo.table_host.nbytes)
    first, lb = t.levels[-1]
    print(f"{index.engine} k={index.k}: {index.n} keys, device records {new / 2 ** 20:.1f} MiB "
          f"({len(t.levels)} levels, buckets {[1 << b for _, b in t.levels]}), JAX's layout "
          f"{old / 2 ** 20:.1f} MiB ({card})")
    check(new <= 1.5 * old, f"device records {new} B within 1.5x JAX's layout ({old} B)")
    return new


def sector_mix(card: str, label: str, index, keys) -> None:
    """The probes' mix on the batch ``keys`` (the keys the engine is asked
    for, after the rule): present share; in JAX's layout the share of
    present keys the second row answers and its sectors a query (a row a
    sector, tf only); in the bucketed layout the buckets a query reads, for
    present and for absent keys."""
    import torch
    t = index.tables
    hit = t.probe_plain(keys)[0]
    first = old_first_hit(index, keys)
    reads = bucket_reads(t, keys).to(torch.float64)
    n, n_hit = keys.numel(), int(hit.sum())
    second = int((hit & ~first).sum())
    old = (n + int((~first).sum())) / n
    print(f"{label}: {n} queries, {n_hit / n:.4f} present; JAX's layout: {second / max(n_hit, 1):.4f} "
          f"of present keys in the second row, {old:.4f} rows a query; buckets: "
          f"{float(reads.mean()):.4f} a query, {float(reads[hit].mean()):.4f} a present key, "
          f"{float(reads[~hit].mean()) if n_hit < n else 0:.4f} an absent one ({card})")


def wide_host_probe(ct, keys: np.ndarray):
    """(found, tf, slot) of uint64 ``keys`` on the wide table's host rows,
    as aindex_tpu/index/cuckoo.py:142 compares whole rows, the first half
    winning."""
    from aindex_torch.index.cuckoo import _mix64_np
    lo, hi = keys & np.uint64(0xFFFFFFFF), keys >> np.uint64(32)
    found = np.zeros(keys.size, bool)
    tf = np.zeros(keys.size, np.uint32)
    slot = np.full(keys.size, -1, np.int32)
    for base, seed in ((ct.m, ct.seed2), (0, ct.seed1)):
        r = (_mix64_np(keys ^ np.uint64(seed)) & np.uint64(ct.m - 1)).astype(np.int64) + base
        row = ct.table_host[r]
        h = (row[:, 0] == lo) & (row[:, 1] == hi)
        found |= h
        tf = np.where(h, row[:, 2], tf)
        slot = np.where(h, row[:, 3].view(np.int32), slot)
    return found, tf, slot


def host_answers(index, codes: np.ndarray, rc: np.ndarray, rule: int):
    """(tf, slot, strand) of uint64 ``codes`` (with their reverse
    complements ``rc``) under ``rule``, from the index's host table's own
    probe."""
    from aindex_torch.kernels import probe
    fn = index.quot.lookup_host if index.engine == "quot" else \
        (lambda x: wide_host_probe(index.cuckoo, x))
    if rule == probe.KEYS:
        hit, tf, slot = fn(codes)
        strand = np.ones(codes.size, np.int32)
    elif rule == probe.CANON:
        fwd = codes <= rc
        hit, tf, slot = fn(np.where(fwd, codes, rc))
        strand = np.where(fwd, 1, 2)
    else:
        h1, tf1, s1 = fn(codes)
        h2, tf2, s2 = fn(rc)
        hit, tf, slot, strand = h1 | h2, np.where(h1, tf1, tf2), np.where(h1, s1, s2), \
            np.where(h1, 1, 2)
    return (np.where(hit, tf, 0).astype(np.uint32), np.where(hit, slot, -1).astype(np.int32),
            np.where(hit, strand, 0).astype(np.int32))


def engine_edges_vs_plain(dev, card: str, index) -> None:
    """K6's or K10's query exactly against its plain version and against
    the host table's own probe, on the keys where the bucketed layout could
    differ from JAX's rows: keys in an overflow level (there must be some),
    keys of marked and of unmarked buckets, of the first and the last
    bucket, absent keys that share a present key's bucket, codes with bits
    above 2k, and 0xFFFFFFFF_00000000 (the key an empty wide row matches),
    0, 2^62 - 1 and 2^64 - 1, under the KEYS, CANON and FWD_RC rules with
    slot (and strand)."""
    import torch
    from aindex_torch.kernels import probe
    from aindex_torch.kernels.buckets import BUCKET, EMPTY_HI, EMPTY_KEY, bucket_of
    from aindex_torch.kernels.encode import revcomp_code64
    from aindex_torch.kernels.lookup import _s64, mix64
    t, k = index.tables, index.k
    gen = torch.Generator(device=dev).manual_seed(73)
    rec = t.records.view(-1, BUCKET, 4)
    real = (rec[..., 1] & EMPTY_HI) == 0
    n0 = 1 << t.levels[0][1]

    def some(x, n=4096):
        return x[torch.randperm(x.numel(), device=dev, generator=gen)[:n]]
    over = key_of(rec[n0:])[real[n0:]]
    check(over.numel() > 0, f"{index.engine}: keys in an overflow level")
    marked = rec[:n0, 0, 1] < 0
    groups = {
        "overflow": some(over),
        "marked buckets": some(key_of(rec[:n0][marked])[real[:n0][marked]]),
        "unmarked buckets": some(key_of(rec[:n0][~marked])[real[:n0][~marked]]),
        "first and last buckets": torch.cat([key_of(rec[0])[real[0]],
                                             key_of(rec[n0 - 1])[real[n0 - 1]]]),
    }
    draws = torch.randint(0, 1 << (2 * k), (1 << 20,), dtype=torch.int64, device=dev,
                          generator=gen)
    shared = real[:n0].any(dim=1)[bucket_of(mix64(draws ^ _s64(t.seed)), t.levels[0][1])]
    groups["absent, in a present key's bucket"] = some(draws[shared & ~t.probe_plain(draws)[0]])
    members = some(key_of(rec[:n0])[real[:n0]])
    high = torch.randint(1, 1 << (62 - 2 * k), (members.numel(),), dtype=torch.int64,
                         device=dev, generator=gen)
    groups["codes above 2k bits"] = members | (high << (2 * k))
    groups["0xFFFFFFFF_00000000, 0, 2^62 - 1, 2^64 - 1"] = torch.tensor(
        [_s64(EMPTY_KEY), 0, (1 << 62) - 1, -1], device=dev)
    keys = torch.cat(list(groups.values()))
    codes = keys.cpu().numpy().view(np.uint64)
    rc = revcomp_code64(keys, k).cpu().numpy().view(np.uint64)
    for rule in probe.RULES:
        kw = {"k": k, "rule": rule, "slot": True, "strand": rule != probe.KEYS}
        got = probe.query(t, keys, **kw)
        for a, b in zip(got, probe.query_plain(t, keys, **kw)):
            max_abs_err(a, b)
        want = host_answers(index, codes, rc, rule)
        check(np.array_equal(got[0].view(torch.int32).cpu().numpy().view(np.uint32), want[0])
              and np.array_equal(got[1].cpu().numpy(), want[1]),
              f"{index.engine} tf and slot == the host table's, rule {rule}")
        if rule != probe.KEYS:
            check(np.array_equal(got[2].cpu().numpy(), want[2]),
                  f"{index.engine} strand == the host table's, rule {rule}")
    print(f"{t.QUERY} edge keys == plain == host table, rules KEYS, CANON, FWD_RC: "
          + "; ".join(f"{len(v)} {g}" for g, v in groups.items())
          + f"; empty-row key answer {t.empty} ({card})")


@functools.lru_cache(maxsize=2)
def parent_engines(parent: str) -> dict:
    """The K6, K7 and K10 query and coverage entries, K7's ASCII-rows entry,
    K4, K11's coverage, K1, K15, K2, K3 (``gather13``) and K5's
    canonical23_ascii of the checkout at ``parent`` (its ``quot23.cu``,
    ``quotcov23.cu``, ``cuckoo64.cu``, ``coverage13.cu``, ``mphfwalk.cu``,
    ``count13.cu``, ``total13.cu``, ``gather13.cu`` and ``spectrum23.cu``,
    one nvcc each, all started together), by name."""
    from aindex_torch.kernels import _cuda
    out_dir = os.path.join(HERE, "build", "parent_kernels", os.path.basename(parent))
    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.join(parent, "aindex_torch", "csrc")
    sources = {"quot23": ("quot23",), "quotcov23": ("quotcov23", "quotcov23_rows"),
               "cuckoo64": ("cuckoo64", "cuckoocov64"),
               "coverage13": ("coverage13_packed",), "mphfwalk": ("mphfcov",),
               "count13": ("scatter_count", "count13_packed", "count13_rows"),
               "total13": ("total13",), "gather13": ("gather13",),
               "spectrum23": ("canonical23_ascii",)}
    procs = {src: (os.path.join(out_dir, f"{src}.so"), subprocess.Popen(
        [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", csrc, "-o",
         os.path.join(out_dir, f"{src}.so"), os.path.join(csrc, f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)) for src in sources}
    fns = {}
    for src, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"{parent}'s {src}.cu builds:\n{log.decode(errors='replace')}")
        for name in sources[src]:
            fn = getattr(ctypes.CDLL(lib), name)
            fn.argtypes = _cuda.KERNELS[name].argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
    return fns


def parent_tables(dev, index) -> tuple:
    """The parent's device layout of the index's table, built from the host
    table as the parent uploaded it, as (p, u, tensors) for its C entry:
    the quotient table's two halves of (fingerprint, tf) rows and two slot
    columns, or the wide table's rows; or, for a parent whose K6 and K10
    already read the bucketed records (it has kernels/buckets.py), this
    tree's own tables."""
    import ctypes

    import torch
    from aindex_torch.kernels import probe
    if os.path.exists(os.path.join(PARENT, "aindex_torch", "kernels", "buckets.py")):
        t = index.tables
        return (*probe.c_engine(t), t.tensors())
    if index.engine == "quot":
        qc = index.quot
        fp_tf = torch.from_numpy(qc.fp_tf_host.view(np.int32)).to(dev)
        slot = torch.from_numpy(qc.slot_host).to(dev)
        tensors = (fp_tf[:qc.m].contiguous(), fp_tf[qc.m:].contiguous(),
                   slot[:qc.m].contiguous(), slot[qc.m:].contiguous())
        params = [qc.m, qc.lb, qc.w, *(int(x) for x in qc.mults)]
    else:
        ct = index.cuckoo
        tensors = (torch.from_numpy(ct.table_host.view(np.int32)).to(dev),)
        params = [ct.m, ct.seed1, ct.seed2]

    ptrs = [x.data_ptr() for x in tensors]
    return ((ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_ulonglong * len(params))(*(int(x) & (2 ** 64 - 1) for x in params)),
            tensors)


def parent_vs_this(dev, card: str, label: str, fn, old, t, codes, k: int, rule: int,
                   slot: bool, strand: bool) -> None:
    """The parent's query entry ``fn`` on its layout ``old`` (parent_tables)
    beside this tree's on ``t``, on the same codes, in turns (in_turns)."""
    import torch
    from aindex_torch.kernels import _cuda, probe
    p, u, _ = old
    n = codes.numel()
    outs = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3)]
    wanted = (True, slot, strand)

    def parent():
        check(fn(p, u, codes.data_ptr(), None, None, k, n, rule, outs[0].data_ptr(),
                 outs[1].data_ptr() if slot else None, outs[2].data_ptr() if strand else None,
                 _cuda.stream(dev)) == 0, "the parent's query")
        return tuple(x for x, on in zip(outs, wanted) if on)

    def this():
        got = probe.query(t, codes, k=k, rule=rule, slot=slot, strand=strand)
        return tuple(x.view(torch.int32) for x in (got if isinstance(got, tuple) else (got,)))
    in_turns(card, label, this, parent, 20)


def in_turns(card: str, label: str, this, parent, reps: int) -> dict:
    """This tree's call and the parent's, whose results must be equal,
    each timed twice in turns (this, parent, parent, this); prints and
    returns both: name -> [ms, ms]."""
    import torch
    mine, old = this(), parent()
    for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (mine, old))):
        if a is not None:
            max_abs_err(a, b)
    del mine, old
    torch.cuda.empty_cache()
    times = {"this tree": [], "parent": []}
    for name in ("this tree", "parent", "parent", "this tree"):
        times[name].append(cuda_ms(this if name == "this tree" else parent, reps))
    print(f"{label}: this tree {times['this tree'][0]:.4f} / {times['this tree'][1]:.4f} ms, "
          f"parent {times['parent'][0]:.4f} / {times['parent'][1]:.4f} ms ({card})")
    return times


def upload(dev, packed, vbits):
    import torch
    return (torch.from_numpy(packed.reshape(-1).view(np.int32)).to(dev),
            torch.from_numpy(vbits.reshape(-1)).to(dev))


# -- the packed coverage entries' four clocks ---------------------------------

#: distinct batches that a cold timing of a coverage entry rotates over
N_COLD = 8
#: random reads a second by width in bytes, from this run's width_test: the
#: coverage entries' random-read floors
READ_RATE: dict[int, float] = {}
#: 4-byte adds a second by (log2 table entries, n, order), from this run's
#: rmw_test: K16's floors
RMW_RATE: dict[tuple, float] = {}


@contextlib.contextmanager
def parent_kernel(name: str):
    """This tree's wrapper launching the parent's C entry ``name``
    (``parent_engines``) in place of its own, within the block."""
    from aindex_torch.kernels import _cuda
    kern = _cuda.KERNELS[name]
    own = kern._lib
    kern._lib = types.SimpleNamespace(**{name: parent_engines(PARENT)[name],
                                         "dna13_error_string": own.dna13_error_string})
    try:
        yield
    finally:
        kern._lib = own


def device_ms_per_call(fn, calls, tries: int = 3,
                       kernel: tuple = ("coverage",)) -> tuple[float, int]:
    """(torch.profiler's mean device time of the kernels that ``fn(b)``
    launches for b in ``calls`` whose names hold a word of ``kernel``, the
    launches the trace holds).
    A trace taken late in a long process can come back short of its
    events, so the mean is over those it holds, and a trace holding fewer
    than half the launches is taken again, up to ``tries`` times."""
    import torch
    from torch import profiler
    best: list = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profiler.profile(activities=[profiler.ProfilerActivity.CUDA]) as prof:
            for b in calls:
                fn(b)
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and any(word in e.name for word in kernel)]
        best = spans if len(spans) > len(best) else best
        if 2 * len(best) >= len(calls):
            break
    return (sum(best) / 1e3 / len(best) if best else float("nan")), len(best)


def clocks(card: str, label: str, name: str, fn, n_batches: int, floor_ms: float,
           footprint: int, reps: int = 48, kernel: tuple = ("coverage",),
           floor_what: str = "random-read floor", footprint_what: str = "table",
           compare: bool = True) -> dict:
    """The kernel entry ``name`` (its device kernels named by a word of
    ``kernel``) through its wrapper, ``fn(b)`` on the
    uploaded batch b < ``n_batches``, timed by this tree's kernel and, with
    ``parent=DIR``, the parent's in the same wrapper (``parent_kernel``),
    in turns (this, parent, parent, this), after both gave equal answers
    on every batch (unless ``compare`` is False: the caller held them):

    * warm: CUDA events over ``reps`` calls back to back on batch 0;
    * cold: CUDA events over ``reps`` calls rotating over the batches, whose
      distinct table bytes (``footprint``) pass the 50 MB L2;
    * device cold / warm: torch.profiler's device time a launch of the
      same rotation / of batch 0 (one launch a call, checked);
    * host: the host clock a call of the rotation, with no synchronize
      (the wrapper's Python and the launch).

    Prints them beside the floor (``floor_what``); returns tree -> clock ->
    [ms, ...]."""
    import torch
    trees = {"this tree": contextlib.nullcontext}
    if PARENT is not None:
        trees["parent"] = lambda: parent_kernel(name)
    for b in range(n_batches if PARENT is not None and compare else 0):
        mine = fn(b)
        with parent_kernel(name):
            theirs = fn(b)
        for x, y in zip(*(v if isinstance(v, tuple) else (v,) for v in (mine, theirs))):
            max_abs_err(x, y)
        del mine, theirs
    rotation = [b % n_batches for b in range(reps)]
    out = {tree: {c: [] for c in ("warm", "cold", "device cold", "device warm", "host")}
           for tree in trees}
    order = list(trees) + list(trees)[::-1]
    for tree in order:
        with trees[tree]():
            got = out[tree]
            got["warm"].append(cuda_ms(lambda: fn(0), reps))
            turn = itertools.cycle(range(n_batches))
            got["cold"].append(cuda_ms(lambda: fn(next(turn)), reps))
            for clock, bs in (("device cold", rotation), ("device warm", [0] * reps)):
                ms, ops = device_ms_per_call(fn, bs, kernel=kernel)
                check(ops <= reps, f"{name}: one device operation a call ({ops} for {reps})")
                if ops < reps:
                    print(f"{name} {label}, {tree}: the {clock} trace holds {ops} of {reps} "
                          f"launches")
                got[clock].append(ms)
            t0 = time.perf_counter()
            for b in rotation:
                fn(b)
            got["host"].append((time.perf_counter() - t0) / reps * 1e3)
            torch.cuda.synchronize()
    for tree, got in out.items():
        print(f"{name} {label}, {tree}: " + ", ".join(
            f"{c} " + " / ".join(f"{v:.4f}" for v in vals) for c, vals in got.items())
            + f" ms; {floor_what} {floor_ms:.4f} ms; cold rotation {n_batches} batches, "
            f"{footprint / 1e6:.1f} MB of {footprint_what} ({card})")
    SIDE_MS[f"{name} {label}, clocks"] = {f"{tree} {c}": vals for tree, got in out.items()
                                          for c, vals in got.items()}
    return out


def table_reads(t, keys) -> tuple[int, object]:
    """(random table reads that the probes of ``keys`` make, the ids of the
    32-byte sectors they start at): a bucket a level on the bucketed
    tables (bucket_reads; ids of the level-0 buckets' first sectors), one
    16-byte node record a key on the MPHF walk (its g-words lie in L2)."""
    import torch
    from aindex_torch.kernels.lookup import mphf_owner_node
    if hasattr(t, "levels"):
        from aindex_torch.kernels.buckets import bucket_of
        from aindex_torch.kernels.lookup import _s64, mix64
        first, lb = t.levels[0]
        k = keys & ((1 << t.w) - 1) if t.w < 64 else keys
        bucket = first + bucket_of(mix64(k ^ _s64(t.seed)), lb)
        return int(bucket_reads(t, keys).sum()), bucket * 2
    if t.n == 0:
        return 0, torch.zeros(0, dtype=torch.int64, device=keys.device)
    return keys.numel(), mphf_owner_node(t.g_packed, keys, t.seed, t.domain) >> 1


def probe_keys(t, packed, vbits, k: int, rule: int):
    """The keys the coverage probes of the packed rows ask the engine for:
    the canonical code of every valid window (CANON), or its forward code
    and, where that misses, its reverse complement (FWD_RC)."""
    import torch
    from aindex_torch.kernels.encode import packed_window_codes, revcomp_code64, u64_le
    from aindex_torch.kernels.probe import CANON
    codes, valid = packed_window_codes(packed, vbits, k)
    fwd = codes[valid]
    rc = revcomp_code64(fwd, k)
    if rule == CANON:
        return torch.where(u64_le(fwd, rc), fwd, rc)
    return torch.cat([fwd, rc[~t.probe_plain(fwd)[0]]])


def engine_coverage_clocks(card: str, index, name: str, batches: list) -> dict:
    """The engine's coverage entry (K7, K10's or K11's) on the N_COLD
    packed batches of 10,000 corpus reads (coverage_batches), cutoff 0,
    under the index's rule: clocks, beside the random-read floor of batch
    0 (its table reads over READ_RATE: 64-byte buckets, 16-byte records)."""
    import torch
    from aindex_torch.kernels import probe
    t, k, rule = index.tables, index.k, index.rule
    n_reads, sectors = 0, []
    for packed, vbits, _, _ in batches:
        n, s = table_reads(t, probe_keys(t, packed, vbits, k, rule))
        n_reads = n_reads or n
        sectors.append(s)
    width = 64 if hasattr(t, "levels") else 16
    per = 2 if width == 64 else 1
    footprint = int(torch.unique(torch.cat(sectors)).numel()) * 32 * per
    floor = n_reads / READ_RATE[width] * 1e3
    rows, stride = batches[0][2:]
    return clocks(card, f"cutoff 0, {rows} x {stride}, k={k}", name,
                  lambda b: probe.coverage(t, *batches[b], k, 0, rule), len(batches),
                  floor, footprint)


def coverage_batches(dev, reads: np.ndarray, k: int) -> list:
    """N_COLD batches of N_SEQ corpus reads each (reads[i N_SEQ:(i + 1)
    N_SEQ]), packed as ``sequence_coverage_batch`` packs them and uploaded:
    [(packed, vbits, rows, stride)]."""
    from aindex_torch.core import codec
    out = []
    for i in range(N_COLD):
        [(members, stride, packed, vbits)] = codec.coverage_row_batches(
            [row.tobytes() for row in reads[i * N_SEQ:(i + 1) * N_SEQ]], k)
        out.append((*upload(dev, packed, vbits), len(members), stride))
    return out


def dense_coverage_batches(dev, rng) -> list:
    """N_COLD random ASCII matrices of N_SEQ rows of 150 bases (1% N) and a
    newline, packed and uploaded: [(packed, vbits, rows, stride)]."""
    from aindex_torch.core import codec
    out = []
    for _ in range(N_COLD):
        mat = random_ascii(rng, N_SEQ * (READ_LEN + 1), b"ACGTN",
                           [0.2475, 0.2475, 0.2475, 0.2475, 0.01]).reshape(N_SEQ, -1)
        mat[:, -1] = ord("\n")
        out.append((*upload(dev, *codec.pack_ascii_chunk(mat.reshape(-1))), N_SEQ,
                    READ_LEN + 1))
    return out


def coverage_stages(dev, card: str, label: str, k: int, name: str, launch, call,
                    seqs: list, dtype=None, reps: int = 3) -> None:
    """One coverage call of ``seqs`` (``call(seqs)``: the index's
    ``sequence_coverage_batch``) split into its stages by the host clock,
    each ended by a synchronize, as the call runs them: the ASCII encode,
    ``codec.coverage_row_batches``' Python row fill and its
    ``pack_ascii_chunk``, the upload, the kernel (``launch(packed, vbits,
    rows, stride)``), the download, the per-row slicing, and the facade's
    Python lists (``AIndex.get_sequence_coverage_batch``); with parent=DIR
    also with the parent's kernel ``name``. The best of ``reps`` runs of
    each stage, beside the best of the whole call."""
    import torch
    from aindex_torch.core import codec
    trees = {"this tree": contextlib.nullcontext}
    if PARENT is not None:
        trees["parent"] = lambda: parent_kernel(name)
    real_pack = codec.pack_ascii_chunk
    pack_s = [0.0]

    def timed_pack(chunk):
        t0 = time.perf_counter()
        out = real_pack(chunk)
        pack_s[0] += time.perf_counter() - t0
        return out
    for tree, ctx in trees.items():
        best: dict[str, float] = {}
        with ctx():
            for _ in range(reps):
                torch.cuda.synchronize()
                marks = [time.perf_counter()]
                raws = [s.encode("ascii") for s in seqs]
                marks.append(time.perf_counter())
                pack_s[0] = 0.0
                codec.pack_ascii_chunk = timed_pack
                try:
                    batches = list(codec.coverage_row_batches(raws, k))
                finally:
                    codec.pack_ascii_chunk = real_pack
                marks.append(time.perf_counter())
                ins = [(members, stride, torch.from_numpy(p.view(np.int32)).to(dev),
                        torch.from_numpy(v).to(dev)) for members, stride, p, v in batches]
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
                covs = [(members, launch(p, v, len(members), stride))
                        for members, stride, p, v in ins]
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
                hosts = [(members, c.view(torch.int32).cpu().numpy().view(np.uint32))
                         for members, c in covs]
                marks.append(time.perf_counter())
                out = [None] * len(seqs)
                for members, cov in hosts:
                    for row, i in enumerate(members):
                        out[i] = cov[row, :len(raws[i]) - k + 1]
                        if dtype is not None:
                            out[i] = out[i].astype(dtype)
                marks.append(time.perf_counter())
                lists = [[int(v) for v in c] for c in out]
                marks.append(time.perf_counter())
                del lists
                spans = np.diff(marks) * 1e3
                stages = {"encode": spans[0], "row fill": spans[1] - pack_s[0] * 1e3,
                          "pack": pack_s[0] * 1e3, "upload": spans[2], "kernel": spans[3],
                          "download": spans[4], "row slices": spans[5],
                          "facade lists": spans[6]}
                for stage, ms in stages.items():
                    best[stage] = min(best.get(stage, ms), ms)
            whole = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call(seqs)
                whole.append((time.perf_counter() - t0) * 1e3)
        print(f"coverage call stages, {label}, {len(seqs)} sequences, {tree}'s kernel: "
              + ", ".join(f"{s} {ms:.3f}" for s, ms in best.items())
              + f" ms; the index's call {min(whole):.3f} ms, the stages but the facade's "
              f"lists {sum(best.values()) - best['facade lists']:.3f} ms (host clock, best "
              f"of {reps}) ({card})")


def dense_stages(dev, card: str, index, reads: np.ndarray) -> None:
    """coverage_stages of the dense index's coverage call on 10,000 corpus
    reads (K4 on its query table)."""
    from aindex_torch.kernels.coverage import _NP_DTYPES, coverage13_packed
    table = index.tf_query
    coverage_stages(dev, card, f"dense table k={K} ({table.dtype})", K, "coverage13_packed",
                    lambda p, v, rows, stride: coverage13_packed(table, p, v, rows, stride, 0),
                    lambda seqs: index.sequence_coverage_batch(seqs),
                    [row.tobytes().decode("ascii") for row in reads[:N_SEQ]],
                    _NP_DTYPES[table.dtype])


def coverage_edges(dev, rows_of, k: int) -> list:
    """(tag, packed, vbits, rows, stride) of the shapes where the tiled
    coverage front end (csrc/dna23.cuh tile_run) could break, uploaded,
    with ASCII rows from ``rows_of(n, length)``: one row longer than many
    tiles, rows of one window each, windows that end mid-tile and mid-run,
    rows wider than a tile, rows of all N, rows that fill packed to its
    last word (the last row's bases all valid), and a batch whose packed
    and vbits lie 4 and 2 bytes past 16-byte alignment."""
    import torch
    from aindex_torch.core import codec

    def nl(n):
        return np.full((n, 1), ord("\n"), np.uint8)
    mats = [("one row of 2^20 bases", np.hstack([rows_of(1, 1 << 20), nl(1)])),
            (f"5000 rows of stride k + 1 = {k + 1}", np.hstack([rows_of(5000, k), nl(5000)])),
            ("13 rows of stride 100", np.hstack([rows_of(13, 99), nl(13)])),
            ("3 rows of stride 5000", np.hstack([rows_of(3, 4999), nl(3)])),
            ("40 rows of 151 N", np.full((40, READ_LEN + 1), ord("N"), np.uint8)),
            ("16 rows of 151 valid bases to packed's last word", rows_of(16, READ_LEN + 1)),
            ("300 rows of stride 151", np.hstack([rows_of(300, READ_LEN), nl(300)]))]
    out = []
    for tag, mat in mats:
        packed, vbits = codec.pack_ascii_chunk(np.ascontiguousarray(mat).reshape(-1))
        check(packed.size * 16 == mat.size or tag != mats[5][0], "16 x 151 bases fill packed")
        out.append((tag, *upload(dev, packed, vbits), *mat.shape))
    tag, packed, vbits, rows, stride = out[-1]
    pb = torch.zeros(packed.numel() + 1, dtype=packed.dtype, device=dev)
    vb = torch.zeros(vbits.numel() + 2, dtype=vbits.dtype, device=dev)
    pb[1:], vb[2:] = packed, vbits
    out.append((f"{tag}, 4 and 2 bytes past alignment", pb[1:], vb[2:], rows, stride))
    return out


def dense_coverage_edges_vs_plain(dev, card: str, rng) -> None:
    """K4 exactly against its plain version at coverage_edges' shapes
    (random ASCII, 1% N), on random u8, u16 and u32 tables over their
    whole range, at cutoffs 0, 10 and 2^32 - 1."""
    import torch
    from aindex_torch.kernels.coverage import coverage13_packed, coverage13_packed_plain
    gen = torch.Generator(device=dev).manual_seed(13)
    tables = [torch.randint(0, 256, (SPACE,), dtype=torch.uint8, device=dev, generator=gen)]
    for bits, dtype, view in ((16, torch.int16, torch.uint16), (32, torch.int32, torch.uint32)):
        tables.append(torch.randint(-2 ** (bits - 1), 2 ** (bits - 1), (SPACE,), dtype=dtype,
                                    device=dev, generator=gen).view(view))

    def rows_of(n, length):
        return random_ascii(rng, n * length, b"ACGTN", [0.2475] * 4 + [0.01]).reshape(n, length)
    tags = []
    for tag, packed, vbits, rows, stride in coverage_edges(dev, rows_of, K):
        for table in tables:
            for cutoff in (0, 10, 2 ** 32 - 1):
                args = (table, packed, vbits, rows, stride, cutoff)
                max_abs_err(coverage13_packed(*args), coverage13_packed_plain(*args))
        tags.append(tag)
    print(f"coverage13_packed edge shapes == plain, u8/u16/u32 tables, cutoffs 0, 10, "
          f"2^32 - 1: {'; '.join(tags)} ({card})")


def engine_coverage_edges_vs_plain(dev, card: str, index, reads: np.ndarray) -> None:
    """The engine's coverage entry (K7, K10's or K11's) exactly against its
    plain version at coverage_edges' shapes (rows cut from the corpus
    reads, 0.3% N), under the CANON and FWD_RC rules, at cutoffs 0, 10 and
    2^32 - 1; counts the probes that read a second bucket level (the
    overflowed levels)."""
    from aindex_torch.kernels import probe
    t, k = index.tables, index.k
    rng = np.random.default_rng(83)
    flat = reads.reshape(-1)

    def rows_of(n, length):
        start = rng.integers(0, flat.size - length, n)
        mat = flat[start[:, None] + np.arange(length)[None, :]].copy()
        mat[rng.random(mat.shape) < 0.003] = ord("N")
        return mat
    tags, second = [], 0
    for tag, packed, vbits, rows, stride in coverage_edges(dev, rows_of, k):
        for rule in (probe.CANON, probe.FWD_RC):
            for cutoff in (0, 10, 2 ** 32 - 1):
                args = (t, packed, vbits, rows, stride, k, cutoff, rule)
                max_abs_err(probe.coverage(*args), probe.coverage_plain(*args))
        if hasattr(t, "levels"):
            keys = probe_keys(t, packed, vbits, k, probe.CANON)
            second += int((bucket_reads(t, keys) > 1).sum()) if keys.numel() else 0
        tags.append(tag)
    levels = (f"; {second} of the canonical probes read a second level of "
              f"{len(t.levels)}, empty-row key answer {t.empty}" if hasattr(t, "levels") else "")
    print(f"{t.COVERAGE} k={k} edge shapes == plain, rules CANON and FWD_RC, cutoffs 0, 10, "
          f"2^32 - 1: {'; '.join(tags)}{levels} ({card})")


def dense_coverage_clocks(card: str, table, batches: list) -> dict:
    """K4 on the N_COLD batches (dense_coverage_batches) at cutoff 0:
    clocks, beside the random-read floor of batch 0 (its valid windows, one
    table read each, over READ_RATE[16])."""
    import torch
    from aindex_torch.kernels.coverage import coverage13_packed
    from aindex_torch.kernels.encode import packed_window_codes
    n_valid, sectors = 0, []
    for packed, vbits, _, _ in batches:
        codes, valid = packed_window_codes(packed, vbits, K)
        n_valid = n_valid or int(valid.sum())
        sectors.append(codes[valid] * table.element_size() // 32)
    footprint = int(torch.unique(torch.cat(sectors)).numel()) * 32
    bits = 8 * table.element_size()
    return clocks(card, f"u{bits} cutoff 0, {N_SEQ} x {READ_LEN + 1}", "coverage13_packed",
                  lambda b: coverage13_packed(table, *batches[b], 0), len(batches),
                  n_valid / READ_RATE[16] * 1e3, footprint)


# -- phase 2: dense kernels against plain versions -----------------------------

def k1_edges_vs_plain(dev, card: str, rng) -> None:
    """K1 exactly against its plain version where its buffer and partition
    could break, from a table that holds values near 2^32 (entry 0 among
    them, so the adds wrap): chunks of 1, 15, 16 and 17 words and an empty
    chunk, each alone and all through one PackedCounter (bins below SPARSE
    records: their counters added with atomics); a skewed chunk (90%
    poly-A) whose bin 0 holds more than CAP records, so bin_count splits it
    and adds its partial slices with atomics. The corpus build
    (count_build_vs_plain) takes the swept bins."""
    import torch
    from aindex_torch.core import codec
    from aindex_torch.kernels.count import PackedCounter, count13_packed, count13_packed_plain
    start = torch.zeros(SPACE, dtype=torch.int32, device=dev)
    hot = torch.from_numpy(np.concatenate([[0, 1, SPACE - 1],
                                           rng.integers(0, SPACE, size=1 << 16)])).to(dev)
    start[hot] = -torch.randint(1, 4, (hot.numel(),), dtype=torch.int32, device=dev)
    sizes = (16, 240, 256, 272, 0, 1 << 20, 37)
    chunks = []
    for n in sizes:
        c = random_ascii(rng, n, b"ACGTN\n", [0.245, 0.245, 0.245, 0.245, 0.01, 0.01])
        c[:min(n, 30)] = ord("A")
        chunks.append(upload(dev, *codec.pack_ascii_chunk(c)))
    want = start.clone()
    for p, v in chunks:
        if p.numel():
            count13_packed_plain(want, p, v)
    got = start.clone()
    for p, v in chunks:
        count13_packed(got, p, v)
    max_abs_err(got.view(torch.uint32), want.view(torch.uint32))
    got = start.clone()
    counter = PackedCounter(got)
    for p, v in chunks:
        counter.add(p, v)
    max_abs_err(counter.finish().view(torch.uint32), want.view(torch.uint32))
    skew = random_ascii(rng, 1 << 22, b"ACGTA\n", [0.025, 0.025, 0.025, 0.025, 0.9, 0.007])
    sp, sv = upload(dev, *codec.pack_ascii_chunk(skew))
    ref = want.clone()
    count13_packed_plain(ref, sp, sv)
    bin0 = int((ref[:1 << 15].to(torch.int64) - want[:1 << 15].to(torch.int64))
               .remainder(1 << 32).sum())
    check(bin0 > 1 << 18, f"the skewed chunk's bin 0 holds {bin0} records, more than CAP")
    count13_packed(got, sp, sv)
    max_abs_err(got.view(torch.uint32), ref.view(torch.uint32))
    print(f"kernel count13_packed: chunks of {[-(-n // 16) for n in sizes]} words alone and "
          f"through one counter, and a skewed chunk ({bin0} records in bin 0, split), from a "
          f"table near 2^32: max_abs_err 0 ({card})")


def dense_kernels_vs_plain(dev, card: str) -> dict:
    import torch
    from aindex_torch.core import codec
    from aindex_torch.kernels import _cuda
    from aindex_torch.index.dense13 import (_narrow, total13, total13_half, total13_half_plain,
                                            total13_plain)
    from aindex_torch.kernels.count import count13_packed, count13_packed_plain
    from aindex_torch.kernels.coverage import coverage13_packed, coverage13_packed_plain
    from aindex_torch.kernels.encode import (ascii_to_base_codes, half_index13,
                                             packed_window_codes, revcomp_code13, window_codes)
    from aindex_torch.kernels.lookup import gather13, gather13_plain, jax_index

    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev).manual_seed(7)
    res = {}

    def touched(codes, valid):
        return int(torch.unique(codes[valid]).numel())

    # K1 alone on one 2^22-byte chunk (count13_packed: one count of its
    # 4.19M windows, ~2,000 records a bin), reads of 150 bases with N,
    # lowercase and '~'; the path's figure is a whole build's
    # (count_build_vs_plain)
    chunk = random_ascii(rng, CHUNK_BYTES, b"ACGTacgtN~",
                         [0.24, 0.24, 0.24, 0.24, 0.005, 0.005, 0.005, 0.005, 0.005, 0.005])
    chunk[150::151] = ord("\n")
    packed, vbits = upload(dev, *codec.pack_ascii_chunk(chunk))
    kern = torch.zeros(SPACE, dtype=torch.int32, device=dev)
    plain = torch.zeros(SPACE, dtype=torch.int32, device=dev)
    count13_packed(kern, packed, vbits)
    count13_packed_plain(plain, packed, vbits)
    max_abs_err(kern.view(torch.uint32), plain.view(torch.uint32))
    scratch = torch.zeros(SPACE, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: count13_packed(scratch, packed, vbits), 50)
    pms = cuda_ms(lambda: count13_packed_plain(scratch, packed, vbits), 5)
    SIDE_MS["count13_packed: one 2^22-byte chunk alone (earlier 0.2284, one launch)"] = {
        "this tree": [ms]}
    print(f"kernel count13_packed [one 2^22-byte chunk alone]: max_abs_err 0, kernel {ms:.4f} "
          f"ms, plain {pms:.4f} ms ({card})")
    if PARENT is not None:
        mine = torch.zeros(SPACE, dtype=torch.int32, device=dev)
        theirs = torch.zeros(SPACE, dtype=torch.int32, device=dev)

        def parent_chunk():
            with parent_kernel("count13_packed"):
                return count13_packed(theirs, packed, vbits).view(torch.uint32)
        SIDE_MS["count13_packed: one 2^22-byte chunk alone, in turns"] = in_turns(
            card, "count13_packed, one chunk alone",
            lambda: count13_packed(mine, packed, vbits).view(torch.uint32), parent_chunk, 50)
        del mine, theirs
    del kern, plain, scratch
    k1_edges_vs_plain(dev, card, rng)

    # K2: a random full table, wrapping adds included
    tf = torch.randint(-2 ** 31, 2 ** 31, (SPACE,), dtype=torch.int32, device=dev,
                       generator=gen).view(torch.uint32)
    err = max_abs_err(total13(tf), total13_plain(tf))
    ms = cuda_ms(lambda: total13(tf), 20)
    pms = cuda_ms(lambda: total13_plain(tf), 3)
    res["total13"] = record(err, ms, pms, 2 * 4 * SPACE)
    report(card, "total13", "4^13 table", res["total13"])
    if PARENT is not None:
        fn = parent_engines(PARENT)["total13"]
        theirs = torch.empty(SPACE, dtype=torch.int32, device=dev)

        def parent_total():
            check(fn(tf.data_ptr(), theirs.data_ptr(), _cuda.stream(dev)) == 0,
                  "the parent's total13")
            return theirs.view(torch.uint32)
        SIDE_MS["total13: random 4^13 table, in turns"] = in_turns(
            card, "total13, random 4^13 table", lambda: total13(tf), parent_total, 20)
        del theirs
    # K2's half mode: the same reads, half the writes
    err = max_abs_err(total13_half(tf), total13_half_plain(tf))
    check(torch.equal(total13_half(tf).view(torch.int32)[half_index13(
        torch.arange(SPACE, dtype=torch.int64, device=dev))], total13(tf).view(torch.int32)),
        "total13_half at each code's half_index13 == total13")
    ms = cuda_ms(lambda: total13_half(tf), 20)
    pms = cuda_ms(lambda: total13_half_plain(tf), 3)
    res["total13_half"] = record(err, ms, pms, 4 * SPACE + 4 * HALF)
    report(card, "total13_half", "4^13 table to its 2^25 half", res["total13_half"])
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
    n_touched, n_touched_half = {}, {}
    for mode, fwd in (("codes", index), ("codes+mask", index[valid]), ("ascii", row_codes)):
        rc = revcomp_code13(fwd) if mode == "ascii" else rc_index[valid] \
            if mode == "codes+mask" else rc_index
        n_touched[mode, False] = int(torch.unique(fwd).numel())
        n_touched[mode, True] = int(torch.unique(torch.cat([fwd, rc])).numel())
        n_touched_half[mode] = int(torch.unique(half_index13(fwd)).numel())
    del rc_index
    k3, k3_half = [], []
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
        # the half total table's entry (a random table: the plain version
        # folds as the kernel does), every mode but both
        half = table[:HALF]
        for mode, kw in modes:
            got = gather13(half, **kw)
            err = max_abs_err(got, gather13_plain(half, **kw))
            ms = cuda_ms(lambda: gather13(half, **kw), 20)
            pms = cuda_ms(lambda: gather13_plain(half, **kw), 2)
            n_out = n_codes if mode != "ascii" else rows.shape[0]
            n_in = {"codes": 4 * n_codes, "codes+mask": 5 * n_codes,
                    "ascii": rows.numel()}[mode]
            n_bytes = n_in + n_out * 4 + n_touched_half[mode] * bits // 8
            rec = record(err, ms, pms, n_bytes)
            tag = f"u{bits} half {mode}, {'2^20 rows' if mode == 'ascii' else '4x2^24 codes'}"
            report(card, "gather13_half", tag, rec)
            k3_half.append((tag, rec))
        if bits == 8:
            # the main path's own traffic: codes of reads, every one in range
            inside = torch.randint(0, SPACE, (n_codes,), dtype=torch.int32, device=dev,
                                   generator=gen)
            err = max_abs_err(gather13(table, inside), gather13_plain(table, inside))
            ms = cuda_ms(lambda: gather13(table, inside), 20)
            pms = cuda_ms(lambda: gather13_plain(table, inside), 2)
            inside64 = inside.to(torch.int64)
            lib = cuda_ms(lambda: torch.take(table, inside64), 20)
            n_bytes = 8 * n_codes + int(torch.unique(inside).numel())
            rec = record(err, ms, pms, n_bytes, lib)
            tag = "u8 codes in range, 4x2^24 codes"
            report(card, "gather13", tag, rec)
            k3.append((tag, rec))
            res["gather13 in range"] = rec
            del inside64
            half_vs_full(dev, card, gen, inside)
            del inside
        del table, half
    head = dict(k3)["u8 codes, 4x2^24 codes"]
    res["gather13"] = {**head, "max_abs_err": max(r["max_abs_err"] for _, r in k3)}
    head = dict(k3_half)["u8 half codes, 4x2^24 codes"]
    res["gather13_half"] = {**head, "max_abs_err": max(r["max_abs_err"] for _, r in k3_half)}
    del codes, valid, rows, index
    gather13_edges_vs_plain(dev, card)

    # K4: 10,000 rows x stride 151 (150 bp reads), cutoff 0 and 10
    n_rows, stride = N_SEQ, READ_LEN + 1
    mat = random_ascii(rng, n_rows * stride, b"ACGTN",
                       [0.2475, 0.2475, 0.2475, 0.2475, 0.01]).reshape(n_rows, stride)
    mat[:, -1] = ord("\n")
    packed, vbits = upload(dev, *codec.pack_ascii_chunk(mat.reshape(-1)))
    n_touched = touched(*packed_window_codes(packed, vbits, K))
    batches = dense_coverage_batches(dev, rng)[1:]
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
        # warm, cold, device and host clocks on N_COLD matrices, beside the parent's
        dense_coverage_clocks(card, table, [(packed, vbits, n_rows, stride)] + batches)
    res["coverage13_packed"] = {**k4[0], "max_abs_err": max(r["max_abs_err"] for r in k4)}
    dense_coverage_edges_vs_plain(dev, card, rng)
    return res


def gather13_edges_vs_plain(dev, card: str) -> None:
    """K3's four entries exactly against their plain versions at edge
    shapes: batches of 0-9 codes and 2^20 + 3, codes (and masks) starting
    0-3 items past a 16-byte boundary, masks at another offset than the
    codes, every table width, tables of 1, 1000, 5 x 2^20 and 4^13
    entries, and the half total table (2^25 entries; codes, masked codes
    and as many ASCII rows, starting 0-3 rows in)."""
    import torch
    from aindex_torch.kernels.lookup import (gather13, gather13_plain, gather_tf,
                                             gather_tf_plain, gather_tf_total_13,
                                             gather_tf_total_13_plain)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(17)
    base = torch.randint(-2 ** 31, 2 ** 31, (4 + (1 << 20) + 3 + 4,), dtype=torch.int32,
                         device=dev, generator=gen)
    base[::3] &= SPACE - 1
    base[:5] = torch.tensor([SPACE - 1, SPACE, 2 ** 31 - 1, -2 ** 31, -1], dtype=torch.int32)
    vbase = torch.rand(base.numel(), device=dev, generator=gen) < 0.8
    rbase = torch.from_numpy(random_ascii(
        np.random.default_rng(17), base.numel() * K, b"ACGTacgtN\n~",
        [0.245, 0.245, 0.245, 0.245, 0.004, 0.004, 0.004, 0.004, 0.002, 0.001, 0.001]
    ).reshape(-1, K)).to(dev)
    n_checked = n_half = 0
    for bits, dtype, view in ((8, torch.uint8, None), (16, torch.int16, torch.uint16),
                              (32, torch.int32, torch.uint32)):
        lo, hi = (0, 256) if bits == 8 else (-2 ** (bits - 1), 2 ** (bits - 1))
        tables = [torch.randint(lo, hi, (n_t,), dtype=dtype, device=dev, generator=gen)
                  for n_t in (SPACE, 1, 1000, 5 << 20)]
        tables = [t.view(view) if view is not None else t for t in tables]
        half = tables[0][:HALF]
        for n in (*range(10), (1 << 20) + 3):
            for off in range(4):
                codes = base[off:off + n]
                rows = rbase[off:off + n]
                max_abs_err(gather13(half, ascii=rows), gather13_plain(half, ascii=rows))
                n_half += 1
                for voff in {off, (off + 1) % 4}:
                    valid = vbase[voff:voff + n]
                    for kw in ({"codes": codes}, {"codes": codes, "valid": valid}):
                        max_abs_err(gather13(half, **kw), gather13_plain(half, **kw))
                        n_half += 1
                    for both in (False, True):
                        for kw in ({"codes": codes}, {"codes": codes, "valid": valid}):
                            got = gather13(tables[0], both=both, **kw)
                            ref = gather13_plain(tables[0], both=both, **kw)
                            for a, b in zip(got, ref) if both else [(got, ref)]:
                                max_abs_err(a, b)
                    for t in tables:
                        max_abs_err(gather_tf(t, codes), gather_tf_plain(t, codes))
                        max_abs_err(gather_tf_total_13(t, codes, valid, 16),
                                    gather_tf_total_13_plain(t, codes, valid, 16))
                        n_checked += 2
    print(f"gather13 edge shapes == plain: {n_checked} table calls, the 4^13 modes and "
          f"{n_half} half-table calls at 0-9 and 2^20 + 3 codes, offsets 0-3 "
          f"({time.perf_counter() - t0:.1f} s, {card})")


def half_vs_full(dev, card: str, gen, inside) -> None:
    """K3 on the main path's traffic (``inside``: 4 x 2^24 codes, every one
    in range) in the two u8 total tables of one random count table (entries
    below 128, so the totals narrow to uint8): the full 4^13 table through
    ``gather13`` and its half (2^25) through ``gather13_half``, equal
    answers, timed in turns (full, half, half, full); with ``parent=DIR``
    the half also in turns with the parent's ``gather13`` on the full
    table."""
    import torch
    from aindex_torch.index.dense13 import _narrow, total13, total13_half
    from aindex_torch.kernels.lookup import gather13, gather13_plain
    tf = torch.randint(0, 128, (SPACE,), dtype=torch.int32, device=dev, generator=gen)
    full, half = _narrow(total13(tf)), _narrow(total13_half(tf))
    del tf
    check(full.dtype == half.dtype == torch.uint8, "u8 total tables")
    want = gather13_plain(full, inside)
    max_abs_err(gather13(half, inside), want)
    max_abs_err(gather13(full, inside), want)
    del want
    times = {"full": [], "half": []}
    for name in ("full", "half", "half", "full"):
        table = full if name == "full" else half
        times[name].append(cuda_ms(lambda: gather13(table, inside), 20))
    print(f"gather13 u8 codes in range, 4x2^24 codes, equal answers: full 4^13 table "
          f"{times['full'][0]:.4f} / {times['full'][1]:.4f} ms, half 2^25 table "
          f"{times['half'][0]:.4f} / {times['half'][1]:.4f} ms ({card})")
    SIDE_MS["gather13 u8 codes in range, 4x2^24: full table / half table, in turns"] = times
    if PARENT is not None:
        def parent_full():
            with parent_kernel("gather13"):
                return gather13(full, inside)
        SIDE_MS["gather13 u8 codes in range: half (this tree) / full (parent), in turns"] = \
            in_turns(card, "gather13 u8 codes in range, 4x2^24: the half table (this tree) "
                     "against the parent's on the full table",
                     lambda: gather13(half, inside), parent_full, 20)


# -- phase 4: the dense path end to end ----------------------------------------

def dense_path(dev, card: str, tmp: str, genome: np.ndarray, reads: np.ndarray,
               fasta: str, table: np.ndarray) -> None:
    import torch
    from aindex_torch import Dense13Index
    from aindex_torch.io.fastq import iter_sequence_bytes
    from aindex_torch.kernels import _cuda

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

    # codes-in total on 4 x 2^24 device codes, from the half total table
    # alone: one gather13_half launch a call
    gen = torch.Generator(device=dev).manual_seed(13)
    codes = torch.randint(0, SPACE, (N_CODES,), dtype=torch.int32, device=dev, generator=gen)
    got = index.get_total_tf_values_codes(codes)
    check(np.array_equal(got.view(torch.int32).cpu().numpy().view(np.uint32),
                         total[codes.cpu().numpy()]), "get_total_tf_values_codes")
    before = _cuda.launches()
    for _ in range(8):
        index.get_total_tf_values_codes(codes)
    after = _cuda.launches()
    diff = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    check(diff == {"gather13_half": 8}, f"8 dense total calls launch {diff}")
    half = index.tf_total_half
    check(half.shape == (HALF,) and index._tf_total_half is half, "the index holds the half table")
    ms = cuda_ms(lambda: index.get_total_tf_values_codes(codes), 20)
    print(f"dense get_total_tf_values_codes: {codes.numel()} device codes, "
          f"{codes.numel() / ms / 1e6:.2f} G queries/s ({ms:.4f} ms, CUDA events; "
          f"half table {half.dtype}[{half.numel()}], one gather13_half launch a call) ({card})")
    # the full total table, built on request (K2), keeps its values
    full = index.tf_total
    check(full.dtype == half.dtype and np.array_equal(
        full.cpu().numpy().astype(np.uint64), total.astype(np.uint64)), "tf_total == oracle")
    del full

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
    return index


# -- phase 4b: K1 as the dense build runs it, K2 on the corpus table ----------

def busy_ms(fn, reps: int) -> float:
    """Device time of ``fn``: the union of its device intervals (kernels,
    copies, fills) in a torch.profiler trace of ``reps`` calls, over
    ``reps``. Host time between them, when the card waits, is left out."""
    import torch
    from torch import profiler
    fn()
    torch.cuda.synchronize()
    with profiler.profile(activities=[profiler.ProfilerActivity.CPU,
                                      profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return device_busy_ms(prof)[0] / reps


def count_build_vs_plain(dev, card: str, reads: np.ndarray, table: np.ndarray) -> dict:
    """K1 at the dense build's shape: the corpus's packed chunks (the
    2^22-byte chunks of its sequence bytes, as the build cuts them) through
    one PackedCounter, from the first add to finish, exactly against the
    sum of the plain version over the same chunks (itself held to the
    oracle table), and again with a sixth of the windows a piece (several
    counts a build); timed by CUDA events and by the device's busy time, with the
    plain sum and, given a parent, the parent's one launch a chunk in
    turns. Then K2 exactly on the corpus table."""
    import torch
    from aindex_torch.core import codec
    from aindex_torch.core.reads import blob_chunks
    from aindex_torch.index.dense13 import total13, total13_plain
    from aindex_torch.kernels import count
    from aindex_torch.kernels.count import KERNEL, PackedCounter, count13_packed_plain

    chunks = [upload(dev, *codec.pack_ascii_chunk(piece))
              for piece, _ in blob_chunks(corpus_blob(reads), K, CHUNK_BYTES)]

    def build(counts, piece=None):
        """One counter over the chunks; a piece of ``piece`` windows in
        place of ``count.PIECE`` if given."""
        full = count.PIECE
        count.PIECE = piece or full
        try:
            counter = PackedCounter(counts)
        finally:
            count.PIECE = full
        for p, v in chunks:
            counter.add(p, v)
        return counter.finish()

    def plain_build(counts):
        for p, v in chunks:
            count13_packed_plain(counts, p, v)
        return counts

    plain = plain_build(torch.zeros(SPACE, dtype=torch.int32, device=dev))
    check(np.array_equal(plain.cpu().numpy().view(np.uint32), table),
          "the plain count of the corpus chunks == the oracle table")
    before = KERNEL.launches
    err = max_abs_err(build(torch.zeros(SPACE, dtype=torch.int32, device=dev))
                      .view(torch.uint32), plain.view(torch.uint32))
    check(KERNEL.launches - before == 1, "the corpus chunks counted at once")
    n_words = sum(p.numel() for p, _ in chunks)
    piece = 16 * n_words // 6
    before = KERNEL.launches
    err = max(err, max_abs_err(build(torch.zeros(SPACE, dtype=torch.int32, device=dev), piece)
                               .view(torch.uint32), plain.view(torch.uint32)))
    n_counts = KERNEL.launches - before
    check(n_counts > 1, f"a piece of {piece} windows counts the corpus {n_counts} times")
    del plain
    torch.cuda.empty_cache()
    print(f"kernel count13_packed [the corpus's {len(chunks)} chunks, {n_words} words, through "
          f"one counter; and a piece of {piece} windows: {n_counts} counts]: max_abs_err {err} "
          f"({card})")

    t = torch.zeros(SPACE, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    build(t)
    torch.cuda.synchronize()
    held = torch.cuda.max_memory_allocated(dev) - base
    ms = cuda_ms(lambda: build(t), 10)
    busy = busy_ms(lambda: build(t), 5)
    pms = cuda_ms(lambda: plain_build(t), 2)
    # the chunks in, and each table entry their windows touch read and written once
    rec = record(err, ms, pms, sum(4 * p.numel() + v.numel() for p, v in chunks)
                 + 8 * int(np.count_nonzero(table)))
    rec["timing"] = f"CUDA events, a build of {len(chunks)} chunks"
    report(card, "count13_packed", f"a build: the corpus's {len(chunks)} chunks, CUDA events",
           rec)
    print(f"count13_packed, a build: {ms:.4f} ms by CUDA events (host enqueue of the "
          f"{len(chunks)} adds included), {busy:.4f} ms device busy; the counter's buffer and "
          f"scratch at their peak {held} bytes ({card})")
    SIDE_MS["count13_packed: a build's count by CUDA events, device busy"] = {
        "this tree": [ms, busy]}
    if PARENT is not None:
        mine = torch.zeros(SPACE, dtype=torch.int32, device=dev)
        theirs = torch.zeros(SPACE, dtype=torch.int32, device=dev)

        def parent_build():
            with parent_kernel("count13_packed"):
                return build(theirs).view(torch.uint32)

        def this_build():
            return build(mine).view(torch.uint32)
        SIDE_MS["count13_packed: a build's chunks, in turns (CUDA events)"] = in_turns(
            card, f"count13_packed, the corpus's {len(chunks)} chunks", this_build,
            parent_build, 10)
        busy_turns = {"this tree": [], "parent": []}
        for name in ("this tree", "parent", "parent", "this tree"):
            busy_turns[name].append(busy_ms(this_build if name == "this tree" else parent_build,
                                            5))
        SIDE_MS["count13_packed: a build's chunks, in turns (device busy)"] = busy_turns
        print("count13_packed, the corpus chunks, device busy: " + "; ".join(
            f"{k} " + " / ".join(f"{x:.4f}" for x in v) for k, v in busy_turns.items())
              + f" ms ({card})")
        del mine, theirs
    del t, chunks
    torch.cuda.empty_cache()

    tf = torch.from_numpy(table.view(np.int32)).to(dev).view(torch.uint32)
    err = max_abs_err(total13(tf), total13_plain(tf))
    print(f"kernel total13 [the corpus table]: max_abs_err {err} ({card})")
    return {"count13_packed": rec}


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


def sort_edges_vs_plain(dev, card: str) -> None:
    """K5's keys mode and K13 against their plain versions, exactly, at the
    shapes where the onesweep sort's tiles and look-back could break: one
    live key, all keys equal, nothing live, live counts of one tile and one
    tile +- 1, a cap that is no multiple of the tile, keys over all 64 bits
    (8 passes), 4 x 2^24 keys; K13 with uint32 and uint64 weights whose
    sums pass 2^32 and wrap at 2^64, and with key ranges."""
    import torch
    from aindex_torch.kernels.spectrum import (ONESWEEP_TILE, sorted_spectrum_weighted,
                                               sorted_spectrum_weighted_plain, spectrum23,
                                               spectrum23_plain)
    rng = np.random.default_rng(71)
    tile = ONESWEEP_TILE
    sentinel = np.uint64(2 ** 64 - 1)

    def live_among_sentinels(n_live: int, cap: int) -> np.ndarray:
        keys = np.full(cap, sentinel)
        keys[np.sort(rng.permutation(cap)[:n_live])] = rng.integers(0, 1 << 46, size=n_live,
                                                                     dtype=np.uint64) % 5000
        return keys

    dups = rng.integers(0, 2 ** 64 - 1, size=700, dtype=np.uint64)
    mixed = dups[rng.integers(0, dups.size, size=5 * tile + 11)]
    mixed[rng.random(mixed.size) < 0.2] = sentinel
    shapes = [
        ("1 live key", np.array([12345], np.uint64)),
        ("1 live key among tile + 3 sentinels", live_among_sentinels(1, tile + 3)),
        ("all 3 x tile + 5 keys equal", np.full(3 * tile + 5, 99, np.uint64)),
        ("all 2 x tile + 1 keys the sentinel", np.full(2 * tile + 1, sentinel)),
        *((f"{n} live of 2 x tile", live_among_sentinels(n, 2 * tile))
          for n in (tile - 1, tile, tile + 1)),
        ("cap 5 x tile + 11, 20% sentinels, 700 distinct 64-bit keys", mixed),
        ("2^20 keys over all 64 bits", rng.integers(0, 2 ** 64, size=1 << 20, dtype=np.uint64)),
        ("4 x 2^24 keys of 2^25 values", rng.integers(0, 1 << 46, size=N_CODES, dtype=np.uint64)
         % np.uint64(1 << 25)),
    ]
    for tag, host in shapes:
        t0 = time.perf_counter()
        keys = torch.from_numpy(host.view(np.int64)).to(dev)
        err = max(max_abs_err(a, b) for a, b in zip(spectrum23(keys=keys),
                                                     spectrum23_plain(keys=keys)))
        w32 = torch.from_numpy(rng.integers(0, 2 ** 32, size=host.size, dtype=np.uint64)
                               .astype(np.uint32).view(np.int32)).to(dev).view(torch.uint32)
        w64 = torch.from_numpy(rng.integers(0, 2 ** 64, size=host.size, dtype=np.uint64)
                               .view(np.int64)).to(dev)
        for w, (lo, hi) in itertools.product((w32, w64), ((0, 2 ** 64 - 1), (1 << 40, 1 << 45),
                                                           (2 ** 63, 2 ** 64 - 1))):
            err = max(err, *(max_abs_err(a, b) for a, b in zip(
                sorted_spectrum_weighted(keys, w, lo, hi),
                sorted_spectrum_weighted_plain(keys, w, lo, hi))))
        print(f"K5 keys mode and K13 (uint32/uint64 weights, 3 ranges) [{tag}]: max_abs_err "
              f"{err} ({time.perf_counter() - t0:.1f} s, {card})")
        del keys, w32, w64
    # weight sums past 2^32 (uint32 in) and past 2^64 (uint64 in, wrapping)
    keys = torch.full((2 * tile + 9,), 5, dtype=torch.int64, device=dev)
    keys[::3] = 6
    for w in (torch.full_like(keys, -1, dtype=torch.int32).view(torch.uint32),
              torch.full_like(keys, 2 ** 63 + 1 - 2 ** 64)):
        got = sorted_spectrum_weighted(keys, w)
        err = max(max_abs_err(a, b) for a, b in zip(got, sorted_spectrum_weighted_plain(keys, w)))
        print(f"K13 [{keys.numel()} keys of 2 values, {w.dtype} weights, sums "
              f"{[int(x) & (2 ** 64 - 1) for x in got[1][:2].tolist()]}]: max_abs_err {err} ({card})")
    torch.cuda.empty_cache()


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
    print(f"sparse index: n {index.n}, quotient table m 2^{index.quot.lb} rows per half, "
          f"{index.quot.nbytes / 1e6:.1f} MB; device records "
          f"{tables.records.numel() * 4 / 1e6:.1f} MB")

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
    real_coverage = sparse23.probe.coverage

    def coverage_seen(t, packed, vbits, rows, stride, *args):
        k7_shapes.add((rows, stride))
        return real_coverage(t, packed, vbits, rows, stride, *args)

    sparse23.probe.coverage = coverage_seen
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
    sparse23.probe.coverage = real_coverage
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
                                             packed_window_codes, revcomp_code64, window_codes)
    from aindex_torch.kernels.probe import CANON, FWD_RC
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
    n_probe = {False: distinct_probed_rows(index, canon),
               True: distinct_probed_rows(index, canon[valid])}
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
    # the forward-else-reverse-complement rule of reference-keyed indexes:
    # the forward probes, then the reverse complements of their misses
    kw = {"codes": codes, "rule": FWD_RC, "slot": True, "strand": True}
    got, ref = quot23(t, k=K23, **kw), quot23_plain(t, k=K23, **kw)
    err = max(max_abs_err(a, b) for a, b in zip(got, ref))
    ms = cuda_ms(lambda: quot23(t, k=K23, **kw), 20)
    pms = cuda_ms(lambda: quot23_plain(t, k=K23, **kw), 2)
    miss = ~t.probe_plain(codes)[0]
    n_fr = distinct_probed_rows(index, torch.cat([codes, revcomp_code64(codes[miss], K23)]))
    rec = record(err, ms, pms, n_codes * (8 + 12) + n_fr * 12)
    report(card, "quot23", f"codes, forward else reverse complement, tf+slot+strand, "
           f"{n_codes} codes", rec)
    k6.append(("codes, fwd-rc, tf+slot+strand", rec))
    del miss, got, ref
    row_codes, row_valid = window_codes(ascii_to_base_codes(rows), K23)
    ascii_probe = distinct_probed_rows(
        index, canonical_code64(row_codes.reshape(-1)[row_valid.reshape(-1)], K23))
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
    sector_mix(card, f"K6 batch ({n_codes} codes, canonical, half present)", index,
               canonical_code64(codes, K23))
    device_table_bytes(card, index)
    if PARENT:
        old = parent_tables(dev, index)
        for tag, rule, with_slot in (("codes, tf", CANON, False),
                                     ("codes, tf+slot+strand", CANON, True),
                                     ("codes, fwd-rc, tf+slot+strand", FWD_RC, True)):
            parent_vs_this(dev, card, f"quot23 {tag}, {n_codes} codes",
                           parent_engines(PARENT)["quot23"], old, t, codes, K23, rule,
                           with_slot, with_slot)
        del old
    else:
        print(f"parent: not given ({PARENT_ARG}DIR times a checkout's K6, K10, K14 and K15 beside these)")
    engine_edges_vs_plain(dev, card, index)
    del codes, valid, picks, sample

    # K7: 10,000 reads of the corpus, cutoff 0 and 10, packed as
    # sequence_coverage_batch packs them on the sparse path (one launch of
    # 10,000 rows of stride 151, which sparse_path checks)
    [(members, stride, packed, vbits)] = codec.coverage_row_batches(
        [row.tobytes() for row in reads[:N_SEQ]], K23)
    n_rows = len(members)
    packed, vbits = upload(dev, packed, vbits)
    wcodes, wvalid = packed_window_codes(packed, vbits, K23)
    n_probe = distinct_probed_rows(index, canonical_code64(wcodes[wvalid], K23))
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
    del wcodes, wvalid
    engine_coverage_clocks(card, index, "quotcov23", coverage_batches(dev, reads, K23))
    engine_coverage_edges_vs_plain(dev, card, index, reads)
    coverage_stages(dev, card, f"quotient table k={K23}", K23, "quotcov23",
                    lambda p, v, rows, stride: quotcov23(t, p, v, rows, stride, K23, 0),
                    lambda seqs: index.sequence_coverage_batch(seqs),
                    [row.tobytes().decode("ascii") for row in reads[:N_SEQ]])
    return res


# -- phase 8: the ASCII-in and codes-in functions end to end -------------------

ASCII_KERNELS = ("scatter_count", "count13_rows", "gather13_table", "gather13_total",
                 "spectrum23_ascii", "canonical23_ascii", "quotcov23_rows")


def read_batches(reads: np.ndarray):
    """Row batches of the read matrix of about CHUNK_BYTES bytes each."""
    rows = max(1, CHUNK_BYTES // READ_LEN)
    return [reads[i:i + rows] for i in range(0, len(reads), rows)]


def ascii_path(dev, card: str, reads: np.ndarray, table: np.ndarray, oracle, index) -> None:
    """The unpacked functions on the corpus at full size, each against the
    packed kernels of the same data and the numpy oracles: count_batch_13
    over the read matrix, chunk_spectrum (with _extract_canonical) over the
    corpus blob, quot_tf_windows on 10,000 reads, gather_tf and
    gather_tf_total_13 on 4 x 2^24 codes, scatter_count on every window."""
    import torch
    from aindex_torch.core import codec
    from aindex_torch.core.reads import blob_chunks
    from aindex_torch.index.dense13 import _count_step, total13
    from aindex_torch.index.sparse23 import _extract_canonical
    from aindex_torch.kernels.count import count_batch_13, scatter_count, zeros_dev
    from aindex_torch.kernels.lookup import gather13, gather_tf, gather_tf_total_13
    from aindex_torch.kernels.quot import quot_tf_windows, quotcov23
    from aindex_torch.kernels.spectrum import chunk_spectrum, merge_spectra, spectrum23

    keys, counts = oracle
    n_bases = reads.size
    table_dev = torch.from_numpy(table.view(np.int32)).to(dev).view(torch.uint32)

    # count_batch_13 over the read matrix in row batches (_count_step on
    # every other one: the same function at k = 13)
    batches = read_batches(reads)
    counts13 = zeros_dev(SPACE, torch.int32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        rows = torch.from_numpy(batch).to(dev)
        (_count_step if i % 2 else count_batch_13)(counts13, rows)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool((counts13 == table_dev.view(torch.int32)).all()),
          "count_batch_13 table == oracle table (== the dense path's)")
    print(f"ascii count_batch_13: {len(batches)} row batches of {len(batches[0])} x {READ_LEN}, "
          f"{dt:.3f} s, {n_bases / dt / 1e6:.2f} MB/s of bases (host clock, uploads "
          f"included) ({card})")
    del counts13

    # chunk_spectrum over the corpus blob's chunks, each against K5 on the
    # same chunk packed; _extract_canonical on the first, against its
    # spectrum; the merged spectrum against the oracle
    parts = []
    t_spec = 0.0
    for i, (piece, _) in enumerate(blob_chunks(corpus_blob(reads), K23, CHUNK_BYTES)):
        ascii = torch.from_numpy(piece).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_keys, got_counts, got_n = chunk_spectrum(ascii, K23)
        n = int(got_n)
        t_spec += time.perf_counter() - t0
        ref_keys, ref_counts, ref_n = spectrum23(*upload(dev, *codec.pack_ascii_chunk(piece)),
                                                 K23)
        check(n == int(ref_n) and bool((got_keys[:n] == ref_keys[:n]).all())
              and bool((got_counts[:n].view(torch.int32) == ref_counts[:n].view(torch.int32))
                       .all()) and bool((got_keys[n:] == -1).all()),
              f"chunk_spectrum == K5 on chunk {i}")
        if i == 0:
            canon, valid = _extract_canonical(ascii, K23)
            u, c = torch.unique(canon[valid], return_counts=True)   # keys < 2^46: signed order
            check(u.numel() == n and bool((u == got_keys[:n]).all())
                  and bool((c == bits64(got_counts[:n])).all()),
                  "_extract_canonical's windows == chunk_spectrum of chunk 0")
        parts.append((got_keys[:n].cpu().numpy().view(np.uint64),
                      got_counts[:n].view(torch.int32).cpu().numpy().view(np.uint32)))
    merged_keys, merged_counts = merge_spectra(parts)
    check(np.array_equal(merged_keys, keys) and np.array_equal(merged_counts, counts),
          f"merged chunk_spectrum ({merged_keys.size} keys) == oracle ({keys.size})")
    print(f"ascii chunk_spectrum: {len(parts)} corpus chunks of 2^22 B, merged "
          f"{merged_keys.size} canonical 23-mers == oracle; {t_spec / len(parts) * 1e3:.3f} ms "
          f"a chunk (host clock, synchronised) ({card})")
    del parts, merged_keys, merged_counts

    # quot_tf_windows on 10,000 reads, against K7 on the same reads packed
    # and the oracle
    t = index.tables
    mat = torch.from_numpy(reads[:N_SEQ]).to(dev)
    got = quot_tf_windows(t, mat, K23)
    [(members, stride, packed, vbits)] = codec.coverage_row_batches(
        [row.tobytes() for row in reads[:N_SEQ]], K23)
    ref = quotcov23(t, *upload(dev, packed, vbits), len(members), stride, K23)
    wf, wr, wok = oracle_windows23(reads[:N_SEQ])
    want = np.where(wok, oracle_lookup(keys, counts, np.minimum(wf, wr)), 0).astype(np.uint32)
    check(got.shape == ref.shape and bool((got.view(torch.int32) == ref.view(torch.int32)).all()),
          "quot_tf_windows == K7")
    check(np.array_equal(got.view(torch.int32).cpu().numpy().view(np.uint32), want),
          "quot_tf_windows == oracle")
    ms = cuda_ms(lambda: quot_tf_windows(t, mat, K23), 20)
    print(f"ascii quot_tf_windows: {N_SEQ} x {READ_LEN} reads, {ms:.4f} ms, "
          f"{N_SEQ / ms * 1e3:.0f} sequences/s (CUDA events) ({card})")

    # gather_tf and gather_tf_total_13 on 4 x 2^24 device codes against K3
    # and K2's total table
    gen = torch.Generator(device=dev).manual_seed(47)
    codes = torch.randint(0, SPACE, (N_CODES,), dtype=torch.int32, device=dev, generator=gen)
    valid = torch.rand(N_CODES, device=dev, generator=gen) < 0.9
    got = gather_tf(table_dev, codes)
    check(got.dtype == torch.uint32 and bool((got.view(torch.int32) == gather13(
        table_dev, codes).view(torch.int32)).all()), "gather_tf == K3")
    got = gather_tf_total_13(table_dev, codes, valid)
    total = total13(table_dev)
    check(bool((got.view(torch.int32) == gather13(total, codes, valid).view(torch.int32)).all()),
          "gather_tf_total_13 == K3 on K2's total table")
    for name, fn in (("gather_tf", lambda: gather_tf(table_dev, codes)),
                     ("gather_tf_total_13", lambda: gather_tf_total_13(table_dev, codes, valid))):
        ms = cuda_ms(fn, 20)
        print(f"ascii {name}: {N_CODES} device codes, {N_CODES / ms / 1e6:.2f} G queries/s "
              f"({ms:.4f} ms, CUDA events) ({card})")
    del codes, valid, got, total

    # scatter_count of every 13-mer window of the corpus in one call
    codes, valid = corpus_windows13(dev, reads)
    got = scatter_count(codes, valid)
    check(bool((got.view(torch.int32) == table_dev.view(torch.int32)).all()),
          "scatter_count of the corpus windows == oracle table")
    ms = cuda_ms(lambda: scatter_count(codes, valid), 5)
    print(f"ascii scatter_count: {codes.numel()} window codes, {ms:.4f} ms (CUDA events) "
          f"({card})")


def corpus_windows13(dev, reads: np.ndarray):
    """(int32 codes, bool valid) of every 13-mer window of the read matrix,
    made on the card batch by batch."""
    import torch
    from aindex_torch.kernels.encode import ascii_to_base_codes, window_codes
    codes, valid = [], []
    for batch in read_batches(reads):
        c, v = window_codes(ascii_to_base_codes(torch.from_numpy(batch).to(dev)), K)
        codes.append(c.reshape(-1).to(torch.int32))
        valid.append(v.reshape(-1))
    return torch.cat(codes), torch.cat(valid)


# -- phase 9: the ASCII-in and codes-in kernels against their plain versions ---

def ascii_kernels_vs_plain(dev, card: str, reads: np.ndarray, table: np.ndarray, index) -> dict:
    import torch
    from aindex_torch.kernels import _cuda
    from aindex_torch.kernels.count import (BIN_W, scatter_count, scatter_count_plain,
                                            scatter_scratch_bytes)
    from aindex_torch.kernels.encode import (ascii_to_base_codes, canonical_code64,
                                             revcomp_code13, window_codes)
    from aindex_torch.kernels.lookup import (gather_tf, gather_tf_plain, gather_tf_total_13,
                                             gather_tf_total_13_plain, jax_index)
    from aindex_torch.kernels.quot import quot_tf_windows, quot_tf_windows_plain
    from aindex_torch.kernels.spectrum import (ascii_canonical, ascii_canonical_plain,
                                               chunk_spectrum, chunk_spectrum_plain)
    from aindex_torch.core.reads import blob_chunks

    rng = np.random.default_rng(53)
    gen = torch.Generator(device=dev).manual_seed(53)
    res = {}

    def held(name, tag, fn, plain, reps, pms_reps, n_bytes, lib=None, timed=True):
        """Check fn against plain; time both (and the library call) when
        timed, else fold the check into the timed record of the name."""
        got, ref = fn(), plain()
        pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
        err = max(max_abs_err(a, b) for a, b in pairs)
        if not timed:
            print(f"kernel {name} [{tag}]: max_abs_err {err} ({card})")
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
            return
        rec = record(err, cuda_ms(fn, reps), cuda_ms(plain, pms_reps), n_bytes,
                     None if lib is None else cuda_ms(lib, reps))
        report(card, name, tag, rec)
        res[name] = rec

    # an adversarial chunk: N runs, lowercase, '~', newlines and every byte value
    mixed = random_ascii(rng, CHUNK_BYTES, b"ACGTacgtN~",
                         [0.24, 0.24, 0.24, 0.24, 0.005, 0.005, 0.01, 0.005, 0.005, 0.005])
    mixed[150::151] = ord("\n")
    mixed[rng.permutation(mixed.size)[:4096]] = np.arange(4096) % 256
    mixed_dev = torch.from_numpy(mixed).to(dev)

    res["count13_rows"] = rows_count_vs_plain(dev, card, reads, mixed_dev)

    # K15: every window of the corpus in one call, as the path calls it
    # (beside the parent's K15 in turns, given a parent); the corpus codes
    # skewed, 90% of them 0 at weight 255 (entry 0 wraps past 2^32); then
    # the edge codes over the whole uint32 range into 16 entries, and codes
    # on every bin edge of the spaces around K15's bins and rounds
    codes, valid = corpus_windows13(dev, reads)
    weights = valid.to(torch.float32)
    held("scatter_count", f"{codes.numel()} corpus window codes",
         lambda: scatter_count(codes, valid), lambda: scatter_count_plain(codes, valid), 5, 2,
         5 * codes.numel() + 4 * SPACE,
         lambda: torch.bincount(codes, weights=weights, minlength=SPACE))
    del weights
    if PARENT is not None:
        fn = parent_engines(PARENT)["scatter_count"]
        held_scratch = torch.empty(scatter_scratch_bytes(codes.numel(), SPACE),
                                   dtype=torch.uint8, device=dev)

        def parent_scatter():
            counts = torch.empty(SPACE, dtype=torch.int32, device=dev)
            check(fn(counts.data_ptr(), codes.data_ptr(), valid.data_ptr(), codes.numel(), SPACE,
                     held_scratch.data_ptr(), _cuda.stream(dev)) == 0,
                  "the parent's scatter_count")
            return counts.view(torch.uint32)
        SIDE_MS["scatter_count: corpus codes, in turns"] = in_turns(
            card, "scatter_count, corpus windows", lambda: scatter_count(codes, valid),
            parent_scatter, 5)
        del held_scratch
    skew = torch.where(torch.rand(codes.numel(), device=dev, generator=gen) < 0.9, 0, codes)
    w255 = torch.full_like(valid, 255, dtype=torch.uint8)
    err = max_abs_err(scatter_count(skew, w255), scatter_count_plain(skew, w255))
    ms = cuda_ms(lambda: scatter_count(skew, w255), 5)
    pms = cuda_ms(lambda: scatter_count_plain(skew, w255), 2)
    SIDE_MS["scatter_count: 90% of the corpus codes 0, weight 255"] = {"this tree": [ms]}
    print(f"kernel scatter_count [{codes.numel()} corpus window codes, 90% set to 0, weight "
          f"255]: max_abs_err {err}, kernel {ms:.4f} ms, plain {pms:.4f} ms ({card})")
    del codes, valid, skew, w255
    edges = torch.tensor(np.array([0, 15, 16, 2 ** 31 + 3, 2 ** 32 - 1, 2 ** 31 - 1, 2 ** 32 - 16,
                                   2 ** 32 - 17], np.uint32).view(np.int32), device=dev)
    wild = torch.cat([edges, torch.randint(-2 ** 31, 2 ** 31, (1 << 20,), dtype=torch.int32,
                                           device=dev, generator=gen)])
    wild_valid = torch.rand(wild.numel(), device=dev, generator=gen) < 0.9
    wild_valid[:edges.numel()] = True
    held("scatter_count", "edge and random uint32 codes, space 16",
         lambda: scatter_count(wild, wild_valid, 16),
         lambda: scatter_count_plain(wild, wild_valid, 16), 0, 0, 0, timed=False)
    for space in (BIN_W - 1, BIN_W, BIN_W + 1, (1 << 18) + 1, SPACE, (1 << 26) + 1):
        bin_edges = torch.tensor(np.array(
            [e % 2 ** 32 for b in range(0, space + BIN_W + 1, BIN_W) for e in (b - 1, b, b + 1)]
            + [space - 1, space, 2 ** 32 - space, 2 ** 32 - space - 1], np.uint64)
            .astype(np.uint32).view(np.int32), device=dev)
        spread = torch.cat([bin_edges, torch.randint(0, space, (1 << 22,), dtype=torch.int32,
                                                     device=dev, generator=gen), wild])
        w = torch.randint(0, 256, (spread.numel(),), dtype=torch.uint8, device=dev,
                          generator=gen)
        held("scatter_count", f"space {space}: every bin edge, 2^22 codes in range, the wild "
             "codes, uint8 weights", lambda: scatter_count(spread, w, space),
             lambda: scatter_count_plain(spread, w, space), 0, 0, 0, timed=False)

    # K3's table-length entries: 4 x 2^24 codes over the whole uint32 range
    # (half in range, the edges first) on the 4^13 uint32 table, and a
    # 16-entry uint16 table
    table_dev = torch.from_numpy(table.view(np.int32)).to(dev).view(torch.uint32)
    codes = torch.randint(-2 ** 31, 2 ** 31, (N_CODES,), dtype=torch.int32, device=dev,
                          generator=gen)
    codes[N_CODES // 2:] &= SPACE - 1
    codes[:edges.numel()] = edges
    valid = torch.rand(N_CODES, device=dev, generator=gen) < 0.9
    index_fwd = jax_index(codes)
    index_rc = jax_index(revcomp_code13(codes))
    n_fwd = int(torch.unique(index_fwd).numel())
    n_both = int(torch.unique(torch.cat([index_fwd[valid], index_rc[valid]])).numel())
    del index_rc
    # codes in, answers out, each table entry they reach read once
    held("gather13_table", "u32 4^13 table, 4x2^24 codes", lambda: gather_tf(table_dev, codes),
         lambda: gather_tf_plain(table_dev, codes), 20, 2, 8 * N_CODES + 4 * n_fwd,
         lambda: torch.take(table_dev.view(torch.int32), index_fwd))
    held("gather13_total", "u32 4^13 table, 4x2^24 codes + mask, k=13",
         lambda: gather_tf_total_13(table_dev, codes, valid),
         lambda: gather_tf_total_13_plain(table_dev, codes, valid), 20, 2,
         9 * N_CODES + 4 * n_both)
    small = torch.randint(0, 1 << 16, (16,), dtype=torch.int32, device=dev,
                          generator=gen).to(torch.int16).view(torch.uint16)
    for k in (13, 16, 2):
        held("gather13_total", f"u16 16-entry table, k={k}",
             lambda: gather_tf_total_13(small, codes, valid, k),
             lambda: gather_tf_total_13_plain(small, codes, valid, k), 0, 0, 0, timed=False)
    held("gather13_table", "u16 16-entry table", lambda: gather_tf(small, codes),
         lambda: gather_tf_plain(small, codes), 0, 0, 0, timed=False)
    del codes, valid, index_fwd

    # K5's ASCII entries: the first corpus chunk of the blob, then the
    # mixed chunk (1-D, and as [B, L] rows) at k = 23 and 31
    piece, _ = next(iter(blob_chunks(corpus_blob(reads), K23, CHUNK_BYTES)))
    chunk = torch.from_numpy(piece).to(dev)
    canon, valid = ascii_canonical_plain(chunk, K23)
    live = canon[valid]
    n_win = canon.numel()
    # the chunk in; padded keys (8 B) and counts (4 B) out
    held("spectrum23_ascii", f"corpus chunk 2^22 B, {live.numel()} valid windows",
         lambda: chunk_spectrum(chunk, K23), lambda: chunk_spectrum_plain(chunk, K23), 20, 3,
         chunk.numel() + 12 * n_win,
         lambda: torch.unique(live, sorted=True, return_counts=True))
    # the chunk in; a key (8 B) and a flag (1 B) out per window
    held("canonical23_ascii", "corpus chunk 2^22 B", lambda: ascii_canonical(chunk, K23),
         lambda: ascii_canonical_plain(chunk, K23), 20, 3, chunk.numel() + 9 * n_win)
    del canon, valid, live
    for k in (K23, 31):
        for tag, x in (("mixed chunk 1-D", mixed_dev), ("mixed chunk as 4096 x 1024 rows",
                                                        mixed_dev.view(-1, 1024))):
            held("spectrum23_ascii", f"{tag}, k={k}", lambda: chunk_spectrum(x, k),
                 lambda: chunk_spectrum_plain(x, k), 0, 0, 0, timed=False)
            held("canonical23_ascii", f"{tag}, k={k}", lambda: ascii_canonical(x, k),
                 lambda: ascii_canonical_plain(x, k), 0, 0, 0, timed=False)

    # K7's ASCII-rows entry: 10,000 reads, as the path calls it; then the
    # mixed chunk's rows
    t = index.tables
    mat = torch.from_numpy(reads[:N_SEQ]).to(dev)
    wcodes, wvalid = window_codes(ascii_to_base_codes(mat), K23)
    n_probe = distinct_probed_rows(index, canonical_code64(wcodes[wvalid], K23))
    # the rows in, tf out, each probed row read once
    held("quotcov23_rows", f"{N_SEQ} x {READ_LEN} reads", lambda: quot_tf_windows(t, mat, K23),
         lambda: quot_tf_windows_plain(t, mat, K23), 50, 5,
         mat.numel() + 4 * wcodes.numel() + 8 * n_probe)
    rows = mixed_dev.view(-1, 1024)
    held("quotcov23_rows", "mixed chunk as 4096 x 1024 rows",
         lambda: quot_tf_windows(t, rows, K23), lambda: quot_tf_windows_plain(t, rows, K23),
         0, 0, 0, timed=False)
    return res


def rows_count_vs_plain(dev, card: str, reads: np.ndarray, mixed_dev) -> dict:
    """K16 (count13_rows) held exactly to count_batch_13_plain: on the
    path's first row batch (k = 13 into the 4^13 table, timed, beside its
    read-modify-write floors from rmw_test), then at the shapes where its
    routes, source and partition could break; with ``parent=DIR``, beside
    the parent's on 8 row batches (``clocks``, in turns, after equal
    tables). Returns the batch's record."""
    import torch
    from aindex_torch.kernels.count import PIECE, count_batch_13, count_batch_13_plain
    from aindex_torch.kernels.encode import ascii_to_base_codes, window_codes

    def held(tag, rows, k=K, space=SPACE, start=None):
        kern = (torch.zeros(space, dtype=torch.int32, device=dev) if start is None
                else start.clone())
        plain = kern.clone()
        err = max_abs_err(count_batch_13(kern, rows, k, space).view(torch.uint32),
                          count_batch_13_plain(plain, rows, k, space).view(torch.uint32))
        print(f"kernel count13_rows [{tag}, {tuple(rows.shape)}, k={k}, space {space}]: "
              f"max_abs_err {err} ({card})")
        return err

    batches = [torch.from_numpy(b).to(dev) for b in read_batches(reads)[:N_COLD]]
    batch = batches[0]
    codes13, valid13 = window_codes(ascii_to_base_codes(batch), K)
    touched = int(torch.unique(codes13[valid13]).numel())
    n_valid = int(valid13.sum())
    del codes13, valid13
    gen = torch.Generator(device=dev).manual_seed(59)
    near = torch.zeros(SPACE, dtype=torch.int32, device=dev)
    near[torch.randint(0, SPACE, (1 << 16,), device=dev, generator=gen)] = -2  # 2^32 - 2
    err = held("the path's first row batch, from a table near 2^32", batch, start=near)
    del near
    scratch = torch.zeros(SPACE, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: count_batch_13(scratch, batch), 50)
    pms = cuda_ms(lambda: count_batch_13_plain(scratch, batch), 5)
    # the rows in, and each table entry their windows touch read and written once
    rec = record(err, ms, pms, batch.numel() + 8 * touched)
    report(card, "count13_rows", f"{batch.shape[0]} x {batch.shape[1]} rows, k=13", rec)
    floors = {o: n_valid / RMW_RATE[(26, RMW_NS[0], o)] * 1e3
              for o in ("random", "bins of 2^15", "sorted")}
    print(f"count13_rows floors: its {n_valid} adds at this run's rates (rmw_test, "
          f"{RMW_NS[0]} adds into 2^26 entries): " + ", ".join(
              f"{o} {v:.4f} ms" for o, v in floors.items()) + f" ({card})")
    SIDE_MS["count13_rows: the adds' floors (random, bins of 2^15, sorted)"] = {
        "this tree": list(floors.values())}

    # the edge shapes
    acgt = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
    poly = torch.full((4096, READ_LEN), ord("A"), dtype=torch.uint8, device=dev)
    poly[7, 40] = ord("C")
    err = max(err, held("poly-A rows: code 0 fills whole tiles, past 2^18 windows", poly))
    err = max(err, held("poly-A rows, into 2^22", poly, space=1 << 22))
    rows_k = acgt[torch.randint(0, 4, (1 << 17, K), device=dev, generator=gen)]
    err = max(err, held("rows of exactly k bytes", rows_k))
    err = max(err, held("rows of exactly k bytes, k=16", acgt[torch.randint(
        0, 4, (1 << 17, 16), device=dev, generator=gen)], 16))
    err = max(err, held("the mixed chunk, 1-D", mixed_dev))
    flat = batch.reshape(-1)
    n_view = min(4000, batch.shape[0] - 1)
    for off in range(1, 16):
        view = flat[off:off + n_view * READ_LEN].view(n_view, READ_LEN)
        err = max(err, held(f"a view {off} bytes past the batch's start", view))
    rows = mixed_dev.view(-1, 1024)
    red_space = 1 << 22   # csrc/count13.cu bins::RED_SPACE: the largest table of the rows' REDs
    for k, space, tag in ((13, red_space + 7, "a space no multiple of the bin width"),
                          (7, 4 ** 7 - 1000, "a space below the bin width"),
                          (7, 4 ** 7, "4^7, the shared histogram"),
                          (13, 3 * 2 ** 15 + 7, "3 x 2^15 + 7, the rows' REDs"),
                          (16, red_space, "k=16 wrapping, the rows' REDs"),
                          (16, (1 << 26) + 1, "k=16 wrapping, the sweep")):
        err = max(err, held(tag, rows, k, space))
    big = acgt[torch.randint(0, 4, (PIECE // READ_LEN + 4096, READ_LEN), device=dev,
                             generator=gen)]
    err = max(err, held("more than 2^27 windows: 31 tiles a sweep block", big))
    del poly, rows_k, big
    rec["max_abs_err"] = err

    if PARENT is not None:
        mine = torch.zeros(SPACE, dtype=torch.int32, device=dev)
        theirs = torch.zeros(SPACE, dtype=torch.int32, device=dev)
        for b in batches:
            count_batch_13(mine, b)
            with parent_kernel("count13_rows"):
                count_batch_13(theirs, b)
        max_abs_err(mine.view(torch.uint32), theirs.view(torch.uint32))
        print(f"count13_rows, the parent's: equal tables after {len(batches)} row batches "
              f"({card})")
        del mine, theirs
        clocks(card, f"{batch.shape[0]} x {batch.shape[1]} rows, k=13", "count13_rows",
               lambda b: count_batch_13(scratch, batches[b]), len(batches),
               floors["bins of 2^15"], sum(b.numel() for b in batches),
               kernel=("rows_sweep", "count13_rows"), floor_what="bin-order add floor",
               footprint_what="rows", compare=False)
    del scratch
    return rec


# -- phase 9b: the staged ASCII front end (quotcov23_rows, canonical23_ascii) --

def ascii_edges(dev, rows_of, k: int) -> list:
    """(tag, uint8 rows on the card) of the shapes where the staged ASCII
    front end (csrc/dna23.cuh AsciiSource and tile_run) could break, rows
    from ``rows_of(n, length)``: rows of k and of k + 1 bytes (one and two
    windows a row), 64 rows of 30 bytes (narrower than a tile; k <= 30),
    one row of 2^16 + 5 bytes, rows of all N, lowercase and N mixed in, 7
    rows of 100 (a last tile that ends mid-run), and a [4096, 1024] view of
    a 1-D buffer at a 3-byte offset (its rows off 16-byte alignment)."""
    import torch
    rng = np.random.default_rng(k)
    mats = [(f"5000 rows of k = {k} bytes", rows_of(5000, k)),
            (f"5000 rows of k + 1 = {k + 1} bytes", rows_of(5000, k + 1))]
    if k <= 30:
        mats.append(("64 rows of 30 bytes", rows_of(64, 30)))
    mats.append(("one row of 2^16 + 5 bytes", rows_of(1, (1 << 16) + 5).reshape(-1)))
    mats.append((f"40 rows of {READ_LEN + 1} N", np.full((40, READ_LEN + 1), ord("N"), np.uint8)))
    mixed = rows_of(64, READ_LEN + 1)
    mixed[rng.random(mixed.shape) < 0.3] |= 0x20
    mixed[rng.random(mixed.shape) < 0.02] = ord("N")
    mats.append((f"64 rows of {READ_LEN + 1}, lowercase and N mixed in", mixed))
    mats.append(("7 rows of 100, the last tile ending mid-run", rows_of(7, 100)))
    out = [(tag, torch.from_numpy(np.ascontiguousarray(m)).to(dev)) for tag, m in mats]
    buf = torch.from_numpy(rows_of(1, 4096 * 1024 + 3).reshape(-1)).to(dev)
    view = buf[3:].view(4096, 1024)
    check(view.is_contiguous() and view.data_ptr() % 16 == 3, "a view 3 bytes past alignment")
    out.append(("[4096, 1024] view of a 1-D buffer at a 3-byte offset", view))
    return out


def ascii_front_end(dev, card: str, reads: np.ndarray, index) -> None:
    """The two kernels on the staged ASCII front end: canonical23_ascii at
    k = 11, 23 and 31 and quotcov23_rows at k = 23 held exactly to their
    plain versions at ascii_edges' shapes (rows cut from the corpus reads,
    0.3% N) and on a 2^22-byte corpus chunk as one row; then each timed
    four ways (clocks), with parent=DIR beside the parent's entry in turns:
    quotcov23_rows on N_COLD batches of 10,000 x 150 corpus reads, beside
    K7 on the same reads packed (quot_vs_plain's clocks) and the
    random-read floor; canonical23_ascii on N_COLD corpus chunks of 2^22
    bytes, beside its byte bound."""
    import torch
    from aindex_torch.core.reads import blob_chunks
    from aindex_torch.kernels.encode import ascii_to_base_codes, canonical_code64, window_codes
    from aindex_torch.kernels.quot import quot_tf_windows, quot_tf_windows_plain
    from aindex_torch.kernels.spectrum import ascii_canonical, ascii_canonical_plain
    t = index.tables
    rng = np.random.default_rng(89)
    flat = reads.reshape(-1)

    def rows_of(n, length):
        start = rng.integers(0, flat.size - length, n)
        mat = flat[start[:, None] + np.arange(length)[None, :]]
        mat[rng.random(mat.shape) < 0.003] = ord("N")
        return mat
    chunks = [torch.from_numpy(piece).to(dev) for piece, _ in itertools.islice(
        blob_chunks(corpus_blob(reads), K23, CHUNK_BYTES), N_COLD)]
    for k in (11, K23, 31):
        shapes = ascii_edges(dev, rows_of, k)
        if k == K23:
            shapes.append(("a 2^22-byte corpus chunk as one row", chunks[0]))
        for tag, x in shapes:
            for a, b in zip(ascii_canonical(x, k), ascii_canonical_plain(x, k)):
                max_abs_err(a, b)
            if k == K23:
                max_abs_err(quot_tf_windows(t, x, k), quot_tf_windows_plain(t, x, k))
        print(f"canonical23_ascii k={k}{' and quotcov23_rows' if k == K23 else ''} edge shapes "
              f"== plain: {'; '.join(tag for tag, _ in shapes)} ({card})")
        del shapes

    batches = [torch.from_numpy(reads[i * N_SEQ:(i + 1) * N_SEQ]).to(dev) for i in range(N_COLD)]
    n_reads, sectors = 0, []
    for b in batches:
        codes, valid = window_codes(ascii_to_base_codes(b), K23)
        n, sec = table_reads(t, canonical_code64(codes[valid], K23))
        n_reads = n_reads or n
        sectors.append(sec)
    footprint = int(torch.unique(torch.cat(sectors)).numel()) * 64
    floor = n_reads / READ_RATE[64] * 1e3
    rows = clocks(card, f"{N_SEQ} x {READ_LEN}, k={K23}", "quotcov23_rows",
                  lambda b: quot_tf_windows(t, batches[b], K23), N_COLD, floor, footprint)
    k7 = SIDE_MS.get(f"quotcov23 cutoff 0, {N_SEQ} x {READ_LEN + 1}, k={K23}, clocks", {})
    print(f"quotcov23_rows beside K7 on the same {N_SEQ * (READ_LEN - K23 + 1)} windows, device "
          f"cold: " + " / ".join(f"{v:.4f}" for v in rows["this tree"]["device cold"])
          + " ms, K7 " + " / ".join(f"{v:.4f}" for v in k7.get("this tree device cold", []))
          + f" ms; random-read floor {floor:.4f} ms ({card})")
    del batches, sectors
    n_win = chunks[0].numel() - K23 + 1
    clocks(card, f"corpus chunk of {chunks[0].numel()} bytes, k={K23}", "canonical23_ascii",
           lambda b: ascii_canonical(chunks[b], K23), len(chunks),
           bound_ms(chunks[0].numel() + 9 * n_win), sum(c.numel() for c in chunks),
           kernel=("canonical", "ascii_windows"), floor_what="byte bound",
           footprint_what="chunks")
    del chunks
    torch.cuda.empty_cache()


# -- phase 10: K8 and K9 against their plain versions --------------------------

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
        scratch = fill_scratch(16 * packed.numel() - k + 1, n_slots, dev)
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
                index, canonical_code64(codes[wvalid], k))
        rec = record(err, ms, pms, n_bytes, lib)
        report(card, "posfill", f"{tag}, corpus chunk 2^22 B at {off}, {n_valid} valid "
               f"windows, {n_distinct} slots", rec)
        k9.append(rec)
        del got, ref, work, scratch, cursor, tf, offsets
    res["posfill"] = {**k9[0], "max_abs_err": max(r["max_abs_err"] for r in k9)}
    return res


def fill_edge_checks(dev, reads: np.ndarray, k: int, tables, rule: int, n_slots: int
                     ) -> list[str]:
    """Hold one chunk fill (K9 dense or on the quotient table, or the K10 or
    K11 fill entry) to its plain version, exactly, at the shapes where the
    fill's tiles, runs and cursor could break, each chunk filled twice in a
    row (the second from the first's cursor): no valid window; poly-A over
    five 4096-key tiles (one slot holds every window, dense); one read
    repeated over five tiles; tile - 1, tile, tile + 1 and 3 tiles + 1
    valid windows; a cursor of 2^31 - 2 on every other slot (those wrap,
    their cells past the end dropped); cells past the end. Returns the
    shapes' tags."""
    import torch
    from aindex_torch.core import codec
    from aindex_torch.kernels.positional import (chunk_slots_plain, fill_scratch, posfill,
                                                 scatter_chunk_plain)
    from aindex_torch.kernels.spectrum import ONESWEEP_TILE as tile
    line = READ_LEN + 1
    corpus = corpus_blob(reads[:-(-5 * tile // (line - k + 1)) + 2])
    repeated = np.tile(corpus[:line], -(-5 * tile // (line - k + 1)))
    gen = torch.Generator(device=dev).manual_seed(k)

    def cut(v):
        """A corpus piece with exactly v valid windows, N after them."""
        packed, vbits = upload(dev, *codec.pack_ascii_chunk(corpus))
        valid = chunk_slots_plain(packed, vbits, k, tables, rule)[1]
        last = int(torch.nonzero(valid).reshape(-1)[v - 1])
        piece = np.full(last + k + 300, ord("N"), np.uint8)
        piece[:last + k] = corpus[:last + k]
        return piece

    shapes = [("no valid window", np.full(3000, ord("N"), np.uint8), "small", 0),
              ("poly-A over 5 tiles", np.full(5 * tile + k + 3, ord("A"), np.uint8), "small", 0),
              ("one read repeated over 5 tiles", repeated, "small", 0),
              *((f"{v} valid windows", cut(v), "small", 0)
                for v in (tile - 1, tile, tile + 1, 3 * tile + 1)),
              ("cursor 2^31 - 2 on every other slot", corpus[:3 * tile], "big", 0),
              ("1000 cells past the end", corpus[:3 * tile], "small", 1000)]
    tags = []
    for tag, piece, cursor_mode, drop in shapes:
        packed, vbits = upload(dev, *codec.pack_ascii_chunk(piece))
        n_win = 16 * packed.numel() - k + 1
        slots, valid = chunk_slots_plain(packed, vbits, k, tables, rule)
        counts = torch.bincount(slots[valid], minlength=n_slots).to(torch.int64)
        if cursor_mode == "big":
            cursor = torch.zeros(n_slots, dtype=torch.int32, device=dev)
            cursor[::2] = 2 ** 31 - 2
            tf = 2 * counts
        else:
            cursor = torch.randint(0, 4, (n_slots,), dtype=torch.int32, device=dev,
                                   generator=gen)
            tf = 2 * counts + cursor
        offsets = (torch.cumsum(tf, 0) - tf).contiguous()
        total = max(1, int(tf.sum()) - drop)
        got = (torch.zeros(total, dtype=torch.int64, device=dev), cursor.clone())
        ref = (torch.zeros(total, dtype=torch.int64, device=dev), cursor.clone())
        scratch = fill_scratch(n_win, n_slots, dev)
        for off in (5, 5 + n_win):
            posfill(*got, offsets, packed, vbits, k, off, tables, scratch, rule)
            scatter_chunk_plain(*ref, offsets, slots, torch.arange(n_win, device=dev) + off,
                                valid)
            max(max_abs_err(a, b) for a, b in zip(got, ref))
        if cursor_mode == "big" and bool(valid.any()):
            check(int(got[1].min()) < 0, "the cursor wrapped")
        tags.append(f"{tag} ({int(valid.sum())} valid)")
        del got, ref, cursor, tf, offsets, counts, scratch
    torch.cuda.empty_cache()
    return tags


def fill_edges_vs_plain(dev, card: str, reads: np.ndarray, index) -> None:
    """K8, K9's chunk entry (dense k = 13 and on the k = 23 quotient table)
    and its pairs-in entry against their plain versions on the card,
    exactly, at the shapes where the one-pass scan, the onesweep sort's
    tiles and the fill's run heads and cursors could break: K8 at n = 0, 1,
    tile - 1, tile, tile + 1 and 3 tiles + 5, random and every value 2^32 -
    1, and on 4 x 2^24 values 2^32 - 1 (a sum near 2^58); the chunk fills
    at fill_edge_checks' shapes; the pairs-in entry on packed records (some
    empty) and slot ids (-1, other shards' slots), one slot's run over five
    tiles, every record its own slot, keys of slot_bits + idx_bits = 64
    bits (the C entry called with wider index or slot fields than needed)
    and 4 x 2^24 records."""
    import torch
    from aindex_torch.kernels import _cuda
    from aindex_torch.kernels.positional import (csr_offsets, csr_offsets_plain, fill_scratch,
                                                 posfill_pairs, posfill_pairs_plain)
    from aindex_torch.kernels.spectrum import ONESWEEP_TILE as tile
    from aindex_torch.kernels.spectrum import onesweep_scratch, sort_passes
    rng = np.random.default_rng(83)
    t0 = time.perf_counter()
    for n in (0, 1, tile - 1, tile, tile + 1, 3 * tile + 5, N_CODES):
        for values in ("random", "max"):
            if n == N_CODES and values == "random":
                continue
            host = (np.full(n, 2 ** 32 - 1, np.uint32) if values == "max" else
                    rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32))
            tf = torch.from_numpy(host.view(np.int32)).to(dev).view(torch.uint32)
            got = csr_offsets(tf)
            max_abs_err(got, csr_offsets_plain(tf))
            check(n == 0 or values != "max" or int(got[-1]) == n * (2 ** 32 - 1),
                  "K8's total of 2^32 - 1 values")
    # a table that starts off a 16-byte boundary (the wrapper copies it)
    tf = torch.arange(tile + 3, dtype=torch.int32, device=dev)[1:].view(torch.uint32)
    max_abs_err(csr_offsets(tf), csr_offsets_plain(tf))
    print(f"K8 edge shapes (n = 0, 1, tile - 1, tile, tile + 1, 3 tiles + 5, random and all "
          f"2^32 - 1; {N_CODES} x 2^32 - 1; an unaligned table) == plain "
          f"({time.perf_counter() - t0:.1f} s, {card})")

    for k, tables, n_slots, kind in ((K, None, SPACE, "dense k=13"),
                                     (K23, index.tables, index.n, "quotient k=23")):
        t0 = time.perf_counter()
        tags = fill_edge_checks(dev, reads, k, tables, index.rule, n_slots)
        print(f"K9 {kind} edge shapes == plain: {'; '.join(tags)} "
              f"({time.perf_counter() - t0:.1f} s, {card})")

    def pairs(tag, rec, n_slots, lo=0, packed=False, bits=None):
        rec = torch.from_numpy(rec).to(dev)
        roff = torch.arange(rec.shape[0], dtype=torch.int64, device=dev) * (1 << 26) + 3
        slot = (rec >> 24) - 1 if packed else rec
        live = slot[(slot >= lo) & (slot < lo + n_slots)] - lo
        counts = torch.bincount(live, minlength=n_slots).to(torch.int64)
        offsets = (torch.cumsum(2 * counts, 0) - 2 * counts).contiguous()
        total = max(1, 2 * int(counts.sum()))
        fills = [(torch.zeros(total, dtype=torch.int64, device=dev),
                  torch.zeros(n_slots, dtype=torch.int32, device=dev)) for _ in range(2)]
        for _ in range(2):
            if bits is None:
                posfill_pairs(*fills[0], offsets, rec, roff, lo, packed)
            else:
                slot_bits, idx_bits = bits
                scratch = torch.empty(onesweep_scratch(rec.numel(), sort_passes(slot_bits), 0),
                                      dtype=torch.uint8, device=dev)
                with torch.cuda.device(dev):
                    _cuda.KERNELS["posfill_pairs"].launch(
                        rec.data_ptr(), rec.shape[0], rec.shape[1], int(packed),
                        roff.data_ptr(), lo, n_slots, slot_bits, idx_bits, offsets.data_ptr(),
                        fills[0][1].data_ptr(), fills[0][0].data_ptr(), total,
                        scratch.data_ptr(), _cuda.stream(dev))
            posfill_pairs_plain(*fills[1], offsets, rec, roff, lo, packed)
            max(max_abs_err(a, b) for a, b in zip(*fills))
        return f"{tag} ({rec.numel()} records, {live.numel()} live)"

    t0 = time.perf_counter()
    n_rec = 3 * tile + 17
    slot_ids = rng.integers(-1, 3000, size=(3, n_rec)).astype(np.int64)
    deltas = np.sort(rng.permutation(1 << 20)[:2 * n_rec].reshape(2, n_rec), axis=1)
    packed_rec = ((rng.integers(0, 2500, size=(2, n_rec)) + 1) << 24) | deltas
    packed_rec[:, rng.random(n_rec) < 0.3] = 0
    tags = [pairs("slot ids, -1 and other shards' slots", slot_ids, 1000, lo=1000),
            pairs("packed, empty records", packed_rec.astype(np.int64), 2500, packed=True),
            pairs("packed, a shard's range", packed_rec.astype(np.int64), 700, lo=900,
                  packed=True),
            pairs("one slot over 5 tiles", np.full((1, 5 * tile + 3), 7, np.int64), 10),
            pairs("every record its own slot",
                  rng.permutation(2 * n_rec).astype(np.int64).reshape(2, n_rec), 2 * n_rec),
            pairs("10 slot + 54 index bits", slot_ids, 1000, bits=(10, 54)),
            pairs("50 slot + 14 index bits", slot_ids[:1, :tile], 3000, bits=(50, 14)),
            pairs(f"4 x 2^24 slot ids over {index.n} slots",
                  rng.integers(-1, index.n, size=(4, 1 << 24)).astype(np.int64), index.n)]
    print(f"K9 pairs-in edge shapes == plain: {'; '.join(tags)} "
          f"({time.perf_counter() - t0:.1f} s, {card})")
    torch.cuda.empty_cache()


# -- phase 11: the positional path end to end ----------------------------------

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


def oracle_canon(reads: np.ndarray, k: int = K23):
    """(canonical k-mer code, valid) of every window, [n_reads, 151 - k]."""
    n_win = READ_LEN - k + 1
    canon = np.empty((len(reads), n_win), np.uint64)
    ok = np.empty((len(reads), n_win), bool)
    for i in range(0, len(reads), 1 << 16):
        fwd, rc, v = oracle_windows23(reads[i:i + (1 << 16)], k)
        canon[i:i + len(v)] = np.minimum(fwd, rc)
        ok[i:i + len(v)] = v
    return canon, ok


def positional_path(dev, card: str, tmp: str, reads: np.ndarray, fasta: str,
                    table: np.ndarray, oracle, hashes: dict) -> dict[str, int]:
    """build_all on the corpus FASTA for k = 13 and k = 23 under the
    profiler, each against the numpy oracle; returns the K8 and K9 launch
    counts of the two runs, and keeps each run's artifact SHA-256s in
    ``hashes[k]`` (the mesh path's reference). The two artifact sets stay
    in ``tmp``: the examples path reads them, then removes them."""
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
                     scratch=None, rule=1):
        k9_shapes.add((packed.numel(), "dense" if tables is None else "sparse"))
        return real_posfill(positions, cursor, offsets, packed, vbits, k, off, tables, scratch,
                            rule)

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
                "aindex.build_all.reads", "aindex.build_all.count",
                "aindex.build_all.positional", "aindex.positional.tables",
                "aindex.positional.offsets", "aindex.positional.fill",
                "aindex.positional.copy", "aindex.positional.save") if name in ranges}
            t_pos = stages["aindex.build_all.positional"]
            print(f"positional build_all k={k}: {t_all:.3f} s in all (torch.profiler on); "
                  + ", ".join(f"{n} {v:.3f} s" for n, v in stages.items()) + f"; positional "
                  f"stage {n_bases / t_pos / 1e6:.2f} MB/s of bases; launches "
                  f"{ {n: c for n, c in runs.items() if c} } ({card})")
            fs, fe = ranges["aindex.positional.fill"]
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
            hashes[k] = artifact_hashes(prefix)
            torch.cuda.empty_cache()
    finally:
        tpos.posfill = real_posfill
    want_words = CHUNK_BYTES // 16
    check(k9_shapes == {(want_words, "dense"), (want_words, "sparse")},
          f"K9 ran at (words, kind) {sorted(k9_shapes)}, the chunk its check uses")
    print(f"positional path: K9 launched at (words, kind) {sorted(k9_shapes)}")
    return launched


# -- phase 11b: the port's examples, and the facade families they reach -----

#: the port's Python examples, each with the strings its run must print
#: (what tests/test_examples.py asserts of aindex_tpu's)
EXAMPLES = (("torch_basic_usage", ("tf(",)),
            ("torch_comprehensive_demo", ("All API families exercised.",
                                          "reloaded index answers identically: True")),
            ("torch_device_and_sharded_queries", ("codes-in tf: device array",
                                                  "coverage profile:", "sharded over 1 rank")))
#: the artifacts torch_pipeline_cli.sh must write
CLI_ARTIFACTS = (".reads", ".ridx", ".tf.bin", ".pf", ".kmers.bin", ".index.bin",
                 ".indices.bin", ".dat")
N_ITER = 1_000_000         # iter_kmers_by_frequency's cap (bench.py's)
N_PROBES = 4096            # k-mers whose positions resolve to reads (bench.py's)


def example_runs(card: str, tmp: str) -> None:
    """Each Python example's main() in this process on the card, its output
    captured and held to the strings it must print; then the CLI example
    as a subprocess into ``tmp``."""
    import importlib.util
    import io
    for name, must in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(HERE, "examples", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main()
        dt = time.perf_counter() - t0
        out = buf.getvalue()
        for s in must:
            check(s in out, f"examples/{name}.py prints {s!r}")
        print(f"examples/{name}.py on the card: {len(out.splitlines())} lines printed, "
              f"{dt:.3f} s (host clock) ({card})")
    prefix = os.path.join(tmp, "examples", "p23")
    t0 = time.perf_counter()
    proc = subprocess.run(["sh", os.path.join(HERE, "examples", "torch_pipeline_cli.sh"), prefix],
                          cwd=HERE, env=dict(os.environ, PYTHON=sys.executable),
                          capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    check(proc.returncode == 0, f"examples/torch_pipeline_cli.sh exited {proc.returncode}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    check("pipeline complete" in proc.stdout and '"total_kmers"' in proc.stdout,
          "torch_pipeline_cli.sh reports its artifacts and statistics")
    for sfx in CLI_ARTIFACTS:
        check(os.path.getsize(prefix + sfx) > 0, f"torch_pipeline_cli.sh wrote {sfx}")
    print(f"examples/torch_pipeline_cli.sh on the card: {dt:.3f} s for the two subprocesses, "
          f"{len(CLI_ARTIFACTS)} artifacts ({card})")


def kmer_strings(mat: np.ndarray) -> list[str]:
    """The rows of an ASCII matrix as strings."""
    k = mat.shape[1]
    text = mat.tobytes().decode("ascii")
    return [text[i:i + k] for i in range(0, len(text), k)]


def probe_windows(rng, reads: np.ndarray, k: int):
    """N_PROBES windows of the reads, every 512th with an N: (strings, code
    (k = 13: forward; else canonical), valid)."""
    r = rng.integers(0, len(reads), size=N_PROBES)
    o = rng.integers(0, READ_LEN - k + 1, size=N_PROBES)
    mat = reads[r[:, None], o[:, None] + np.arange(k)[None, :]]
    mat[::512, 5] = ord("N")
    if k == K:
        code, ok = (a[:, 0] for a in oracle_codes(mat))
        return kmer_strings(mat), code.astype(np.uint64), ok
    fwd, rc, ok = (a[:, 0] for a in oracle_windows23(mat, k))
    return kmer_strings(mat), np.minimum(fwd, rc), ok


def oracle_probe_positions(reads: np.ndarray, probe13: np.ndarray, probe23: np.ndarray
                           ) -> tuple[list, list]:
    """0-based blob positions of every window whose code is a probe's (the
    forward 13-mer code for ``probe13``, the canonical 23-mer code for
    ``probe23``), ascending, one array a probe. One pass of 13-mer window
    codes: a 23-mer window is a candidate when its first 13 bases begin a
    probe or a probe's reverse complement, and its whole code decides."""
    stride = READ_LEN + 1
    u23 = np.unique(probe23)
    shift = np.uint64(2 * (K23 - K))
    mark = np.zeros(SPACE, np.uint8)
    mark[probe13.astype(np.int64)] |= 1
    mark[(u23 >> shift).astype(np.int64)] |= 2
    mark[(oracle_rc(u23, K23) >> shift).astype(np.int64)] |= 2
    hits = {K: [], K23: []}
    for i in range(0, len(reads), 1 << 16):
        block = reads[i:i + (1 << 16)]
        code, ok = oracle_codes(block)
        m = np.where(ok, mark[code], 0)
        r, c = np.nonzero(m & 1)
        hits[K].append((code[r, c].astype(np.uint64), (i + r) * stride + c))
        r, c = np.nonzero(m[:, :READ_LEN - K23 + 1] & 2)
        fwd, rc, v = (a[:, 0] for a in oracle_windows23(
            block[r[:, None], c[:, None] + np.arange(K23)[None, :]], K23))
        canon = np.minimum(fwd, rc)
        at = np.minimum(np.searchsorted(u23, canon), u23.size - 1)
        keep = v & (u23[at] == canon)
        hits[K23].append((canon[keep], (i + r[keep]) * stride + c[keep]))
    out = []
    for k, probe in ((K, probe13), (K23, probe23)):
        code = np.concatenate([h[0] for h in hits[k]])
        pos = np.concatenate([h[1] for h in hits[k]])
        o = np.lexsort((pos, code))
        code, pos = code[o], pos[o]
        lo, hi = np.searchsorted(code, probe, "left"), np.searchsorted(code, probe, "right")
        out.append([pos[a:b] for a, b in zip(lo, hi)])
    return out[0], out[1]


def iteration_check(card: str, ai, k: int, codes_want, tf_of) -> None:
    """iter_kmers_by_frequency(min_tf=1, max_kmers=N_ITER) and
    get_top_kmers(100): the tf sequence never rises and every (k-mer, tf)
    pair is the oracle's (``tf_of``: tf of codes); with ``codes_want``,
    the k-mers' order is that sequence exactly."""
    t0 = time.perf_counter()
    got = list(ai.iter_kmers_by_frequency(min_tf=1, max_kmers=N_ITER))
    dt = time.perf_counter() - t0
    kmers, tf = [g[0] for g in got], np.array([g[1] for g in got], np.int64)
    mat = np.frombuffer("".join(kmers).encode("ascii"), np.uint8).reshape(-1, k)
    if k == K:
        code, ok = (a[:, 0] for a in oracle_codes(mat))
        code = code.astype(np.uint64)
    else:
        code, _, ok = (a[:, 0] for a in oracle_windows23(mat, k))
    check(bool(ok.all()) and bool((np.diff(tf) <= 0).all()) and bool((tf >= 1).all()),
          f"k={k} iter_kmers_by_frequency: valid k-mers, tf never rises")
    check(np.array_equal(tf_of(code), tf), f"k={k} iter_kmers_by_frequency (k-mer, tf) pairs")
    check(np.unique(code).size == code.size, f"k={k} iter_kmers_by_frequency k-mers distinct")
    if codes_want is not None:
        check(np.array_equal(code, codes_want), f"k={k} iter_kmers_by_frequency order")
    print(f"k={k} iter_kmers_by_frequency(min_tf=1, max_kmers={N_ITER}): {len(got)} k-mers, "
          f"{len(got) / dt:.0f} k-mers/s, {dt:.3f} s (host clock) ({card})")
    t0 = time.perf_counter()
    top = ai.get_top_kmers(100)
    dt = time.perf_counter() - t0
    check(top == got[:100], f"k={k} get_top_kmers(100) == the iteration's first 100")
    print(f"k={k} get_top_kmers(100): {dt:.3f} s (host clock) ({card})")


def stats_check(card: str, ai, k: int, tf: np.ndarray) -> None:
    """get_kmer_frequency_stats, get_{13,23}mer_statistics and
    set_stats(coverage=25) against the oracle's tf over the index's slots
    (``tf``: the dense table, or the spectrum's counts)."""
    nz = tf[tf > 0].astype(np.int64)
    total = int(nz.sum())
    mode = "13mer" if k == K else "23mer"
    want = {"kmer_type": mode, "total_kmers": tf.size, "non_zero_kmers": nz.size,
            "zero_kmers": tf.size - nz.size, "max_tf": int(nz.max()), "min_tf": int(nz.min()),
            "avg_tf": total / nz.size, "total_tf": total, "coverage": nz.size / tf.size}
    t0 = time.perf_counter()
    got = ai.get_kmer_frequency_stats()
    check(got == want, f"k={k} get_kmer_frequency_stats {got} == {want}")
    want = {"total_kmers": tf.size, "non_zero_kmers": nz.size, "max_frequency": int(nz.max()),
            "total_count": total}
    if k == K:
        got = ai.get_13mer_statistics()
        other = ai.get_23mer_statistics
    else:
        want["unique_kmers"] = int((nz == 1).sum())
        got = ai.get_23mer_statistics()
        other = ai.get_13mer_statistics
    check(got == want, f"k={k} get_{mode}_statistics {got} == {want}")
    try:
        other()
    except RuntimeError:
        pass
    else:
        check(False, f"k={k}: the other mode's statistics raise RuntimeError")
    s = ai.set_stats(coverage=25)
    profile = np.bincount(np.minimum(tf.astype(np.int64), 36), minlength=37)
    check({n: s[n] for n in ("zero", "unique", "distinct", "total", "max_count", "coverage")}
          == {"zero": tf.size - nz.size, "unique": int((nz == 1).sum()), "distinct": nz.size,
              "total": total, "max_count": int(nz.max()), "coverage": 25}
          and np.array_equal(s["profile"], profile), f"k={k} set_stats(coverage=25)")
    print(f"k={k} get_kmer_frequency_stats, get_{mode}_statistics, set_stats(coverage=25): "
          f"{time.perf_counter() - t0:.3f} s (host clock) ({card})")


def reads_check(card: str, ai, reads: np.ndarray, k: int, probe: list[str],
                want_pos: list[np.ndarray]) -> None:
    """get_rid2poses and get_reads_by_kmer of the probe k-mers against the
    oracle's positions, and iter_reads against the read matrix."""
    stride = READ_LEN + 1
    t0 = time.perf_counter()
    got = [ai.get_rid2poses(km) for km in probe]
    dt = time.perf_counter() - t0
    n_pos = sum(p.size for p in want_pos)
    for km, g, p in zip(probe, got, want_pos):
        rid = p // stride
        want = {}
        for r, q in zip(rid.tolist(), (p - rid * stride).tolist()):
            want.setdefault(r, []).append(q)
        check(list(g.items()) == list(want.items()), f"k={k} get_rid2poses({km})")
    print(f"k={k} get_rid2poses: {len(probe)} k-mers -> {n_pos} positions, {n_pos / dt:.0f} "
          f"positions/s, {dt:.3f} s (host clock) ({card})")
    t0 = time.perf_counter()
    got = [ai.get_reads_by_kmer(km) for km in probe]
    dt = time.perf_counter() - t0
    for km, g, p in zip(probe, got, want_pos):
        rids = np.unique(p // stride)[:100]
        check(g == [reads[r].tobytes().decode("ascii") for r in rids],
              f"k={k} get_reads_by_kmer({km})")
    n_reads = sum(map(len, got))
    print(f"k={k} get_reads_by_kmer: {len(probe)} k-mers -> {n_reads} reads, "
          f"{n_pos / dt:.0f} positions/s, {dt:.3f} s (host clock) ({card})")
    t0 = time.perf_counter()
    n, text = 0, []
    for rid, read in ai.iter_reads():
        check(rid == n, "iter_reads yields read ids in order")
        n += 1
        text.append(read)
    dt = time.perf_counter() - t0
    check(n == ai.n_reads == len(reads) and "".join(text).encode("ascii") == reads.tobytes(),
          f"k={k} iter_reads yields every read")
    print(f"k={k} iter_reads: {n} reads, {n / dt:.0f} reads/s, {dt:.3f} s (host clock) ({card})")


def examples_path(dev, card: str, tmp: str, reads: np.ndarray, fasta: str,
                  table: np.ndarray, oracle) -> None:
    """The port's examples on the card, then the facade families they reach
    at the corpus's size on the k = 13 and k = 23 artifact sets of the
    positional path (rebuilt through compute-aindex when ``tmp`` does not
    hold them, as when this phase runs alone), each against the numpy
    oracles; removes the sets."""
    import torch
    from aindex_torch import AIndex

    example_runs(card, tmp)
    keys, counts = oracle
    rng = np.random.default_rng(83)
    t0 = time.perf_counter()
    probes = {k: probe_windows(rng, reads, k) for k in (K, K23)}
    positions = dict(zip((K, K23), oracle_probe_positions(reads, probes[K][1], probes[K23][1])))
    print(f"oracle positions of {N_PROBES} probes at k = 13 and k = 23: "
          f"{time.perf_counter() - t0:.1f} s")
    for k in (K, K23):
        prefix = os.path.join(tmp, f"ecoli_25x.p{k}")
        if not all(os.path.exists(prefix + sfx) for sfx in (".tf.bin", ".index.bin", ".reads")):
            run_cli(["compute-aindex", "-i", fasta, "-o", prefix, "-k", str(k)])
        t0 = time.perf_counter()
        ai = AIndex.load_from_prefix(prefix, kmer_size=k, load_reads=True, device=dev)
        if ai.sparse23 is not None:
            ai.sparse23.tables      # built at the first query; not a query's cost
        torch.cuda.synchronize()
        print(f"k={k} load_from_prefix(load_reads=True) and the engine's tables on the card: "
              f"{time.perf_counter() - t0:.3f} s (host clock) ({card})")
        check(ai.n_reads == len(reads) and ai.aindex_loaded, f"k={k} reads and positions loaded")

        if k == K:
            nzc = np.flatnonzero(table >= 1)
            order = nzc[np.argsort(table[nzc], kind="stable")[::-1]][:N_ITER]
            iteration_check(card, ai, k, order.astype(np.uint64),
                            lambda c: table[c.astype(np.int64)].astype(np.int64))
            stats_check(card, ai, k, table)
        else:
            iteration_check(card, ai, k, None,
                            lambda c: oracle_lookup(keys, counts, c).astype(np.int64))
            stats_check(card, ai, k, counts)
            path = os.path.join(tmp, "values.dat")
            t0 = time.perf_counter()
            tallies = ai.save_values(path)
            dt = time.perf_counter() - t0
            with open(path, "rb") as f:
                lines = f.read().split(b"\n")
            check(lines[-1] == b"" and len(lines) - 1 == keys.size
                  and tallies == (0, int((counts == 1).sum()), int((counts > 1).sum())),
                  f"save_values tallies {tallies} and {len(lines) - 1} lines")
            at = rng.integers(0, keys.size, size=N_PROBES)
            rows = [lines[i].split(b"\t") for i in at]
            fwd, rc, ok = (a[:, 0] for a in oracle_windows23(
                np.frombuffer(b"".join(r[0] for r in rows), np.uint8).reshape(-1, k), k))
            check(bool(ok.all()) and np.array_equal(
                oracle_lookup(keys, counts, np.minimum(fwd, rc)), [int(r[1]) for r in rows]),
                  "save_values lines hold the oracle's (k-mer, tf)")
            os.remove(path)
            del lines, rows
            print(f"k={k} save_values: {keys.size} lines, {keys.size / dt:.0f} lines/s, "
                  f"{dt:.3f} s (host clock) ({card})")

        probe, pcode, pok = probes[k]
        want_pos = [p if v else p[:0] for p, v in zip(positions[k], pok)]
        reads_check(card, ai, reads, k, probe, want_pos)

        if k == K:
            try:
                ai.get_kmer_info_by_kid(1)
            except RuntimeError:
                pass
            else:
                check(False, "get_kmer_info_by_kid raises on a 13-mer index, as aindex_tpu's")
            # both directions and the total of 2^20 13-mers: half windows of
            # the reads, half random, every 64th with an N
            rr = rng.integers(0, len(reads), size=N_ASCII)
            oo = rng.integers(0, READ_LEN - K + 1, size=N_ASCII)
            qmat = reads[rr[:, None], oo[:, None] + np.arange(K)[None, :]]
            qmat[1::2] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (N_ASCII // 2, K))]
            qmat[::64, 7] = ord("N")
            qcode, qok = (np.ascontiguousarray(a[:, 0]) for a in oracle_codes(qmat))
            fwd_tf = np.where(qok, table[qcode], 0).astype(np.int64)
            rc_tf = np.where(qok, table[oracle_rc(qcode)], 0).astype(np.int64)
            qkmers = kmer_strings(qmat)
            t0 = time.perf_counter()
            pairs = ai.get_tf_both_directions_13mer_batch(qkmers)
            dt = time.perf_counter() - t0
            check(pairs == list(zip(fwd_tf.tolist(), rc_tf.tolist())),
                  "get_tf_both_directions_13mer_batch == oracle")
            print(f"k={k} get_tf_both_directions_13mer_batch: {N_ASCII} k-mers, "
                  f"{N_ASCII / dt / 1e6:.3f} M k-mers/s, {dt:.3f} s (host clock) ({card})")
            total = (fwd_tf + rc_tf) & 0xFFFFFFFF
            codes_dev = torch.from_numpy(qcode.view(np.int32)).to(dev).view(torch.uint32)
            ok_dev = torch.from_numpy(qok).to(dev)
            got = ai.get_total_tf_values_codes_13mer(codes_dev, ok_dev)
            check(got.dtype == torch.uint32 and got.device == codes_dev.device
                  and np.array_equal(bits64(got).cpu().numpy(), total),
                  "get_total_tf_values_codes_13mer on device codes: torch.uint32 on the card "
                  "== oracle")
            got = ai.get_total_tf_values_codes_13mer(qcode, qok)
            check(got.dtype == torch.uint32 and got.device == codes_dev.device
                  and np.array_equal(bits64(got).cpu().numpy(), total),
                  "get_total_tf_values_codes_13mer on numpy codes == oracle")
            ms = cuda_ms(lambda: ai.get_total_tf_values_codes_13mer(codes_dev, ok_dev), 20)
            print(f"k={k} get_total_tf_values_codes_13mer: {N_ASCII} device codes, "
                  f"{N_ASCII / ms / 1e6:.3f} G queries/s ({ms:.4f} ms, CUDA events) ({card})")
            del codes_dev, ok_dev, got
        else:
            t0 = time.perf_counter()
            kids = [ai.get_kid_by_kmer(km) for km in probe]
            info = [ai.get_kmer_info_by_kid(kid) for kid in kids]
            dt = time.perf_counter() - t0
            canon_str = kmer_strings(np.frombuffer(b"ACGT", np.uint8)[
                (pcode[:, None] >> (2 * np.arange(k - 1, -1, -1, dtype=np.uint64))[None, :])
                & np.uint64(3)])
            want_tf = oracle_lookup(keys, counts, pcode)
            comp = str.maketrans("ACGT", "TGCA")
            for i in range(N_PROBES):
                if pok[i]:
                    check(info[i] == (canon_str[i], canon_str[i].translate(comp)[::-1],
                                      int(want_tf[i])),
                          f"get_kmer_info_by_kid of {probe[i]}")
                else:
                    check(kids[i] == 0, f"get_kid_by_kmer of {probe[i]} is 0")
            print(f"k={k} get_kid_by_kmer + get_kmer_info_by_kid: {N_PROBES} k-mers, "
                  f"{N_PROBES / dt:.0f} k-mers/s, {dt:.3f} s (host clock) ({card})")
        del ai
        for sfx in ARTIFACTS:
            if os.path.exists(prefix + sfx):
                os.remove(prefix + sfx)
        torch.cuda.empty_cache()


# -- phases 12-14: the wide engines, the facade and the CLI, the golden sets ---

#: the two facade configurations: (k, the engine aindex_tpu's routing gives
#: the corpus's n, that engine's query, coverage and fill kernels)
FACADE_CONFIGS = ((31, "walk", ("mphfwalk", "mphfcov", "mphffill")),
                  (29, "cuckoo", ("cuckoo64", "cuckoocov64", "cuckoofill64")))
#: kernels that must not launch on the wide configurations' paths (K6, K7, K9)
QUOT_KERNELS = ("quot23", "quotcov23", "posfill")
N_FACADE_DB = 1 << 14      # De Bruijn CONT records through the facade (dicts)
N_POS = 1 << 14            # k-mers whose positions the facade path checks
HERE = os.path.dirname(os.path.abspath(__file__))

#: runs ``python -m aindex_torch`` with the given argv, then prints the
#: process's kernel launch counts on a line of its own
_CLI = """import json, runpy, sys
from aindex_torch.kernels import _cuda
sys.argv = ["aindex_torch"] + json.loads(sys.argv[1])
try:
    runpy.run_module("aindex_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code
else:
    code = 0
print("LAUNCHES " + json.dumps(_cuda.launches()))
sys.exit(code)
"""


def run_cli(argv: list[str]) -> tuple[dict, str, float]:
    """(launch counts, standard output, seconds) of ``python -m
    aindex_torch <argv>`` run as a subprocess from the repository root."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _CLI, json.dumps(argv)], cwd=HERE,
                          capture_output=True, text=True, timeout=900)
    dt = time.perf_counter() - t0
    check(proc.returncode == 0, f"python -m aindex_torch {' '.join(argv)} exited "
          f"{proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("LAUNCHES ")][-1]
    return json.loads(line[len("LAUNCHES "):]), proc.stdout, dt


def trace_stages(path: str) -> dict[str, float]:
    """Seconds of the first aindex.build_all.* and aindex.positional.* range
    of a torch.profiler chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        name = e.get("name", "")
        if e.get("ph") == "X" and name.startswith(("aindex.build_all.", "aindex.positional.")) \
                and e.get("cat") in ("user_annotation", "cpu_op") and name not in out:
            out[name] = e["dur"] / 1e6
    return out


def probe_bytes(index, keys, k: int) -> int:
    """Bytes of the index's table that the canonical probes of literal
    ``keys`` read, each distinct row, word or entry once, in JAX's layout
    (whatever layout the device reads): the wide cuckoo table's host rows
    (16 B, the second only for first misses); or the MPHF walk's
    (``walk_bytes``)."""
    import torch
    from aindex_torch.kernels.encode import canonical_code64
    from aindex_torch.kernels.lookup import _s64, mix64
    keys = canonical_code64(keys, k)
    if index.engine == "cuckoo":
        ct = index.cuckoo
        r1 = mix64(keys ^ _s64(ct.seed1)) & (ct.m - 1)
        hit1 = old_first_hit(index, keys)
        r2 = mix64(keys[~hit1] ^ _s64(ct.seed2)) & (ct.m - 1)
        return 16 * (int(torch.unique(r1).numel()) + int(torch.unique(r2).numel()))
    return walk_bytes(index.tables, keys)


def walk_bytes(t, keys) -> int:
    """Bytes of JAX's layout that the MPHF walk over ``t`` (``MphfTables``)
    of the canonical ``keys`` reads, each distinct entry once: the
    g-words (4 B), the slot entries of the owner nodes (4 B), the checker
    words of the slots those hold (8 B; every unassigned node holds slot 0)
    and, on a hit, tf entries (4 B)."""
    import torch
    from aindex_torch.kernels.lookup import hash_triple, mphf_owner_node
    words = torch.unique(torch.cat([n >> 4 for n in hash_triple(keys, t.seed, t.domain)]))
    hit, _, slot = t.probe_plain(keys)
    nodes = torch.unique(mphf_owner_node(t.g_packed, keys, t.seed, t.domain))
    n_reached = int(torch.unique(t.records[nodes, 3]).numel())
    return (4 * int(words.numel()) + 4 * int(nodes.numel()) + 8 * n_reached
            + 4 * int(torch.unique(slot[hit]).numel()))


def walk_edges_vs_plain(dev, card: str, index) -> None:
    """K11's query exactly against its plain version, and against the host
    arrays, on the keys where the record walk could differ from JAX's three
    reads: keys whose walk ends at an unassigned node (it holds slot 0's
    record), the key in slot 0 (checker[0]), 0 and 2^62 - 1, under the
    KEYS and CANON rules, with slot and strand."""
    import torch
    from aindex_torch.kernels import probe
    from aindex_torch.kernels.lookup import mphf_owner_node
    t, k = index.tables, index.k
    gen = torch.Generator(device=dev).manual_seed(67)
    draws = torch.randint(0, 1 << 62, (1 << 22,), dtype=torch.int64, device=dev, generator=gen)
    node = mphf_owner_node(t.g_packed, draws, t.seed, t.domain)
    g = (t.g_packed[node >> 4].to(torch.int64) >> (2 * (node & 15))) & 3
    unassigned = draws[g == 3]
    check(unassigned.numel() > 0, "random keys that walk to an unassigned node")
    first = int(index.checker_host[:1].view(np.int64)[0])
    keys = torch.cat([unassigned, torch.tensor([first, 0, (1 << 62) - 1], device=dev)])
    for rule in (probe.KEYS, probe.CANON):
        got = probe.query(t, keys, k=k, rule=rule, slot=True, strand=rule != probe.KEYS)
        ref = probe.query_plain(t, keys, k=k, rule=rule, slot=True, strand=rule != probe.KEYS)
        for a, b in zip(got, ref):
            max_abs_err(a, b)
    tf, slot = probe.query(t, keys, k=k, rule=probe.KEYS, slot=True)
    n_un = unassigned.numel()
    check(not bool(tf[:n_un].view(torch.int32).any()) and bool((slot[:n_un] == -1).all()),
          "unassigned-node keys are absent")
    check(int(tf[n_un].view(torch.int32)) == int(index.tf_host[:1].view(np.int32)[0])
          and int(slot[n_un]) == 0, "checker[0] hits slot 0 with its tf")
    print(f"mphfwalk edge keys == plain: {n_un} unassigned-node keys absent, checker[0] at "
          f"slot 0, keys 0 and 2^62 - 1, rules KEYS and CANON ({card})")


def engines_vs_plain(dev, card: str, index, reads: np.ndarray, names) -> dict:
    """The engine's three kernels (K10 or K11) against their plain versions
    on the configuration's index, at the path's shapes: 4 x 2^24 codes,
    2^20 ASCII k-mers, 10,000 x 151 coverage rows, one 2^22-byte fill
    chunk."""
    import torch
    from aindex_torch.core import codec
    from aindex_torch.core.reads import blob_chunks
    from aindex_torch.kernels import probe
    from aindex_torch.kernels.encode import (ascii_to_base_codes, canonical_code64,
                                             packed_window_codes, window_codes)
    from aindex_torch.kernels.positional import (chunk_slots_plain, csr_offsets_plain,
                                                 fill_scratch, posfill, scatter_chunk_plain)
    t, k = index.tables, index.k
    q_name, c_name, f_name = names
    res = {}
    gen = torch.Generator(device=dev).manual_seed(53)
    half = N_CODES // 2
    sample = torch.from_numpy(index.checker_host.view(np.int64)).to(dev)
    codes = torch.cat([sample[torch.randint(0, sample.numel(), (half,), device=dev,
                                            generator=gen)],
                       torch.randint(0, 1 << (2 * k), (half,), dtype=torch.int64, device=dev,
                                     generator=gen)])
    codes = codes[torch.randperm(N_CODES, device=dev, generator=gen)]
    del sample
    rows_np = np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(59).integers(
        0, 4, size=(N_ASCII, k))]
    rows_np[::2] = reads[np.random.default_rng(61).integers(0, len(reads), N_ASCII // 2), :k]
    rows_np[::97, 3] = ord("N")
    rows = torch.from_numpy(rows_np).to(dev)
    recs = []
    n_probe = probe_bytes(index, codes, k)
    for tag, kw, n_io in (("codes, tf", {"codes": codes}, N_CODES * 12),
                          ("codes, tf+slot+strand", {"codes": codes, "slot": True,
                                                     "strand": True}, N_CODES * 20),
                          ("ascii, tf+slot+strand", {"ascii": rows, "slot": True,
                                                     "strand": True}, N_ASCII * (k + 12))):
        got = probe.query(t, k=k, **kw)
        ref = probe.query_plain(t, k=k, **kw)
        pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
        err = max(max_abs_err(a, b) for a, b in pairs)
        ms = cuda_ms(lambda: probe.query(t, k=k, **kw), 20)
        pms = cuda_ms(lambda: probe.query_plain(t, k=k, **kw), 2)
        if "ascii" in kw:
            rc, rv = window_codes(ascii_to_base_codes(rows), k)
            n_tab = probe_bytes(index, rc.reshape(-1)[rv.reshape(-1)], k)
        else:
            n_tab = n_probe
        rec = record(err, ms, pms, n_io + n_tab)
        report(card, q_name, f"{tag}, {N_CODES if 'codes' in kw else N_ASCII} k={k} queries",
               rec)
        recs.append(rec)
    res[q_name] = {**recs[0], "max_abs_err": max(r["max_abs_err"] for r in recs)}
    if q_name == "cuckoo64":
        sector_mix(card, f"K10 batch ({N_CODES} codes, canonical, half present)", index,
                   canonical_code64(codes, k))
        device_table_bytes(card, index)
        if PARENT:
            old = parent_tables(dev, index)
            parent_vs_this(dev, card, f"cuckoo64 codes, tf, {N_CODES} k={k} codes",
                           parent_engines(PARENT)["cuckoo64"], old, t, codes, k, index.rule,
                           False, False)
            del old
        engine_edges_vs_plain(dev, card, index)
    del codes, rows

    [(members, stride, packed, vbits)] = codec.coverage_row_batches(
        [row.tobytes() for row in reads[:N_SEQ]], k)
    packed, vbits = upload(dev, packed, vbits)
    wcodes, wvalid = packed_window_codes(packed, vbits, k)
    n_tab = probe_bytes(index, wcodes[wvalid], k)
    recs = []
    for cutoff in (0, 10):
        args = (t, packed, vbits, len(members), stride, k, cutoff, index.rule)
        err = max_abs_err(probe.coverage(*args), probe.coverage_plain(*args))
        ms = cuda_ms(lambda: probe.coverage(*args), 50)
        pms = cuda_ms(lambda: probe.coverage_plain(*args), 5)
        n_bytes = packed.numel() * 4 + vbits.numel() + len(members) * (stride - k) * 4 + n_tab
        rec = record(err, ms, pms, n_bytes)
        report(card, c_name, f"cutoff {cutoff}, {len(members)} x {stride}, k={k}", rec)
        recs.append(rec)
    res[c_name] = {**recs[0], "max_abs_err": max(r["max_abs_err"] for r in recs)}
    del wcodes, wvalid
    engine_coverage_clocks(card, index, c_name, coverage_batches(dev, reads, k))
    engine_coverage_edges_vs_plain(dev, card, index, reads)

    # the fill of the second corpus chunk, from a nonzero cursor (as K9's)
    piece, off = list(itertools.islice(blob_chunks(corpus_blob(reads), k, CHUNK_BYTES), 2))[1]
    packed, vbits = upload(dev, *codec.pack_ascii_chunk(piece))
    slots, valid = chunk_slots_plain(packed, vbits, k, t, index.rule)
    live = slots[valid]
    n_valid, n_distinct = live.numel(), int(torch.unique(live).numel())
    cursor = torch.randint(0, 4, (index.n,), dtype=torch.int32, device=dev, generator=gen)
    tf = torch.bincount(live, minlength=index.n).to(torch.int32) + cursor
    offsets = csr_offsets_plain(tf)
    total = int(offsets[-1])
    got = (torch.zeros(total, dtype=torch.int64, device=dev), cursor.clone())
    ref = (torch.zeros(total, dtype=torch.int64, device=dev), cursor.clone())
    scratch = fill_scratch(16 * packed.numel() - k + 1, index.n, dev)
    posfill(*got, offsets[:-1], packed, vbits, k, off, t, scratch, index.rule)
    scatter_chunk_plain(*ref, offsets[:-1], slots, torch.arange(slots.numel(), device=dev) + off,
                        valid)
    err = max(max_abs_err(a, b) for a, b in zip(got, ref))
    check(int((got[0] > 0).sum()) == n_valid, f"{f_name} wrote every valid window")
    work = (got[0].clone(), got[1].clone())
    ms = cuda_ms(lambda: posfill(*work, offsets[:-1], packed, vbits, k, off, t, scratch,
                                 index.rule), 20)

    def plain():
        s, v = chunk_slots_plain(packed, vbits, k, t, index.rule)
        scatter_chunk_plain(*work, offsets[:-1], s, torch.arange(s.numel(), device=dev) + off, v)
    pms = cuda_ms(plain, 3)
    idx_bits = max(1, (16 * packed.numel() - k).bit_length())
    keys = (live << idx_bits) | torch.nonzero(valid).reshape(-1)
    lib = cuda_ms(lambda: torch.sort(keys, stable=True), 20)
    fcodes, fvalid = packed_window_codes(packed, vbits, k)
    n_bytes = (packed.numel() * 4 + vbits.numel() + 8 * n_valid + 16 * n_distinct
               + probe_bytes(index, fcodes[fvalid], k))
    rec = record(err, ms, pms, n_bytes, lib)
    report(card, f_name, f"corpus chunk 2^22 B at {off}, k={k}, {n_valid} valid windows, "
           f"{n_distinct} slots", rec)
    res[f_name] = rec
    del got, ref, work, scratch, cursor, tf, offsets
    t0 = time.perf_counter()
    tags = fill_edge_checks(dev, reads, k, t, index.rule, index.n)
    print(f"{f_name} edge shapes == plain: {'; '.join(tags)} "
          f"({time.perf_counter() - t0:.1f} s, {card})")
    if q_name == "mphfwalk":
        walk_edges_vs_plain(dev, card, index)
    return res


def facade_path(dev, card: str, tmp: str, reads: np.ndarray, fasta: str, k: int,
                engine: str, names) -> tuple[dict, object]:
    """``python -m aindex_torch compute-aindex -k <k>`` on the corpus FASTA
    (a subprocess, under --profile-dir), then ``AIndex.load_from_prefix``
    and the facade's queries, each against the numpy oracle. Returns the
    launch counts of the two (CLI and facade) and the loaded AIndex."""
    import torch
    from aindex_torch import AIndex
    from aindex_torch.kernels import _cuda

    t0 = time.perf_counter()
    wcanon, wvalid = oracle_canon(reads, k)     # every window; also the positions' oracle
    keys, counts = np.unique(wcanon[wvalid], return_counts=True)
    print(f"facade k={k}: oracle spectrum {keys.size} distinct canonical {k}-mers "
          f"({time.perf_counter() - t0:.1f} s)")
    prefix = os.path.join(tmp, f"ecoli_25x.c{k}")
    prof_dir = os.path.join(tmp, f"prof{k}")
    n_bases = reads.size
    cli_launches, out, t_cli = run_cli(["compute-aindex", "-i", fasta, "-o", prefix, "-k",
                                        str(k), "--profile-dir", prof_dir])
    stages = trace_stages(os.path.join(prof_dir, "build_all.trace.json"))
    t_all = sum(stages[n] for n in ("aindex.build_all.reads", "aindex.build_all.count",
                                    "aindex.build_all.positional"))
    print(f"facade k={k} compute-aindex: {t_cli:.3f} s for the subprocess (interpreter, "
          f"imports, kernel load, torch.profiler on); stages " + ", ".join(
              f"{n} {v:.3f} s" for n, v in stages.items()) + f"; build_all "
          f"{n_bases / t_all / 1e6:.2f} MB/s of bases, positional stage "
          f"{n_bases / stages['aindex.build_all.positional'] / 1e6:.2f} MB/s; launches "
          f"{ {n: c for n, c in cli_launches.items() if c} } ({card})")
    check("pipeline complete" in out, "compute-aindex reports its artifacts")

    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    ai = AIndex.load_from_prefix(prefix, kmer_size=k, load_reads=True, device=dev)
    index = ai.sparse23
    tables = index.tables
    torch.cuda.synchronize()
    print(f"facade k={k}: load_from_prefix + {index.engine} tables {time.perf_counter() - t0:.3f} s")
    check(index.engine == engine, f"k={k} is served by the {engine} engine, got {index.engine}")
    order = np.argsort(index.checker_host)
    check(np.array_equal(index.checker_host[order], keys)
          and np.array_equal(index.tf_host[order], counts.astype(np.uint32)),
          f"k={k} index == oracle spectrum")
    check(ai.n_reads == len(reads) and ai.aindex_loaded, "reads and positions loaded")

    # tf, pfid and strand of 2^20 ASCII k-mers: half windows of the reads
    rng = np.random.default_rng(71 + k)
    r = rng.integers(0, len(reads), size=N_ASCII)
    o = rng.integers(0, READ_LEN - k + 1, size=N_ASCII)
    mat = reads[r[:, None], o[:, None] + np.arange(k)[None, :]]
    mat[1::2] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(N_ASCII // 2, k))]
    mat[::64, 7] = ord("N")
    text = mat.tobytes().decode("ascii")
    kmers = [text[i:i + k] for i in range(0, len(text), k)]
    fwd, rc, ok = (a[:, 0] for a in oracle_windows23(mat, k))
    canon = np.minimum(fwd, rc)
    want = np.where(ok, oracle_lookup(keys, counts, canon), 0).astype(np.uint32)
    for name, call, check_fn in (
            ("get_tf_values", lambda: ai.get_tf_values(kmers),
             lambda g: np.array_equal(np.asarray(g, np.uint32), want)),
            ("get_pfids", lambda: index.get_pfids(kmers),
             lambda g: np.array_equal(g == index.n, want == 0)
             and np.array_equal(index.checker_host[g[want > 0]], canon[want > 0])),
            ("get_strands", lambda: index.get_strands(kmers),
             lambda g: np.array_equal(g, np.where(want > 0, np.where(fwd <= rc, 1, 2), 0)))):
        t0 = time.perf_counter()
        got = call()
        dt = time.perf_counter() - t0
        check(check_fn(got), f"facade k={k} {name}")
        print(f"facade k={k} {name}: {N_ASCII} ASCII k-mers, {N_ASCII / dt / 1e6:.2f} M "
              f"queries/s (host clock) ({card})")
    check(ai.get_kid_by_kmer(kmers[0]) == (index.get_pfids(kmers[:1])[0] if want[0] else 0),
          "get_kid_by_kmer")

    # codes-in, 4 x 2^24 device codes: half windows of the reads, half random
    gen = torch.Generator(device=dev).manual_seed(73)
    half = N_CODES // 2
    reads_dev = torch.from_numpy(reads).to(dev)
    lut = torch.from_numpy(_LUT.astype(np.int64)).to(dev)
    rr = torch.randint(0, len(reads), (half,), device=dev, generator=gen)
    oo = torch.randint(0, READ_LEN - k + 1, (half,), device=dev, generator=gen)
    sampled = torch.zeros(half, dtype=torch.int64, device=dev)
    for j in range(k):
        sampled = (sampled << 2) | lut[reads_dev[rr, oo + j].to(torch.int64)]
    codes = torch.cat([sampled, torch.randint(0, 1 << (2 * k), (half,), dtype=torch.int64,
                                              device=dev, generator=gen)])
    del reads_dev, rr, oo, sampled
    from aindex_torch.kernels.encode import canonical_code64
    keys_dev = torch.from_numpy(keys.view(np.int64)).to(dev)
    counts_dev = torch.from_numpy(counts.astype(np.int64)).to(dev)
    c = canonical_code64(codes, k)
    at = torch.searchsorted(keys_dev, c).clamp_(max=keys.size - 1)
    want_codes = torch.where(keys_dev[at] == c, counts_dev[at], 0)
    del c, at, keys_dev, counts_dev
    got = ai.get_tf_values_codes_23mer(codes)
    check(got.dtype == torch.uint32 and bool((bits64(got) == want_codes).all()),
          f"facade k={k} get_tf_values_codes == oracle")
    ms = cuda_ms(lambda: ai.get_tf_values_codes_23mer(codes), 20)
    print(f"facade k={k} get_tf_values_codes_23mer: {N_CODES} device codes, "
          f"{N_CODES / ms / 1e6:.3f} G queries/s ({ms:.4f} ms, CUDA events) ({card})")
    del got, want_codes, codes

    # coverage of 10,000 reads, cutoff 0 and 10
    seqs = [row.tobytes().decode("ascii") for row in reads[:N_SEQ]]
    wf, wr, wok = oracle_windows23(reads[:N_SEQ], k)
    wtf = np.where(wok, oracle_lookup(keys, counts, np.minimum(wf, wr)), 0)
    for cutoff in (0, 10):
        t0 = time.perf_counter()
        covs = ai.get_sequence_coverage_batch(seqs, cutoff)
        dt = time.perf_counter() - t0
        check(np.array_equal(np.array(covs, dtype=np.int64), np.where(wtf >= cutoff, wtf, 0)),
              f"facade k={k} coverage cutoff {cutoff}")
        print(f"facade k={k} get_sequence_coverage_batch cutoff {cutoff}: {N_SEQ} x "
              f"{READ_LEN} bp, {N_SEQ / dt:.0f} sequences/s (host clock) ({card})")

    # De Bruijn CONT of 2^14 k-mers of the reads
    dmat = reads[r[:2 * N_FACADE_DB:2, None], o[:2 * N_FACADE_DB:2, None]
                 + np.arange(k)[None, :]]
    dtext = dmat.tobytes().decode("ascii")
    dkmers = [dtext[i:i + k] for i in range(0, len(dtext), k)]
    dfwd, _, _ = oracle_windows23(dmat, k)
    ext = ((dfwd[:, :1] << np.uint64(2)) | np.arange(4, dtype=np.uint64)) \
        & np.uint64((1 << (2 * k)) - 1)
    ext_rc = np.zeros_like(ext)
    for j in range(k):
        ext_rc |= (np.uint64(3) - ((ext >> np.uint64(2 * (k - 1 - j))) & np.uint64(3))) \
            << np.uint64(2 * j)
    etf = oracle_lookup(keys, counts, np.minimum(ext, ext_rc).reshape(-1)).reshape(-1, 4)
    best = np.array([max(i for i in range(4) if row[i] == row.max()) for row in etf])
    t0 = time.perf_counter()
    info = ai.debruijn_next_info_batch(dkmers)
    dt = time.perf_counter() - t0
    check([[d[b] for b in "ACGT"] for d in info] == etf.tolist()
          and [d["best_hit"] for d in info] == ["ACGT"[b] for b in best]
          and [d["best_ukmer"] for d in info] == ext[np.arange(len(best)), best].tolist(),
          f"facade k={k} debruijn_next_info_batch")
    print(f"facade k={k} debruijn_next_info_batch: {N_FACADE_DB} k-mers, "
          f"{N_FACADE_DB / dt:.0f} CONT records/s (host clock) ({card})")

    # positions by slot of 2^14 present k-mers, from the oracle's windows
    pk = kmers[:2 * N_POS:2]
    t0 = time.perf_counter()
    got_pos = ai.get_positions_batch(pk)
    dt = time.perf_counter() - t0
    u = np.unique(canon[:2 * N_POS:2])
    flat = wcanon.reshape(-1)
    at = np.minimum(np.searchsorted(u, flat), u.size - 1)
    hit = np.flatnonzero((u[at] == flat) & wvalid.reshape(-1))
    w = wcanon.shape[1]
    p = (hit // w) * (READ_LEN + 1) + hit % w
    srt = np.lexsort((p, at[hit]))
    grp, p = at[hit][srt], p[srt]
    bounds = np.searchsorted(grp, np.arange(u.size + 1))
    slot_u = np.searchsorted(u, canon[:2 * N_POS:2])
    want_pos = [p[bounds[j]:bounds[j + 1]].tolist() if ok[2 * i] else []
                for i, j in enumerate(slot_u)]
    check(got_pos == want_pos, f"facade k={k} get_positions_batch == oracle")
    print(f"facade k={k} get_positions_batch: {N_POS} k-mers -> "
          f"{sum(map(len, got_pos))} positions, {N_POS / dt:.0f} k-mers/s (host clock) ({card})")
    flat_pos = [q for lst in got_pos for q in lst][:4096]
    check([ai.get_rid(q) for q in flat_pos] == [q // (READ_LEN + 1) for q in flat_pos],
          f"facade k={k} get_rid of the positions")
    del wcanon, wvalid, flat, at, hit, p

    facade = _cuda.launches()
    launched = {n: cli_launches[n] + facade[n] for n in facade}
    print(f"facade k={k} launches: compute-aindex "
          f"{ {n: c for n, c in cli_launches.items() if c} }, facade "
          f"{ {n: c for n, c in facade.items() if c} }")
    for name in names:
        check(launched[name] > 0, f"{name} launched on the k={k} path")
    for name in QUOT_KERNELS:
        check(launched[name] == 0, f"no {name} launch on the k={k} path")
    for sfx in (".reads", ".ridx", ".header", ".tf.bin", ".pf", ".kmers.bin", ".index.bin",
                ".indices.bin"):
        if os.path.exists(prefix + sfx):
            os.remove(prefix + sfx)
    return launched, ai


def golden_path(dev, tmp: str) -> None:
    """The reference-built sets of tests/golden_ref through
    ``AIndex.load_from_prefix``, against p.23.dat and counts of p.reads."""
    import gzip
    import shutil
    from aindex_torch import AIndex
    from aindex_torch.core.codec import revcomp

    gold = os.path.join(HERE, "tests", "golden_ref")
    blob = open(os.path.join(gold, "p.reads")).read()

    def occurrences(km):
        out = set()
        for q in {km, revcomp(km)}:
            start = blob.find(q)
            while start >= 0:
                out.add(start)
                start = blob.find(q, start + 1)
        return out

    t0 = time.perf_counter()
    ai = AIndex.load_from_prefix(os.path.join(gold, "p.23"), load_reads=True, device=dev)
    dat = [line.split() for line in open(os.path.join(gold, "p.23.dat"))]
    kms = [km for km, _ in dat]
    check(not ai.sparse23.canonical_keys and ai.get_tf_values(kms) == [int(c) for _, c in dat]
          and ai.get_tf_values([revcomp(km) for km in kms]) == [int(c) for _, c in dat],
          "golden p.23: tf of every .dat k-mer and its reverse complement == its count")
    filled = 0
    for km, pos in zip(kms, ai.get_positions_batch(kms)):
        want = {p for p in occurrences(km) if min(km, revcomp(km)) == km}
        check(set(pos) == want, f"golden p.23 positions of {km}")
        filled += bool(want)
    check(filled == 81, f"golden p.23: {filled} slots with positions (the reference's 81)")
    d = os.path.join(tmp, "gold13")
    os.makedirs(d, exist_ok=True)
    for name in ("p.13.pf", "p.13.tf.bin", "p.13.indices.bin"):
        with gzip.open(os.path.join(gold, name + ".gz"), "rb") as f, \
                open(os.path.join(d, name), "wb") as out:
            shutil.copyfileobj(f, out)
    for name in ("p.13.index.bin", "p.reads", "p.ridx"):
        shutil.copy(os.path.join(gold, name), os.path.join(d, name))
    ai13 = AIndex.load_from_prefix(os.path.join(d, "p.13"), load_reads=True, device=dev)
    occ = {}
    for i in range(len(blob) - K + 1):
        km = blob[i:i + K]
        if set(km) <= set("ACGT"):
            occ[km] = occ.get(km, 0) + 1
    kms13 = sorted(occ)
    check(ai13.get_tf_values_13mer(kms13) == [occ[km] for km in kms13]
          and ai13.n_reads == ai.n_reads,
          "golden p.13: the re-keyed reference table == counts of p.reads")
    from aindex_torch.index import emphf
    emphf.clear_perm_cache()
    shutil.rmtree(d)
    print(f"golden sets: p.23 ({ai.sparse23.n} reference-keyed slots, {filled} with positions) "
          f"and p.13 ({len(kms13)} 13-mers of p.reads) through AIndex.load_from_prefix, == "
          f".dat and p.reads counts ({time.perf_counter() - t0:.1f} s)")


# -- phases 15-16: the mesh path on NCCL, K12-K14 against their plain versions ---

#: kernels that only the mesh path runs (K12, K13, K14, K9's pairs-in entry)
MESH_KERNELS = ("shardwalk", "spectrummerge", "posbucket", "posfill_pairs")
#: the simulated shard counts at which K12-K14 meet their plain versions
SHARDS = (1, 2, 4, 8)
#: the sharded engine's codes-in rate at world size 1 before the walk
#: (G queries/s; NVIDIA H100 80GB HBM3, 700.00 W), K12 as two entries
SHARDED_EARLIER_G = 12.303
ARTIFACTS = (".reads", ".ridx", ".header", ".tf.bin", ".pf", ".kmers.bin", ".index.bin",
             ".indices.bin")


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def artifact_hashes(prefix: str) -> dict[str, str]:
    return {sfx: sha256(prefix + sfx) for sfx in ARTIFACTS if os.path.exists(prefix + sfx)}


def query_codes(dev, reads: np.ndarray, index) -> object:
    """4 x 2^24 device codes: half present k-mers of the index, half random,
    shuffled (the codes-in shape of the sparse path)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(67)
    half = N_CODES // 2
    sample = torch.from_numpy(index.checker_host.view(np.int64)).to(dev)
    codes = torch.cat([sample[torch.randint(0, sample.numel(), (half,), device=dev,
                                            generator=gen)],
                       torch.randint(0, 1 << (2 * K23), (half,), dtype=torch.int64, device=dev,
                                     generator=gen)])
    return codes[torch.randperm(N_CODES, device=dev, generator=gen)]


def mesh_path(dev, card: str, tmp: str, reads: np.ndarray, fasta: str,
              hashes: dict) -> tuple[dict, object]:
    """The multi-device path at world size 1 on NCCL: build_all on a (1, 1)
    mesh for k = 13 and k = 23 (artifacts against the single-device
    build's SHA-256), the k = 23 positional stage again through the
    allgather exchange, then AIndex.shard_to and the sparse queries against
    the single-device engine's answers. Returns the launch counts of the
    path and the k = 23 index (loaded on the card)."""
    import datetime
    import torch
    import torch.distributed as dist
    from torch import profiler
    from aindex_torch import AIndex, Sparse23Index
    from aindex_torch.core.reads import ReadsStore
    from aindex_torch.kernels import _cuda
    from aindex_torch.parallel import positional as ppos
    from aindex_torch.parallel.mesh import make_mesh
    from aindex_torch.pipeline.build import BuildConfig, build_all

    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'pg')}", rank=0,
                            world_size=1, timeout=datetime.timedelta(minutes=5))
    try:
        mesh = make_mesh(1, 1)
        print(f"mesh: {mesh} on {dist.get_backend()}, world size {dist.get_world_size()}")
        n_bases = reads.size
        torch.cuda.synchronize()
        _cuda.reset_launches()
        acts = [profiler.ProfilerActivity.CPU, profiler.ProfilerActivity.CUDA]
        for k in (K, K23):
            prefix = os.path.join(tmp, f"ecoli_25x.m{k}")
            with profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                build_all([fasta], BuildConfig(prefix=prefix, k=k, chunk=CHUNK_BYTES, mesh=mesh))
                t_all = time.perf_counter() - t0
            ranges, spans = profile_ranges(prof)
            stages = {name: (e - s) / 1e6 for name, (s, e) in ranges.items()
                      if name.startswith(("aindex.build_all.", "aindex.positional."))}
            got = artifact_hashes(prefix)
            check(got == hashes[k], f"mesh build_all k={k}: every artifact's SHA-256 == the "
                  f"single-device build's ({sorted(got)})")
            fs, fe = ranges["aindex.positional.fill"]
            idle = (f"idle share {1 - busy_in(spans, fs, fe) / (fe - fs):.4f} of the fill"
                    if spans else "fill idle share not measured (no device events)")
            print(f"mesh build_all k={k} (alltoall exchange): {t_all:.3f} s in all "
                  f"(torch.profiler on), {n_bases / t_all / 1e6:.2f} MB/s of bases; "
                  + ", ".join(f"{n} {v:.3f} s" for n, v in stages.items())
                  + f"; {idle}; {len(got)} artifacts byte-identical to the single-device "
                  f"build ({card})")
        blob = ReadsStore.from_reads_file(prefix + ".reads", prefix + ".ridx").blob
        index = Sparse23Index.load(prefix, K23, device=dev)
        t0 = time.perf_counter()
        pos = ppos.build_positional_sharded(blob, index.n, index.tf_host, index.tables, mesh,
                                            K23, CHUNK_BYTES, exchange="allgather")
        t_pos = time.perf_counter() - t0
        pos.save(prefix + ".ag")
        check(sha256(prefix + ".ag.index.bin") == hashes[K23][".index.bin"]
              and sha256(prefix + ".ag.indices.bin") == hashes[K23][".indices.bin"],
              "allgather exchange: the same CSR bytes")
        print(f"mesh positional k={K23} (allgather exchange): {t_pos:.3f} s, "
              f"{n_bases / t_pos / 1e6:.2f} MB/s of bases, the same bytes ({card})")
        del pos, blob

        # the sharded engine against the single-device engine
        ai = AIndex.load_from_prefix(prefix, device=dev)
        sp = ai.sparse23
        codes = query_codes(dev, reads, sp)
        rng = np.random.default_rng(71)
        r = rng.integers(0, len(reads), size=N_ASCII)
        o = rng.integers(0, READ_LEN - K23 + 1, size=N_ASCII)
        mat = reads[r[:, None], o[:, None] + np.arange(K23)[None, :]]
        mat[1::2] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(N_ASCII // 2, K23))]
        mat[::64, 7] = ord("N")
        text = mat.tobytes().decode("ascii")
        kmers = [text[i:i + K23] for i in range(0, len(text), K23)]
        seqs = [reads[i].tobytes().decode("ascii") for i in rng.integers(0, len(reads), N_SEQ)]
        db = kmers[:N_DB]

        def answers(engine):
            return {"codes": bits64(engine.get_tf_values_codes(codes)),
                    "tf": engine.get_tf_values(kmers), "pfids": engine.get_pfids(kmers),
                    "hash": engine.get_hash_values(kmers),
                    "strands": engine.get_strands(kmers),
                    "coverage": np.concatenate(engine.sequence_coverage_batch(seqs)),
                    "next": engine.debruijn_next(db), "prev": engine.debruijn_prev(db, 1)}
        want = answers(sp)
        ai.shard_to(mesh)
        eng = ai._engine23
        check(eng is not sp and sp._device_released, "shard_to: the sharded engine serves")
        got = answers(eng)
        for name in want:
            same = (bool((got[name] == want[name]).all()) if name == "codes"
                    else np.array_equal(got[name], want[name]))
            check(same, f"sharded {name} == single-device")
        check(ai.get_tf_values(kmers[:1000]) == [int(v) for v in want["tf"][:1000]],
              "the facade's tf goes through the sharded engine")
        ms = cuda_ms(lambda: eng.get_tf_values_codes(codes), 10)
        t0 = time.perf_counter()
        eng.get_tf_values(kmers)
        dt = time.perf_counter() - t0
        print(f"mesh shard_to: codes-in {N_CODES} device codes {ms:.4f} ms = "
              f"{N_CODES / ms / 1e6:.3f} G queries/s (CUDA events; {SHARDED_EARLIER_G} G "
              f"with K12 as two entries); ASCII tf {N_ASCII / dt / 1e6:.2f} "
              f"M k-mers/s (host clock); tf, pfids, hash, strands, coverage of {N_SEQ} reads, "
              f"next/prev of {N_DB}: == the single-device engine; {eng.per_device_bytes} "
              f"bytes on the device ({card})")
        launched = _cuda.launches()
        print(f"mesh path launches: { {n: c for n, c in launched.items() if c} }")
        del ai, eng, sp, codes, want, got
        for sfx in ARTIFACTS + (".ag.index.bin", ".ag.indices.bin"):
            for p in (os.path.join(tmp, f"ecoli_25x.m{k}{sfx}") for k in (K, K23)):
                if os.path.exists(p):
                    os.remove(p)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launched, index


def mesh_kernels_vs_plain(dev, card: str, index, reads: np.ndarray) -> dict:
    """K12, K13, K14 and K9's pairs-in entry against their plain versions at
    1, 2, 4 and 8 simulated shards on the card (rank d of N, the collective
    stood in for by a sum or a concatenation), each timed at the world-of-
    one mesh path's shape."""
    import torch
    from aindex_torch.core import codec
    from aindex_torch.core.reads import blob_chunks
    from aindex_torch.kernels import probe
    from aindex_torch.kernels.encode import canonical_code64
    from aindex_torch.kernels.lookup import MphfTables, shard_walk, shard_walk_plain
    from aindex_torch.kernels.positional import (bucket_scratch, chunk_slots_plain,
                                                 fill_scratch, posbucket, posbucket_plain,
                                                 posfill, posfill_pairs, posfill_pairs_plain)
    from aindex_torch.kernels.spectrum import (chunk_spectrum_packed, merge_spectra,
                                               sorted_spectrum_weighted,
                                               sorted_spectrum_weighted_plain)
    from aindex_torch.parallel.positional import bucket_cap, range_layout
    from aindex_torch.parallel.query23 import shard_records
    from aindex_torch.parallel.spectrum23 import key_range

    res = {}
    m = index.mphf
    g = torch.from_numpy(m.g_packed.view(np.int32)).to(dev)
    codes = query_codes(dev, reads, index)
    n = codes.numel()

    # K12: per shard the walk over its node range's records, one sum
    walk = MphfTables.from_host(m, index.checker_host, index.tf_host, dev)
    want_tf, want_slot = probe.query(walk, codes, k=K23, rule=probe.CANON, slot=True)
    n_tab = walk_bytes(walk, canonical_code64(codes, K23))
    del walk
    err = 0
    for n_sh in SHARDS:
        t0 = time.perf_counter()
        total = torch.zeros((3, n), dtype=torch.int32, device=dev)
        for i in range(n_sh):
            rec = shard_records(m, index.checker_host, index.tf_host, n_sh, i)[0].to(dev)
            args = (g, rec, i * rec.shape[0], index.n, int(m.seed), int(m.domain), codes)
            got, fwd = shard_walk(*args, k=K23, canonical=True)
            ref, ref_fwd = shard_walk_plain(*args, k=K23, canonical=True)
            err = max(err, max_abs_err(got, ref),
                      max_abs_err(fwd.to(torch.int64), ref_fwd.to(torch.int64)))
            total += got
            del rec, got, ref, fwd, ref_fwd
        check(bool((total[0] == want_tf.view(torch.int32)).all())
              and bool((torch.where(total[2] > 0, total[1], -1) == want_slot).all()),
              f"K12 at {n_sh} shards == K11's single-device tf and slot")
        print(f"K12 at {n_sh} shards: each shard's walk of {n} codes == plain; their sum == "
              f"K11's tf and slot ({time.perf_counter() - t0:.1f} s)")
        del total
    # timed at the path's shape: one shard holds every node
    rec = shard_records(m, index.checker_host, index.tf_host, 1, 0)[0].to(dev)
    args = (g, rec, 0, index.n, int(m.seed), int(m.domain), codes)
    ms = cuda_ms(lambda: shard_walk(*args, k=K23, canonical=True), 20)
    pms = cuda_ms(lambda: shard_walk_plain(*args, k=K23, canonical=True), 3)
    # codes in; tf, slot, found and fwd out; the table K11's walk of the
    # same codes reads (walk_bytes, JAX's layout)
    res["shardwalk"] = record(err, ms, pms, n * (8 + 3 * 4 + 1) + n_tab)
    report(card, "shardwalk", f"{n} codes, canonical, 1 shard; earlier as two entries "
           f"{EARLIER_MS['shardwalk']} ms", res["shardwalk"])
    del codes, rec, want_tf, want_slot
    torch.cuda.empty_cache()

    # K13: the concatenated K5 spectra of 8 corpus chunks, per key range
    blob = corpus_blob(reads)
    chunks = [upload(dev, *codec.pack_ascii_chunk(piece))
              for piece, _ in itertools.islice(blob_chunks(blob, K23, CHUNK_BYTES), 8)]
    spectra = [chunk_spectrum_packed(p, v, K23) for p, v in chunks]
    all_k = torch.cat([s[0] for s in spectra])
    all_c = torch.cat([s[1].view(torch.int32) for s in spectra])
    want_k, want_c = merge_spectra([(s[0][:int(s[2])].cpu().numpy().view(np.uint64),
                                     s[1][:int(s[2])].view(torch.int32).cpu().numpy()
                                     .view(np.uint32)) for s in spectra])
    err13 = 0
    for n_sh in SHARDS:
        t0 = time.perf_counter()
        outs = []
        for d in range(n_sh):
            lo, hi = key_range(d, n_sh, K23)
            got = sorted_spectrum_weighted(all_k, all_c, lo, hi)
            ref = sorted_spectrum_weighted_plain(all_k, all_c, lo, hi)
            err13 = max(err13, *(max_abs_err(a, b) for a, b in zip(got, ref)))
            u = int(got[2])
            outs.append((got[0][:u].cpu().numpy().view(np.uint64),
                         got[1][:u].cpu().numpy().view(np.uint64)))
        check(np.array_equal(np.concatenate([o[0] for o in outs]), want_k)
              and np.array_equal(np.concatenate([o[1] for o in outs]), want_c),
              f"K13 at {n_sh} shards == merge_spectra")
        print(f"K13 at {n_sh} shards: {all_k.numel()} keys of 8 chunks, {want_k.size} unique, "
              f"== plain and == merge_spectra ({time.perf_counter() - t0:.1f} s)")
    # timed at the path's shape: one chunk's spectrum, the whole key range
    k1, c1 = spectra[1][0], spectra[1][1]
    lo, hi = key_range(0, 1, K23)
    ms = cuda_ms(lambda: sorted_spectrum_weighted(k1, c1, lo, hi), 20)
    pms = cuda_ms(lambda: sorted_spectrum_weighted_plain(k1, c1, lo, hi), 3)
    live = k1[:int(spectra[1][2])]
    lib = cuda_ms(lambda: torch.sort(live), 20)
    ms8 = cuda_ms(lambda: sorted_spectrum_weighted(all_k, all_c, lo, hi), 5)
    lib8 = cuda_ms(lambda: torch.sort(all_k[all_k >= 0]), 5)
    # keys and uint32 counts in; keys and uint64 counts out
    rec = record(err13, ms, pms, k1.numel() * (8 + 4 + 8 + 8), lib)
    report(card, "spectrummerge", f"one chunk's spectrum, {k1.numel()} keys; 8 chunks "
           f"{ms8:.4f} ms (bound {bound_ms(all_k.numel() * 28):.4f}, torch.sort {lib8:.4f})", rec)
    res["spectrummerge"] = rec
    del spectra, all_k, all_c, chunks
    torch.cuda.empty_cache()

    # K14 per simulated source on corpus chunks, K9's pairs-in entry per
    # destination, against the plain versions; at one shard against K9
    tables = index.tables
    pieces = list(itertools.islice(blob_chunks(blob, K23, CHUNK_BYTES), 9))[1:]
    ups = [upload(dev, *codec.pack_ascii_chunk(p)) for p, _ in pieces]
    n_win = CHUNK_BYTES - K23 + 1
    offsets = np.zeros(index.n + 1, np.int64)
    np.cumsum(index.tf_host.astype(np.int64), out=offsets[1:])
    err14 = errp = 0
    for n_sh in SHARDS:
        t0 = time.perf_counter()
        mm, bounds, _ = range_layout(offsets, index.n, n_sh)
        cap = bucket_cap(n_win, n_sh)
        sent = []
        for s in range(n_sh):
            args = (*ups[s], K23, tables, probe.CANON, index.n, mm, n_sh, cap)
            got, ref = posbucket(*args), posbucket_plain(*args)
            err14 = max(err14, *(max_abs_err(a, b) for a, b in zip(got, ref)))
            check(int(got[2]) == 0, "no overflow at 2x the mean")
            sent.append(got)
        roff = torch.arange(n_sh, device=dev) * n_win + int(pieces[0][1])
        for d in range(n_sh):
            rec_d = torch.stack([x[1][d] for x in sent])
            fills = []
            for _ in range(2):
                fills.append((torch.zeros(int(offsets[bounds[d + 1]] - offsets[bounds[d]]),
                                          dtype=torch.int64, device=dev),
                              torch.zeros(int(bounds[d + 1] - bounds[d]), dtype=torch.int32,
                                          device=dev)))
            loc = torch.from_numpy(offsets[bounds[d]:bounds[d + 1]] - offsets[bounds[d]]).to(dev)
            posfill_pairs(*fills[0], loc, rec_d, roff, int(bounds[d]))
            posfill_pairs_plain(*fills[1], loc, rec_d, roff, int(bounds[d]))
            errp = max(errp, *(max_abs_err(a, b) for a, b in zip(*fills)))
        if n_sh == 1:
            # one shard: the records' fill == K9's fill of the same chunk
            ref = (torch.zeros(int(offsets[-1]), dtype=torch.int64, device=dev),
                   torch.zeros(index.n, dtype=torch.int32, device=dev))
            posfill(*ref, torch.from_numpy(offsets[:-1]).to(dev), *ups[0], K23,
                    int(pieces[0][1]), tables)
            check(bool((fills[0][0] == ref[0]).all()) and bool((fills[0][1] == ref[1]).all()),
                  "K14 + pairs-in at one shard == K9's chunk fill")
        print(f"K14 + K9 pairs at {n_sh} shards: {n_sh} sources x {n_win} windows, cap {cap}, "
              f"== plain ({time.perf_counter() - t0:.1f} s)")
    # a forced small cap (a quarter of the mean) overflows: the kept
    # records and the count == plain
    args = (*ups[0], K23, tables, probe.CANON, index.n, -(-index.n // 4), 4, n_win // 16)
    got, ref = posbucket(*args), posbucket_plain(*args)
    err14 = max(err14, *(max_abs_err(a, b) for a, b in zip(got, ref)))
    check(int(got[2]) > 0, "the forced small cap overflows")
    print(f"K14 with cap {n_win // 16} at 4 shards: overflow {int(got[2])} == plain")
    # dense windows (k = 13) at 2 shards
    args = (*ups[0], K, None, probe.CANON, SPACE, SPACE // 2, 2, bucket_cap(CHUNK_BYTES - K + 1, 2))
    got, ref = posbucket(*args), posbucket_plain(*args)
    err14 = max(err14, *(max_abs_err(a, b) for a, b in zip(got, ref)))
    print("K14 dense k=13 at 2 shards == plain")
    # chunks of one tile of the pass +- 1 windows (dense k = 2, 1 and 16 on
    # 256 and 257 words; k = 23 chunks of 4090 and 4106 windows) at 1, 3
    # and 255 destinations
    for k, n_bytes, tabs, n_slots in ((2, 4096, None, 4 ** 2), (1, 4096, None, 4),
                                      (16, 4112, None, 4 ** 16), (K23, 4112, tables, index.n),
                                      (K23, 4128, tables, index.n)):
        up = upload(dev, *codec.pack_ascii_chunk(pieces[0][0][:n_bytes]))
        n_w = 16 * up[0].numel() - k + 1
        for n_dest in (1, 3, 255):
            args = (*up, k, tabs, probe.CANON, n_slots, -(-n_slots // n_dest), n_dest,
                    bucket_cap(n_w, n_dest))
            got, ref = posbucket(*args), posbucket_plain(*args)
            err14 = max(err14, *(max_abs_err(a, b) for a, b in zip(got, ref)))
    print("K14 on chunks of 4095, 4096, 4097, 4090 and 4106 windows at 1, 3 and 255 "
          "destinations == plain")
    # the corpus chunk at 255 destinations; the Mphf engine (the index's
    # walk) under FWD_RC and CANON at 4
    args = (*ups[0], K23, tables, probe.CANON, index.n, -(-index.n // 255), 255,
            bucket_cap(n_win, 255))
    got, ref = posbucket(*args), posbucket_plain(*args)
    err14 = max(err14, *(max_abs_err(a, b) for a, b in zip(got, ref)))
    walk = MphfTables.from_host(m, index.checker_host, index.tf_host, dev)
    for rule in (probe.FWD_RC, probe.CANON):
        args = (*ups[0], K23, walk, rule, index.n, -(-index.n // 4), 4, bucket_cap(n_win, 4))
        got, ref = posbucket(*args), posbucket_plain(*args)
        err14 = max(err14, *(max_abs_err(a, b) for a, b in zip(got, ref)))
    del walk, got, ref
    print("K14 on the corpus chunk at 255 destinations, and on the MPHF walk under FWD_RC "
          "and CANON at 4, == plain")
    # timed at the path's shape: one shard, the corpus chunk
    cap = bucket_cap(n_win, 1)
    scratch = bucket_scratch(dev)
    args = (*ups[0], K23, tables, probe.CANON, index.n, index.n, 1, cap)
    slots, buckets, _ = posbucket(*args, scratch)
    ms = cuda_ms(lambda: posbucket(*args, scratch), 20)
    pms = cuda_ms(lambda: posbucket_plain(*args), 3)
    dest = torch.where(slots >= 0, 0, 1)
    lib = cuda_ms(lambda: torch.sort(dest, stable=True), 20)
    s_ok, v_ok = chunk_slots_plain(*ups[0], K23, tables)
    live = s_ok[v_ok]
    n_live, n_distinct = live.numel(), int(torch.unique(live).numel())
    from aindex_torch.kernels.encode import canonical_code64, packed_window_codes
    wc, wv = packed_window_codes(*ups[0], K23)
    n_bytes = (ups[0][0].numel() * 4 + ups[0][1].numel() + 8 * n_win + 8 * n_live
               + 4 * n_distinct + 8 * distinct_probed_rows(index, canonical_code64(wc[wv], K23)))
    rec = record(err14, ms, pms, n_bytes, lib)
    report(card, "posbucket", f"corpus chunk {CHUNK_BYTES} B, {n_live} present windows, "
           f"1 shard, cap {cap}", rec)
    res["posbucket"] = rec
    roff = torch.tensor([int(pieces[0][1])], device=dev)
    work = (torch.zeros(int(offsets[-1]), dtype=torch.int64, device=dev),
            torch.zeros(index.n, dtype=torch.int32, device=dev))
    loc = torch.from_numpy(offsets[:-1]).to(dev)
    pscratch = fill_scratch(buckets.numel(), index.n, dev)
    ms = cuda_ms(lambda: posfill_pairs(*work, loc, buckets, roff, 0, True, pscratch), 20)
    pms = cuda_ms(lambda: posfill_pairs_plain(*work, loc, buckets, roff, 0), 3)
    idx_bits = max(1, (buckets.numel() - 1).bit_length())
    keys = (live << idx_bits) | torch.nonzero(v_ok).reshape(-1)
    lib = cuda_ms(lambda: torch.sort(keys, stable=True), 20)
    # the records in; a position out a record; an offset and a cursor a slot
    rec = record(errp, ms, pms, 8 * buckets.numel() + 8 * n_live + 16 * n_distinct, lib)
    report(card, "posfill_pairs", f"{buckets.numel()} records of one source, {n_live} live, "
           f"{n_distinct} slots", rec)
    res["posfill_pairs"] = rec
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:] == [LAUNCHES_FLAG]:
        return fresh_launches_main()
    global PARENT
    for arg in sys.argv[1:]:
        check(arg.startswith(PARENT_ARG), f"argument {arg!r} (takes only {PARENT_ARG}DIR)")
        PARENT = os.path.abspath(arg[len(PARENT_ARG):])
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
    built = [name for name in TILED if _cuda.KERNELS[name].build_log]
    for name in built:
        frames = {f: b for f, b in stack_frames(_cuda.KERNELS[name].build_log).items()
                  if "coverage_kernel" in f or "canonical_kernel" in f}
        check(bool(frames) and not any(frames.values()),
              f"{name}: the tiled kernels' stack frames are 0 bytes ({frames})")
    print(f"tiled front-end kernels of {', '.join(built)}: 0-byte stack frames"
          + (f"; {', '.join(sorted(set(TILED) - set(built)))}: libraries built by an earlier "
             "process, not read" if len(built) < len(TILED) else ""))

    t0 = time.perf_counter()
    width_test(dev, card)
    footprint_test(dev, card)
    rmw_test(dev, card)
    print(f"phase random reads by width and footprint, adds by order: "
          f"{time.perf_counter() - t0:.1f} s")
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
        dense = dense_path(dev, card, tmp, genome, reads, fasta, table)
        dense_counts = _cuda.launches()
        print(f"phase dense path: {time.perf_counter() - t0:.1f} s")
        counts.update({name: dense_counts[name] for name in DENSE_KERNELS})
        dense_stages(dev, card, dense, reads)
        del dense
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        measured.update(count_build_vs_plain(dev, card, reads, table))
        print(f"phase dense build count and total table vs plain: "
              f"{time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        measured["spectrum23"] = spectrum_vs_plain(dev, card, reads)
        print(f"phase spectrum kernel-vs-plain: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        sort_edges_vs_plain(dev, card)
        print(f"phase onesweep edge shapes: {time.perf_counter() - t0:.1f} s")

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
        _cuda.reset_launches()
        ascii_path(dev, card, reads, table, oracle, index)
        ascii_counts = _cuda.launches()
        counts.update({name: ascii_counts[name] for name in ASCII_KERNELS})
        print(f"phase ascii path: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        measured.update(ascii_kernels_vs_plain(dev, card, reads, table, index))
        print(f"phase ascii kernels-vs-plain: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ascii_front_end(dev, card, reads, index)
        print(f"phase ascii front end: {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        measured.update(positional_vs_plain(dev, card, reads, table, index))
        print(f"phase positional kernels-vs-plain: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        fill_edges_vs_plain(dev, card, reads, index)
        print(f"phase fill and scan edge shapes: {time.perf_counter() - t0:.1f} s")
        del index
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        hashes: dict = {}
        counts.update(positional_path(dev, card, tmp, reads, fasta, table, oracle, hashes))
        print(f"phase positional path: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        examples_path(dev, card, tmp, reads, fasta, table, oracle)
        print(f"phase examples path: {time.perf_counter() - t0:.1f} s")
        del table, oracle

        t0 = time.perf_counter()
        launched, index = mesh_path(dev, card, tmp, reads, fasta, hashes)
        counts.update({name: launched[name] for name in MESH_KERNELS})
        print(f"phase mesh path (world size 1, NCCL): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        measured.update(mesh_kernels_vs_plain(dev, card, index, reads))
        print(f"phase mesh kernels-vs-plain at {SHARDS} shards: "
              f"{time.perf_counter() - t0:.1f} s")
        del index
        torch.cuda.empty_cache()

        for k, engine, names in FACADE_CONFIGS:
            t0 = time.perf_counter()
            launched, ai = facade_path(dev, card, tmp, reads, fasta, k, engine, names)
            counts.update({name: launched[name] for name in names})
            print(f"phase facade path k={k}: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            measured.update(engines_vs_plain(dev, card, ai.sparse23, reads, names))
            print(f"phase {engine} kernels-vs-plain: {time.perf_counter() - t0:.1f} s")
            del ai
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        golden_path(dev, tmp)
        print(f"phase golden sets: {time.perf_counter() - t0:.1f} s")
    for name in _cuda.KERNELS:
        check(counts[name] > 0, f"kernel {name} launched on its main path")
    t0 = time.perf_counter()
    launches = fresh_launches()
    print(f"phase launches a call (a fresh process): {time.perf_counter() - t0:.1f} s")
    print(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
    for name, ms in EARLIER_MS.items():
        rec = measured[name]
        calls = f", {launches[name]:.2f} launches a call" if name in launches else ""
        lib = ("" if rec["library_ms"] is None else
               f"; library {rec['library_ms']:.4f} ms (kernel/library "
               f"{rec['ms'] / rec['library_ms']:.2f}x)")
        print(f"{name}: {rec['ms']:.4f} ms now, {ms:.4f} ms earlier "
              f"({rec['ms'] / ms - 1:+.1%}){calls}{lib}; bound {rec['bound_ms']:.4f} ms "
              f"({card})")

    for label, times in SIDE_MS.items():
        print(f"{label}: " + "; ".join(f"{tree} " + " / ".join(f"{t:.4f}" for t in ms)
                                       for tree, ms in times.items()) + f" ms ({card})")

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
