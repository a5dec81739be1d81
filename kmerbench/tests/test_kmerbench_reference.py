"""The reference, the control, the corpus and the traffic generator on
small hand-worked cases."""

import itertools

import numpy as np
import pytest
import torch

from kmerbench.corpus import make_corpus
from kmerbench.reference.control import SketchCounts
from kmerbench.reference.kmers import ExactCounts, canonical, revcomp, window_codes
from kmerbench.traffic import batch_stats, check_mix, fnv1a64, make_pool, zipfian_ranks

CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def bases(*rows):
    return torch.tensor([[CODE[c] for c in r] for r in rows], dtype=torch.uint8)


def code_of(s):
    c = 0
    for ch in s:
        c = c * 4 + CODE[ch]
    return c


def rc_str(s):
    return "".join(COMP[c] for c in reversed(s))


def test_window_codes_by_hand():
    # ACG = 0b00_01_10, CGT = 0b01_10_11, GTA = 0b10_11_00
    assert window_codes(bases("ACGTA"), 3).tolist() == [[6, 27, 44]]
    assert window_codes(bases("TTTT", "AAAA"), 4).tolist() == [[255], [0]]


def test_revcomp_and_canonical_by_hand():
    assert revcomp(torch.tensor([code_of("ACG")]), 3).tolist() == [code_of("CGT")]
    assert revcomp(torch.tensor([code_of("AAC")]), 3).tolist() == [code_of("GTT")]
    assert canonical(torch.tensor([code_of("GTT"), code_of("AAC")]), 3).tolist() == \
        [code_of("AAC")] * 2
    k = 23
    x = torch.randint(0, 1 << 46, (1000,), dtype=torch.int64)
    assert torch.equal(revcomp(revcomp(x, k), k), x)


@pytest.mark.parametrize("rule", ["total", "canonical"])
def test_exact_counts_against_strings(rule):
    rng = np.random.default_rng(3)
    reads = ["".join("ACGT"[b] for b in rng.integers(0, 4, 12)) for _ in range(40)]
    reads += ["ACGTACGTACGT", "AAAAAAAAAAAA", "TTTTTTTTTTTT"]
    k = 5
    fwd = {}
    for r in reads:
        for i in range(len(r) - k + 1):
            fwd[r[i:i + k]] = fwd.get(r[i:i + k], 0) + 1
    exact = ExactCounts(bases(*reads), k, rule)
    queries = ["".join(p) for p in itertools.product("ACGT", repeat=k)]
    got = exact.answers(torch.tensor([code_of(q) for q in queries])).tolist()
    for q, g in zip(queries, got):
        if rule == "total":
            want = fwd.get(q, 0) + fwd.get(rc_str(q), 0)
        else:
            c = min(q, rc_str(q))
            want = sum(n for s, n in fwd.items() if min(s, rc_str(s)) == c)
        assert g == want, q


@pytest.mark.parametrize("rule", ["total", "canonical"])
def test_control_overcounts(rule):
    g = torch.Generator().manual_seed(1)
    reads = torch.randint(0, 4, (2000, 60), generator=g, dtype=torch.uint8)
    k = 13
    q = window_codes(reads[:200], k).reshape(-1)
    exact = ExactCounts(reads, k, rule).answers(q)
    sketch = SketchCounts(reads, k, rule).answers(q)
    assert bool((sketch >= exact).all())
    assert float((sketch != exact).double().mean()) > 0.5


CONFIG = {"genome_bp": 5000, "coverage": 3, "read_len": 150, "error_rate": 0.003}


def test_corpus_from_the_seed():
    a = make_corpus(CONFIG, 2 ** 31 + 17, torch.device("cpu"))
    b = make_corpus(CONFIG, 2 ** 31 + 17, torch.device("cpu"))
    c = make_corpus(CONFIG, 2 ** 31 + 18, torch.device("cpu"))
    assert torch.equal(a.reads, b.reads) and torch.equal(a.genome, b.genome)
    assert not torch.equal(a.reads, c.reads)
    assert a.reads.shape == (100, 150) and a.genome.shape == (5000,)
    assert int(a.reads.max()) <= 3
    seqs = a.sequences()
    assert len(seqs) == 100 and all(len(s) == 150 and set(s) <= set("ACGT") for s in seqs)
    assert seqs[0] == "".join("ACGT"[b] for b in a.reads[0].tolist())


def test_corpus_reads_follow_the_genome():
    """Each read is its genome window but for ~0.225% of bases (0.3% drawn,
    a quarter of them the same base)."""
    cfg = dict(CONFIG, coverage=40)
    corpus = make_corpus(cfg, 9, torch.device("cpu"))
    genome = "".join("ACGT"[b] for b in corpus.genome.tolist())
    diffs = []
    for s in corpus.sequences()[:300]:
        best = min(sum(x != y for x, y in zip(s, genome[i:i + 150]))
                   for i in range(len(genome) - 150))
        diffs.append(best)
    assert max(diffs) <= 6 and 0 < sum(diffs) < 300


def java_fnvhash64(val):
    h = 0xCBF29CE484222325
    for _ in range(8):
        h ^= val & 0xFF
        h = (h * 1099511628211) & ((1 << 64) - 1)
        val >>= 8
    if h >= 1 << 63:
        h -= 1 << 64
    return abs(h)


def test_fnv_matches_ycsb():
    vals = [0, 1, 2, 255, 256, 123456789, 10 ** 10 - 1]
    assert fnv1a64(torch.tensor(vals)).tolist() == [java_fnvhash64(v) for v in vals]


def test_zipfian_skew():
    """YCSB's zipfian over 10^10 ranks with its zetan: rank 0 takes
    1 / zetan of the draws, and the 10^5 hottest ranks about 48%."""
    mix = {"theta": 0.99, "rank_space": 10 ** 10, "zetan": 26.46902820178302}
    g = torch.Generator().manual_seed(4)
    r = zipfian_ranks(1 << 20, mix, g, "cpu")
    assert int(r.min()) == 0 and int(r.max()) < 10 ** 10
    top = float((r == 0).double().mean())
    assert abs(top - 1 / 26.469) < 0.003
    assert 0.42 < float((r < 10 ** 5).double().mean()) < 0.54


K13 = {"k": 13, "rule": "total", "code_dtype": "int32"}
TOTAL3 = {"k": 3, "rule": "total"}
READS = {"why": "x", "source": "reads", "draw": "uniform", "strand": "forward",
         "codes_per_call": 1000, "pool_batches": 3, "in_flight": 2}
ZIPF = dict(READS, source="genome", draw="scrambled_zipfian", strand="either", theta=0.99,
            rank_space=10 ** 10, zetan=26.46902820178302)


@pytest.mark.parametrize("mix", [READS, ZIPF], ids=["reads", "zipf"])
def test_pool_from_the_seed(mix):
    corpus = make_corpus(CONFIG, 5, torch.device("cpu"))
    a = make_pool(mix, corpus, K13, 77, "cpu")
    b = make_pool(mix, corpus, K13, 77, "cpu")
    assert len(a) == 3 and all(x.shape == (1000,) and x.dtype == torch.int32 for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    # every code is a window of the corpus, on one strand or the other
    if mix["source"] == "reads":
        known = set(window_codes(corpus.reads, 13).reshape(-1).tolist())
    else:
        fwd = window_codes(corpus.genome[None, :], 13).reshape(-1)
        known = set(fwd.tolist()) | set(revcomp(fwd, 13).tolist())
    assert set(a[0].tolist()) <= known


def test_pool_reads_are_whole_reads():
    corpus = make_corpus(CONFIG, 5, torch.device("cpu"))
    mix = dict(READS, codes_per_call=138 * 4)
    batch = make_pool(mix, corpus, dict(K13, code_dtype="int64"), 1, "cpu")[0].reshape(4, 138)
    rows = {tuple(r) for r in window_codes(corpus.reads, 13).tolist()}
    assert all(tuple(r) in rows for r in batch.tolist())


def test_batch_stats():
    codes = torch.tensor([code_of("AAC"), code_of("GTT"), code_of("AAC"), code_of("ACG")])
    assert batch_stats(codes, TOTAL3).distinct == 3
    assert batch_stats(codes, dict(TOTAL3, rule="canonical")).distinct == 2
    assert batch_stats(codes.to(torch.int32), TOTAL3).code_bytes == 4


@pytest.mark.parametrize("bad", [{"source": "genome"}, {"strand": "both"}, {"extra": 1},
                                 {"in_flight": 0}])
def test_mix_rejects_what_it_does_not_know(bad):
    with pytest.raises(ValueError):
        check_mix(dict(READS, **bad))
