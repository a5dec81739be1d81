"""The one traffic generator: a pool of query batches from a mix's
parameters (``kmerbench/mixes/<name>.json``).

A mix is a closed loop of one caller that keeps ``in_flight`` calls
outstanding; each call hands ``codes_per_call`` k-mer codes, already on
the device, taken in turn from a pool of ``pool_batches`` batches made in
set-up from the seed. Where the codes come from:

* ``"source": "reads"``, ``"draw": "uniform"``: every window of whole
  reads drawn uniformly (with replacement) from the read set, the last
  read's windows cut at the batch's end.
* ``"source": "genome"``, ``"draw": "scrambled_zipfian"``: k-mer start
  positions of the genome drawn as YCSB's ``ScrambledZipfianGenerator``
  draws keys: a zipfian rank over ``rank_space`` items with the constant
  ``theta`` (Gray et al.'s method, with ``zetan`` given), hashed by FNV-1a
  64 and taken modulo the number of positions.

``"strand": "forward"`` keeps each window as it reads; ``"either"`` takes
its reverse complement with odds one half. Every value drawn is the same
for the same seed, and no two batches of a pool are alike.

A mix's module (``mixes/<name>.py``, see ``spec.py``) may define any of
``HOOKS`` in its own way; ``hooks`` gives the generator's for the rest.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from types import ModuleType, SimpleNamespace

import torch

from kmerbench.corpus import generator
from kmerbench.reference.kmers import ExactCounts, canonical, revcomp, window_codes

#: every key a mix file may hold, and the values a few of them may take
KEYS = {"why", "source", "draw", "strand", "codes_per_call", "pool_batches",
        "in_flight", "theta", "rank_space", "zetan"}
SOURCES = {"reads": "uniform", "genome": "scrambled_zipfian"}
STRANDS = ("forward", "either")
CODE_DTYPES = {"int32": torch.int32, "int64": torch.int64}

_FNV_OFFSET = 0xCBF29CE484222325 - (1 << 64)
_FNV_PRIME = 1099511628211


def check_mix(mix: dict) -> None:
    """Raise on a key or value the generator does not know."""
    unknown = set(mix) - KEYS
    if unknown:
        raise ValueError(f"unknown mix keys {sorted(unknown)}")
    if SOURCES.get(mix["source"]) != mix["draw"]:
        raise ValueError(f"source {mix['source']!r} with draw {mix['draw']!r}: "
                         f"expected one of {SOURCES}")
    if mix["strand"] not in STRANDS:
        raise ValueError(f"strand {mix['strand']!r} is not one of {STRANDS}")
    for key in ("codes_per_call", "pool_batches", "in_flight"):
        if int(mix[key]) < 1:
            raise ValueError(f"{key} must be at least 1")


def fnv1a64(values: torch.Tensor) -> torch.Tensor:
    """YCSB's ``Utils.fnvhash64`` of each non-negative int64, its absolute
    value (int64 arithmetic wraps as Java's long does)."""
    v = values.clone()
    h = torch.full_like(v, _FNV_OFFSET)
    for _ in range(8):
        h = (h ^ (v & 0xFF)) * _FNV_PRIME
        v = v >> 8
    return h.abs()


def zipfian_ranks(n: int, mix: dict, g: torch.Generator, device) -> torch.Tensor:
    """``n`` ranks of YCSB's ``ZipfianGenerator(0, rank_space - 1, theta,
    zetan).nextValue()``."""
    theta, items, zetan = float(mix["theta"]), float(mix["rank_space"]), float(mix["zetan"])
    zeta2 = 1.0 + 0.5 ** theta
    alpha = 1.0 / (1.0 - theta)
    eta = (1.0 - (2.0 / items) ** (1.0 - theta)) / (1.0 - zeta2 / zetan)
    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    uz = u * zetan
    far = torch.floor(items * torch.pow(eta * u - eta + 1.0, alpha)).to(torch.int64)
    return torch.where(uz < 1.0, 0, torch.where(uz < 1.0 + 0.5 ** theta, 1, far))


def _windows_of_reads(reads: torch.Tensor, n: int, k: int, g, device) -> torch.Tensor:
    per_read = reads.shape[1] - k + 1
    rows = torch.randint(0, reads.shape[0], (math.ceil(n / per_read),), generator=g,
                         device=device)
    return window_codes(reads[rows], k).reshape(-1)[:n]


def _zipfian_positions(genome_codes: torch.Tensor, n: int, mix: dict, g,
                       device) -> torch.Tensor:
    at = torch.remainder(fnv1a64(zipfian_ranks(n, mix, g, device)), genome_codes.numel())
    return genome_codes[at]


@dataclass
class BatchStats:
    """What the roofline counts of one batch need."""
    n: int            # codes in the batch
    code_bytes: int   # bytes of one code as handed in
    distinct: int     # distinct table entries the batch's keys reach


def make_pool(mix: dict, corpus, config: dict, seed: int, device) -> list[torch.Tensor]:
    """``pool_batches`` batches of ``codes_per_call`` codes each, 1-D, of
    the configuration's ``code_dtype``, on ``device``."""
    check_mix(mix)
    k, code_dtype = int(config["k"]), config["code_dtype"]
    n = int(mix["codes_per_call"])
    if mix["source"] == "genome":
        genome_codes = window_codes(corpus.genome[None, :], k).reshape(-1)
    pool = []
    for b in range(int(mix["pool_batches"])):
        g = generator(seed, 1 + b, device)
        if mix["source"] == "reads":
            codes = _windows_of_reads(corpus.reads, n, k, g, device)
        else:
            codes = _zipfian_positions(genome_codes, n, mix, g, device)
        if mix["strand"] == "either":
            flip = torch.randint(0, 2, (n,), generator=g, device=device, dtype=torch.bool)
            codes = torch.where(flip, revcomp(codes, k), codes)
        pool.append(codes.to(CODE_DTYPES[code_dtype]).contiguous())
    return pool


def batch_stats(batch: torch.Tensor, config: dict) -> BatchStats:
    """Codes, their width, and the distinct entries they reach: distinct
    codes under the "total" rule (one total entry a code), distinct
    canonical forms under "canonical"."""
    keys = batch.to(torch.int64)
    if config["rule"] == "canonical":
        keys = canonical(keys, int(config["k"]))
    return BatchStats(int(batch.numel()), batch.element_size(), int(torch.unique(keys).numel()))


def call(system, batch: torch.Tensor) -> torch.Tensor:
    """One call of the window: the batch through the configuration's entry."""
    return system.call(batch)


def reference(reads: torch.Tensor, config: dict) -> ExactCounts:
    """What a kept call's answers are compared with: ``answers(batch)``."""
    return ExactCounts(reads, int(config["k"]), config["rule"])


#: what a mix's module may define in its own way, with the signatures above
HOOKS = ("make_pool", "call", "reference", "batch_stats")


def hooks(code: ModuleType | None) -> SimpleNamespace:
    """The mix's functions: each one its module defines, else the generator's."""
    return SimpleNamespace(**{name: getattr(code, name, globals()[name]) for name in HOOKS})
