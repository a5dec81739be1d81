"""Plain k-mer arithmetic and exact counts.

A base is a code 0-3 (A, C, G, T). A k-mer's code holds its first base in
the highest two bits: code = sum(base[i] << 2 * (k - 1 - i)). Its reverse
complement reads the complemented bases (3 - b) backwards. Every function
takes and returns int64 tensors on any device; k is at most 31.
"""

from __future__ import annotations

import torch

#: rows of reads turned into window codes at a time (bounds the temporaries)
BLOCK_ROWS = 1 << 16

#: the answer rules a configuration may name
RULES = ("total", "canonical")


def window_codes(bases: torch.Tensor, k: int) -> torch.Tensor:
    """int64 [rows, L - k + 1]: the code of every k-mer window of each row
    of ``bases`` (uint8 [rows, L], values 0-3)."""
    rows, length = bases.shape
    w = length - k + 1
    b = bases.to(torch.int64)
    code = torch.zeros((rows, w), dtype=torch.int64, device=bases.device)
    for j in range(k):
        code = (code << 2) | b[:, j:j + w]
    return code


def revcomp(codes: torch.Tensor, k: int) -> torch.Tensor:
    """The reverse complement of each k-mer code."""
    c = codes.to(torch.int64)
    r = torch.zeros_like(c)
    for _ in range(k):
        r = (r << 2) | (3 - (c & 3))
        c = c >> 2
    return r


def canonical(codes: torch.Tensor, k: int) -> torch.Tensor:
    """min(code, revcomp(code)) of each k-mer code."""
    c = codes.to(torch.int64)
    return torch.minimum(c, revcomp(c, k))


def read_keys(reads: torch.Tensor, k: int, rule: str) -> torch.Tensor:
    """Every window of every read as a 1-D int64 key: its forward code
    under the "total" rule, its canonical code under "canonical"."""
    if rule not in RULES:
        raise ValueError(f"unknown rule {rule!r}; expected one of {RULES}")
    rows, length = reads.shape
    w = length - k + 1
    keys = torch.empty(rows * w, dtype=torch.int64, device=reads.device)
    for lo in range(0, rows, BLOCK_ROWS):
        hi = min(lo + BLOCK_ROWS, rows)
        codes = window_codes(reads[lo:hi], k)
        if rule == "canonical":
            codes = canonical(codes, k)
        keys[lo * w:hi * w] = codes.reshape(-1)
    return keys


class Spectrum:
    """Sorted distinct keys and their counts."""

    def __init__(self, keys: torch.Tensor):
        self.keys, self.counts = torch.unique(keys, sorted=True, return_counts=True)

    def __len__(self) -> int:
        return int(self.keys.numel())

    def lookup(self, keys: torch.Tensor) -> torch.Tensor:
        """The count of each key, 0 for a key never seen."""
        if not len(self):
            return torch.zeros_like(keys)
        at = torch.searchsorted(self.keys, keys).clamp_(max=len(self) - 1)
        return torch.where(self.keys[at] == keys, self.counts[at], 0)


class ExactCounts:
    """The exact answer to a query code, from the reads alone.

    "total": the count of the code's k-mer plus that of its reverse
    complement, each counted on the reads' forward strand (aindex's dense
    13-mer total). "canonical": the count of the code's canonical form,
    every window counted canonically (aindex's sparse k-mer tf)."""

    def __init__(self, reads: torch.Tensor, k: int, rule: str):
        self.k, self.rule = k, rule
        self.spectrum = Spectrum(read_keys(reads, k, rule))

    def answers(self, codes: torch.Tensor) -> torch.Tensor:
        """int64 answers, one per code."""
        c = codes.to(torch.int64)
        if self.rule == "canonical":
            return self.spectrum.lookup(canonical(c, self.k))
        return self.spectrum.lookup(c) + self.spectrum.lookup(revcomp(c, self.k))
