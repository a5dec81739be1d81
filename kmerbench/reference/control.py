"""The control: the reference with its one guarantee broken.

The configurations state exact counts. The step that would tempt a later
change is an approximate table small enough to sit in the L2 cache: a
count-min sketch of two rows, with eight distinct keys to a counter. Its
answers are never below the exact count and nearly always above it, so a
run that serves them has to come out not correct.
"""

from __future__ import annotations

import torch

from kmerbench.reference.kmers import canonical, read_keys, revcomp

#: distinct keys per counter of each row
KEYS_PER_COUNTER = 8
#: rows of the sketch; an answer is the least of them
ROWS = 2
#: odd multipliers of the rows' multiply-shift hashes (64-bit)
_MULTIPLIERS = (0x9E3779B97F4A7C15 - (1 << 64), 0xC2B2AE3D27D4EB4F - (1 << 64))


class SketchCounts:
    """Count-min sketch of the reads' keys, under the same answer rule as
    ``ExactCounts``."""

    def __init__(self, reads: torch.Tensor, k: int, rule: str):
        self.k, self.rule = k, rule
        keys = read_keys(reads, k, rule)
        distinct = int(torch.unique(keys).numel())
        self.bits = max(4, (max(distinct // KEYS_PER_COUNTER, 16)).bit_length() - 1)
        self.table = torch.zeros((ROWS, 1 << self.bits), dtype=torch.int64, device=keys.device)
        for row in range(ROWS):
            self.table[row].index_add_(0, self._slot(keys, row), torch.ones_like(keys))

    def _slot(self, keys: torch.Tensor, row: int) -> torch.Tensor:
        h = keys * _MULTIPLIERS[row]          # wraps modulo 2^64
        return (h >> (64 - self.bits)) & ((1 << self.bits) - 1)

    def _lookup(self, keys: torch.Tensor) -> torch.Tensor:
        return torch.stack([self.table[r][self._slot(keys, r)] for r in range(ROWS)]).amin(0)

    def answers(self, codes: torch.Tensor) -> torch.Tensor:
        c = codes.to(torch.int64)
        if self.rule == "canonical":
            return self._lookup(canonical(c, self.k))
        return self._lookup(c) + self._lookup(revcomp(c, self.k))
