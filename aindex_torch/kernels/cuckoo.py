"""K10: the wide cuckoo engine of the sparse index.

``CuckooTables`` is the table of index/cuckoo.py on one device as bucketed
records (``kernels/buckets.py``), the engine of ``kernels/probe.py``'s
query, coverage and fill (kernel ``csrc/cuckoo64.cu``); its
``probe_plain`` answers as aindex_tpu/index/cuckoo.py:142 ``cuckoo_query``
does on the host rows (key_lo, key_hi, tf, slot): a key is present when a
row holds it. Keys are int64 tensors holding uint64 bits; the seeds, which
exceed int64, travel as their bit patterns. An empty row (0, 0xFFFFFFFF,
0, 0) matches the one key 0xFFFFFFFF_00000000 when JAX compares whole
rows; that key's answer is taken from the host rows at upload.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from aindex_torch.kernels.buckets import EMPTY_KEY, BucketTables, build_records
from aindex_torch.kernels.lookup import _s64, mix64
from aindex_torch.trace import span, to_device


@dataclasses.dataclass(frozen=True)
class CuckooTables(BucketTables):
    """The wide cuckoo table on one device as bucketed records, keyed by
    the whole 64-bit key, level 0 hashed with the table's ``seed1``."""

    QUERY = "cuckoo64"
    COVERAGE = "cuckoocov64"
    FILL = "cuckoofill64"

    @classmethod
    def from_host(cls, table: np.ndarray, m: int, seed1: int, seed2: int,
                  device) -> "CuckooTables":
        """The records of the host table (index/cuckoo.py: uint32[2m, 4]
        rows, m a half, key_hi = 0xFFFFFFFF for an empty row), built on
        ``device``; in the timed span ``aindex.index.upload``."""
        with span("aindex.index.upload", timed=True):
            rows = to_device(torch.from_numpy(np.ascontiguousarray(table).view(np.int32)),
                             device)
            rows = rows[rows[:, 1] != -1]
            keys = (rows[:, 0].to(torch.int64) & 0xFFFFFFFF) \
                | (rows[:, 1].to(torch.int64) << 32)
            records, levels = build_records(keys, rows[:, 2], rows[:, 3], seed1)
            return cls(records, levels, seed1, 64, empty_answer(table, m, seed1, seed2))


def empty_answer(table: np.ndarray, m: int, seed1: int, seed2: int) -> tuple[bool, int, int]:
    """(hit, tf, slot) of EMPTY_KEY on the host rows, as JAX's row compare
    gives it: its row in the first half, else in the second."""
    key = torch.tensor([_s64(EMPTY_KEY)])
    for base, seed in ((0, seed1), (m, seed2)):
        r = int(mix64(key ^ _s64(seed))[0] & (m - 1)) + base
        lo, hi, tf, slot = (int(x) for x in table[r:r + 1].view(np.int32)[0])
        if lo == 0 and hi == -1:  # EMPTY_KEY's two words
            return True, tf & 0xFFFFFFFF, slot
    return False, 0, -1
