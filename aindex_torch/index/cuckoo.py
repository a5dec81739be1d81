"""Wide cuckoo table: the sparse index's device engine for the (n, k) that
the quotient table does not take, k <= 30 (index/quotcuckoo.py
``eligible``).

Host copy of aindex_tpu/index/cuckoo.py's ``CuckooTable``: the verified
(key -> tf, slot) mapping re-packed so that a query reads at most two
16-byte rows. Layout: ``table[2m, 4]`` uint32 rows ``(key_lo, key_hi, tf,
slot)``; row ``mix64(key ^ seed_h) & (m - 1)`` (+ ``m`` for the second
half); empty marker ``key_hi = 0xFFFFFFFF`` (keys are < 2^62). The build
is the native random-walk insertion of native/aindex_host.cpp (the one
aindex_tpu runs), so the table is byte-identical to aindex_tpu's. On the
device its rows become bucketed records (kernels/buckets.py), which K10
(kernels/cuckoo.py, ``csrc/cuckoo64.cu``) probes.
"""

from __future__ import annotations

import numpy as np
import torch

from aindex_torch import native
from aindex_torch.kernels.cuckoo import CuckooTables

_SEED1 = 0x1B873593_9E3779B9
_SEED2 = 0x85EBCA6B_C2B2AE35


def _mix64_np(x: np.ndarray) -> np.ndarray:
    x = np.array(x, dtype=np.uint64)
    with np.errstate(over="ignore"):  # mod-2^64 wraparound is the hash
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xFF51AFD7ED558CCD)
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xC4CEB9FE1A85EC53)
        x ^= x >> np.uint64(33)
    return x


class CuckooTable:
    """Built table on the host (``table_host`` uint32[2m, 4]);
    ``tables(device)`` gives it on a device for K10."""

    def __init__(self, table: np.ndarray, m: int, seed1: int, seed2: int):
        self.table_host = table
        self.m = m
        self.seed1 = int(seed1)
        self.seed2 = int(seed2)
        self._tables: CuckooTables | None = None

    def tables(self, device) -> CuckooTables:
        """The table on ``device`` (built once, then cached): its rows as
        the bucketed records K10 probes (``CuckooTables.from_host``)."""
        device = torch.device(device)
        if self._tables is None or self._tables.device != device:
            self._tables = CuckooTables.from_host(self.table_host, self.m, self.seed1,
                                                  self.seed2, device)
        return self._tables

    def release_device(self) -> None:
        """Drop the device copy of the table (``tables`` uploads it again)."""
        self._tables = None

    @property
    def nbytes(self) -> int:
        return self.table_host.nbytes

    @classmethod
    def build(cls, keys: np.ndarray, tf: np.ndarray, slot: np.ndarray,
              max_rebuilds: int = 8) -> "CuckooTable":
        """Build from parallel arrays (distinct uint64 keys < 2^62), with
        aindex_tpu's sizing, seeds and reseeding, by the native insertion
        (a missing C++ compiler raises)."""
        n = len(keys)
        m = 1
        while m < max(1, int(np.ceil(n * 1.05 / 2))):
            m <<= 1
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        tf = np.ascontiguousarray(tf, dtype=np.uint32)
        slot = np.ascontiguousarray(slot, dtype=np.int32)
        s1, s2 = _SEED1, _SEED2
        for attempt in range(max_rebuilds):
            table = native.cuckoo_build(keys, tf, slot, m, s1, s2)
            if table is not None:
                return cls(table, m, s1, s2)
            s1 = int(_mix64_np(np.uint64(s1 + 1)))
            s2 = int(_mix64_np(np.uint64(s2 + 3)))
            if attempt >= 1:
                m <<= 1  # grow after two failed seed sets
        raise RuntimeError(f"cuckoo build failed after {max_rebuilds} attempts "
                           f"(n={n}, m={m})")
