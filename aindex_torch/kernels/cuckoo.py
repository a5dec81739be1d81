"""K10: the wide cuckoo engine of the sparse index.

``CuckooTables`` is the table of index/cuckoo.py on one device, the
engine of ``kernels/probe.py``'s query, coverage and fill (kernel
``csrc/cuckoo64.cu``); ``CuckooTables.probe_plain`` is the plain version
of aindex_tpu/index/cuckoo.py:142 ``cuckoo_query``: two rows of (key_lo,
key_hi, tf, slot) per key, at ``mix64(key ^ seed) & (m - 1)`` in the first
half and ``+ m`` in the second. Keys are int64 tensors holding uint64 bits;
the seeds, which exceed int64, travel as their bit patterns. The empty
marker key_hi = 0xFFFFFFFF reads -1 in the int32 storage and never equals
the high half of a key below 2^62 (k <= 30).
"""

from __future__ import annotations

import dataclasses

import torch

from aindex_torch.kernels.lookup import _s64, mix64


@dataclasses.dataclass(frozen=True)
class CuckooTables:
    """table int32[2m, 4] rows (key_lo, key_hi, tf, slot), m rows a half,
    and the halves' seeds (Python ints, uint64 values)."""
    table: torch.Tensor
    m: int
    seed1: int
    seed2: int

    QUERY = "cuckoo64"
    COVERAGE = "cuckoocov64"
    FILL = "cuckoofill64"

    @property
    def device(self) -> torch.device:
        return self.table.device

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.table,)

    def engine_args(self) -> tuple[list, list]:
        """probe.cuh ``Cuckoo``: p = {table}, u = {m, seed1, seed2}."""
        return [self.table.data_ptr()], [self.m, self.seed1, self.seed2]

    def check(self) -> None:
        t = self.table
        if t.dtype != torch.int32 or t.shape != (2 * self.m, 4) or not t.is_contiguous():
            raise ValueError(f"table must be a contiguous int32[{2 * self.m}, 4] tensor")
        if self.m <= 0 or self.m & (self.m - 1):
            raise ValueError(f"m={self.m} is not a power of two")

    def check_k(self, k: int) -> None:
        if not 1 <= k <= 31:
            raise ValueError(f"k={k} is outside 1..31")

    def probe_plain(self, keys: torch.Tensor):
        """(hit, tf int64, slot int64) per key: both rows' verified
        compares of the whole 64-bit key, the first half winning."""
        lo, hi = keys & 0xFFFFFFFF, (keys >> 32) & 0xFFFFFFFF
        hit = torch.zeros_like(keys, dtype=torch.bool)
        tf = torch.zeros_like(keys)
        slot = torch.full_like(keys, -1)
        for base, seed in ((self.m, self.seed2), (0, self.seed1)):
            c = self.table[(mix64(keys ^ _s64(seed)) & (self.m - 1)) + base].to(torch.int64)
            h = ((c[:, 0] & 0xFFFFFFFF) == lo) & ((c[:, 1] & 0xFFFFFFFF) == hi)
            hit = hit | h
            tf = torch.where(h, c[:, 2] & 0xFFFFFFFF, tf)
            slot = torch.where(h, c[:, 3], slot)
        return hit, tf, slot
