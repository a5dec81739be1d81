"""The bucketed record layout that K6 and K10 probe on the device
(``csrc/probe.cuh`` ``Buckets``), its build and its plain probe.

Both cuckoo tables of the sparse index (index/quotcuckoo.py, index/cuckoo.py)
answer one question: is the key in the index, and with which tf and slot.
On the device both are laid out alike, built at upload from the host
tables (which stay as aindex_tpu builds them):

* a record is 16 bytes, int32[4]: (key_lo, key_hi, tf, slot);
* a bucket is ``BUCKET`` records (64 bytes, one aligned block);
* level 0 has 2^lb buckets, the fewest with at most ``KEYS_PER_BUCKET``
  keys a bucket on average; a key's bucket there is the top lb bits of
  ``mix64(key ^ seed)``;
* a bucket keeps the first ``BUCKET`` of its keys in key order; the rest
  go to level 1, sized the same way for them, whose hash is
  ``mix64(h ^ LEVEL_SALT)`` of level 0's ``h``, and so on;
* a bucket whose keys went on carries ``MARK`` in its first record's
  key_hi (keys are below 2^62, so key_hi has two free bits); an empty
  record holds key_hi = ``EMPTY_HI``, which no key's high word equals.

So a probe reads one bucket, and the next level's only when the bucket is
marked. The records of all levels lie in one int32[n_buckets * BUCKET, 4]
tensor, level l from bucket ``levels[l][0]``.

A key is masked to the table's ``w`` bits first (the quotient table's
bijection keeps 2k bits). A masked key at or above 2^62 is absent, but for
``EMPTY_KEY`` = 0xFFFFFFFF_00000000 on the wide table: its empty rows
(0, 0xFFFFFFFF, 0, 0) match that key as JAX compares rows, and its
answer there is computed from the host table at upload (``empty``).
"""

from __future__ import annotations

import dataclasses

import torch

from aindex_torch.kernels.lookup import _s64, _shr, mix64

#: records a bucket (probe.cuh ``BUCKET``): 64 bytes, one aligned block
BUCKET = 4
#: the most keys a bucket holds on average at each level (about 4% of a
#: level's keys go on at 2.0, under 1% at half that)
KEYS_PER_BUCKET = 2.0
#: most levels a table may have (probe.cuh ``MAX_LEVELS``)
MAX_LEVELS = 8
MARK = 1 << 31
EMPTY_HI = 1 << 30
EMPTY_KEY = 0xFFFFFFFF_00000000
#: level l + 1 hashes mix64(h ^ LEVEL_SALT) of level l's h
LEVEL_SALT = 0x2545F4914F6CDD1D


def level_bits(n: int) -> int:
    """log2 of a level's bucket count for n keys."""
    lb = 0
    while n > KEYS_PER_BUCKET * (1 << lb):
        lb += 1
    return lb


def bucket_of(h: torch.Tensor, lb: int) -> torch.Tensor:
    """The top lb bits of the uint64 bits of int64 ``h`` (0 for lb = 0)."""
    return _shr(h, 1) >> (63 - lb)


def build_records(keys: torch.Tensor, tf: torch.Tensor, slot: torch.Tensor, seed: int):
    """(records int32[n_buckets * BUCKET, 4], levels ((first bucket, lb),
    ...)) of distinct int64 ``keys`` below 2^62 with their int32 ``tf`` and
    ``slot``, on the keys' device. Deterministic: a bucket keeps its
    smallest keys."""
    if bool(((keys >> 62) != 0).any()):
        raise ValueError("bucketed records take keys below 2^62")
    live = torch.arange(keys.numel(), device=keys.device)
    h = mix64(keys ^ _s64(seed))
    levels, parts, first = [], [], 0
    while True:
        if len(levels) == MAX_LEVELS:
            raise RuntimeError(f"{live.numel()} keys left after {MAX_LEVELS} bucket levels")
        lb = level_bits(live.numel())
        order = torch.sort(keys[live], stable=True).indices
        b, second = torch.sort(bucket_of(h[order], lb), stable=True)
        order = order[second]
        rank = torch.arange(b.numel(), device=b.device) - torch.searchsorted(b, b)
        keep = rank < BUCKET
        rec = torch.zeros(((1 << lb) * BUCKET, 4), dtype=torch.int32, device=keys.device)
        rec[:, 1] = EMPTY_HI
        src = live[order[keep]]
        k = keys[src]
        rec[b[keep] * BUCKET + rank[keep]] = torch.stack(
            [k.to(torch.int32), (k >> 32).to(torch.int32), tf[src], slot[src]], dim=1)
        rec[torch.unique(b[~keep]) * BUCKET, 1] |= -MARK  # MARK's int32 bits
        levels.append((first, lb))
        parts.append(rec)
        first += 1 << lb
        over = order[~keep]
        if not over.numel():
            break
        live, h = live[over], mix64(h[over] ^ LEVEL_SALT)
    return torch.cat(parts), tuple(levels)


@dataclasses.dataclass(frozen=True)
class BucketTables:
    """The bucketed records of a cuckoo table on one device, the engine of
    ``kernels/probe.py``'s query, coverage and fill (probe.cuh
    ``Buckets``): records int32[n_buckets * BUCKET, 4], the levels (first
    bucket, log2 bucket count), the level-0 seed (a uint64 value), the key
    bits kept ``w`` (64: all) and ``empty``, the (hit, tf, slot) of
    ``EMPTY_KEY``."""
    records: torch.Tensor
    levels: tuple[tuple[int, int], ...]
    seed: int
    w: int
    empty: tuple[bool, int, int] = (False, 0, -1)

    @property
    def device(self) -> torch.device:
        return self.records.device

    @property
    def n_buckets(self) -> int:
        first, lb = self.levels[-1]
        return first + (1 << lb)

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.records,)

    def engine_args(self) -> tuple[list, list]:
        """probe.cuh ``Buckets``: p = {records}, u = {BUCKET, w, seed, the
        empty key's hit, tf and slot, the level count, then each level's
        first bucket and lb}."""
        hit, tf, slot = self.empty
        return ([self.records.data_ptr()],
                [BUCKET, self.w, self.seed, int(hit), tf, slot, len(self.levels),
                 *(x for level in self.levels for x in level)])

    def check(self) -> None:
        r = self.records
        if r.dtype != torch.int32 or r.shape != (self.n_buckets * BUCKET, 4) \
                or not r.is_contiguous():
            raise ValueError(f"records must be a contiguous int32[{self.n_buckets * BUCKET}, 4]"
                             " tensor")
        if not 1 <= len(self.levels) <= MAX_LEVELS or not 1 <= self.w <= 64:
            raise ValueError(f"{len(self.levels)} levels (1..{MAX_LEVELS}), w={self.w} (1..64)")

    def check_k(self, k: int) -> None:
        if not 1 <= k <= 31:
            raise ValueError(f"k={k} is outside 1..31")

    def probe_plain(self, keys: torch.Tensor):
        """(hit, tf int64, slot int64) per int64 key: the key masked to w
        bits, then its bucket at each level while the bucket before was
        marked; the empty key's answer from ``empty``."""
        if self.w < 64:
            keys = keys & ((1 << self.w) - 1)
        lo, hi = keys & 0xFFFFFFFF, _shr(keys, 32)
        active = (keys >> 62) == 0
        hit = torch.zeros_like(active)
        tf = torch.zeros_like(keys)
        slot = torch.full_like(keys, -1)
        buckets = self.records.view(-1, BUCKET, 4)
        h = mix64(keys ^ _s64(self.seed))
        for first, lb in self.levels:
            rec = buckets[first + bucket_of(h, lb)].to(torch.int64)
            match = ((rec[..., 0] & 0xFFFFFFFF) == lo[:, None]) \
                & ((rec[..., 1] & 0x7FFFFFFF) == hi[:, None]) & active[:, None]
            found = match.any(dim=1)
            j = match.to(torch.int8).argmax(dim=1, keepdim=True)
            tf = torch.where(found, rec[..., 2].gather(1, j)[:, 0] & 0xFFFFFFFF, tf)
            slot = torch.where(found, rec[..., 3].gather(1, j)[:, 0], slot)
            hit = hit | found
            active = active & ~found & ((rec[:, 0, 1] & MARK) != 0)
            if not bool(active.any()):
                break
            h = mix64(h ^ LEVEL_SALT)
        e_hit, e_tf, e_slot = self.empty
        if e_hit:
            at = keys == _s64(EMPTY_KEY)
            hit = hit | at
            tf = torch.where(at, e_tf & 0xFFFFFFFF, tf)
            slot = torch.where(at, e_slot, slot)
        return hit, tf, slot
