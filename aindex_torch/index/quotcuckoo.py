"""Quotiented split-half cuckoo table: the query engine of the sparse index.

Host side copied from aindex_tpu/index/quotcuckoo.py (:57-273), so that
both packages build byte-identical tables for the same keys; the device
probes are the hand-written kernels K6 and K7 (kernels/quot.py;
``quot_tf_windows``, quotcuckoo.py:329's ASCII-rows coverage, is
re-exported here).

Each half of the table has its own invertible mixer (an xorshift-multiply
bijection on the 2k-bit code space); the row index takes the hash's low
``lb`` bits and the row stores the remaining ``2k - lb`` bits as a
fingerprint. Row + fingerprint reconstruct the full hash, and the
bijection the full key, so a fingerprint match is an exact key match. Per
half ``h``:

    row  = bij_h(key) & (m - 1)
    fp   = bij_h(key) >> lb               (<= 31 bits)
    cell = (fp, tf)                        8 bytes

Slot ids (needed only by the pfid and position paths) live in parallel
int32 columns read through the winning row. On the device the occupied
rows become bucketed 16-byte (key, tf, slot) records, each key recovered
by inverting its half's bijection (``QuotCuckoo.tables``,
kernels/buckets.py).

Eligibility: fp must fit 31 bits (0xFFFFFFFF is the empty marker), i.e.
``lb >= 2k - 31``; an ineligible ``(n, k)`` is served by the wide cuckoo
table (index/cuckoo.py) for k <= 30, else by the MPHF walk
(index/sparse23.py ``tables``).
"""

from __future__ import annotations

import numpy as np
import torch

from aindex_torch import native
from aindex_torch.kernels.quot import QuotTables, quot_tf_windows  # noqa: F401 (re-export)

_EMPTY_FP = np.uint32(0xFFFFFFFF)

# base odd multipliers for the two bijections (public splitmix64/murmur
# mixing constants; any good odd constants work, rebuilds re-derive)
_M1A = 0x9E3779B97F4A7C15
_M1B = 0xBF58476D1CE4E5B9
_M2A = 0xC2B2AE3D27D4EB4F
_M2B = 0x94D049BB133111EB

#: Largest key count the pure-Python insertion takes when the native
#: library cannot be built; beyond it the build raises.
PURE_MAX_KEYS = 1 << 14


def _mix64_np(x: np.ndarray | int) -> np.ndarray:
    x = np.uint64(x) if np.isscalar(x) else x.copy()
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(33)
        x = x * np.uint64(0xFF51AFD7ED558CCD)
        x ^= x >> np.uint64(33)
        x = x * np.uint64(0xC4CEB9FE1A85EC53)
        x ^= x >> np.uint64(33)
    return x


def derive_mults(attempt: int, w: int) -> tuple[int, int, int, int]:
    """The four odd multipliers (masked to w bits) for a build attempt."""
    mask = (1 << w) - 1
    out = []
    for i, base in enumerate((_M1A, _M1B, _M2A, _M2B)):
        m = int(_mix64_np(np.uint64(base + 2 * attempt * (i + 1)))) if attempt \
            else base
        out.append((m | 1) & mask)
    return tuple(out)


def _bij_np(x: np.ndarray, ma: int, mb: int, w: int) -> np.ndarray:
    """xorshift-multiply bijection on the low w bits (numpy, mod-2^w)."""
    mask = np.uint64((1 << w) - 1)
    s = np.uint64((w + 1) // 2)
    x = np.asarray(x, dtype=np.uint64) & mask
    with np.errstate(over="ignore"):
        x = x ^ (x >> s)
        x = (x * np.uint64(ma)) & mask
        x = x ^ (x >> s)
        x = (x * np.uint64(mb)) & mask
        x = x ^ (x >> s)
    return x


def natural_lb(n: int, w: int) -> int:
    """Per-half log2 row count for n keys: total load n/(2m) <= ~0.467
    (under the 1-slot 2-choice cuckoo threshold of 0.5) and fp <= 31
    bits."""
    lb = 1
    while (1 << lb) < max(1, int(np.ceil(n * 1.07))):
        lb += 1
    return max(lb, w - 31, 1)


def eligible(n: int, k: int) -> bool:
    """The quotient layout is used when the fp-width floor does not force a
    table more than ~4x the natural size or larger than ~32 MB."""
    w = 2 * k
    if w - 31 <= 0:
        return True
    lb_nat = natural_lb(n, 0)  # size-driven part only
    return (w - 31) <= max(lb_nat + 2, 20)


class QuotCuckoo:
    """Built table: ``fp_tf`` uint32[2m, 2] + ``slot`` int32[2m] on the
    host; ``tables(device)`` gives the halves as separate tensors."""

    def __init__(self, fp_tf: np.ndarray, slot: np.ndarray, m: int, lb: int,
                 w: int, mults: tuple[int, int, int, int]):
        self.fp_tf_host = fp_tf
        self.slot_host = slot
        self.m = m
        self.lb = lb
        self.w = w
        self.mults = tuple(np.uint64(mu) for mu in mults)
        self._tables: QuotTables | None = None

    def tables(self, device) -> QuotTables:
        """The table on ``device`` (built once, then cached): its rows as
        the bucketed records K6, K7 and K9 probe (``QuotTables.from_host``)."""
        device = torch.device(device)
        if self._tables is None or self._tables.device != device:
            self._tables = QuotTables.from_host(self.fp_tf_host, self.slot_host, self.m,
                                                self.lb, self.w, self.mults, device)
        return self._tables

    def release_device(self) -> None:
        """Drop the device copy of the table (``tables`` uploads it again)."""
        self._tables = None

    @property
    def nbytes(self) -> int:
        return self.fp_tf_host.nbytes + self.slot_host.nbytes

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, keys: np.ndarray, tf: np.ndarray, slot: np.ndarray,
              k: int, max_rebuilds: int = 10) -> "QuotCuckoo":
        """Build from parallel arrays of distinct 2k-bit codes, with the
        native insertion when it can be built; above ``PURE_MAX_KEYS`` keys
        it is required (a missing compiler raises)."""
        w = 2 * k
        n = len(keys)
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        tf = np.ascontiguousarray(tf, dtype=np.uint32)
        slot = np.ascontiguousarray(slot, dtype=np.int32)
        use_native = n > PURE_MAX_KEYS or native.available()
        lb = natural_lb(n, w)
        attempt = 0
        while attempt < max_rebuilds:
            mults = derive_mults(attempt, w)
            if use_native:
                out = native.quot_build(keys, tf, slot, 1 << lb, lb, w, mults)
            else:
                out = cls._try_build(keys, tf, slot, 1 << lb, lb, w, mults)
            if out is not None:
                return cls(out[0], out[1], 1 << lb, lb, w, mults)
            attempt += 1
            if attempt % 2 == 0:
                lb += 1  # grow after two failed multiplier sets
        raise RuntimeError(
            f"quotient cuckoo build failed after {max_rebuilds} attempts "
            f"(n={n}, m=2^{lb})")

    @staticmethod
    def _try_build(keys, tf, slot, m, lb, w, mults):
        """Pure-Python random-walk insertion (the native one's twin)."""
        fp_tf = np.zeros((2 * m, 2), dtype=np.uint32)
        fp_tf[:, 0] = _EMPTY_FP
        slot_col = np.zeros(2 * m, dtype=np.int32)
        side_key = np.zeros(2 * m, dtype=np.uint64)  # evictee recovery
        mask = np.uint64(m - 1)
        ma = (np.uint64(mults[0]), np.uint64(mults[2]))
        mb = (np.uint64(mults[1]), np.uint64(mults[3]))
        max_kicks = 512
        rng = np.uint64(mults[0]) ^ np.uint64(0x9E3779B97F4A7C15)
        for i in range(len(keys)):
            key, etf, eslot = keys[i], tf[i], slot[i]
            half = 0
            kicks = 0
            while True:
                h = _bij_np(np.uint64(key), int(ma[half]), int(mb[half]), w)
                row = int(h & mask) + (m if half else 0)
                if fp_tf[row, 0] == _EMPTY_FP:
                    fp_tf[row, 0] = np.uint32(h >> np.uint64(lb))
                    fp_tf[row, 1] = etf
                    slot_col[row] = eslot
                    side_key[row] = key
                    break
                okey = side_key[row]
                otf, oslot = fp_tf[row, 1], slot_col[row]
                fp_tf[row, 0] = np.uint32(h >> np.uint64(lb))
                fp_tf[row, 1] = etf
                slot_col[row] = eslot
                side_key[row] = key
                key, etf, eslot = okey, otf, oslot
                half ^= 1
                kicks += 1
                if kicks > max_kicks:
                    return None
                rng = _mix64_np(rng)
                if (kicks & 63) == 0 and (int(rng) & 1):
                    half ^= 1
        return fp_tf, slot_col

    # -- host lookup -------------------------------------------------------

    def lookup_host(self, keys: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(found, tf, slot) on the host rows, as aindex_tpu's device probe
        reads them; the second row is read only for first-probe misses."""
        keys = np.asarray(keys, dtype=np.uint64)
        mask = np.uint64(self.m - 1)
        lbs = np.uint64(self.lb)
        h1 = _bij_np(keys, int(self.mults[0]), int(self.mults[1]), self.w)
        r1 = (h1 & mask).astype(np.int64)
        c1 = self.fp_tf_host[r1]
        found = c1[:, 0] == (h1 >> lbs).astype(np.uint32)
        tf = np.where(found, c1[:, 1], np.uint32(0))
        slot = np.where(found, self.slot_host[r1], -1).astype(np.int32)
        idx = np.nonzero(~found)[0]
        if idx.size:
            h2 = _bij_np(keys[idx], int(self.mults[2]), int(self.mults[3]),
                         self.w)
            r2 = (h2 & mask).astype(np.int64) + self.m
            c2 = self.fp_tf_host[r2]
            hit2 = c2[:, 0] == (h2 >> lbs).astype(np.uint32)
            found[idx] = hit2
            tf[idx] = np.where(hit2, c2[:, 1], np.uint32(0))
            slot[idx] = np.where(hit2, self.slot_host[r2], -1).astype(np.int32)
        return found, tf, slot

