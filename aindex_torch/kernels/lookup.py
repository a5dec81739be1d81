"""K3: batched lookups in a dense 13-mer table; K11: the MPHF walk of the
sparse index.

One wrapper, ``gather13``, covers every gather of aindex_tpu's dense query
path (kernels/lookup.py:32 ``gather_tf_valid``, :49 ``gather_tf_both_13``;
index/dense13.py:103 ``_gather_total``, :109 ``_gather_codes_u32``, :115
``_gather_codes_valid_u32``, with :92 ``_encode_batch_dev`` for ASCII rows).
The kernel is ``csrc/gather13.cu``; ``gather13_plain`` is its plain PyTorch
version. ``gather13`` also reads a half total table (2^25 entries, built by
``index/dense13.py`` ``total13_half``): the shape alone selects the C entry
``gather13_half``, which folds each code to its slot (``encode.half_index13``)
after the index rule below, so it answers what the full total table
answers. Two more entries of K3 take a 1-D table of any length and answer
in the table's own dtype: ``gather_tf`` (``gather13_table``, replacing
aindex_tpu/kernels/lookup.py:22) and ``gather_tf_total_13``
(``gather13_total``, :39: forward plus reverse complement straight from
the forward table, summed in the table's dtype); ``gather_tf_plain`` and
``gather_tf_total_13_plain`` are their plain versions.

Codes are uint32 bit patterns (int32 or uint32 storage). A code outside
[0, 4^13) reads what JAX's ``table[code.astype(int32)]`` reads: the int32
value, plus 4^13 (the table's length) if negative, clamped into the table.
K3 takes one code a thread and streams codes and answers past L2 with
evict-first loads and stores; the table is read with plain loads
(``csrc/gather13.cu``).

K12 (kernel ``csrc/shard23.cu``: ``shard_walk``) is one index shard's
part of a query against the node-sharded index (``parallel/query23.py``):
the owner node from the replicated g-values, then the node's record when
the node lies in the shard's node range (``walk_records`` of the range:
the raw slot, and the checker verify and tf); ``mphf_owner_node``
(aindex_tpu/kernels/lookup.py:124) and ``shard_walk_plain`` are its plain
versions.

K11 (kernel ``csrc/mphfwalk.cu``) is ``kernels/probe.py``'s query,
coverage and fill on an ``MphfTables``; ``mix64``, ``hash_triple``,
``mphf_lookup`` and ``MphfTables.probe_plain`` are the plain versions of
aindex_tpu/kernels/lookup.py:70-121 and index/sparse23.py:51
``_query_kernel``, on int64 tensors holding uint64 bits: every right shift
is masked and the remainder by the domain is taken unsigned, by a 32-bit
split. Node ids stay int64 where aindex_tpu casts them to int32. The walk
reads one 16-byte record a node (``walk_records``) in place of JAX's node
-> slot, checker and tf gathers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from aindex_torch.constants import HALF_13, K13, SPACE_13
from aindex_torch.kernels import _cuda
from aindex_torch.trace import span, to_device
from aindex_torch.kernels.encode import (as_unsigned, ascii_to_base_codes, check_packed,
                                         half_index13, int32_value, packed_window_codes,
                                         revcomp_code13, revcomp_code64, table_values, u64_le,
                                         window_codes)

KERNEL = _cuda.KERNELS["gather13"]
KERNEL_HALF = _cuda.KERNELS["gather13_half"]
KERNEL_TABLE = _cuda.KERNELS["gather13_table"]
KERNEL_TOTAL = _cuda.KERNELS["gather13_total"]
KERNEL_WALK = _cuda.KERNELS["shardwalk"]

#: table dtype -> bits per entry (the narrowed widths of ``_narrow``)
WIDTHS = {torch.uint8: 8, torch.uint16: 16, torch.uint32: 32}


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> uint32 tensor of their low 32 bits."""
    return x.to(torch.int32).view(torch.uint32)


def jax_index(codes: torch.Tensor, n: int = SPACE_13) -> torch.Tensor:
    """The index JAX's gather reads in a table of ``n`` entries for each
    code (int64): int32/uint32 codes by their int32 value, int64 codes
    holding uint32 values by the int32 value of their bits."""
    i = int32_value(codes) if codes.dtype == torch.int64 \
        else codes.view(torch.int32).to(torch.int64)
    return torch.where(i < 0, i + n, i).clamp_(0, n - 1)


def _check(table, codes, valid, ascii, both) -> None:
    if table.dtype not in WIDTHS or table.shape not in ((SPACE_13,), (HALF_13,)) \
            or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous uint8/uint16/uint32 [{SPACE_13}] "
                         f"table or [{HALF_13}] half total table, got "
                         f"{table.dtype}{tuple(table.shape)}")
    if both and table.numel() == HALF_13:
        raise ValueError("a half total table has no reverse-complement lookups")
    if (codes is None) == (ascii is None):
        raise ValueError("give exactly one of codes and ascii")
    if ascii is not None:
        if ascii.dtype != torch.uint8 or ascii.dim() != 2 \
                or ascii.shape[1] != K13 or not ascii.is_contiguous():
            raise ValueError(f"ascii must be a contiguous uint8[B, {K13}] tensor")
        if valid is not None:
            raise ValueError("ASCII rows carry their own validity")
        return
    if codes.dtype not in (torch.int32, torch.uint32) or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous int32/uint32 tensor")
    if valid is not None and (valid.dtype != torch.bool or valid.shape != codes.shape
                              or not valid.is_contiguous()):
        raise ValueError("valid must be a contiguous bool tensor shaped like codes")


def gather13_plain(table, codes=None, valid=None, ascii=None, both=False):
    """Plain version of ``gather13``, same arguments and results."""
    if ascii is not None:
        code, valid = window_codes(ascii_to_base_codes(ascii), K13)
        code, valid = code.reshape(-1), valid.reshape(-1)
        idx = code
    else:
        idx = jax_index(codes)
        code = codes
    if table.numel() == HALF_13:
        idx = half_index13(idx)
    fwd = table_values(table, idx)
    if valid is not None:
        fwd = torch.where(valid, fwd, 0)
    if not both:
        return as_u32(fwd)
    rc = table_values(table, revcomp_code13(code))
    if valid is not None:
        rc = torch.where(valid, rc, 0)
    return as_u32(fwd), as_u32(rc)


def gather13(table: torch.Tensor, codes: torch.Tensor | None = None,
             valid: torch.Tensor | None = None, ascii: torch.Tensor | None = None,
             both: bool = False):
    """uint32 lookups of 13-mers in ``table`` (uint8/16/32[4^13], or a
    half total table of 2^25 entries, which answers each code with the
    full total table's entry and takes no ``both``).

    Queries are either ``codes`` (int32/uint32 of any shape, optionally
    masked by a bool ``valid`` of the same shape) or ``ascii`` rows
    (uint8[B, 13], invalid where a byte is not ACGT/acgt). Invalid queries
    give 0. Returns the forward lookups shaped like the codes (``[B]`` for
    ASCII), or with ``both`` the pair (forward, reverse complement).

    A CPU tensor runs the plain version; a CUDA tensor launches K3. The
    whole call is the span ``aindex.kernel.gather13``."""
    with span("aindex.kernel.gather13"):
        _check(table, codes, valid, ascii, both)
        query = ascii if ascii is not None else codes
        extra = (valid,) if valid is not None else ()
        if not _cuda.on_cuda(table, query, *extra):
            return gather13_plain(table, codes, valid, ascii, both)
        shape = (ascii.shape[0],) if ascii is not None else tuple(codes.shape)
        out = torch.empty(shape, dtype=torch.int32, device=table.device)
        out_rc = torch.empty_like(out) if both else None
        if out.numel():
            args = (table.data_ptr(), WIDTHS[table.dtype],
                    None if codes is None else codes.data_ptr(),
                    None if valid is None else valid.data_ptr(),
                    None if ascii is None else ascii.data_ptr(),
                    out.numel(), out.data_ptr())
            with torch.cuda.device(table.device):
                if table.numel() == HALF_13:
                    KERNEL_HALF.launch(*args, _cuda.stream(table.device))
                else:
                    KERNEL.launch(*args, None if out_rc is None else out_rc.data_ptr(),
                                  _cuda.stream(table.device))
    if both:
        return out.view(torch.uint32), out_rc.view(torch.uint32)
    return out.view(torch.uint32)


# -- K3's table-length entries: gather_tf and gather_tf_total_13 -------------------

def _signed(table: torch.Tensor) -> torch.Tensor:
    """The table through the signed view of its width (uint8 as it is)."""
    return table if table.dtype == torch.uint8 else table.view(
        torch.int16 if table.dtype == torch.uint16 else torch.int32)


def _check_table(table, codes, valid=None, k=K13) -> None:
    if table.dtype not in WIDTHS or table.dim() != 1 or table.numel() == 0 \
            or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous non-empty 1-D uint8/uint16/uint32 "
                         f"tensor, got {table.dtype}{tuple(table.shape)}")
    if codes.dtype not in (torch.int32, torch.uint32) or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous int32/uint32 tensor")
    if valid is not None and (valid.dtype != torch.bool or valid.shape != codes.shape
                              or not valid.is_contiguous()):
        raise ValueError("valid must be a contiguous bool tensor shaped like codes")
    if not 1 <= k <= 16:
        raise ValueError(f"k={k} outside 1..16 (codes are uint32)")


def gather_tf_plain(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gather_tf``."""
    return _signed(table)[jax_index(codes, table.numel())].view(table.dtype)


def gather_tf(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``table[codes.astype(int32)]`` (aindex_tpu/kernels/lookup.py:22),
    unmasked: ``table`` a 1-D uint8/uint16/uint32 tensor of any length,
    ``codes`` int32/uint32 (uint32 bit patterns) of any shape; a code reads
    its int32 value, plus the table's length if negative, clamped into the
    table. Returns the table's dtype, shaped like ``codes``.

    A CPU tensor runs the plain version; a CUDA tensor launches K3's
    ``gather13_table``."""
    _check_table(table, codes)
    if not _cuda.on_cuda(table, codes):
        return gather_tf_plain(table, codes)
    out = torch.empty(codes.shape, dtype=_signed(table).dtype, device=table.device)
    if out.numel():
        with torch.cuda.device(table.device):
            KERNEL_TABLE.launch(table.data_ptr(), WIDTHS[table.dtype], table.numel(),
                                codes.data_ptr(), out.numel(), out.data_ptr(),
                                _cuda.stream(table.device))
    return out.view(table.dtype)


def gather_tf_total_13_plain(table: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor,
                             k: int = K13) -> torch.Tensor:
    """Plain version of ``gather_tf_total_13``."""
    n = table.numel()
    fwd = table_values(table, jax_index(codes, n))
    rc = table_values(table, jax_index(revcomp_code13(codes, k), n))
    tf = (fwd + rc) & ((1 << WIDTHS[table.dtype]) - 1)
    return torch.where(valid, tf, 0).to(_signed(table).dtype).view(table.dtype)


def gather_tf_total_13(table: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor,
                       k: int = K13) -> torch.Tensor:
    """Forward plus reverse-complement tf straight from the forward table
    (aindex_tpu/kernels/lookup.py:39): ``table[code] + table[revcomp_k(code)]``
    summed in the table's dtype (so a uint16 sum wraps at 2^16) where
    ``valid``, else 0. The reverse complement is taken of the code's uint32
    bits at ``k`` (1..16), and both reads index as ``gather_tf``. ``valid``
    is bool, shaped like ``codes``.

    A CPU tensor runs the plain version; a CUDA tensor launches K3's
    ``gather13_total`` (one pass, two reads, one write; no total table)."""
    _check_table(table, codes, valid, k)
    if not _cuda.on_cuda(table, codes, valid):
        return gather_tf_total_13_plain(table, codes, valid, k)
    out = torch.empty(codes.shape, dtype=_signed(table).dtype, device=table.device)
    if out.numel():
        with torch.cuda.device(table.device):
            KERNEL_TOTAL.launch(table.data_ptr(), WIDTHS[table.dtype], table.numel(),
                                codes.data_ptr(), valid.data_ptr(), k, out.numel(),
                                out.data_ptr(), _cuda.stream(table.device))
    return out.view(table.dtype)


# -- K11: the MPHF walk -----------------------------------------------------------

_U64_MASK = (1 << 64) - 1


def _s64(x: int) -> int:
    """A uint64 constant as the int64 of the same bits."""
    x &= _U64_MASK
    return x - (1 << 64) if x >> 63 else x


_MIX_M1 = _s64(0xFF51AFD7ED558CCD)
_MIX_M2 = _s64(0xC4CEB9FE1A85EC53)
_TRIPLE_C1 = _s64(0x9E3779B97F4A7C15)
_TRIPLE_C2 = _s64(0x165667B19E3779F9)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 tensors holding uint64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 fmix64 on int64 tensors holding uint64 bits
    (aindex_tpu/kernels/lookup.py:70): masked shifts, wrapping multiplies."""
    x = x ^ _shr(x, 33)
    x = x * _MIX_M1
    x = x ^ _shr(x, 33)
    x = x * _MIX_M2
    return x ^ _shr(x, 33)


def umod(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x % d`` of the uint64 bits of int64 ``x``, for 0 < d < 2^32 / 3:
    x = hi 2^32 + lo, and (hi % d) (2^32 % d) + lo stays below 2^63."""
    hi, lo = _shr(x, 32), x & 0xFFFFFFFF
    return ((hi % d) * ((1 << 32) % d) + lo) % d


def hash_triple(keys: torch.Tensor, seed: int, domain: int):
    """Three node ids (int64) per key, node i in partition i
    (aindex_tpu/kernels/lookup.py:83)."""
    h = mix64(keys ^ _s64(seed))
    return (umod(h, domain), umod(mix64(h ^ _TRIPLE_C1), domain) + domain,
            umod(mix64(h + _TRIPLE_C2), domain) + 2 * domain)


def mphf_owner_node(g_packed: torch.Tensor, keys: torch.Tensor, seed: int,
                    domain: int) -> torch.Tensor:
    """Owner node (int64) per key, without the node -> slot read: the
    triple hash, three 2-bit g-values, node by (sum % 3)
    (aindex_tpu/kernels/lookup.py:124, whose int32 node ids these equal
    below 2^31)."""
    nodes = hash_triple(keys, seed, domain)
    g = [(as_unsigned(g_packed[n >> 4]) >> ((n & 15) * 2)) & 3 for n in nodes]
    v = (g[0] + g[1] + g[2]) % 3
    return torch.where(v == 0, nodes[0], torch.where(v == 1, nodes[1], nodes[2]))


def mphf_lookup(g_packed: torch.Tensor, slots: torch.Tensor, keys: torch.Tensor,
                seed: int, domain: int) -> torch.Tensor:
    """Unverified slot (int64) per key: the owner node's slot
    (aindex_tpu/kernels/lookup.py:100). Node ids stay int64."""
    return slots[mphf_owner_node(g_packed, keys, seed, domain)].to(torch.int64)


def walk_records(slots: torch.Tensor, checker: torch.Tensor, tf: torch.Tensor) -> torch.Tensor:
    """The walk's node records, int32[3 domain, 4]: row v holds the checker
    key (int64 of uint64 bits, as its low and high 32-bit words), the tf and
    the slot of node v's slot ``slots[v]``, for every node, assigned or not
    (an unassigned node holds slot 0's, as JAX's node -> slot table reads
    there: its key walks elsewhere, so it never matches). With no keys
    (n = 0) every row is 0."""
    if checker.numel() == 0:
        return torch.zeros((slots.numel(), 4), dtype=torch.int32, device=slots.device)
    s = slots.to(torch.int64)
    key = checker[s]
    return torch.stack([key.to(torch.int32), (key >> 32).to(torch.int32), tf[s], slots], dim=1)


@dataclasses.dataclass(frozen=True)
class MphfTables:
    """The ATPF MPHF (index/mphf.py) and its node records on one device,
    the MPHF walk's engine (``kernels/probe.py``): g_packed
    int32[ceil(3 domain / 16)] (uint32 words of 2-bit values), records
    int32[3 domain, 4] (``walk_records``: checker key, tf, slot a node)."""
    g_packed: torch.Tensor
    records: torch.Tensor
    n: int
    domain: int
    seed: int

    QUERY = "mphfwalk"
    COVERAGE = "mphfcov"
    FILL = "mphffill"

    @classmethod
    def from_host(cls, mphf, checker: np.ndarray, tf: np.ndarray, device) -> "MphfTables":
        """The engine of a host MPHF (``index/mphf.MPHF``) and its
        slot-ordered checker (uint64[n]) and tf (uint32[n]) on ``device``;
        the records are gathered there (the slots, checker and tf copies
        are dropped after); in the timed span ``aindex.index.upload``."""
        def up(x, dtype):
            return to_device(torch.from_numpy(np.ascontiguousarray(x).view(dtype)), device,
                             copy=True)
        with span("aindex.index.upload", timed=True):
            records = walk_records(up(np.asarray(mphf.slots, np.int32), np.int32),
                                   up(np.asarray(checker, np.uint64), np.int64),
                                   up(np.asarray(tf, np.uint32), np.int32))
            return cls(up(np.asarray(mphf.g_packed, np.uint32), np.int32), records,
                       int(mphf.n), int(mphf.domain), int(mphf.seed))

    @property
    def device(self) -> torch.device:
        return self.records.device

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.g_packed, self.records)

    def engine_args(self) -> tuple[list, list]:
        """probe.cuh ``Mphf``: p = {g_packed, records}, u = {n, domain,
        seed}."""
        return [x.data_ptr() for x in self.tensors()], [self.n, self.domain, self.seed]

    def check(self) -> None:
        n_nodes = 3 * self.domain
        for name, shape in (("g_packed", (-(-n_nodes // 16),)), ("records", (n_nodes, 4))):
            x = getattr(self, name)
            if x.dtype != torch.int32 or x.shape != shape or not x.is_contiguous():
                raise ValueError(f"{name} must be a contiguous torch.int32{list(shape)} tensor")
        if not 0 < self.domain < (1 << 32) // 3:
            raise ValueError(f"domain {self.domain} is outside (0, 2^32 / 3)")

    def check_k(self, k: int) -> None:
        if not 1 <= k <= 31:
            raise ValueError(f"k={k} is outside 1..31")

    def probe_plain(self, keys: torch.Tensor):
        """(hit, tf int64, slot int64) per key: the walk to the owner node,
        then its record's checker verify (aindex_tpu/index/sparse23.py:51
        ``_query_kernel``)."""
        if self.n == 0:
            zero = torch.zeros_like(keys)
            return zero != 0, zero, zero - 1
        rec = self.records[mphf_owner_node(self.g_packed, keys, self.seed, self.domain)]
        key = (rec[:, 0].to(torch.int64) & 0xFFFFFFFF) | (rec[:, 1].to(torch.int64) << 32)
        return key == keys, as_unsigned(rec[:, 2]), rec[:, 3].to(torch.int64)


# -- K12: one index shard's part of a sharded query ---------------------------------

def _check_i32(name: str, t: torch.Tensor) -> None:
    if t.dtype not in (torch.int32, torch.uint32) or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D int32/uint32 tensor")


def shard_walk_plain(g_packed, records_local, node_lo: int, n_keys: int, seed: int,
                     domain: int, codes=None, valid=None, windows=None, k: int = 23,
                     canonical: bool = False):
    """Plain version of ``shard_walk``, same arguments and results."""
    if codes is None:
        packed, vbits, rows, stride = windows
        all_codes, all_valid = packed_window_codes(packed, vbits, k)
        pos = (torch.arange(rows, device=packed.device)[:, None] * stride
               + torch.arange(stride - k, device=packed.device)[None, :]).reshape(-1)
        codes, valid = all_codes[pos], all_valid[pos]
    key, fwd = codes, None
    if canonical:
        rc = revcomp_code64(codes, k)
        fwd = u64_le(codes, rc)
        key = torch.where(fwd, codes, rc)
    local = mphf_owner_node(g_packed, key, seed, domain) - node_lo
    inside = (local >= 0) & (local < records_local.shape[0])
    rec = torch.where(inside[:, None], records_local[torch.where(inside, local, 0)], 0)
    ck = (rec[:, 0].to(torch.int64) & 0xFFFFFFFF) | (rec[:, 1].to(torch.int64) << 32)
    ok = inside & (ck == key) & (n_keys > 0)
    if valid is not None:
        ok = ok & valid
    parts = torch.stack([torch.where(ok, rec[:, 2], 0), rec[:, 3], ok.to(torch.int32)])
    return parts, fwd


def shard_walk(g_packed: torch.Tensor, records_local: torch.Tensor, node_lo: int, n_keys: int,
               seed: int, domain: int, codes: torch.Tensor | None = None,
               valid: torch.Tensor | None = None, windows=None, k: int = 23,
               canonical: bool = False):
    """One index shard's part of a verified query: per key the owner node
    of the MPHF walk from the replicated ``g_packed``
    (int32[ceil(3 domain / 16)]); when the node lies in this shard's node
    range from ``node_lo``, its record in ``records_local`` (int32[n_nodes,
    4], ``walk_records`` of the range) gives the raw slot, and the checker
    compare gives the tf and a found flag (gated by ``valid`` and by
    ``n_keys`` > 0); else all three are 0 (the local body of
    aindex_tpu/parallel/query23.py:62, its two psums' parts at once).

    The keys are ``codes`` (1-D int64 of uint64 bits, optionally masked by a
    bool ``valid``), or with ``windows`` = (packed, vbits, rows, stride) the
    windows of ``rows`` packed rows of ``stride`` bases
    (``codec.pack_ascii_chunk`` of newline-padded rows, as coverage takes
    them; an invalid window is masked); ``canonical`` probes min(code,
    revcomp).

    Returns (parts int32[3, n]: tf (uint32 bits), raw slot and found, which
    the shards sum; fwd bool[n] or None (with ``canonical``: code <=
    revcomp)). A CPU tensor runs the plain version; a CUDA tensor launches
    K12."""
    _check_i32("g_packed", g_packed)
    if records_local.dtype != torch.int32 or records_local.dim() != 2 \
            or records_local.shape[1] != 4 or records_local.shape[0] < 1 \
            or not records_local.is_contiguous():
        raise ValueError("records_local must be a contiguous torch.int32[n_nodes >= 1, 4] "
                         "tensor")
    if not 1 <= k <= 31:
        raise ValueError(f"k={k} is outside 1..31")
    if not 0 < domain < (1 << 32) // 3:
        raise ValueError(f"domain {domain} is outside (0, 2^32 / 3)")
    if (codes is None) == (windows is None):
        raise ValueError("give exactly one of codes and windows")
    if codes is not None:
        if codes.dtype != torch.int64 or codes.dim() != 1 or not codes.is_contiguous():
            raise ValueError("codes must be a contiguous 1-D int64 tensor")
        if valid is not None and (valid.dtype != torch.bool or valid.shape != codes.shape
                                  or not valid.is_contiguous()):
            raise ValueError("valid must be a contiguous bool tensor shaped like codes")
        inputs = (codes,) if valid is None else (codes, valid)
        n = codes.numel()
    else:
        if valid is not None:
            raise ValueError("windows carry their own validity")
        packed, vbits, rows, stride = windows
        check_packed(packed, vbits)
        if stride <= k or rows < 0 or 16 * packed.numel() < rows * stride:
            raise ValueError(f"packed holds {16 * packed.numel()} bases, fewer than "
                             f"rows * stride = {rows} * {stride} (stride > {k})")
        inputs = (packed, vbits)
        n = rows * (stride - k)
    if not _cuda.on_cuda(g_packed, records_local, *inputs):
        return shard_walk_plain(g_packed, records_local, node_lo, n_keys, seed, domain, codes,
                                valid, windows, k, canonical)
    dev = g_packed.device
    parts = torch.empty((3, n), dtype=torch.int32, device=dev)
    fwd = torch.empty(n, dtype=torch.bool, device=dev) if canonical else None
    if n:
        packed, vbits, _, stride = windows if windows is not None else (None, None, 0, 0)
        with torch.cuda.device(dev):
            KERNEL_WALK.launch(
                g_packed.data_ptr(), records_local.data_ptr(), node_lo, records_local.shape[0],
                n_keys, domain, seed & ((1 << 64) - 1),
                None if codes is None else codes.data_ptr(),
                None if valid is None else valid.data_ptr(),
                None if packed is None else packed.data_ptr(),
                None if vbits is None else vbits.data_ptr(),
                0 if packed is None else packed.numel(), stride, k, int(canonical), n,
                None if fwd is None else fwd.data_ptr(), parts.data_ptr(), _cuda.stream(dev))
    return parts, fwd
