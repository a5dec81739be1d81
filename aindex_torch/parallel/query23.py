"""Index-sharded sparse k-mer queries over a device mesh.

Counterpart of aindex_tpu/parallel/query23.py. Everything that grows with
the key count is sharded over the ``index`` axis, by MPHF node range:

* each rank holds the node records of its range (``walk_records``: the
  checker key, tf and slot of each node's slot, 16 B a node, ~20 B/key);
* only the 2-bit g-values (~1 bit/key) and the query batch are held by
  every rank,

so the bytes a rank holds fall as the mesh grows. aindex_tpu shards the
node -> slot map by node range and tf and checker by slot range, so its
query sums twice: the slot, then the verified tf and found. Here the rank
that owns a key's node holds its slot's checker and tf too: every rank
walks to the owner node from the g-values, the owning rank reads the
node's record and verifies, and one ``all_reduce`` of (tf, slot, found)
gives every rank every answer: routing with one sum per key and no
all-to-all. Each rank's part is K12 (``kernels/lookup.py``
``shard_walk``). The three cross as one int32 block (tf as the int32 bit
pattern of uint32).

``ShardedSparse23`` serves the whole query surface of the single-device
index: tf (ASCII and codes-in), both directions, De Bruijn continuation
and coverage (``SharedQueryOps``), pfids, hash values and strands.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from aindex_torch.core import codec
from aindex_torch.index.common import host_u32
from aindex_torch.index.sparse23 import SharedQueryOps, codes_tensor
from aindex_torch.kernels.lookup import shard_walk, walk_records
from aindex_torch.parallel.mesh import INDEX_AXIS, axis_group, axis_rank, axis_size, mesh_device


def shard_slice(arr: np.ndarray, n_shards: int, shard: int, pad_value) -> tuple[np.ndarray, int]:
    """Shard ``shard`` of a host array cut into ``n_shards`` equal parts
    after padding it with ``pad_value`` to a multiple of ``n_shards``
    (at least one entry a shard). Returns (the part, the padded length)."""
    n = len(arr)
    padded = -(-max(n, 1) // n_shards) * n_shards
    size = padded // n_shards
    part = np.full(size, pad_value, dtype=arr.dtype)
    lo = shard * size
    got = arr[lo:min(lo + size, n)]
    part[:got.size] = got
    return part, padded


def shard_records(mphf, checker: np.ndarray, tf: np.ndarray, n_shards: int, shard: int
                  ) -> tuple[torch.Tensor, int]:
    """Shard ``shard`` of ``n_shards`` of an MPHF's node records, built on
    the host: ``walk_records`` of its node range (the node -> slot map cut
    as ``shard_slice`` cuts it, padding nodes holding slot 0) over the
    slot-ordered checker (uint64[n]) and tf (uint32[n]). Returns (int32
    [padded / n_shards, 4] CPU tensor, the padded node count)."""
    slots, padded = shard_slice(np.asarray(mphf.slots, dtype=np.int32), n_shards, shard, 0)
    records = walk_records(torch.from_numpy(slots),
                           torch.from_numpy(np.asarray(checker, dtype=np.uint64).view(np.int64)),
                           torch.from_numpy(np.asarray(tf, dtype=np.uint32).view(np.int32)))
    return records, padded


def resolve23_sharded(g_packed, records_local, n: int, seed: int, domain: int, codes=None,
                      valid=None, *, mesh, windows=None, k: int = 23, canonical: bool = False):
    """(tf uint32, raw slot int32, found bool, fwd) per key against the
    node-sharded records (aindex_tpu/parallel/query23.py:62). ``slot`` is
    the unverified MPHF id (get_hash_value semantics); ``found`` gates tf
    and verified-slot consumers. The keys are ``codes`` (int64, optionally
    masked by ``valid``) or the ``windows`` of packed rows; ``canonical``
    probes min(code, revcomp) (``fwd``: code <= revcomp), as
    ``shard_walk`` takes them. One ``all_reduce`` over the index axis."""
    shard = axis_rank(mesh, INDEX_AXIS)
    parts, fwd = shard_walk(g_packed, records_local, shard * records_local.shape[0], n, seed,
                            domain, codes, valid, windows, k, canonical)
    dist.all_reduce(parts, group=axis_group(mesh, INDEX_AXIS))
    return parts[0].view(torch.uint32), parts[1], parts[2] > 0, fwd


class ShardedSparse23(SharedQueryOps):
    """Mesh-resident engine over a ``Sparse23Index`` with node-sharded
    records (canonical-keyed indexes with an ATPF MPHF only; the facade
    keeps reference-keyed indexes on the single-device engine). Every rank
    of the mesh builds it from the same index and asks the same queries
    (SPMD); each holds its ``index`` shard and gets every answer."""

    def __init__(self, index, mesh):
        if not index.canonical_keys or not hasattr(index.mphf, "g_packed"):
            raise ValueError("sharded engine requires a canonical-keyed native-MPHF index")
        self.k = index.k
        self.n = index.n
        self.mesh = mesh
        self.device = mesh_device(mesh)
        m = index.mphf
        self.g_packed = torch.from_numpy(np.asarray(m.g_packed, dtype=np.uint32)
                                         .view(np.int32)).to(self.device)
        self.seed = int(m.seed)
        self.domain = int(m.domain)
        records, self.padded_nodes = shard_records(
            m, index.checker_host, index.tf_host, axis_size(mesh, INDEX_AXIS),
            axis_rank(mesh, INDEX_AXIS))
        self.records_local = records.to(self.device)

    @property
    def per_device_bytes(self) -> int:
        """Device bytes a rank holds: its node records (16 B a node of the
        padded node range) plus the g-values every rank holds."""
        return 16 * self.padded_nodes // axis_size(self.mesh, INDEX_AXIS) + \
            self.g_packed.numel() * self.g_packed.element_size()

    # -- core resolution -----------------------------------------------------

    def _resolve(self, codes=None, valid=None, canonical=True, windows=None):
        return resolve23_sharded(self.g_packed, self.records_local, self.n, self.seed,
                                 self.domain, codes, valid, mesh=self.mesh, windows=windows,
                                 k=self.k, canonical=canonical)

    def _resolve_codes(self, codes, valid=None):
        """(tf uint32, slot int32, strand int32) for literal codes, all on
        the device; slot -1 when absent; strand 0/1/2 = absent/forward/
        revcomp."""
        tf, slot, found, fwd = self._resolve(codes, valid)
        strand = torch.where(found, torch.where(fwd, 1, 2), 0).to(torch.int32)
        return tf, torch.where(found, slot, -1), strand

    def _encode(self, kmers: list[str]):
        return codec.encode_kmers(kmers, self.k)

    def _encoded(self, kmers: list[str]):
        codes, valid = self._encode(kmers)
        return (torch.from_numpy(np.ascontiguousarray(codes).view(np.int64)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(valid)).to(self.device))

    def _ext_tf(self, ext_codes: np.ndarray, cutoff: int) -> np.ndarray:
        flat = torch.from_numpy(np.ascontiguousarray(ext_codes, dtype=np.uint64)
                                .reshape(-1).view(np.int64)).to(self.device)
        tf = host_u32(self._resolve(flat)[0]).reshape(ext_codes.shape)
        if cutoff > 0:
            tf = np.where(tf <= cutoff, 0, tf)
        return tf

    def _coverage_rows(self, packed: np.ndarray, vbits: np.ndarray, rows: int, stride: int,
                       cutoff: int) -> np.ndarray:
        """Coverage of packed [rows, stride] rows: every window's verified
        tf against the sharded records (K12 reads the windows), then the
        cutoff; uint32[rows, stride - k] on the host."""
        windows = (torch.from_numpy(packed.view(np.int32)).to(self.device),
                   torch.from_numpy(vbits).to(self.device), rows, stride)
        tf = host_u32(self._resolve(windows=windows)[0]).reshape(rows, stride - self.k)
        return np.where(tf >= cutoff, tf, 0).astype(np.uint32)

    # -- public surface (Sparse23Index signatures) ----------------------------

    def get_tf_values(self, kmers: list[str]) -> np.ndarray:
        return host_u32(self._resolve(*self._encoded(kmers))[0])

    def get_tf_values_codes(self, codes, valid=None) -> torch.Tensor:
        """Codes-in twin of ``Sparse23Index.get_tf_values_codes`` against
        the sharded tables: a ``torch.uint32`` tensor shaped like
        ``codes`` on this rank's device."""
        codes, valid, shape = codes_tensor(codes, valid, self.device)
        return self._resolve(codes, valid)[0].reshape(shape)

    def get_tf_both_directions(self, kmers: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """(fwd tf, rc tf): canonical-keyed indexes resolve both strands to
        the same verified tf (see ``Sparse23Index.get_tf_both_directions``)."""
        tf = self.get_tf_values(kmers)
        return tf, tf.copy()

    def get_pfids(self, kmers: list[str]) -> np.ndarray:
        """Verified slot id per k-mer; n when absent."""
        _, slot, _ = self._resolve_codes(*self._encoded(kmers))
        slot = slot.cpu().numpy().astype(np.int64)
        return np.where(slot < 0, self.n, slot)

    def get_hash_values(self, kmers: list[str]) -> np.ndarray:
        """Raw (unverified) MPHF ids of the literal k-mer strings."""
        codes, _ = self._encoded(kmers)
        return self._resolve(codes, canonical=False)[1].cpu().numpy().astype(np.int64)

    def get_strands(self, kmers: list[str]) -> np.ndarray:
        _, _, strand = self._resolve_codes(*self._encoded(kmers))
        return strand.cpu().numpy()
