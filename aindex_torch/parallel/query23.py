"""Index-sharded sparse k-mer queries over a device mesh.

Counterpart of aindex_tpu/parallel/query23.py. Everything that grows with
the key count is sharded over the ``index`` axis:

* ``slots`` (owner node -> slot id, the big MPHF component at ~13 B/key)
  shards by node range;
* ``tf`` and ``checker`` (12 B/key) shard by slot range;
* only the 2-bit g-values (~1 bit/key) and the query batch are held by
  every rank,

so the bytes a rank holds fall as the mesh grows. A query is: every rank
computes the owner nodes from the g-values, the rank owning a node's range
contributes its slot id (one ``all_reduce``), the rank owning that slot's
range contributes the verified tf and a found flag (a second
``all_reduce``): routing with two sums per key and no all-to-all. Each
rank's part is K12 (``kernels/lookup.py`` ``shard_owner``,
``shard_verify``). Slots cross as int32, tf as the int32 bit pattern of
uint32, found as int32.

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
from aindex_torch.kernels.lookup import shard_owner, shard_verify
from aindex_torch.parallel.mesh import INDEX_AXIS, axis_group, axis_rank, axis_size, mesh_device

#: the checker key of padding slots: the sentinel, never a k-mer code
_PAD_KEY = -1


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


def _shard_1d(mesh, arr: np.ndarray, pad_value) -> tuple[torch.Tensor, int]:
    """This rank's ``index`` shard of a host array (padded to divide) on its
    device. Returns (the shard, the padded length)."""
    part, padded = shard_slice(arr, axis_size(mesh, INDEX_AXIS), axis_rank(mesh, INDEX_AXIS),
                               pad_value)
    return torch.from_numpy(part).to(mesh_device(mesh)), padded


def shard_slot_arrays(mesh, tf: np.ndarray, checker: np.ndarray
                      ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """This rank's slot-range shard of tf (int32 storage of uint32) and
    checker (int64 of uint64 keys); padding slots hold an impossible key."""
    tf_s, padded = _shard_1d(mesh, np.asarray(tf, dtype=np.uint32).view(np.int32), 0)
    ck_s, _ = _shard_1d(mesh, np.asarray(checker, dtype=np.uint64).view(np.int64), _PAD_KEY)
    return tf_s, ck_s, padded


def resolve23_sharded(g_packed, slots_local, tf_local, checker_local, seed: int, domain: int,
                      codes=None, valid=None, *, mesh, windows=None, k: int = 23,
                      canonical: bool = False):
    """(tf uint32, raw slot int32, found bool, key int64, fwd, valid) per
    key against the sharded tables (aindex_tpu/parallel/query23.py:62).
    ``slot`` is the unverified MPHF id (get_hash_value semantics); ``found``
    gates tf and verified-slot consumers. The keys are ``codes`` (int64,
    optionally masked by ``valid``) or the ``windows`` of packed rows;
    ``canonical`` probes min(code, revcomp) (``fwd``: code <= revcomp), as
    ``shard_owner`` takes them."""
    group = axis_group(mesh, INDEX_AXIS)
    shard = axis_rank(mesh, INDEX_AXIS)
    key, slot, fwd, w_valid = shard_owner(g_packed, slots_local, shard * slots_local.numel(),
                                          seed, domain, codes, windows, k, canonical)
    if w_valid is not None:
        valid = w_valid
    dist.all_reduce(slot, group=group)
    tf, found = shard_verify(slot, tf_local, checker_local, shard * tf_local.numel(), key, valid)
    tf = tf.view(torch.int32)
    dist.all_reduce(tf, group=group)
    dist.all_reduce(found, group=group)
    return tf.view(torch.uint32), slot, found > 0, key, fwd, valid


class ShardedSparse23(SharedQueryOps):
    """Mesh-resident engine over a ``Sparse23Index`` with node-sharded MPHF
    slots and slot-sharded tf/checker (canonical-keyed indexes with an
    ATPF MPHF only; the facade keeps reference-keyed indexes on the
    single-device engine). Every rank of the mesh builds it from the same
    index and asks the same queries (SPMD); each holds its ``index``
    shard and gets every answer."""

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
        self.slots_local, self.padded_nodes = _shard_1d(
            mesh, np.asarray(m.slots, dtype=np.int32), 0)
        self.tf_local, self.checker_local, self.padded_n = shard_slot_arrays(
            mesh, index.tf_host, index.checker_host)

    @property
    def per_device_bytes(self) -> int:
        """Device bytes a rank holds: its shards of the sharded arrays plus
        the g-values every rank holds."""
        sharded = (4 * self.padded_nodes + (4 + 8) * self.padded_n)
        return sharded // axis_size(self.mesh, INDEX_AXIS) + \
            self.g_packed.numel() * self.g_packed.element_size()

    # -- core resolution -----------------------------------------------------

    def _resolve(self, codes=None, valid=None, canonical=True, windows=None):
        return resolve23_sharded(self.g_packed, self.slots_local, self.tf_local,
                                 self.checker_local, self.seed, self.domain, codes, valid,
                                 mesh=self.mesh, windows=windows, k=self.k,
                                 canonical=canonical)

    def _resolve_codes(self, codes, valid=None):
        """(tf uint32, slot int32, strand int32) for literal codes, all on
        the device; slot -1 when absent; strand 0/1/2 = absent/forward/
        revcomp."""
        tf, slot, found, _, fwd, _ = self._resolve(codes, valid)
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
        tf against the sharded tables (K12 reads the windows), then the
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
