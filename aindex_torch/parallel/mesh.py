"""Device mesh over the ranks of a torch.distributed job.

Counterpart of aindex_tpu/parallel/mesh.py. The reference is single-node
shared memory; its thread-level parallelism maps onto a mesh with two
axes:

* ``data``: read batches stream data-parallel (the analogue of the
  reference's byte-range worker sharding, reference: src/hash.hpp:414-423);
* ``index``: the sparse k-mer table is sharded by MPHF node range (the dense
  13-mer table is replicated).

Count partials merge with an ``all_reduce`` over ``data``; sharded-table
queries with ``all_reduce`` over ``index``.

One rank drives one device, so a rank's two mesh coordinates are its data
row and its index shard. The mesh spans the whole world: where aindex_tpu
takes a prefix of ``jax.devices()``, ``make_mesh`` requires ``n_data *
n_index`` to equal the world size. aindex_tpu's ``NamedSharding`` helpers
have no torch meaning (a rank holds its own shard) and are not copied.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

DATA_AXIS = "data"
INDEX_AXIS = "index"


def make_mesh(n_data: int | None = None, n_index: int = 1, *, device_type: str = "cuda"):
    """(data, index) ``DeviceMesh`` over every rank of the job, which must
    have joined a process group (``distributed.initialize``).

    With the defaults every rank goes to the ``data`` axis; ``n_index`` > 1
    carves an index-sharding axis. ``device_type`` is "cuda" (NCCL) or
    "cpu" (gloo) and must be one the group's backend serves; "cuda"
    without a card raises."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device_type='cuda'): CUDA is not available")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "aindex_torch.parallel.distributed.initialize() (or "
                           "torch.distributed.init_process_group) first")
    backend = str(dist.get_backend())
    if ("nccl" if device_type == "cuda" else "gloo") not in backend:
        raise ValueError(f"a {device_type} mesh needs the "
                         f"{'nccl' if device_type == 'cuda' else 'gloo'} backend; the "
                         f"process group runs {backend}")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // max(n_index, 1)
    if n_data < 1 or n_index < 1 or n_data * n_index != world:
        raise ValueError(f"n_data={n_data} x n_index={n_index} must equal the world size "
                         f"{world}: the mesh spans every rank")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (n_data, n_index),
                            mesh_dim_names=(DATA_AXIS, INDEX_AXIS))


def axis_size(mesh, axis: str) -> int:
    """Number of ranks along ``axis`` (aindex_tpu's ``mesh.shape[axis]``)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of the ranks that share this rank's other
    coordinate: the one a collective over ``axis`` runs on."""
    return mesh.get_group(axis)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on: its card for a cuda mesh,
    the CPU for a cpu mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
