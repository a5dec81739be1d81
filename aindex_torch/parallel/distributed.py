"""Joining a multi-rank job, and the rank-level building blocks of the
sharded build paths.

Counterpart of aindex_tpu/parallel/distributed.py. The reference is
strictly single-node; scaling beyond one device is the rebuild's own
capability. The model, on ``torch.distributed``:

* every rank runs the same program (SPMD), one rank per device, started
  by ``torchrun`` (or any launcher that sets its environment), and calls
  :func:`initialize` once before building a mesh;
* :func:`global_mesh` builds the (data, index) mesh over every rank;
* each rank packs and feeds only its own ``data`` row of every batch
  (:func:`local_data_rows`), and host results cross ranks through
  :func:`allgather_concat`;
* rank 0 writes shared artifacts (:func:`should_write`), the others wait
  at a :func:`barrier` before reading them.

Without a launcher's environment :func:`initialize` is a no-op, and a
process with no group runs as a world of one.
"""

from __future__ import annotations

import datetime
import logging
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

from aindex_torch.parallel.mesh import DATA_AXIS, axis_rank, axis_size, make_mesh, mesh_device

logger = logging.getLogger(__name__)

#: the environment ``torchrun`` sets for every rank
ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
#: how long a collective waits for the other ranks before it fails
TIMEOUT = datetime.timedelta(minutes=10)


def _backend(device) -> str:
    """NCCL for a card (which must exist), gloo for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda process group needs CUDA, which is not available")
        return "nccl"
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}: aindex_torch runs on cpu or cuda")
    return "gloo"


def initialize(*, device="cuda", timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Join the job ``torchrun`` started (``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` in the environment), on
    NCCL for ``device="cuda"`` (after ``torch.cuda.set_device(LOCAL_RANK)``)
    or gloo for "cpu". Returns whether a group is joined: without the
    environment this is a no-op (a single-process run), and a group that
    already exists is kept."""
    if dist.is_initialized():
        return True
    if not all(os.environ.get(v) for v in ENV):
        logger.debug("no torchrun environment; single-process run")
        return False
    backend = _backend(device)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, timeout=timeout)
    logger.info("joined distributed job: rank %d/%d on %s", dist.get_rank(),
                dist.get_world_size(), backend)
    return True


def ensure_group(*, device="cuda", timeout: datetime.timedelta = TIMEOUT) -> None:
    """A process group to build a mesh on: the existing one, else a world
    of one rank (an in-memory store; no address, no port)."""
    if dist.is_initialized():
        return
    dist.init_process_group(_backend(device), store=dist.HashStore(), rank=0, world_size=1,
                            timeout=timeout)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(n_index: int = 1, *, device_type: str = "cuda"):
    """(data, index) mesh over every rank of the job: ``n_index`` ranks
    shard the sparse table's slots (keep them on one host, where the query
    sums are cheap), the rest carry data parallelism. Ranks follow their
    global order, so consecutive ``data`` rows are neighbouring ranks."""
    world = world_size()
    if n_index < 1 or world % n_index:
        raise ValueError(f"n_index={n_index} must divide the world size {world}")
    return make_mesh(world // n_index, n_index, device_type=device_type)


def host_read_slice(n_items: int) -> slice:
    """The slice of a length-``n_items`` input list this rank should read:
    contiguous, balanced rank-level data sharding for input pipelines."""
    p, n = rank(), world_size()
    per = -(-n_items // n)
    return slice(p * per, min((p + 1) * per, n_items))


def is_multiprocess() -> bool:
    return world_size() > 1


def should_write() -> bool:
    """True on the rank that owns shared-filesystem artifact writes (rank
    0): every rank computes identical results, exactly one persists them."""
    return rank() == 0


def local_data_rows(mesh) -> range:
    """The ``data`` rows this rank feeds: its own row of the mesh."""
    d = axis_rank(mesh, DATA_AXIS)
    return range(d, d + 1)


def local_row_chunks(blob: np.ndarray, k: int, chunk: int, mesh):
    """(row, bytes done) for this rank's row of every [n_data, chunk] batch
    of the blob's overlapping chunks (``core.reads.blob_chunk_batches``):
    the input of the data-parallel builds. Every rank gets as many rows;
    the final batch's rows past the blob are newline padding."""
    from aindex_torch.core.reads import blob_chunk_batches
    n_data = axis_size(mesh, DATA_AXIS)
    done = 0
    for batch in blob_chunk_batches(blob, k, chunk, n_data, row_range=local_data_rows(mesh)):
        done = min(done + (batch.shape[1] - (k - 1)) * n_data, blob.size)
        for row in batch:
            yield row, done


def put_row_sharded(rows_local: np.ndarray, mesh) -> torch.Tensor:
    """This rank's rows of a host batch (``local_data_rows``) as a tensor on
    its device: the input half of the "never touch another rank's bytes"
    contract."""
    return torch.from_numpy(np.ascontiguousarray(rows_local)).to(mesh_device(mesh))


def local_row_shards(arr: torch.Tensor, mesh) -> dict[int, np.ndarray]:
    """{data row -> host copy of that row} of a per-rank result whose
    leading dimension holds this rank's rows: the output half of the
    contract."""
    rows = local_data_rows(mesh)
    return {d: arr[i].cpu().numpy() for i, d in enumerate(rows)}


def _comm_device(group) -> torch.device:
    """Where a collective on ``group`` takes its tensors."""
    if "nccl" in str(dist.get_backend(group)):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``all_gather_into_tensor`` of equal-sized ``t`` from every rank of
    ``group``, concatenated along the first dimension in rank order."""
    out = torch.empty((dist.get_world_size(group) * t.shape[0], *t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    with warnings.catch_warnings():
        # newer torch renames the call; the older name works on both
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def allgather_concat(local: np.ndarray, group=None) -> np.ndarray:
    """Concatenate per-rank host arrays across the ranks of ``group`` (the
    world by default), in rank order; first dimensions may differ. A size
    exchange, then one all-gather of each rank's bytes padded to the
    largest, as int64 words. A world of one: identity."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return local
    dev = _comm_device(group)
    local = np.ascontiguousarray(local)
    row = int(np.prod(local.shape[1:], dtype=np.int64)) * local.dtype.itemsize
    sizes = all_gather(torch.tensor([local.shape[0]], dtype=torch.int64, device=dev),
                       group).cpu().numpy()
    cap = -(-max(int(sizes.max()), 1) * row // 8) * 8
    padded = torch.zeros(cap, dtype=torch.uint8, device=dev)
    padded[:local.nbytes] = torch.from_numpy(local.reshape(-1).view(np.uint8)).to(dev)
    gathered = all_gather(padded.view(torch.int64), group).view(torch.uint8)
    gathered = gathered.cpu().numpy().reshape(len(sizes), cap)
    return np.concatenate([gathered[p, :int(sizes[p]) * row].view(local.dtype)
                           .reshape(-1, *local.shape[1:]) for p in range(len(sizes))])


def barrier(name: str) -> None:
    """Block until every rank reaches this point (no-op in a world of one).
    Sequences shared-filesystem artifacts: rank 0 writes, the rest wait
    here before reading."""
    if is_multiprocess():
        logger.debug("barrier %s", name)
        dist.barrier()
