"""The device paths of aindex_torch: codes-in queries on a device tensor,
the mesh-sharded engine, and the statistics/dump surface.

* codes-in queries skip the string handling: encode once, keep the 2-bit
  codes on the index's device, and get a ``torch.uint32`` tensor back on
  that device, with no host round trip;
* ``shard_to(mesh)`` moves the sparse index onto a ``parallel.mesh`` mesh
  over every rank of the job: the MPHF node records shard by node range,
  each query merges with one all_reduce, and every query family keeps
  working. Without a launched job the mesh is a world of one rank
  (``parallel.distributed.ensure_group``);
* ``set_stats`` / ``save_values`` mirror the reference's coverage-profile
  histogram and slot-ordered text dump.

The port's counterpart of examples/device_and_sharded_queries.py. The
index lives on the card unless the caller asks for the CPU; asking for the
card on a machine with none raises.

Run: python examples/torch_device_and_sharded_queries.py [--device cpu]
(or under torchrun, one rank a card, to shard over the job's ranks)
"""

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from aindex_torch import AIndex


def main(device="cuda"):
    rng = np.random.default_rng(1)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = [bytes(bases[rng.integers(0, 4, size=120)]).decode()
             for _ in range(300)]
    idx = AIndex.build_from_sequences(reads, kmer_size=23, device=device)

    # --- codes-in device queries ------------------------------------------
    from aindex_torch.core import codec
    kmers = [r[i:i + 23] for r in reads[:50] for i in (0, 31, 62)]
    codes, _ = codec.encode_kmers(kmers, 23)       # encode once (host)
    codes_dev = torch.from_numpy(codes).to(idx.device)  # ... to the device, once
    tf_dev = idx.get_tf_values_codes_23mer(codes_dev)   # device in, device out
    print(f"codes-in tf: device array {tuple(tf_dev.shape)} {tf_dev.dtype}, "
          f"first 8 = {tf_dev[:8].cpu().tolist()}")

    # --- statistics + dump -------------------------------------------------
    s = idx.set_stats(coverage=4)
    print(f"stats: unique={s['unique']} distinct={s['distinct']} "
          f"total={s['total']} max={s['max_count']}")
    print(f"coverage profile: {s['profile'].tolist()}")
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "dump.dat")
        zeros, ones, other = idx.save_values(path)
        with open(path) as f:
            n_lines = sum(1 for _ in f)
        print(f"save_values: {ones} singletons, {other} repeated "
              f"-> {n_lines} lines")

    # --- mesh-sharded engine ----------------------------------------------
    from aindex_torch.parallel.distributed import ensure_group
    from aindex_torch.parallel.mesh import make_mesh
    joined = dist.is_initialized()
    ensure_group(device=idx.device.type)      # a world of one without a job
    try:
        n_ranks = dist.get_world_size()
        mesh = make_mesh(n_data=1, n_index=n_ranks, device_type=idx.device.type)
        before = list(idx.get_tf_values(kmers))
        idx.shard_to(mesh)                    # releases unsharded replicas
        assert list(idx.get_tf_values(kmers)) == before
        print(f"sharded over {n_ranks} rank(s): "
              f"{idx._sharded23.per_device_bytes} bytes/device, "
              f"tf/De Bruijn/coverage all served sharded")
        print(f"debruijn_next = {idx.debruijn_next(kmers[0])}")
    finally:
        if not joined:                        # leave no group this call made
            dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
