"""The multi-device slice of aindex_torch across real processes on gloo,
the counterpart of tests/test_parallel.py and tests/test_multihost.py.

For world sizes 2 (a data mesh of 2) and 4 (a 2 x 2 data x index mesh),
one spawn of that many ranks (this file run as a script; it imports
aindex_torch only) joins a gloo group through a FileStore in the test's
tmp dir and runs, on every rank:

* ``build_all`` on the mesh at k = 23 (count, spectrum, positional fill
  through the alltoall exchange), rank 0 writing the artifacts, and the
  dense 13-mer count on the mesh (its 4^13 table compared by SHA-256,
  which keeps two 0.5 GB .tf.bin files off the disk);
* the sparse positional fill again through the allgather exchange, and
  the dense fill at k = 5, both on the mesh;
* ``AIndex.shard_to`` on the build mesh and on a mesh whose every rank is
  an index shard, then the sparse query surface through the facade.

Each rank writes what it computed to ``rank<r>.npz``; the tests hold the
artifacts byte for byte, and the answers exactly, to aindex_tpu's
single-process build and its ``ShardedSparse23``."""

import datetime
import hashlib
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

if __name__ != "__main__":   # a rank imports aindex_torch only
    from test_torch_host import jax_native  # noqa: F401 (a fixture)

    #: aindex_tpu's native library loads before anything here builds through it
    pytestmark = pytest.mark.usefixtures("jax_native")

HERE = os.path.dirname(os.path.abspath(__file__))
ARTIFACTS_23 = (".reads", ".ridx", ".pf", ".tf.bin", ".kmers.bin", ".index.bin",
                ".indices.bin")
#: a rank that has not finished by then fails the spawn instead of hanging
SPAWN_TIMEOUT = 120
#: how long a collective waits for a missing rank
GROUP_TIMEOUT = datetime.timedelta(seconds=90)


def _reads(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if not line.startswith(">")]


def _forward_table(reads: list[str], k: int) -> np.ndarray:
    tf = np.zeros(4 ** k, dtype=np.uint32)
    for r in reads:
        for i in range(len(r) - k + 1):
            km = r[i:i + k]
            if set(km) <= set("ACGT"):
                tf[int(km.translate(str.maketrans("ACGT", "0123")), 4)] += 1
    return tf


def _queries(reads: list[str]) -> list[str]:
    """23-mers of the reads, both strands, and absent and invalid ones."""
    from aindex_torch.core.codec import revcomp
    kms = [r[i:i + 23] for r in reads for i in range(0, len(r) - 22, 5)]
    return kms + [revcomp(km) for km in kms[:50]] + ["A" * 23, "ACGTN" + "C" * 18]


def worker(store_path: str, world: int, rank: int, fasta: str, out: str) -> None:
    import torch
    import torch.distributed as dist
    from aindex_torch import AIndex, Dense13Index, PositionalIndex
    from aindex_torch.core.codec import encode_kmers
    from aindex_torch.core.reads import ReadsStore
    from aindex_torch.parallel import positional as ppos
    from aindex_torch.parallel.mesh import make_mesh
    from aindex_torch.pipeline.build import BuildConfig, build_all

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=GROUP_TIMEOUT)
    fallbacks = []
    handler = logging.Handler()
    handler.emit = lambda record: fallbacks.append(record.getMessage())
    ppos.logger.addHandler(handler)
    ppos.logger.setLevel(logging.INFO)
    n_index = 1 if world == 2 else 2
    mesh = make_mesh(world // n_index, n_index, device_type="cpu")
    res = {}
    build_all([fasta], BuildConfig(prefix=f"{out}/m.23", k=23, chunk=512, mesh=mesh,
                                   device="cpu"))
    ai = AIndex.load_from_prefix(f"{out}/m.23", device="cpu")
    blob = ReadsStore.from_reads_file(f"{out}/m.23.reads").blob
    tf13 = Dense13Index.build_from_blob(blob, 512, mesh, device="cpu").tf_host
    res["tf13_sha256"] = np.array(hashlib.sha256(tf13.tobytes()).hexdigest())
    del tf13
    pos = ppos.build_positional_sharded(blob, ai.sparse23.n, ai.sparse23.tf_host,
                                        ai.sparse23.tables, mesh, 23, 512,
                                        exchange="allgather")
    res["allgather_positions"] = pos.positions
    res["allgather_offsets"] = pos.offsets
    reads = _reads(fasta)
    pos5 = PositionalIndex.build_dense13(blob, k=5, chunk=512, tf=_forward_table(reads, 5),
                                         mesh=mesh)
    res["k5_positions"] = pos5.positions
    res["k5_offsets"] = pos5.offsets
    kms = _queries(reads)
    codes, _ = encode_kmers(kms, 23)
    for name, qmesh in (("build", mesh), ("index", make_mesh(1, world, device_type="cpu"))):
        ai = AIndex.load_from_prefix(f"{out}/m.23", device="cpu")
        ai.shard_to(qmesh)
        eng = ai._engine23
        res[f"{name}_tf"] = np.array(ai.get_tf_values(kms))
        res[f"{name}_pfids"] = eng.get_pfids(kms)
        res[f"{name}_hash"] = np.array(ai.get_hash_values(kms))
        res[f"{name}_strands"] = eng.get_strands(kms)
        res[f"{name}_codes"] = ai.get_tf_values_codes_23mer(codes).view(
            torch.int32).numpy().view(np.uint32)
        res[f"{name}_cov"] = np.concatenate(eng.sequence_coverage_batch(reads[:6], 1))
        res[f"{name}_next"] = eng.debruijn_next(kms[:40], 0)
        res[f"{name}_prev"] = eng.debruijn_prev(kms[:40], 1)
        res[f"{name}_bytes"] = np.array(eng.per_device_bytes)
    res["fallbacks"] = np.array(len(fallbacks))
    np.savez(f"{out}/rank{rank}.npz", **res)
    dist.destroy_process_group()
    print(f"rank {rank}/{world}: ok", flush=True)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    rng = np.random.default_rng(20260821)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = [bytes(bases[rng.integers(0, 4, size=70)]).decode() for _ in range(40)]
    reads += ["ACGT" * 20, "TTAA" + "N" * 3 + "ACGTACGTACGTACGTACGTACG"]
    p = tmp_path_factory.mktemp("mp") / "in.fa"
    p.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    return str(p)


@pytest.fixture(scope="module")
def single(fasta, tmp_path_factory, jax_native):
    """aindex_tpu's single-process build of the same FASTA."""
    from aindex_tpu.pipeline.build import BuildConfig, build_all
    d = tmp_path_factory.mktemp("single")
    build_all([fasta], BuildConfig(prefix=str(d / "s.23"), k=23, chunk=512))
    return str(d)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def spawned(request, fasta, tmp_path_factory, jax_native):
    """One spawn of ``world`` ranks; (world, out dir, per-rank results)."""
    world = request.param
    out = str(tmp_path_factory.mktemp(f"world{world}"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(HERE)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    procs = [subprocess.Popen(
        [sys.executable, __file__, os.path.join(out, "store"), str(world), str(r), fasta, out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
        assert f"rank {r}/{world}: ok" in log
    return world, out, [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(world)]


def test_build_all_byte_identical(spawned, single):
    _, out, _ = spawned
    for sfx in ARTIFACTS_23:
        with open(f"{single}/s.23{sfx}", "rb") as a, open(f"{out}/m.23{sfx}", "rb") as b:
            assert a.read() == b.read(), sfx


def test_dense_count_on_every_rank(spawned, single):
    """Every rank holds aindex_tpu's single-device 13-mer table after the
    mesh count's all_reduce."""
    from aindex_tpu.index.dense13 import Dense13Index
    _, _, ranks = spawned
    blob = np.fromfile(f"{single}/s.23.reads", dtype=np.uint8)
    want = hashlib.sha256(Dense13Index.build_from_blob(blob, 512).tf_host.tobytes()).hexdigest()
    for res in ranks:
        assert str(res["tf13_sha256"]) == want


def test_allgather_exchange_on_every_rank(spawned):
    """The build's alltoall exchange ran without a fallback, and the
    allgather exchange gives every rank the same CSR."""
    _, out, ranks = spawned
    positions = np.fromfile(f"{out}/m.23.index.bin", dtype=np.uint64)
    offsets = np.fromfile(f"{out}/m.23.indices.bin", dtype=np.uint64)
    for res in ranks:
        assert int(res["fallbacks"]) == 0
        np.testing.assert_array_equal(res["allgather_positions"], positions)
        np.testing.assert_array_equal(res["allgather_offsets"], offsets)


def test_dense_positional_on_every_rank(spawned, fasta):
    from aindex_tpu.index.positional import PositionalIndex
    _, out, ranks = spawned
    blob = np.fromfile(f"{out}/m.23.reads", dtype=np.uint8)
    want = PositionalIndex.build_dense13(blob, k=5, chunk=512,
                                         tf=_forward_table(_reads(fasta), 5))
    for res in ranks:
        np.testing.assert_array_equal(res["k5_offsets"], want.offsets)
        np.testing.assert_array_equal(res["k5_positions"], want.positions)


@pytest.mark.parametrize("mesh_name", ["build", "index"])
def test_sharded_queries_match_aindex_tpu(spawned, single, fasta, eight_devices, mesh_name):
    from aindex_tpu.core import codec
    from aindex_tpu.index.sparse23 import Sparse23Index
    from aindex_tpu.parallel.mesh import make_mesh
    from aindex_tpu.parallel.query23 import ShardedSparse23
    world, _, ranks = spawned
    n_index = world if mesh_name == "index" else (1 if world == 2 else 2)
    index = Sparse23Index.load(f"{single}/s.23")
    eng = ShardedSparse23(index, make_mesh(n_data=1, n_index=n_index,
                                           devices=eight_devices[:n_index]))
    reads = _reads(fasta)
    kms = _queries(reads)
    codes, _ = codec.encode_kmers(kms, 23)
    want = {"tf": eng.get_tf_values(kms), "pfids": eng.get_pfids(kms),
            "hash": eng.get_hash_values(kms), "strands": eng.get_strands(kms),
            "codes": np.asarray(eng.get_tf_values_codes(codes)),
            "cov": np.concatenate(eng.sequence_coverage_batch(reads[:6], 1)),
            "next": eng.debruijn_next(kms[:40], 0), "prev": eng.debruijn_prev(kms[:40], 1)}
    assert want["tf"][:100].all()
    # the port's layout differs from aindex_tpu's by design: a rank holds
    # the 16-byte node records of its node range and the whole g-vector
    m = index.mphf
    nodes = -(-3 * int(m.domain) // n_index) * n_index
    want["bytes"] = 16 * nodes // n_index + np.asarray(m.g_packed, np.uint32).nbytes
    for res in ranks:
        for key, value in want.items():
            np.testing.assert_array_equal(res[f"{mesh_name}_{key}"], np.asarray(value),
                                          err_msg=key)
        if mesh_name == "index":    # n_index = world against the build mesh's 1 or 2
            assert int(res["index_bytes"]) < int(res["build_bytes"])


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
