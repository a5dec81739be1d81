"""The multi-device slice of aindex_torch in one process, with no process
group: each sharded step's local function (a kernel's plain version on the
CPU) runs for N = 1, 2, 4 and 8 shards, the collective stood in for by a
sum or a concatenation, and the result is held exactly to aindex_tpu's
sharded function on the 8 virtual CPU devices of tests/conftest.py. Also
the plain K12/K13 twins on random keys with sentinels, the world-of-one
mesh entry points, and the positional order of the mesh signatures
aindex_tpu gives (ROADMAP C.1). Every compared value is an integer:
equality is exact."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aindex_tpu.core import codec as jcodec
from aindex_tpu.core.reads import ReadsStore
from aindex_tpu.index import positional as jpos
from aindex_tpu.index.dense13 import Dense13Index as JDense
from aindex_tpu.index.sparse23 import Sparse23Index as JSparse
from aindex_tpu.index.sparse23 import count_canonical_kmers as j_count_canonical
from aindex_tpu.kernels import lookup as jlookup
from aindex_tpu.kernels.encode import packed_window_codes as j_packed_window_codes
from aindex_tpu.kernels import spectrum as jspectrum
from aindex_tpu.parallel import count13 as jcount13
from aindex_tpu.parallel import positional as jppos
from aindex_tpu.parallel.mesh import make_mesh as j_make_mesh
from aindex_tpu.parallel.query23 import ShardedSparse23 as JSharded
from aindex_tpu.parallel.query23 import resolve23_sharded as j_resolve
from aindex_tpu.parallel.spectrum23 import spectrum23_sharded as j_spectrum
from aindex_torch import Dense13Index as TDense
from aindex_torch import PositionalIndex as TPos
from aindex_torch import Sparse23Index as TSparse
from aindex_torch.core import codec as tcodec
from aindex_torch.core.reads import blob_chunk_batches
from aindex_torch.index.sparse23 import count_canonical_kmers as t_count_canonical
from aindex_torch.kernels import lookup as tlookup
from aindex_torch.kernels import spectrum as tspectrum
from aindex_torch.kernels.positional import posbucket, posfill_pairs
from aindex_torch.kernels.probe import CANON
from aindex_torch.parallel import count13 as tcount13
from aindex_torch.parallel import distributed as tdist
from aindex_torch.parallel import positional as tppos
from aindex_torch.parallel.mesh import make_mesh as t_make_mesh
from aindex_torch.parallel.query23 import shard_records
from aindex_torch.parallel.spectrum23 import merge_range

import oracle
from test_torch_host import jax_native  # noqa: F401 (a fixture)

#: aindex_tpu's native library loads before anything here builds through it
pytestmark = pytest.mark.usefixtures("jax_native")

SHARDS = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def reads():
    """tests/test_parallel.py's reads: 37 random reads (not a multiple of
    8), a repeat and a read with an N run."""
    rng = np.random.default_rng(99)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = [bytes(bases[rng.integers(0, 4, size=40 + int(rng.integers(0, 30)))]).decode()
             for _ in range(37)]
    reads.append("ACGT" * 12)
    reads.append("AATT" + "N" * 4 + "GGCCGGCCGGCCGGCCGGCCGGC")
    return reads


@pytest.fixture(scope="module")
def blob(reads):
    return ReadsStore.from_sequences(reads).blob


def _t(a: np.ndarray) -> torch.Tensor:
    """A host array as a CPU tensor (uint32 through its int32 view)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _j_mesh(n_data: int, n_index: int, eight_devices):
    return j_make_mesh(n_data=n_data, n_index=n_index, devices=eight_devices[:n_data * n_index])


@pytest.fixture(scope="module")
def world():
    """A world-of-one gloo group and its (1, 1) cpu mesh."""
    tdist.ensure_group(device="cpu")
    return t_make_mesh(1, 1, device_type="cpu")


# -- count13: K1 per shard, a sum over data ---------------------------------------

@pytest.mark.parametrize("n", SHARDS)
def test_count13_sharded(reads, eight_devices, n):
    batch = tcount13.pack_reads_batch(reads, n_shards=n)
    np.testing.assert_array_equal(batch, jcount13.pack_reads_batch(reads, n_shards=n))
    packed, vbits = tcodec.pack_ascii_chunk(batch)
    want = np.asarray(jcount13.count13_sharded(
        jnp.asarray(packed), jnp.asarray(vbits), mesh=_j_mesh(n, 1, eight_devices)))
    rows = batch.shape[0] // n
    total = torch.zeros(4 ** 13, dtype=torch.int32)
    for d in range(n):
        total += tcount13.count13_local(_t(packed[d * rows:(d + 1) * rows]),
                                        _t(vbits[d * rows:(d + 1) * rows]))
    np.testing.assert_array_equal(total.numpy().view(np.uint32), want)
    golden = oracle.count_forward(reads, 13)
    assert int(want.sum(dtype=np.uint64)) == sum(golden.values())


def test_count13_sharded_world_of_one(reads, eight_devices, world):
    """The collective shell: count13_sharded and its accumulating form on
    a world-of-one mesh."""
    batch = tcount13.pack_reads_batch(reads, n_shards=1)
    packed, vbits = tcodec.pack_ascii_chunk(batch)
    want = np.asarray(jcount13.count13_sharded(
        jnp.asarray(packed), jnp.asarray(vbits), mesh=_j_mesh(1, 1, eight_devices)))
    got = tcount13.count13_sharded(_t(packed), _t(vbits), mesh=world)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    tcount13.count13_sharded_accumulate(got, _t(packed), _t(vbits), mesh=world)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), 2 * want)


# -- spectrum23: K5 per shard, all-gather, K13 per key range ---------------------

@pytest.mark.parametrize("n", SHARDS)
def test_spectrum23_sharded_per_shard(blob, eight_devices, n):
    mesh = _j_mesh(n, 1, eight_devices)
    batches = list(blob_chunk_batches(blob, 23, 256, n))
    assert batches
    for batch in batches:
        packed, vbits = tcodec.pack_ascii_chunk(batch)
        jk, jc, jn = (np.asarray(x) for x in j_spectrum(jnp.asarray(packed), jnp.asarray(vbits),
                                                        mesh=mesh, k=23))
        parts = [tspectrum.chunk_spectrum_packed(_t(packed[d]), _t(vbits[d]), 23)
                 for d in range(n)]
        all_k = torch.cat([p[0] for p in parts])
        all_c = torch.cat([p[1].view(torch.int32) for p in parts])
        for d in range(n):
            keys, counts, n_u = merge_range(all_k, all_c, d, n, 23)
            np.testing.assert_array_equal(_u64(keys), jk[d])
            np.testing.assert_array_equal(_u64(counts), jc[d])
            assert int(n_u) == int(jn[d])


# -- resolve23: K12 per shard (the walk over its node records), one sum -----------

def _walk_sum(mphf, checker, tf, n_keys: int, n: int, codes=None, valid=None, windows=None,
              k: int = 23, canonical: bool = False):
    """resolve23_sharded's local step for ``n`` shards in one process: each
    shard's ``shard_walk`` over its own node records, and the one
    all_reduce stood in for by a sum. Returns (the summed int32[3, m]
    parts, fwd, every shard's parts)."""
    g = _t(np.asarray(mphf.g_packed, np.uint32))
    each, fwd = [], None
    for i in range(n):
        rec, padded = shard_records(mphf, checker, tf, n, i)
        assert rec.shape == (padded // n, 4) and padded >= 3 * int(mphf.domain)
        parts, fwd = tlookup.shard_walk(g, rec, i * rec.shape[0], n_keys, int(mphf.seed),
                                        int(mphf.domain), codes, valid, windows, k, canonical)
        each.append(parts)
    return torch.stack(each).sum(0, dtype=torch.int32), fwd, each


@pytest.mark.parametrize("n", SHARDS)
def test_resolve23_sharded(blob, eight_devices, n):
    jindex = JSparse.build_from_blob(blob)
    sharded = JSharded(jindex, _j_mesh(1, n, eight_devices))
    rng = np.random.default_rng(7 + n)
    present = jindex.checker_host[rng.integers(0, jindex.n, size=300)]
    absent = rng.integers(0, 4 ** 23, size=200, dtype=np.uint64)
    literal = jcodec.revcomp_code(present[:100], 23)
    canon = np.concatenate([present, absent, literal]).astype(np.uint64)
    valid = rng.random(canon.size) < 0.8
    jtf, jslot, jfound = (np.asarray(x) for x in j_resolve(
        sharded.g_packed, sharded.slots_sharded, sharded.tf_sharded, sharded.checker_sharded,
        sharded.seed, sharded.domain, jnp.asarray(canon), jnp.asarray(valid),
        mesh=sharded.mesh))
    parts, fwd, _ = _walk_sum(jindex.mphf, jindex.checker_host, jindex.tf_host, jindex.n, n,
                              _t(canon.view(np.int64)), torch.from_numpy(valid))
    assert fwd is None
    tf, slot, found = parts
    np.testing.assert_array_equal(tf.numpy().view(np.uint32), jtf)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    np.testing.assert_array_equal(found.numpy() > 0, jfound)
    np.testing.assert_array_equal(jfound[:300], valid[:300])    # present keys, masked


@pytest.fixture(scope="module")
def walk_index(blob):
    """(port index, its MphfTables: the single-device walk over every node)."""
    t = TSparse.build_from_blob(blob, device="cpu")
    return t, tlookup.MphfTables.from_host(t.mphf, t.checker_host, t.tf_host, "cpu")


def _walk_keys(t, tables, rng) -> np.ndarray:
    """Members, their reverse complements, random codes, codes that walk to
    unassigned nodes, the key in slot 0, 0 and 4^23 - 1."""
    draws = rng.integers(0, 4 ** 23, 100_000, dtype=np.uint64)
    node = tlookup.mphf_owner_node(tables.g_packed, _t(draws.view(np.int64)), tables.seed,
                                   tables.domain).numpy()
    g = (np.asarray(t.mphf.g_packed, np.uint32)[node >> 4] >> (2 * (node & 15))) & 3
    unassigned = draws[g == 3][:500]
    assert unassigned.size == 500
    members = t.checker_host
    return np.concatenate([members, jcodec.revcomp_code(members, 23), draws[:2000], unassigned,
                           members[:1], np.array([0, 4 ** 23 - 1], np.uint64)])


def _walk_want(tables, keys: torch.Tensor, valid) -> torch.Tensor:
    """The parts the shards must sum to, from the single-device walk: tf
    and found where the key is present (and valid), the raw slot always."""
    hit, tf, slot = tables.probe_plain(keys)
    if valid is not None:
        hit = hit & valid
    return torch.stack([torch.where(hit, tf, 0).to(torch.int32), slot.to(torch.int32),
                        hit.to(torch.int32)])


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("case", ["raw", "masked", "canonical"])
def test_shard_walk_matches_walk(walk_index, n, case):
    """Summed over n shards, shard_walk_plain == MphfTables.probe_plain:
    present, absent and unassigned-node keys, raw (canonical=False) slots,
    a mask, and canonical probes with their strand; the owner of each key
    lies in one shard's node range, so no other shard answers."""
    t, tables = walk_index
    rng = np.random.default_rng(211 + n)
    codes = _t(_walk_keys(t, tables, rng).view(np.int64))
    valid = torch.from_numpy(rng.random(codes.numel()) < 0.8) if case == "masked" else None
    got, fwd, each = _walk_sum(t.mphf, t.checker_host, t.tf_host, t.n, n, codes, valid,
                               canonical=case == "canonical")
    keys = codes
    if case == "canonical":
        rc = tlookup.revcomp_code64(codes, 23)
        keys = torch.where(codes <= rc, codes, rc)    # codes below 2^46: signed order holds
        np.testing.assert_array_equal(fwd.numpy(), (codes <= rc).numpy())
    else:
        assert fwd is None
    want = _walk_want(tables, keys, valid)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    owners = torch.stack([(p != 0).any(0) for p in each]).sum(0)
    assert int(owners.max()) <= 1
    assert bool(want[2, :t.n].all()) == (case != "masked")


@pytest.mark.parametrize("n", SHARDS)
def test_shard_walk_windows(walk_index, reads, n):
    """The windows entry (packed rows, as coverage takes them) == the codes
    entry on the same windows encoded from their strings, each window's
    validity its mask; a row's padding is invalid."""
    t, tables = walk_index
    stride = 80
    rows = [r[:stride - 1] for r in reads]
    packed, vbits = tcodec.pack_ascii_chunk(np.frombuffer(
        "".join(r.ljust(stride, "\n") for r in rows).encode(), np.uint8))
    windows = (_t(packed), _t(vbits), len(rows), stride)
    got, fwd, _ = _walk_sum(t.mphf, t.checker_host, t.tf_host, t.n, n, windows=windows,
                            canonical=True)
    kms = [r.ljust(stride, "\n")[j:j + 23] for r in rows for j in range(stride - 23)]
    codes, valid = tcodec.encode_kmers(kms, 23)
    codes = _t(np.ascontiguousarray(codes).view(np.int64))
    want, want_fwd, _ = _walk_sum(t.mphf, t.checker_host, t.tf_host, t.n, n, codes,
                                  torch.from_numpy(valid), canonical=True)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())
    ok = torch.from_numpy(valid)
    np.testing.assert_array_equal(got[1][ok].numpy(), want[1][ok].numpy())
    np.testing.assert_array_equal(fwd[ok].numpy(), want_fwd[ok].numpy())
    assert int(got[2].sum()) > 0 and not bool(ok.all())


@pytest.mark.parametrize("n", SHARDS)
def test_shard_walk_no_keys(n):
    """n = 0: every key absent (tf 0, not found) at every shard count, its
    raw slot 0, as aindex_tpu's node -> slot table of zeros reads."""
    t = TSparse.build_from_blob(ReadsStore.from_sequences(["ACGTACG"]).blob, device="cpu")
    assert t.n == 0
    codes = np.array([0, 5, 4 ** 23 - 1, 12345678901], dtype=np.uint64)
    got, _, _ = _walk_sum(t.mphf, t.checker_host, t.tf_host, 0, n, _t(codes.view(np.int64)),
                          canonical=True)
    np.testing.assert_array_equal(got.numpy(), 0)
    raw = jlookup.mphf_lookup(jnp.asarray(t.mphf.g_packed), jnp.asarray(t.mphf.slots),
                              jnp.asarray(codes), jnp.uint64(t.mphf.seed),
                              jnp.uint64(t.mphf.domain))
    np.testing.assert_array_equal(np.asarray(raw), 0)


@pytest.mark.parametrize("n", SHARDS)
def test_shard_walk_padding_shards(n):
    """An index of 2 keys (6 nodes): at 4 and 8 shards the last shards'
    node ranges are padding only. They answer nothing, and the sum is the
    single-device walk's."""
    t = TSparse.build_from_blob(ReadsStore.from_sequences(["ACGT" * 5 + "ACGTA"]).blob,
                                device="cpu")
    tables = tlookup.MphfTables.from_host(t.mphf, t.checker_host, t.tf_host, "cpu")
    assert t.n == 2 and 3 * t.mphf.domain == 6
    rng = np.random.default_rng(223)
    keys = np.concatenate([t.checker_host, rng.integers(0, 4 ** 23, 3000, dtype=np.uint64)])
    codes = _t(keys.view(np.int64))
    got, _, each = _walk_sum(t.mphf, t.checker_host, t.tf_host, t.n, n, codes)
    np.testing.assert_array_equal(got.numpy(), _walk_want(tables, codes, None).numpy())
    size = -(-6 // n)
    for i, parts in enumerate(each):
        if i * size >= 6:
            assert not parts.any()
    assert (n >= 4) == any(i * size >= 6 for i in range(n))


def test_sharded_query_is_one_sum(blob, world, monkeypatch):
    """On the world-of-one mesh a codes-in, an ASCII and a coverage query
    each make one all_reduce, of the int32[3, n] parts; the answers are
    the single-device index's, and a rank holds 16 B a node and the
    g-vector."""
    from aindex_torch.parallel import query23
    t = TSparse.build_from_blob(blob, device="cpu")
    eng = query23.ShardedSparse23(t, world)
    calls = []
    real = query23.dist.all_reduce

    def counted(x, **kw):
        calls.append((x.dtype, tuple(x.shape)))
        return real(x, **kw)
    monkeypatch.setattr(query23.dist, "all_reduce", counted)
    rng = np.random.default_rng(227)
    codes = np.concatenate([t.checker_host, rng.integers(0, 4 ** 23, 500, dtype=np.uint64)])
    got = eng.get_tf_values_codes(codes)
    assert calls == [(torch.int32, (3, codes.size))]
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  t.get_tf_values_codes(codes).view(torch.int32).numpy())
    seqs = [q for q in blob.tobytes().decode().split("\n") if len(q) >= 23][:5]
    kms = [q[i:i + 23] for q in seqs for i in range(0, len(q) - 22, 3)]
    calls.clear()
    np.testing.assert_array_equal(eng.get_tf_values(kms), t.get_tf_values(kms))
    assert calls == [(torch.int32, (3, len(kms)))]
    calls.clear()
    cov = eng.sequence_coverage_batch(seqs)
    assert len(calls) == 1    # the reads share one length class
    for a, b in zip(cov, t.sequence_coverage_batch(seqs)):
        np.testing.assert_array_equal(a, b)
    assert eng.per_device_bytes == 16 * 3 * t.mphf.domain + 4 * eng.g_packed.numel()
    assert eng.records_local.shape == (3 * t.mphf.domain, 4)


def test_shard_walk_rejects():
    """shard_walk's argument checks."""
    g = torch.zeros(1, dtype=torch.int32)
    rec = torch.zeros((3, 4), dtype=torch.int32)
    codes = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="records_local"):
        tlookup.shard_walk(g, torch.zeros((0, 4), dtype=torch.int32), 0, 1, 0, 1, codes)
    with pytest.raises(ValueError, match="records_local"):
        tlookup.shard_walk(g, rec[:, :3].contiguous(), 0, 1, 0, 1, codes)
    with pytest.raises(ValueError, match="exactly one"):
        tlookup.shard_walk(g, rec, 0, 1, 0, 1)
    with pytest.raises(ValueError, match="valid"):
        tlookup.shard_walk(g, rec, 0, 1, 0, 1, codes, torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="domain"):
        tlookup.shard_walk(g, rec, 0, 1, 0, 0, codes)


# -- positional: K14 per source, the exchange, K9 pairs per destination ------------

def _simulate_positional(blob, n_slots, tf, tables, n, k, chunk, mode, rule=CANON):
    """build_positional_sharded's loop for n shards in one process: the
    all_to_all is a transpose of the sources' buckets, the all-gather a
    stack of their slots. Returns (offsets, positions, overflow of the
    first run or None, whether it fell back)."""
    offsets = np.zeros(n_slots + 1, dtype=np.int64)
    np.cumsum(np.asarray(tf, dtype=np.int64), out=offsets[1:])
    m, bounds, seg_len = tppos.range_layout(offsets, n_slots, n)

    def run(step_mode):
        shards = [tppos.ShardFill(offsets, bounds[d], bounds[d + 1], torch.device("cpu"))
                  for d in range(n)]
        overflow = 0
        for b, batch in enumerate(blob_chunk_batches(blob, k, chunk, n)):
            stride = batch.shape[1] - (k - 1)
            cap = tppos.bucket_cap(stride, n)
            packed, vbits = tcodec.pack_ascii_chunk(batch)
            roff = (b * n + torch.arange(n)) * stride
            sent = [posbucket(_t(packed[s]), _t(vbits[s]), k, tables, rule, n_slots, m,
                              n if step_mode == "alltoall" else 0, cap) for s in range(n)]
            for d in range(n):
                if step_mode == "alltoall":
                    rec = torch.stack([sent[s][1][d] for s in range(n)])
                else:
                    rec = torch.stack([sent[s][0] for s in range(n)])
                shards[d].fill(rec, roff, step_mode == "alltoall")
            overflow += sum(int(s[2]) for s in sent)
        return shards, overflow

    shards, overflow = run(mode)
    fell_back = mode == "alltoall" and overflow > 0
    if fell_back:
        shards, _ = run("allgather")
    positions = np.concatenate([shards[d].positions[:seg_len[d]].numpy() for d in range(n)])
    return offsets.astype(np.uint64), positions.view(np.uint64), overflow, fell_back


def _j_positional(monkeypatch, mode, build, *args, **kw):
    monkeypatch.setenv(jppos.EXCHANGE_ENV, mode)
    return build(*args, **kw)


@pytest.mark.parametrize("mode", tppos.EXCHANGES)
@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("k", [23, 31])
def test_positional_sparse_sharded(blob, eight_devices, monkeypatch, k, n, mode):
    jindex = JSparse.build_from_blob(blob, k=k)
    tindex = TSparse.from_numpy(vars(jindex.mphf), jindex.checker_host, jindex.tf_host, k,
                                device="cpu")
    want = _j_positional(monkeypatch, mode, jpos.PositionalIndex.build_sparse23, blob, jindex,
                         chunk=512, mesh=_j_mesh(n, 1, eight_devices))
    offsets, positions, _, fell_back = _simulate_positional(
        blob, tindex.n, tindex.tf_host, tindex.tables, n, k, 512, mode)
    assert not fell_back
    np.testing.assert_array_equal(offsets, want.offsets)
    np.testing.assert_array_equal(positions, want.positions)


@pytest.mark.parametrize("mode", tppos.EXCHANGES)
@pytest.mark.parametrize("n", SHARDS)
def test_positional_dense_sharded(reads, blob, eight_devices, monkeypatch, n, mode):
    """k = 5 keeps the dense slot space at 4^5; the path is k = 13's (the
    slot is the forward code)."""
    golden = oracle.count_forward(reads, 5)
    tf = np.zeros(4 ** 5, dtype=np.uint32)
    codes, _ = jcodec.encode_kmers(sorted(golden), 5)
    tf[codes.astype(np.int64)] = [golden[km] for km in sorted(golden)]
    want = _j_positional(monkeypatch, mode, jpos.PositionalIndex.build_dense13, blob, k=5,
                         chunk=512, tf=tf, mesh=_j_mesh(n, 1, eight_devices))
    offsets, positions, _, _ = _simulate_positional(blob, 4 ** 5, tf, None, n, 5, 512, mode)
    np.testing.assert_array_equal(offsets, want.offsets)
    np.testing.assert_array_equal(positions, want.positions)


def test_overflow_falls_back(eight_devices, monkeypatch, caplog):
    """tests/test_parallel.py's case: every window of a poly-A blob is one
    k-mer, so one shard receives every record and the buckets overflow;
    the result is the exact CSR from the all-gather exchange, on both
    sides, and the port's world-of-one build logs the same fallback when
    its one bucket is too small."""
    blob = np.frombuffer(b"A" * 2800 + b"\n", dtype=np.uint8)
    jindex = JSparse.build_from_blob(blob)
    tindex = TSparse.from_numpy(vars(jindex.mphf), jindex.checker_host, jindex.tf_host,
                                device="cpu")
    with caplog.at_level(logging.INFO, logger="aindex_tpu.parallel.positional"):
        want = _j_positional(monkeypatch, "alltoall", jpos.PositionalIndex.build_sparse23,
                             blob, jindex, chunk=256, mesh=_j_mesh(8, 1, eight_devices))
    assert any("fell back to allgather" in r.message for r in caplog.records)
    offsets, positions, overflow, fell_back = _simulate_positional(
        blob, tindex.n, tindex.tf_host, tindex.tables, 8, 23, 256, "alltoall")
    assert fell_back and overflow > 0
    np.testing.assert_array_equal(offsets, want.offsets)
    np.testing.assert_array_equal(positions, want.positions)


def test_overflow_falls_back_world_of_one(blob, world, monkeypatch, caplog):
    """The build's own fallback: with buckets a tenth of the mean a world of
    one overflows too; build_positional_sharded logs the fallback and
    returns the exact CSR from the allgather exchange."""
    jindex = JSparse.build_from_blob(blob)
    tindex = TSparse.from_numpy(vars(jindex.mphf), jindex.checker_host, jindex.tf_host,
                                device="cpu")
    want = jpos.PositionalIndex.build_sparse23(blob, jindex, chunk=512)
    monkeypatch.setattr(tppos, "BUCKET_SLACK", 0.1)
    with caplog.at_level(logging.INFO, logger="aindex_torch.parallel.positional"):
        got = tppos.build_positional_sharded(blob, tindex.n, tindex.tf_host, tindex.tables,
                                             world, 23, 512, exchange="alltoall")
    assert any("fell back to allgather" in r.message and "overflow pairs" in r.message
               for r in caplog.records)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got.positions, want.positions)


def test_posbucket_overflow_counts(blob):
    """A forced small cap: the records that fit match the plain argsort
    formulation, and every window past the cap is counted."""
    jindex = JSparse.build_from_blob(blob)
    tindex = TSparse.from_numpy(vars(jindex.mphf), jindex.checker_host, jindex.tf_host,
                                device="cpu")
    packed, vbits = tcodec.pack_ascii_chunk(next(blob_chunk_batches(blob, 23, 1024, 1))[0])
    slots, buckets, overflow = posbucket(_t(packed), _t(vbits), 23, tindex.tables, CANON,
                                         tindex.n, -(-tindex.n // 4), 4, 8)
    dest = torch.where(slots >= 0, slots // -(-tindex.n // 4), 4)
    per = torch.bincount(dest, minlength=5)[:4]
    assert int(overflow) == int((per - 8).clamp(min=0).sum()) > 0
    for d in range(4):
        rec = buckets[d][buckets[d] != 0]
        window = rec & ((1 << 24) - 1)
        assert rec.numel() == min(8, int(per[d]))
        assert bool((window[1:] > window[:-1]).all())
        assert bool((((rec >> 24) - 1) == slots[window]).all())


#: the tile of K14's pass (csrc/posbucket.cu: onesweep's 4096 windows)
TILE = 4096


@pytest.fixture(scope="module")
def tile_blob():
    """80 reads of 150 bp from a 3 kbp random genome (either strand, a few
    N), so a chunk spans K14's tiles and its windows repeat."""
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, size=3000)
    rows = []
    for _ in range(80):
        s = int(rng.integers(0, genome.size - 150))
        r = genome[s:s + 150] if rng.random() < 0.5 else (3 - genome[s:s + 150])[::-1]
        seq = np.frombuffer(b"ACGT", np.uint8)[r].copy()
        seq[rng.random(150) < 0.003] = ord("N")
        rows.append(bytes(seq).decode())
    return ReadsStore.from_sequences(rows).blob


@pytest.fixture(scope="module")
def tile_index(tile_blob, jax_native):
    jindex = JSparse.build_from_blob(tile_blob)
    return jindex, TSparse.from_numpy(vars(jindex.mphf), jindex.checker_host, jindex.tf_host,
                                      device="cpu")


def _j_local_buckets(packed, vbits, k, resolve, n_dest, m, cap):
    """aindex_tpu's local_alltoall up to the exchange
    (aindex_tpu/parallel/positional.py:121-152), its cap given: (slots,
    buckets[:n_dest] as int64, overflow)."""
    codes, valid = j_packed_window_codes(jnp.asarray(packed), jnp.asarray(vbits), k,
                                         out_dtype=jnp.uint64)
    slot = resolve(codes.reshape(-1), valid.reshape(-1)).astype(jnp.int64)
    B = slot.shape[0]
    dest = jnp.where(slot >= 0, slot // jnp.int64(m), jnp.int64(n_dest))
    order = jnp.argsort(dest, stable=True)
    dest_s = dest[order]
    slot_s = slot[order]
    start = jnp.searchsorted(dest_s, jnp.arange(n_dest + 1, dtype=jnp.int64))
    rank = jnp.arange(B, dtype=jnp.int64) - start[dest_s]
    keep = (rank < cap) & (dest_s < n_dest)
    overflow = jnp.sum(((rank >= cap) & (dest_s < n_dest)).astype(jnp.int64))
    rec = ((slot_s + 1).astype(jnp.uint64) << jnp.uint64(24)) | order.astype(jnp.uint64)
    buckets = jnp.zeros((n_dest + 1, cap), jnp.uint64)
    buckets = buckets.at[jnp.where(keep, dest_s, n_dest),
                         jnp.where(keep, rank, 0).astype(jnp.int32)].set(
        jnp.where(keep, rec, jnp.uint64(0)))
    return (np.asarray(slot), np.asarray(buckets[:n_dest]).view(np.int64), int(overflow))


@pytest.mark.parametrize("n_dest", [1, 3, 255])
@pytest.mark.parametrize("k, n_bytes", [(2, 4096), (1, 4096), (16, 4112), (23, 4112), (23, 4128)],
                         ids=["dense tile-1", "dense tile", "dense tile+1", "sparse tile-6",
                              "sparse tile+10"])
def test_posbucket_tile_edges(tile_blob, tile_index, k, n_bytes, n_dest):
    """K14's send side on chunks of one tile of 4096 windows +- 1 (dense
    k = 2, 1 and 16; a k = 23 chunk's windows are 10 mod 16, so 4090 and
    4106), for 1, 3 and 255 destinations at the build's cap (at 255 the
    few dense slots overflow their buckets): slots, buckets and overflow
    equal to aindex_tpu's local_alltoall body on aindex_tpu's slots."""
    packed, vbits = tcodec.pack_ascii_chunk(tile_blob[:n_bytes])
    n_win = 16 * packed.size - k + 1
    assert n_win == {2: TILE - 1, 1: TILE, 16: TILE + 1}.get(k, n_win)
    if k == 23:
        jindex, tindex = tile_index
        tables, n_slots = tindex.tables, tindex.n

        def resolve(codes, valid):
            return jindex._resolve_device(codes, valid)[1]
    else:
        tables, n_slots = None, 4 ** k

        def resolve(codes, valid):
            return jnp.where(valid, codes.astype(jnp.int64), jnp.int64(-1))
    m = -(-n_slots // n_dest)
    cap = tppos.bucket_cap(n_win, n_dest)
    slots, buckets, overflow = posbucket(_t(packed), _t(vbits), k, tables, CANON, n_slots, m,
                                         n_dest, cap)
    want_slot, want_buckets, want_over = _j_local_buckets(packed, vbits, k, resolve, n_dest, m,
                                                          cap)
    np.testing.assert_array_equal(slots.numpy(), want_slot)
    np.testing.assert_array_equal(buckets.numpy(), want_buckets)
    assert int(overflow) == want_over
    if n_dest == 255 and k < 16:
        assert want_over > 0


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "slot-ids"])
@pytest.mark.parametrize("name", ["random", "empty records", "other shards' slots",
                                  "one slot over 5 tiles", "every record its own slot"])
def test_posfill_pairs_edges(packed, name):
    """K9's pairs-in entry on CPU tensors at the fill's edge shapes, two
    exchanges in a row: packed records ((slot + 1) << 24) | window, with
    empty (zero) records, or slot ids (-1 for none); slots of other shards
    (below lo and past the range) dropped; one slot's run over five
    4096-key tiles; every record in its own slot. Held to aindex_tpu's
    _scatter_chunk over the (slot - lo, position, in range) triples its
    exchange steps form (parallel/positional.py:121-182)."""
    rng = np.random.default_rng(len(name) + packed)
    n_src, cols = (1, 5 * 4096 + 3) if name == "one slot over 5 tiles" else (3, 3001)
    lo, n_slots = (0, n_src * cols) if name == "every record its own slot" else (200, 300)
    roff = np.arange(n_src, dtype=np.int64) * 40_000 + 17
    exchanges = []
    for _ in range(2):
        if name == "one slot over 5 tiles":
            slot = np.full((n_src, cols), lo + 7, np.int64)
        elif name == "every record its own slot":
            slot = rng.permutation(n_src * cols).astype(np.int64).reshape(n_src, cols)
        elif name == "other shards' slots":
            slot = rng.integers(0, 3 * (lo + n_slots), size=(n_src, cols)).astype(np.int64)
        else:
            slot = rng.integers(lo, lo + n_slots, size=(n_src, cols)).astype(np.int64)
        if name == "empty records":
            slot[rng.random(slot.shape) < 0.3] = -1
        if packed:
            delta = np.sort(rng.permutation(1 << 16)[:n_src * cols].reshape(n_src, cols), 1)
            rec = np.where(slot >= 0, ((slot + 1) << 24) | delta, 0)
            pos = roff[:, None] + delta
        else:
            rec = slot
            pos = roff[:, None] + np.arange(cols)
        exchanges.append((rec.astype(np.int64), slot.reshape(-1), pos.reshape(-1)))
    counts = sum(np.bincount(s[(s >= lo) & (s < lo + n_slots)] - lo, minlength=n_slots)
                 for _, s, _ in exchanges)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    total = int(counts.sum())
    jp, jc = jnp.zeros(total, jnp.uint64), jnp.zeros(n_slots, jnp.int32)
    tp, tc = torch.zeros(total, dtype=torch.int64), torch.zeros(n_slots, dtype=torch.int32)
    for rec, slot, pos in exchanges:
        sel = (slot >= lo) & (slot < lo + n_slots)
        jp, jc = jpos._scatter_chunk(jp, jc, jnp.asarray(offsets), jnp.asarray(slot - lo),
                                     jnp.asarray(pos), jnp.asarray(sel))
        posfill_pairs(tp, tc, torch.from_numpy(offsets), torch.from_numpy(rec),
                            torch.from_numpy(roff), lo, packed)
        np.testing.assert_array_equal(_u64(tp), np.asarray(jp))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int((tp > 0).sum()) == total


# -- K12 and K13's plain twins on random keys ---------------------------------------

def test_sorted_spectrum_weighted_plain_vs_jax():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2 ** 64, size=3000, dtype=np.uint64)
    keys[rng.random(keys.size) < 0.3] = jspectrum.SENTINEL
    keys[:500] = keys[500:1000]                     # repeated keys
    keys[-3:] = np.uint64(2 ** 63)                  # top bit set
    weights = rng.integers(0, 2 ** 64, size=keys.size, dtype=np.uint64)
    jk, jc, jn = (np.asarray(x) for x in jspectrum.sorted_spectrum_weighted(
        jnp.asarray(keys), jnp.asarray(weights)))
    tk, tc, tn = tspectrum.sorted_spectrum_weighted(_t(keys.view(np.int64)),
                                                    _t(weights.view(np.int64)))
    np.testing.assert_array_equal(_u64(tk), jk)
    np.testing.assert_array_equal(_u64(tc), jc)
    assert int(tn) == int(jn)
    w32 = weights.astype(np.uint32)
    jk, jc, _ = (np.asarray(x) for x in jspectrum.sorted_spectrum_weighted(
        jnp.asarray(keys), jnp.asarray(w32)))
    tk, tc, _ = tspectrum.sorted_spectrum_weighted(_t(keys.view(np.int64)), _t(w32))
    np.testing.assert_array_equal(_u64(tk), jk)
    np.testing.assert_array_equal(_u64(tc), jc)


TILE = tspectrum.ONESWEEP_TILE
EDGES = ["one_live", "all_equal", "all_sentinel", "tile_minus_1_live", "tile_live",
         "tile_plus_1_live", "cap_not_tile_multiple", "keys_64_bit"]


def _edge_keys(shape: str) -> np.ndarray:
    """uint64 keys at a shape where K13's onesweep sort could break (the
    kernel's tile is ONESWEEP_TILE keys)."""
    rng = np.random.default_rng(EDGES.index(shape) + 40)
    sentinel = jspectrum.SENTINEL
    if shape == "one_live":
        keys = np.full(TILE + 3, sentinel)
        keys[TILE + 1] = 7
        return keys
    if shape == "all_equal":
        return np.full(3 * TILE + 5, 99, np.uint64)
    if shape == "all_sentinel":
        return np.full(2 * TILE + 1, sentinel)
    if shape.startswith("tile"):
        n_live = TILE + {"tile_minus_1_live": -1, "tile_live": 0, "tile_plus_1_live": 1}[shape]
        keys = np.full(2 * TILE, sentinel)
        keys[np.sort(rng.permutation(keys.size)[:n_live])] = rng.integers(
            0, 5000, size=n_live, dtype=np.uint64)
        return keys
    if shape == "cap_not_tile_multiple":
        pool = rng.integers(0, 2 ** 46, size=700, dtype=np.uint64)
        keys = pool[rng.integers(0, pool.size, size=5 * TILE + 11)]
        keys[rng.random(keys.size) < 0.2] = sentinel
        return keys
    keys = rng.integers(0, 2 ** 64 - 1, size=3 * TILE, dtype=np.uint64)   # all 8 digits
    keys[:TILE] = keys[TILE:2 * TILE]
    keys[-5:] = np.uint64(2 ** 63)
    return keys


@pytest.mark.parametrize("shape", EDGES)
@pytest.mark.parametrize("weight_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("key_range", [None, (1 << 40, 1 << 45), (2 ** 63, 2 ** 64 - 1)])
def test_sorted_spectrum_weighted_edges_plain_vs_jax(shape, weight_dtype, key_range):
    """The plain version that K13 is held to on the card, at the onesweep
    sort's edge shapes, with uint32 and uint64 weights, against aindex_tpu
    (whose function takes no range: the keys outside it become the
    sentinel there, as parallel/spectrum23.py selects them)."""
    keys = _edge_keys(shape)
    rng = np.random.default_rng(7)
    weights = rng.integers(0, np.iinfo(weight_dtype).max, size=keys.size, dtype=np.uint64,
                           endpoint=True).astype(weight_dtype)
    lo, hi = key_range or (0, 2 ** 64 - 1)
    ranged = np.where((keys >= np.uint64(lo)) & (keys < np.uint64(hi)), keys,
                      jspectrum.SENTINEL)
    jk, jc, jn = (np.asarray(x) for x in jspectrum.sorted_spectrum_weighted(
        jnp.asarray(ranged), jnp.asarray(weights)))
    w = _t(weights.view(np.int64) if weight_dtype == np.uint64 else weights)
    tk, tc, tn = tspectrum.sorted_spectrum_weighted(_t(keys.view(np.int64)), w, lo, hi)
    np.testing.assert_array_equal(_u64(tk), jk)
    np.testing.assert_array_equal(_u64(tc), jc)
    assert int(tn) == int(jn)


@pytest.mark.parametrize("weight", [2 ** 32 - 1, 2 ** 63 + 1])
def test_sorted_spectrum_weighted_sums_wrap_vs_jax(weight):
    """Sums of uint32 weights pass 2^32 (uint64 sums), and of uint64 weights
    wrap modulo 2^64, as aindex_tpu's."""
    keys = np.full(2 * TILE + 9, 5, np.uint64)
    keys[::3] = 6
    weights = np.full(keys.size, weight, np.uint32 if weight < 2 ** 32 else np.uint64)
    jk, jc, jn = (np.asarray(x) for x in jspectrum.sorted_spectrum_weighted(
        jnp.asarray(keys), jnp.asarray(weights)))
    w = _t(weights if weights.dtype == np.uint32 else weights.view(np.int64))
    tk, tc, tn = tspectrum.sorted_spectrum_weighted(_t(keys.view(np.int64)), w)
    np.testing.assert_array_equal(_u64(tk), jk)
    np.testing.assert_array_equal(_u64(tc), jc)
    assert int(tn) == int(jn) == 2
    n5 = int((keys == 5).sum())
    assert int(_u64(tc)[0]) == (n5 * weight) % 2 ** 64 and (n5 * weight) >= 2 ** 32


def test_mphf_owner_node_plain_vs_jax(blob):
    jindex = JSparse.build_from_blob(blob)
    m = jindex.mphf
    rng = np.random.default_rng(11)
    keys = np.concatenate([jindex.checker_host,
                           rng.integers(0, 2 ** 64, size=2000, dtype=np.uint64)])
    want = np.asarray(jlookup.mphf_owner_node(jnp.asarray(m.g_packed), jnp.asarray(keys),
                                              jnp.uint64(m.seed), jnp.uint64(m.domain)))
    got = tlookup.mphf_owner_node(_t(np.asarray(m.g_packed, np.uint32)),
                                  _t(keys.view(np.int64)), int(m.seed), int(m.domain))
    assert 3 * int(m.domain) < 2 ** 31
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # the owner of every indexed key is the node whose slot holds it
    slot = np.asarray(m.slots)[got.numpy()[:jindex.n]]
    np.testing.assert_array_equal(jindex.checker_host[slot], jindex.checker_host)


# -- the mesh entry points on a world of one, and their argument order (C.1) -------

def test_dense13_build_from_blob_mesh_and_order(blob, world):
    want = JDense.build_from_blob(blob, 256).tf_host
    seen = []
    got = TDense.build_from_blob(blob, 256, None, seen.append, device="cpu")
    np.testing.assert_array_equal(got.tf_host, want)
    assert seen and seen[-1] == blob.size
    got = TDense.build_from_blob(blob, 256, world, device="cpu")
    np.testing.assert_array_equal(got.tf_host, want)


def test_sparse23_build_from_blob_mesh_and_order(blob, world):
    want = JSparse.build_from_blob(blob, 23, 2, 512)
    for mesh in (None, world):
        got = TSparse.build_from_blob(blob, 23, 2, 512, mesh, device="cpu")
        np.testing.assert_array_equal(got.checker_host, want.checker_host)
        np.testing.assert_array_equal(got.tf_host, want.tf_host)
    with pytest.raises(TypeError):
        TSparse.build_from_blob(blob, 23, 1, 512, None, print)   # on_progress is keyword-only


def test_count_canonical_kmers_mesh_and_order(blob, world):
    jk, jc = j_count_canonical(blob, 23, 512, "device")
    seen = []
    for reduce in ("auto", "device", "host"):
        tk, tc = t_count_canonical(blob, 23, 512, reduce, None, seen.append, device="cpu")
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tc, jc.astype(np.uint64))
    assert seen[-1] == blob.size
    tk, tc = t_count_canonical(blob, 23, 512, "device", world)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tc, jc.astype(np.uint64))
    with pytest.raises(ValueError, match="reduce must be"):
        t_count_canonical(blob, 23, 512, "gpu", device="cpu")


def test_positional_mesh_world_of_one(blob, world):
    jindex = JSparse.build_from_blob(blob)
    tindex = TSparse.from_numpy(vars(jindex.mphf), jindex.checker_host, jindex.tf_host,
                                device="cpu")
    want = jpos.PositionalIndex.build_sparse23(blob, jindex, chunk=512)
    for mode in tppos.EXCHANGES:
        got = tppos.build_positional_sharded(blob, tindex.n, tindex.tf_host, tindex.tables,
                                             world, 23, 512, exchange=mode)
        np.testing.assert_array_equal(got.offsets, want.offsets)
        np.testing.assert_array_equal(got.positions, want.positions)
    got = TPos.build_sparse23(blob, tindex, 512, world)
    np.testing.assert_array_equal(got.positions, want.positions)
    with pytest.raises(ValueError, match="unknown positional exchange"):
        tppos.build_positional_sharded(blob, tindex.n, tindex.tf_host, tindex.tables, world,
                                       23, 512, exchange="ring")


def test_mesh_needs_world_and_backend(world):
    with pytest.raises(ValueError, match="world size"):
        t_make_mesh(2, 1, device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_make_mesh(1, 1, device_type="cuda")
    with pytest.raises(ValueError, match="must divide"):
        tdist.global_mesh(n_index=0, device_type="cpu")


def test_distributed_helpers_world_of_one(world, monkeypatch):
    for var in tdist.ENV:
        monkeypatch.delenv(var, raising=False)
    assert tdist.initialize(device="cpu")          # the group exists already
    assert tdist.world_size() == 1 and tdist.should_write() and not tdist.is_multiprocess()
    assert tdist.host_read_slice(10) == slice(0, 10)
    assert list(tdist.local_data_rows(world)) == [0]
    arr = np.arange(6, dtype=np.int64).reshape(1, 6)
    rows = tdist.local_row_shards(tdist.put_row_sharded(arr, world), world)
    np.testing.assert_array_equal(rows[0], arr[0])
    np.testing.assert_array_equal(tdist.allgather_concat(arr[0]), arr[0])
    tdist.barrier("noop")
    mesh = tdist.global_mesh(device_type="cpu")
    assert mesh.size(0) == 1 and mesh.size(1) == 1


def test_shard_to_keeps_reference_keyed_index(world, caplog):
    """An emphf (reference-keyed) index has no MPHF walk and takes the
    forward-else-revcomp rule: shard_to warns and keeps the single-device
    engine, as aindex_tpu's does."""
    import os
    from aindex_tpu.api import AIndex as JAIndex
    from aindex_torch import AIndex as TAIndex
    prefix = os.path.join(os.path.dirname(__file__), "golden_ref", "p.23")
    t = TAIndex.load_from_prefix(prefix, device="cpu")
    j = JAIndex.load_from_prefix(prefix)
    kms = [line.split()[0] for line in open(prefix + ".dat")][:200]
    with caplog.at_level(logging.WARNING, logger="aindex_torch.api"):
        t.shard_to(world)
    assert t._sharded23 is None and t._engine23 is t.sparse23
    assert any("reference-keyed" in r.message for r in caplog.records)
    assert t.get_tf_values(kms) == j.get_tf_values(kms)
