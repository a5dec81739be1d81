"""The positional index: aindex_torch.PositionalIndex on the CPU (K8's and
K9's plain versions) against aindex_tpu.index.positional on the conftest
reads and tests/data/*. Offsets, positions and files are integers or
bytes: equality is exact, dtypes included."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aindex_tpu.core import codec as jcodec
from aindex_tpu.core.reads import ReadsStore
from aindex_tpu.index import positional as jpos
from aindex_tpu.index.sparse23 import Sparse23Index as JSparse
from aindex_tpu.io.fastq import iter_sequence_bytes
from aindex_torch import PositionalIndex as TPos
from aindex_torch import Sparse23Index as TSparse
from aindex_torch.core import codec as tcodec
from aindex_torch.kernels import positional as tk

import oracle
from test_torch_host import jax_native  # noqa: F401 (a fixture)

#: aindex_tpu's native library loads before anything here builds through it
pytestmark = pytest.mark.usefixtures("jax_native")

DATA = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "data", "*")))
JPos = jpos.PositionalIndex
#: the tile of the kernels' onesweep sort, fill and scan (csrc/onesweep.cuh)
TILE = 4096


def _same(t: TPos, j: JPos) -> None:
    assert t.offsets.dtype == j.offsets.dtype == np.uint64
    assert t.positions.dtype == j.positions.dtype == np.uint64
    np.testing.assert_array_equal(t.offsets, j.offsets)
    np.testing.assert_array_equal(t.positions, j.positions)


_LUT = np.full(256, 4, dtype=np.int64)
for _i, _c in enumerate(b"ACGT"):
    _LUT[_c] = _LUT[_c + 32] = _i


def _forward_table(blob: np.ndarray, k: int) -> np.ndarray:
    """uint32[4^k] forward counts of every k-window of the blob whose bases
    are all ACGT (either case)."""
    b = _LUT[blob]
    n = blob.size - k + 1
    if n <= 0:
        return np.zeros(4 ** k, np.uint32)
    code = np.zeros(n, np.int64)
    bad = np.zeros(n, bool)
    for j in range(k):
        code = (code << 2) | (b[j:j + n] & 3)
        bad |= b[j:j + n] > 3
    return np.bincount(code[~bad], minlength=4 ** k).astype(np.uint32)


@pytest.fixture(scope="module")
def blob(random_reads):
    return ReadsStore.from_sequences(random_reads).blob


@pytest.fixture(scope="module")
def sparse(blob, jax_native):
    """(port index, JAX index) of the conftest reads' canonical 23-mers."""
    return TSparse.build_from_blob(blob, device="cpu"), JSparse.build_from_blob(blob)


@pytest.fixture(scope="module")
def dense(blob, jax_native):
    """(port, JAX) dense 13-mer positional indexes, default chunk."""
    return TPos.build_dense13(blob, device="cpu"), JPos.build_dense13(blob)


# -- K8 and K9's plain versions ---------------------------------------------------

class TestPlain:
    @pytest.mark.parametrize("n", [0, 1, 1000, 70_000])
    def test_csr_offsets(self, n):
        rng = np.random.default_rng(n)
        tf = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
        tf[::3] = rng.integers(0, 50, size=tf[::3].size)
        want = np.asarray(jpos._csr_offsets(jnp.asarray(tf)))
        t = torch.from_numpy(tf.view(np.int32)).view(torch.uint32)
        for got in (tk.csr_offsets_plain(t), tk.csr_offsets(t)):
            assert got.dtype == torch.int64 and want.dtype == np.int64
            np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("n,values", [
        (0, "max"), (1, "max"), (TILE - 1, "max"), (TILE, "random"), (TILE + 1, "max"),
        (3 * TILE + 5, "random"), (5 * TILE + 3, "max")])
    def test_csr_offsets_edges(self, n, values):
        """K8's tile edges, and every value 2^32 - 1, whose sums pass 2^32
        at the second item: equal to aindex_tpu's _csr_offsets."""
        rng = np.random.default_rng(n)
        tf = (np.full(n, 2 ** 32 - 1, np.uint32) if values == "max"
              else rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32))
        want = np.asarray(jpos._csr_offsets(jnp.asarray(tf)))
        t = torch.from_numpy(tf.view(np.int32)).view(torch.uint32)
        for got in (tk.csr_offsets_plain(t), tk.csr_offsets(t)):
            np.testing.assert_array_equal(got.numpy(), want)
        if values == "max" and n:
            assert int(want[-1]) == n * (2 ** 32 - 1)

    @pytest.mark.parametrize("n", [0, 1, TILE - 1, TILE, TILE + 1, 4 ** 13, 4 ** 15, 4 ** 16])
    def test_csr_scratch_size(self, n):
        """K8's scratch against csrc/csr.cu's layout: a tile counter word per
        launch of up to 2^30 items, then a look-back word per tile."""
        launches = -(-n // (1 << 30))
        assert tk.csr_scratch_bytes(n) == 8 * (launches + -(-n // TILE))
        assert launches == {0: 0, 4 ** 16: 4}.get(n, 1)

    @pytest.mark.parametrize("n,n_slots", [(1, 1), (TILE - 1, 4 ** 5), (TILE, 300),
                                           (TILE + 1, 4 ** 13), ((1 << 22) - 12, 4 ** 13),
                                           ((1 << 22) - 22, 9_602_528), (3 * TILE, 1 << 24),
                                           (3 * TILE, (1 << 24) + 1)])
    def test_fill_scratch_size(self, n, n_slots):
        """The fill's scratch against csrc/onesweep.cuh's carve with no
        values: two key buffers, the digit histograms of one pass per 8
        slot bits, 16 counter words, and a look-back word per tile for the
        compaction, the fill and each digit of each pass."""
        passes = -(-max(1, (n_slots - 1).bit_length()) // 8)
        tiles = -(-n // TILE)
        want = 2 * 8 * n + 4 * 256 * passes + 4 * 16 + 8 * tiles * (2 + 256 * passes)
        assert tk.fill_scratch_bytes(n, n_slots) == want
        assert tk.fill_scratch(n, n_slots, "cpu").numel() == want
        assert passes == {4 ** 13: 4, 9_602_528: 3, 1 << 24: 3, (1 << 24) + 1: 4}.get(
            n_slots, passes)

    def test_bucket_scratch_shapes(self):
        """K14's scratch: the int32[2] counters it writes (n_win,
        overflow). Its look-back words ride behind each call's buckets
        (one memset zeroes both): the tile counter, then a status word per
        destination and tile of 2048 windows."""
        counters = tk.bucket_scratch("cpu")
        assert counters.shape == (2,) and counters.dtype == torch.int32
        assert [tk.bucket_status_words(n, 3) for n in (1, 2047, 2048, 2049, TILE)] \
            == [4, 4, 4, 7, 7]
        assert tk.bucket_status_words((1 << 22) - 22, 1) == 1 + 2048

    @pytest.mark.parametrize("name", [
        "no valid window", "one slot over 5 tiles", "every window its own slot",
        "tile - 1 windows", "tile windows", "tile + 1 windows", "cursor 2^31 - 2",
        "cells past total"])
    def test_scatter_chunk_edges(self, name):
        """The shapes where the fill's tiles, runs and cursor could break,
        two chunks in a row (the second from the first's cursor): equal to
        aindex_tpu's _scatter_chunk."""
        rng = np.random.default_rng(len(name))
        n, n_slots = {"one slot over 5 tiles": (5 * TILE + 3, 10),
                      "every window its own slot": (2 * TILE + 1, 2 * TILE + 1),
                      "tile - 1 windows": (TILE - 1, 300), "tile windows": (TILE, 300),
                      "tile + 1 windows": (TILE + 1, 300)}.get(name, (3 * TILE, 500))
        chunks = []
        for c in range(2):
            if name == "one slot over 5 tiles":
                slots = np.full(n, 7, np.int64)
            elif name == "every window its own slot":
                slots = rng.permutation(n).astype(np.int64)
            else:
                slots = rng.integers(0, n_slots, size=n).astype(np.int64)
            valid = (np.zeros(n, bool) if name == "no valid window"
                     else rng.random(n) < (1.0 if "slot" in name else 0.8))
            chunks.append((slots, valid, np.arange(n, dtype=np.int64) + c * n + 5))
        counts = sum(np.bincount(sl[v], minlength=n_slots) for sl, v, _ in chunks)
        cursor = np.zeros(n_slots, np.int32)
        if name == "cursor 2^31 - 2":
            cursor[::2] = 2 ** 31 - 2     # these wrap; their cells lie past the end
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        total = int(counts.sum()) - (100 if name == "cells past total" else 0)
        jp, jc = jnp.zeros(total, jnp.uint64), jnp.asarray(cursor)
        tp, tc = torch.zeros(total, dtype=torch.int64), torch.from_numpy(cursor.copy())
        for slots, valid, pos in chunks:
            jp, jc = jpos._scatter_chunk(jp, jc, jnp.asarray(offsets), jnp.asarray(slots),
                                         jnp.asarray(pos), jnp.asarray(valid))
            tk.scatter_chunk_plain(tp, tc, torch.from_numpy(offsets), torch.from_numpy(slots),
                                   torch.from_numpy(pos), torch.from_numpy(valid))
            np.testing.assert_array_equal(tp.numpy().view(np.uint64), np.asarray(jp))
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        if name == "cursor 2^31 - 2":
            assert int(tc.min()) < 0      # wrapped as JAX's int32 add wraps

    @pytest.mark.parametrize("name", ["poly-A over 5 tiles", "no valid window",
                                      "tile - 1 valid", "tile valid", "tile + 1 valid"])
    def test_posfill_edges(self, name):
        """posfill on CPU tensors (k = 5, 4^5 slots) at the fill's edge
        shapes against aindex_tpu's _scatter_chunk of the windows' forward
        codes, from a nonzero cursor and blob offset."""
        k, n_slots, off = 5, 4 ** 5, 777
        rng = np.random.default_rng(11)
        if name == "poly-A over 5 tiles":
            piece = np.full(5 * TILE + 4, ord("A"), np.uint8)
        elif name == "no valid window":
            piece = np.full(3000, ord("N"), np.uint8)
        else:
            v = {"tile - 1 valid": TILE - 1, "tile valid": TILE, "tile + 1 valid": TILE + 1}[name]
            piece = np.full(v + k - 1 + 300, ord("N"), np.uint8)
            piece[:v + k - 1] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, v + k - 1)]
        packed, vbits = (torch.from_numpy(a) for a in tcodec.pack_ascii_chunk(piece))
        packed = packed.view(torch.int32)
        n_win = 16 * packed.numel() - k + 1
        b = _LUT[np.concatenate([piece, np.full(16 * packed.numel() - piece.size, ord("N"),
                                                np.uint8)])]
        code = np.zeros(n_win, np.int64)
        bad = np.zeros(n_win, bool)
        for j in range(k):
            code = (code << 2) | (b[j:j + n_win] & 3)
            bad |= b[j:j + n_win] > 3
        cursor = rng.integers(0, 3, size=n_slots).astype(np.int32)
        tf = np.bincount(code[~bad], minlength=n_slots) + cursor
        offsets = np.concatenate([[0], np.cumsum(tf)[:-1]]).astype(np.int64)
        total = int(tf.sum())
        jp, jc = jpos._scatter_chunk(jnp.zeros(total, jnp.uint64), jnp.asarray(cursor),
                                     jnp.asarray(offsets), jnp.asarray(code),
                                     jnp.asarray(np.arange(n_win, dtype=np.int64) + off),
                                     jnp.asarray(~bad))
        tp, tc = torch.zeros(total, dtype=torch.int64), torch.from_numpy(cursor.copy())
        tk.posfill(tp, tc, torch.from_numpy(offsets), packed, vbits, k, off)
        np.testing.assert_array_equal(tp.numpy().view(np.uint64), np.asarray(jp))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert int((tp > 0).sum()) == int((~bad).sum())

    @pytest.mark.parametrize("seed,n_slots,n,off,cursor_max", [
        (1, 64, 500, 0, 0), (2, 64, 500, 12_345, 3), (3, 7, 2000, 99, 40),
        (4, 1000, 300, 1 << 33, 2), (5, 1, 50, 5, 10)])
    def test_scatter_chunk(self, seed, n_slots, n, off, cursor_max):
        """Seeded slots with repeats, a quarter of them invalid, a nonzero
        starting cursor; cells past the end are dropped, as JAX drops them."""
        rng = np.random.default_rng(seed)
        slots = rng.integers(0, n_slots, size=n).astype(np.int64)
        valid = rng.random(n) < 0.75
        slots[~valid] = rng.integers(-3, 2 * n_slots, size=int((~valid).sum()))
        pos = np.arange(n, dtype=np.int64) + off
        cursor = rng.integers(0, cursor_max + 1, size=n_slots).astype(np.int32)
        tf = np.bincount(slots[valid], minlength=n_slots) + cursor
        offsets = np.concatenate([[0], np.cumsum(tf)[:-1]]).astype(np.int64)
        total = int(tf.sum()) - 2            # the last slot's last cells drop
        positions = rng.integers(0, 9, size=total).astype(np.uint64)
        jp, jc = jpos._scatter_chunk(jnp.asarray(positions), jnp.asarray(cursor),
                                     jnp.asarray(offsets), jnp.asarray(slots),
                                     jnp.asarray(pos), jnp.asarray(valid))
        tp, tc = tk.scatter_chunk_plain(
            torch.from_numpy(positions.view(np.int64).copy()), torch.from_numpy(cursor.copy()),
            torch.from_numpy(offsets), torch.from_numpy(slots), torch.from_numpy(pos),
            torch.from_numpy(valid))
        np.testing.assert_array_equal(tp.numpy().view(np.uint64), np.asarray(jp))
        assert tc.dtype == torch.int32 and np.asarray(jc).dtype == np.int32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))

    def test_posfill_plain_is_scatter_of_window_slots(self, blob):
        """posfill on CPU tensors = the dense windows' codes through
        scatter_chunk_plain, at a nonzero blob offset and cursor."""
        piece = blob[:512]
        packed, vbits = (torch.from_numpy(a) for a in tcodec.pack_ascii_chunk(piece))
        packed = packed.view(torch.int32)
        k, n_slots = 5, 4 ** 5
        rng = np.random.default_rng(9)
        cursor = torch.from_numpy(rng.integers(0, 3, size=n_slots).astype(np.int32))
        tf = torch.from_numpy(rng.integers(0, 12, size=n_slots).astype(np.int32))
        offsets = tk.csr_offsets(tf.view(torch.uint32))
        total = int(offsets[-1])
        got_p, got_c = torch.zeros(total, dtype=torch.int64), cursor.clone()
        tk.posfill(got_p, got_c, offsets[:-1], packed, vbits, k, 777)
        slots, valid = tk.chunk_slots_plain(packed, vbits, k)
        want_p, want_c = torch.zeros(total, dtype=torch.int64), cursor.clone()
        tk.scatter_chunk_plain(want_p, want_c, offsets[:-1], slots,
                               torch.arange(slots.numel()) + 777, valid)
        assert torch.equal(got_p, want_p) and torch.equal(got_c, want_c)
        assert int((got_p > 0).sum()) > 0

    @pytest.mark.parametrize("bad", ["k", "slots", "offsets", "dtype"])
    def test_posfill_rejects(self, blob, bad):
        packed, vbits = (torch.from_numpy(a) for a in tcodec.pack_ascii_chunk(blob[:256]))
        packed = packed.view(torch.int32)
        k, n_slots = {"k": (17, 4 ** 5), "slots": (5, 1000)}.get(bad, (5, 4 ** 5))
        offsets = torch.zeros(n_slots - (bad == "offsets"), dtype=torch.int64)
        cursor = torch.zeros(n_slots, dtype=torch.int64 if bad == "dtype" else torch.int32)
        with pytest.raises(ValueError):
            tk.posfill(torch.zeros(4, dtype=torch.int64), cursor, offsets, packed, vbits, k, 0)


# -- the builds ---------------------------------------------------------------------

class TestBuild:
    def test_dense13(self, random_reads, dense):
        t, j = dense
        _same(t, j)
        golden = oracle.positions_forward(random_reads, 13)
        assert t.total == sum(len(v) for v in golden.values())
        for km, positions in sorted(golden.items())[:200]:
            got = t.positions_by_slot(jcodec.encode_kmer(km))
            assert got.tolist() == positions, km

    def test_dense13_chunk_boundaries(self, blob, dense):
        """chunk=100 cuts the blob into ~30 overlapping chunks; tf=None
        counts the 13-mer table first, as JAX does."""
        t = TPos.build_dense13(blob, chunk=100, device="cpu")
        _same(t, dense[1])

    @pytest.mark.parametrize("chunk", [100, 512, 1 << 22])
    def test_dense_k5(self, blob, chunk):
        tf = _forward_table(blob, 5)
        t = TPos.build_dense13(blob, k=5, chunk=chunk, tf=tf, device="cpu")
        _same(t, JPos.build_dense13(blob, k=5, chunk=chunk, tf=tf))
        assert t.total == int(tf.sum()) > 0

    def test_dense_tf_tensor(self, blob):
        """A uint32 tf tensor (the pipeline's device table) sizes the CSR
        as the host table does."""
        tf = _forward_table(blob, 5)
        t = TPos.build_dense13(blob, k=5, chunk=512, device="cpu",
                               tf=torch.from_numpy(tf.view(np.int32)).view(torch.uint32))
        _same(t, JPos.build_dense13(blob, k=5, chunk=512, tf=tf))

    @pytest.mark.parametrize("chunk", [128, 1024, 1 << 22])
    def test_sparse23(self, random_reads, blob, sparse, chunk):
        ti, ji = sparse
        t = TPos.build_sparse23(blob, ti, chunk=chunk)
        _same(t, JPos.build_sparse23(blob, ji, chunk=chunk))
        np.testing.assert_array_equal(np.diff(t.offsets.astype(np.int64)),
                                      ti.tf_host.astype(np.int64))
        golden = oracle.positions_canonical(random_reads, 23)
        for km, positions in sorted(golden.items())[:100]:
            slot = int(ti.get_pfids([km])[0])
            assert t.positions_by_slot(slot).tolist() == positions, km

    @pytest.mark.parametrize("path", DATA, ids=[os.path.basename(p) for p in DATA])
    def test_test_data(self, path):
        blob = np.concatenate(list(iter_sequence_bytes(path)))
        tf = _forward_table(blob, 5)
        _same(TPos.build_dense13(blob, k=5, chunk=256, tf=tf, device="cpu"),
              JPos.build_dense13(blob, k=5, chunk=256, tf=tf))
        ti, ji = TSparse.build_from_blob(blob, device="cpu"), JSparse.build_from_blob(blob)
        _same(TPos.build_sparse23(blob, ti, chunk=256), JPos.build_sparse23(blob, ji, chunk=256))

    def test_empty_blob(self):
        blob = np.zeros(0, np.uint8)
        tf = np.zeros(4 ** 5, np.uint32)
        t = TPos.build_dense13(blob, k=5, tf=tf, device="cpu")
        _same(t, JPos.build_dense13(blob, k=5, tf=tf))
        assert t.total == 0 and t.n_slots == 4 ** 5 and t.max_tf == 0
        t13 = TPos.build_dense13(blob, device="cpu")
        assert t13.total == 0 and t13.n_slots == 4 ** 13

    def test_rejects(self, blob, sparse, monkeypatch):
        from aindex_torch.parallel import distributed, positional
        from aindex_torch.parallel.mesh import make_mesh
        distributed.ensure_group(device="cpu")
        mesh = make_mesh(1, 1, device_type="cpu")
        with pytest.raises(ValueError, match="counts for"):
            TPos.build_dense13(blob, k=5, tf=np.zeros(10, np.uint32), mesh=mesh)
        monkeypatch.setenv(positional.EXCHANGE_ENV, "ring")
        with pytest.raises(ValueError, match="unknown positional exchange"):
            TPos.build_sparse23(blob, sparse[0], mesh=mesh)
        with pytest.raises(ValueError, match="tf=None"):
            TPos.build_dense13(blob, k=5, device="cpu")
        with pytest.raises(ValueError, match="counts for"):
            TPos.build_dense13(blob, k=5, tf=np.zeros(10, np.uint32), device="cpu")
        with pytest.raises(ValueError, match="2\\^32"):
            TPos.build_dense13(blob, k=5, tf=np.full(4 ** 5, 1 << 33, np.uint64), device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                TPos.build_dense13(blob, k=5, tf=_forward_table(blob, 5))


# -- host structure, queries and persistence -------------------------------------------

class TestHost:
    def test_from_slot_positions(self):
        rng = np.random.default_rng(3)
        slots = rng.integers(0, 40, size=600).astype(np.int64)
        pos0 = rng.permutation(10_000)[:600].astype(np.int64)
        _same(TPos.from_slot_positions(slots, pos0, 50),
              JPos.from_slot_positions(slots, pos0, 50))

    def test_reorder(self, sparse, blob):
        ti, ji = sparse
        t, j = TPos.build_sparse23(blob, ti), JPos.build_sparse23(blob, ji)
        perm = np.random.default_rng(4).permutation(t.n_slots)
        _same(t.reorder(perm), j.reorder(perm))

    def test_positions_by_slot(self, dense):
        t, j = dense
        off = t.offsets.astype(np.int64)
        present = np.flatnonzero(np.diff(off))[:100]
        absent = np.flatnonzero(np.diff(off) == 0)[:20]
        for slot in [*present.tolist(), *absent.tolist(), -1, t.n_slots, t.n_slots + 5]:
            got, want = t.positions_by_slot(slot), j.positions_by_slot(slot)
            assert got.dtype == want.dtype == np.uint64
            np.testing.assert_array_equal(got, want)
        assert (t.n_slots, t.total, t.max_tf) == (j.n_slots, j.total, j.max_tf)

    def test_positions_by_slots(self, dense):
        t, j = dense
        rng = np.random.default_rng(5)
        nz = np.flatnonzero(np.diff(t.offsets.astype(np.int64)))
        slots = np.concatenate([nz[:200], rng.integers(0, 4 ** 13, 50),
                                [-1, 4 ** 13, 4 ** 13 + 5]]).astype(np.int64)
        for got, want in zip(t.positions_by_slots(slots), j.positions_by_slots(slots)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)

    def test_save_load(self, sparse, blob, tmp_path):
        ti, ji = sparse
        t, j = TPos.build_sparse23(blob, ti), JPos.build_sparse23(blob, ji)
        t.save(str(tmp_path / "t"))
        j.save(str(tmp_path / "j"))
        for suffix in (".index.bin", ".indices.bin"):
            assert (tmp_path / ("t" + suffix)).read_bytes() == \
                (tmp_path / ("j" + suffix)).read_bytes(), suffix
        back = TPos.load(str(tmp_path / "j.index.bin"), str(tmp_path / "j.indices.bin"))
        _same(back, j)
