"""The unpacked (ASCII-in and codes-in) device functions of aindex_torch
against aindex_tpu's: zeros_dev, scatter_count (K15), count_batch_13 and
dense13._count_step (K16), gather_tf and gather_tf_total_13 (K3's
table-length entries), chunk_spectrum and sparse23._extract_canonical (K5's
ASCII entries) and quot_tf_windows (K7's ASCII-rows entry), each through
its plain version on the CPU. The same numpy inputs go to both packages;
every output is an integer array, so equality is exact, dtypes and padded
tails included, and the JAX scatter's wrap-and-drop and gather's
wrap-and-clamp index rules are held on codes over the whole uint32 range."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aindex_tpu.constants import SPACE_13
from aindex_tpu.index import dense13 as jdense
from aindex_tpu.index import quotcuckoo as jquot
from aindex_tpu.index import sparse23 as jsparse
from aindex_tpu.kernels import count as jcount
from aindex_tpu.kernels import lookup as jlookup
from aindex_tpu.kernels import spectrum as jspec
from aindex_torch.index import dense13 as tdense
from aindex_torch.index import quotcuckoo as tquotcuckoo
from aindex_torch.index import sparse23 as tsparse
from aindex_torch.kernels import count as tcount
from aindex_torch.kernels import lookup as tlookup
from aindex_torch.kernels import quot as tquot
from aindex_torch.kernels import spectrum as tspec
from test_torch_host import jax_native  # noqa: F401 (a fixture)

#: aindex_tpu's native library loads before anything here builds through it
pytestmark = pytest.mark.usefixtures("jax_native")

#: codes at the edges of the index rules, as uint32
EDGES = np.array([0, 1, 15, 16, 17, SPACE_13 - 1, SPACE_13, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 3,
                  2 ** 31 + 7, 2 ** 32 - SPACE_13, 2 ** 32 - 17, 2 ** 32 - 16, 2 ** 32 - 1],
                 dtype=np.uint32)


def _torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a torch tensor of the same bits (uint16/uint32
    through their signed views)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.uint16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).view(torch.uint32)
    return torch.from_numpy(a)


def _np(t: torch.Tensor) -> np.ndarray:
    """A torch integer tensor as numpy of its unsigned dtype (int64 keys as
    uint64 bits)."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def _same(got: np.ndarray, want) -> None:
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _ascii(case: str, seed: int) -> np.ndarray:
    """ASCII inputs of the shapes and alphabets the functions take."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    if case == "chunk_1d":            # reads joined by newlines, with N runs
        chunk = acgt[rng.integers(0, 4, size=6000)]
        chunk[150::151] = ord("\n")
        for start in rng.integers(0, chunk.size - 20, size=12):
            chunk[start:start + rng.integers(1, 20)] = ord("N")
        chunk[:200] = np.frombuffer(b"ACGT" * 50, np.uint8)
        return chunk
    if case == "rows_padded":         # [B, L] reads of ragged length, 0-padded
        mat = np.zeros((40, 90), np.uint8)
        for i in range(40):
            n = int(rng.integers(5, 91))
            mat[i, :n] = acgt[rng.integers(0, 4, size=n)]
        mat[3, 10] = ord("N")
        return mat
    if case == "mixed_case":          # lowercase, N, '~', newline
        alpha = np.frombuffer(b"ACGTACGTacgtacgtN~\n", np.uint8)
        return alpha[rng.integers(0, alpha.size, size=(16, 120))]
    if case == "all_bytes":           # every byte value, ACGT runs between
        mat = acgt[rng.integers(0, 4, size=(8, 128))]
        mat.reshape(-1)[rng.permutation(1024)[:256]] = np.arange(256, dtype=np.uint8)
        return mat
    if case == "poly_t":              # the top codes: TTTT... windows
        mat = np.full((4, 64), ord("T"), np.uint8)
        mat[1, ::7] = ord("G")
        mat[2, 30] = ord("a")
        return mat
    if case == "no_rows":             # [0, L]
        return np.zeros((0, 40), np.uint8)
    raise AssertionError(case)


#: the edge shapes of the staged ASCII front end of K5's canonical23_ascii
#: and K7's quotcov23_rows (csrc/dna23.cuh AsciiSource, tile_run)
EDGE_CASES = ["rows_of_k", "rows_of_k_plus_1", "rows_64x30", "row_2p16_plus_5",
              "all_n_and_mixed", "view_offset_3"]


def _edge_ascii(case: str, k: int, pool: np.ndarray | None = None) -> np.ndarray:
    """ASCII rows at the front end's edges for k, cut from ``pool`` (random
    ACGT when None): rows of k and of k + 1 bytes (one and two windows a
    row), 64 rows of 30 bytes (narrower than a tile; k + 3 for k = 31), one
    row of 2^16 + 5 bytes, rows of all N beside rows with lowercase and N
    mixed in, and a [4096, 1024] view of a 1-D buffer 3 bytes into it."""
    rng = np.random.default_rng(k + len(case))
    if pool is None:
        pool = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=1 << 14)]

    def rows(n, length):
        src = np.tile(pool, length // pool.size + 2)
        start = rng.integers(0, src.size - length, n)
        return src[start[:, None] + np.arange(length)[None, :]]
    if case == "rows_of_k":
        return rows(300, k)
    if case == "rows_of_k_plus_1":
        return rows(300, k + 1)
    if case == "rows_64x30":
        return rows(64, 30 if k <= 30 else k + 3)
    if case == "row_2p16_plus_5":
        return rows(1, (1 << 16) + 5)[0]
    if case == "all_n_and_mixed":
        mat = rows(48, 151)
        mat[:16] = ord("N")
        mat[16:][rng.random((32, 151)) < 0.3] |= 0x20
        mat[16:][rng.random((32, 151)) < 0.03] = ord("N")
        return mat
    if case == "view_offset_3":
        buf = rows(1, 4096 * 1024 + 3)[0]
        view = buf[3:].reshape(4096, 1024)
        assert view.base is not None and view.ctypes.data == buf.ctypes.data + 3
        return view
    raise AssertionError(case)


# -- zeros_dev ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7,), (2, 3), (0,)], ids=["1d", "2d", "empty"])
@pytest.mark.parametrize("name", ["uint32", "uint16", "uint8", "int32", "uint64", "int64"])
def test_zeros_dev(shape, name):
    got = tcount.zeros_dev(shape, getattr(torch, name), device="cpu")
    want = np.asarray(jcount.zeros_dev(shape, getattr(jnp, name)))
    assert got.dtype == getattr(torch, name) and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape
    _same(got.view(torch.int64 if name in ("uint64", "int64") else {
        "uint32": torch.int32, "uint16": torch.int16}.get(name, got.dtype)
    ).numpy().view(want.dtype), want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcount.zeros_dev(shape, getattr(torch, name))


# -- scatter_count (K15) -------------------------------------------------------------

#: K15's bin of table entries (aindex_torch/csrc/count13.cu)
BIN_W = tcount.BIN_W
#: the spaces around K15's bins and rounds: one bin less one entry, one bin,
#: one bin and one entry, eight bins and one entry
BIN_SPACES = {"bins_w_minus_1": BIN_W - 1, "bins_w": BIN_W, "bins_w_plus_1": BIN_W + 1,
              "bins_2p18_plus_1": (1 << 18) + 1}


def _bin_edges(space: int) -> np.ndarray:
    """Codes on the first and last entry of every bin edge of the space,
    the space's own edges and their negative (wrapping) int32 forms."""
    edges = [e for b in range(0, space + BIN_W + 1, BIN_W) for e in (b - 1, b, b + 1)]
    edges += [space - 1, space, space + 1, -1, -space, -space - 1, 2 ** 31 - 1, 2 ** 31]
    return np.array([e % 2 ** 32 for e in edges], dtype=np.uint64).astype(np.uint32)


def _scatter_inputs(case: str):
    """(codes uint32, valid, space)."""
    rng = np.random.default_rng(len(case))
    if case in BIN_SPACES:          # K15's bin edges, uint8 weights
        space = BIN_SPACES[case]
        edges = _bin_edges(space)
        codes = np.concatenate([edges, rng.integers(0, space, size=6000).astype(np.uint32),
                                rng.integers(0, 2 ** 32, size=2000, dtype=np.uint64)
                                .astype(np.uint32)])
        weights = rng.integers(0, 256, size=codes.size).astype(np.uint8)
        weights[:edges.size] = 255
        return codes, weights, space
    if case == "skewed":            # most codes one value (poly-A's code 0), weights to 255
        codes = np.where(rng.random(20000) < 0.9, 0, rng.integers(0, (1 << 18) + 1, size=20000))
        return codes.astype(np.uint32), rng.integers(1, 256, size=20000).astype(np.uint8), \
            (1 << 18) + 1
    if case == "wrap_and_drop":
        return (np.array([0, 15, 16, 2 ** 31 + 3, 2 ** 32 - 1], np.uint32),
                np.ones(5, bool), 16)
    if case == "edges":
        return EDGES, np.ones(EDGES.size, bool), 1 << 12
    codes = np.concatenate([EDGES, rng.integers(0, 2 ** 32, size=5000, dtype=np.uint64)
                            .astype(np.uint32), rng.integers(0, 4096, size=5000)
                            .astype(np.uint32), (2 ** 32 - rng.integers(1, 4096, size=500))
                            .astype(np.uint32)])
    valid = rng.random(codes.size) < 0.8
    if case == "uint8_weights":
        return codes, rng.integers(0, 4, size=codes.size).astype(np.uint8), 4096
    if case == "shape_2d":
        return codes[:10000].reshape(100, 100), valid[:10000].reshape(100, 100), 4096
    if case == "empty":
        return np.zeros(0, np.uint32), np.zeros(0, bool), 64
    return codes, valid, 4096


@pytest.mark.parametrize("storage", ["uint32", "int32"])
@pytest.mark.parametrize("case", ["wrap_and_drop", "edges", "random", "uint8_weights",
                                  "shape_2d", "empty", *BIN_SPACES, "skewed"])
def test_scatter_count(case, storage):
    codes, valid, space = _scatter_inputs(case)
    tcodes = _torch(codes) if storage == "uint32" else torch.from_numpy(codes.view(np.int32))
    got = tcount.scatter_count(tcodes, torch.from_numpy(valid), space)
    want = jcount.scatter_count(jnp.asarray(codes), jnp.asarray(valid), space=space)
    _same(_np(got), want)
    if case == "wrap_and_drop":       # 15 counted twice (2^32 - 1 wraps), 16 and 2^31 + 3 dropped
        assert _np(got).tolist() == [1] + [0] * 14 + [2]


@pytest.mark.parametrize("n, space", [(0, 1 << 20), (1000, BIN_W), (1, BIN_W + 1),
                                      (106_757_904, SPACE_13), (1 << 28, (1 << 31) - 1)],
                         ids=["no codes", "no partition", "one code", "corpus", "pieces"])
def test_scatter_scratch_bytes(n, space):
    """K15's scratch (csrc/count13.cu bins::carve): none without a
    partition; else a 4-byte record a code of a piece of at most 2^27
    codes, a count a (range, bin) for at most 128 ranges and 8192 bins a
    round, and each bin's total and start. About 4 bytes a code at the
    corpus shape."""
    got = tcount.scatter_scratch_bytes(n, space)
    if n == 0 or space <= BIN_W:
        assert got == 0
        return
    piece = min(n, 1 << 27)
    nb = min(1 << 13, -(-space // BIN_W))
    assert got == 4 * (piece + min(128, -(-piece // (1 << 14))) * nb + 2 * nb + 1)
    if space == SPACE_13:
        assert 4 < got / n < 4.02


def test_scatter_count_rejects():
    codes = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32/uint32"):
        tcount.scatter_count(codes.to(torch.int64), torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="shaped like codes"):
        tcount.scatter_count(codes, torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="space"):
        tcount.scatter_count(codes, torch.ones(4, dtype=torch.bool), 0)


# -- count_batch_13 and _count_step (K16) --------------------------------------------

@pytest.fixture(scope="module")
def start_table():
    """A nonzero 4^13 start table with entries near 2^32, so wraparound shows."""
    rng = np.random.default_rng(3)
    tf = np.zeros(SPACE_13, dtype=np.uint32)
    hot = rng.integers(0, SPACE_13, size=1 << 12)
    tf[hot] = rng.integers(2 ** 32 - 3, 2 ** 32, size=hot.size, dtype=np.uint64)
    return tf


def _start(start_table: np.ndarray, space: int) -> np.ndarray:
    if space == SPACE_13:
        return start_table.copy()
    rng = np.random.default_rng(space)
    return rng.integers(2 ** 32 - 4, 2 ** 32, size=space, dtype=np.uint64).astype(np.uint32)


def _rows_ascii(case: str, k: int) -> np.ndarray:
    """count_batch_13's inputs: _ascii's, and rows of exactly k bytes (one
    window a row), and poly-A rows of more than 2^18 windows, whose code 0
    fills whole warp rows and tiles of K16's adds (csrc/count13.cu
    bins::rows_sweep)."""
    if case == "len_eq_k":
        rng = np.random.default_rng(k)
        rows = np.frombuffer(b"ACGTacgt", np.uint8)[rng.integers(0, 8, size=(300, k))]
        rows[7, k // 2] = ord("N")
        return rows
    if case == "poly_a":
        rows = np.full((2000, 150), ord("A"), np.uint8)
        rows[5, 40] = ord("C")
        return rows
    return _ascii(case, k)


@pytest.mark.parametrize("case", ["chunk_1d", "rows_padded", "mixed_case", "all_bytes",
                                  "poly_t", "no_rows", "len_eq_k", "poly_a"])
@pytest.mark.parametrize("k, space", [(13, SPACE_13), (13, 1 << 20), (9, 4 ** 9 - 1000),
                                      (16, 1 << 22), (3, 64), (13, 3 * BIN_W + 7)],
                         ids=["k13", "k13_small_space", "k9_small_space", "k16_wrap", "k3",
                              "k13_space_3w_plus_7"])
def test_count_batch_13(start_table, case, k, space):
    ascii = _rows_ascii(case, k)
    start = _start(start_table, space)
    counts = _torch(start.copy())                      # the port adds into its own copy
    got = tcount.count_batch_13(counts, torch.from_numpy(ascii), k, space)
    assert got is counts                               # in place
    want = jcount.count_batch_13(jnp.asarray(start), jnp.asarray(ascii), k=k, space=space)
    _same(_np(got), want)


@pytest.mark.parametrize("case", ["chunk_1d", "rows_padded"])
def test_count_step(start_table, case):
    ascii = _ascii(case, 1)
    got = tdense._count_step(_torch(start_table.copy()), torch.from_numpy(ascii))
    want = jdense._count_step(jnp.asarray(start_table), jnp.asarray(ascii))
    _same(_np(got), want)


def test_count_batch_13_rejects():
    counts = torch.zeros(64, dtype=torch.int32)
    for bad, match in ((np.zeros(2, np.uint8), "shorter than k"),
                       (np.zeros(0, np.uint8), "shorter than k")):
        with pytest.raises(ValueError, match=match):
            tcount.count_batch_13(counts, torch.from_numpy(bad), 3, 64)
        with pytest.raises(ValueError, match=match):
            jcount.count_batch_13(jnp.zeros(64, jnp.uint32), jnp.asarray(bad), k=3, space=64)
    with pytest.raises(ValueError, match="k=17"):
        tcount.count_batch_13(counts, torch.zeros(20, dtype=torch.uint8), 17, 64)
    with pytest.raises(ValueError, match="counts must be"):
        tcount.count_batch_13(counts, torch.zeros(20, dtype=torch.uint8), 3, 128)


# -- gather_tf and gather_tf_total_13 (K3's table-length entries) ---------------------

@pytest.fixture(scope="module")
def big_tables():
    """Random 4^13 tables, uint32 and uint16 (numpy)."""
    rng = np.random.default_rng(13)
    return {np.uint32: rng.integers(0, 2 ** 32, size=SPACE_13, dtype=np.uint64)
            .astype(np.uint32),
            np.uint16: rng.integers(0, 2 ** 16, size=SPACE_13).astype(np.uint16)}


def _table(big_tables, length: int, dtype) -> np.ndarray:
    if length == SPACE_13:
        return big_tables[dtype]
    rng = np.random.default_rng(length)
    return rng.integers(0, np.iinfo(dtype).max, size=length, dtype=np.uint64,
                        endpoint=True).astype(dtype)


@pytest.fixture(scope="module")
def gather_codes():
    rng = np.random.default_rng(21)
    return np.concatenate([EDGES, rng.integers(0, 2 ** 32, size=1 << 14, dtype=np.uint64)
                           .astype(np.uint32), rng.integers(0, SPACE_13, size=1 << 14)
                           .astype(np.uint32), rng.integers(0, 64, size=1 << 10)
                           .astype(np.uint32), (2 ** 32 - rng.integers(1, 64, size=1 << 10))
                           .astype(np.uint32)])


@pytest.mark.parametrize("storage", ["uint32", "int32", "2d"])
@pytest.mark.parametrize("length, dtype", [(16, np.uint8), (16, np.uint16), (16, np.uint32),
                                           (SPACE_13, np.uint32), (SPACE_13, np.uint16)],
                         ids=["16_u8", "16_u16", "16_u32", "4^13_u32", "4^13_u16"])
def test_gather_tf(big_tables, gather_codes, length, dtype, storage):
    table = _table(big_tables, length, dtype)
    codes = gather_codes[:32768].reshape(128, 256) if storage == "2d" else gather_codes
    tcodes = torch.from_numpy(codes.view(np.int32)) if storage == "int32" else _torch(codes)
    got = tlookup.gather_tf(_torch(table), tcodes)
    _same(_np(got), jlookup.gather_tf(jnp.asarray(table), jnp.asarray(codes)))


@pytest.mark.parametrize("k", [13, 16, 5])
@pytest.mark.parametrize("length, dtype", [(16, np.uint32), (16, np.uint16),
                                           (SPACE_13, np.uint32), (SPACE_13, np.uint16)],
                         ids=["16_u32", "16_u16", "4^13_u32", "4^13_u16"])
def test_gather_tf_total_13(big_tables, gather_codes, length, dtype, k):
    table = _table(big_tables, length, dtype)
    valid = np.random.default_rng(k).random(gather_codes.size) < 0.85
    valid[:EDGES.size] = True
    got = tlookup.gather_tf_total_13(_torch(table), _torch(gather_codes),
                                     torch.from_numpy(valid), k)
    want = jlookup.gather_tf_total_13(jnp.asarray(table), jnp.asarray(gather_codes),
                                      jnp.asarray(valid), k=k)
    _same(_np(got), want)


def test_gather_total_uint16_wraps():
    table = np.full(16, 40000, np.uint16)
    codes = np.array([0, 5], np.uint32)
    got = tlookup.gather_tf_total_13(_torch(table), _torch(codes), torch.ones(2, dtype=torch.bool),
                                     2)
    assert _np(got).tolist() == [80000 - 65536] * 2


def test_gather_rejects():
    codes = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="non-empty"):
        tlookup.gather_tf(torch.zeros(0, dtype=torch.uint8), codes)
    with pytest.raises(ValueError, match="int32/uint32"):
        tlookup.gather_tf(torch.zeros(4, dtype=torch.uint8), codes.to(torch.int64))
    with pytest.raises(ValueError, match="k=17"):
        tlookup.gather_tf_total_13(torch.zeros(4, dtype=torch.uint8), codes,
                                   torch.ones(3, dtype=torch.bool), 17)


# -- chunk_spectrum and _extract_canonical (K5's ASCII entries) ------------------------

SPECTRUM_CASES = ["chunk_1d", "rows_padded", "mixed_case", "all_bytes", "poly_t"]


@pytest.mark.parametrize("case", SPECTRUM_CASES)
@pytest.mark.parametrize("k", [23, 31])
def test_chunk_spectrum(case, k):
    ascii = _ascii(case, k)
    keys, counts, n = tspec.chunk_spectrum(torch.from_numpy(ascii), k)
    jkeys, jcounts, jn = jspec.chunk_spectrum(jnp.asarray(ascii), k)
    assert keys.dtype == torch.int64 and n.dtype == torch.int32 and n.dim() == 0
    _same(_np(keys).view(np.uint64), jkeys)            # the sentinel tail included
    _same(_np(counts), jcounts)
    assert int(n) == int(jn)
    assert keys.numel() == ascii.size // ascii.shape[-1] * (ascii.shape[-1] - k + 1)


@pytest.mark.parametrize("case", SPECTRUM_CASES + ["no_rows"] + EDGE_CASES)
@pytest.mark.parametrize("k", [23, 31, 11])
def test_extract_canonical(case, k):
    ascii = _edge_ascii(case, k) if case in EDGE_CASES else _ascii(case, k)
    canon, valid = tsparse._extract_canonical(torch.from_numpy(ascii), k)
    jcanon, jvalid = jsparse._extract_canonical(jnp.asarray(ascii), k)
    _same(_np(canon).view(np.uint64), jcanon)          # invalid windows' codes too
    _same(valid.numpy(), jvalid)


def test_chunk_spectrum_rejects():
    with pytest.raises(ValueError, match="shorter than k"):
        tspec.chunk_spectrum(torch.zeros(10, dtype=torch.uint8), 23)
    with pytest.raises(ValueError, match="shorter than k"):
        jspec.chunk_spectrum(jnp.zeros(10, jnp.uint8), 23)
    with pytest.raises(ValueError, match="k=32"):
        tspec.chunk_spectrum(torch.zeros(40, dtype=torch.uint8), 32)
    with pytest.raises(ValueError, match="no rows"):       # JAX raises too
        tspec.chunk_spectrum(torch.from_numpy(_ascii("no_rows", 0)), 23)
    with pytest.raises(ValueError):
        jspec.chunk_spectrum(jnp.asarray(_ascii("no_rows", 0)), 23)


# -- quot_tf_windows (K7's ASCII-rows entry) ----------------------------------------------

@pytest.fixture(scope="module")
def quot_built(random_reads, jax_native):
    """(port QuotCuckoo, JAX QuotCuckoo) over the conftest reads' spectrum,
    as tests/test_torch_mphf_quot.py builds them for the packed twin."""
    jindex = jsparse.Sparse23Index.build_from_sequences(random_reads)
    slot = np.arange(jindex.n, dtype=np.int32)
    t = tquotcuckoo.QuotCuckoo.build(jindex.checker_host, jindex.tf_host, slot, 23)
    j = jquot.QuotCuckoo.build(jindex.checker_host, jindex.tf_host, slot, 23)
    return t, j


def _read_rows(reads: list[str], case: str) -> np.ndarray:
    L = max(len(r) for r in reads)
    mat = np.full((len(reads), L), ord("\n"), np.uint8)
    for i, r in enumerate(reads):
        mat[i, :len(r)] = np.frombuffer(r.encode(), np.uint8)
    if case == "lowercase_n":
        mat[::3] = np.char.lower(mat[::3].view("S1")).view(np.uint8).reshape(mat[::3].shape)
        mat[1::5, 17] = ord("N")
    if case == "one_row":
        return mat[0].copy()
    return mat


@pytest.mark.parametrize("case", ["rows", "lowercase_n", "one_row", "all_bytes"] + EDGE_CASES)
def test_quot_tf_windows(quot_built, random_reads, case):
    t, j = quot_built
    if case in EDGE_CASES:          # rows cut from the indexed reads, so windows hit
        pool = np.frombuffer("".join(random_reads).encode(), np.uint8)
        mat = _edge_ascii(case, 23, pool)
    else:
        mat = _ascii("all_bytes", 1) if case == "all_bytes" else _read_rows(random_reads, case)
    got = tquot.quot_tf_windows(t.tables("cpu"), torch.from_numpy(mat), 23)
    want = jquot.quot_tf_windows(*j.device, jnp.asarray(mat), *j.mults, k=23, m=j.m,
                                 lb=j.lb, w=j.w)
    _same(_np(got), want)
    if case in ("rows", "rows_of_k", "view_offset_3"):
        assert (_np(got) > 0).any()
    assert tquotcuckoo.quot_tf_windows is tquot.quot_tf_windows


def test_quot_tf_windows_rejects(quot_built):
    t, _ = quot_built
    with pytest.raises(ValueError, match="shorter than k"):
        tquot.quot_tf_windows(t.tables("cpu"), torch.zeros((2, 10), dtype=torch.uint8), 23)
    with pytest.raises(ValueError, match="code width"):
        tquot.quot_tf_windows(t.tables("cpu"), torch.zeros((2, 30), dtype=torch.uint8), 13)
    with pytest.raises(TypeError, match="QuotTables"):
        tquot.quot_tf_windows(t, torch.zeros((2, 30), dtype=torch.uint8), 23)
