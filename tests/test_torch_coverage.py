"""K4 (aindex_torch.kernels.coverage): the plain version of
coverage13_packed against aindex_tpu's _coverage_dense_packed on the same
packed rows, and the host batching (coverage_dense, coverage_dense_batch)
against aindex_tpu's. Coverage values are integers: equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aindex_tpu.constants import SPACE_13
from aindex_tpu.core import codec as jcodec
from aindex_tpu.kernels import coverage as jcov
from aindex_torch.core import codec as tcodec
from aindex_torch.kernels import coverage as tcov
from test_torch_host import jax_native  # noqa: F401 (a fixture)

#: aindex_tpu's native library loads before anything here builds through it
pytestmark = pytest.mark.usefixtures("jax_native")

WIDTHS = {8: np.uint8, 16: np.uint16, 32: np.uint32}


@pytest.fixture(scope="module", params=[8, 16, 32], ids=["u8", "u16", "u32"])
def tables(request):
    """(jax, torch) copies of a random table of one width; small values
    dominate so that the cutoff matters."""
    dtype = WIDTHS[request.param]
    rng = np.random.default_rng(100 + request.param)
    t = rng.integers(0, 20, size=SPACE_13).astype(dtype)
    t[rng.integers(0, SPACE_13, size=1 << 12)] = np.iinfo(dtype).max
    return jnp.asarray(t), torch.from_numpy(t)


def _seqs(seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seqs = [bytes(acgt[rng.integers(0, 4, size=n)]).decode()
            for n in (150, 150, 13, 14, 40, 127, 128, 129, 300)]
    seqs += ["ACGT", "", "ACGTNACGTACGTACGTAC", "acgtACGTacgtACGTa~CGTACGTACGTAC"]
    return seqs


@pytest.mark.parametrize("cutoff", [0, 10])
def test_coverage13_packed_plain_matches_jax(tables, cutoff):
    jt, tt = tables
    seqs = _seqs(1)
    rows, stride = 16, 301
    # aindex_tpu's layout: newline-padded [rows, stride] rows plus a k-byte tail
    mat = np.full((rows, stride), ord("\n"), dtype=np.uint8)
    for r, s in enumerate(seqs):
        mat[r, :len(s)] = np.frombuffer(s.encode(), np.uint8)
    flat = np.concatenate([mat.ravel(), np.full(13, ord("\n"), np.uint8)])
    packed, vbits = jcodec.pack_ascii_chunk(flat)
    want = np.asarray(jcov._coverage_dense_packed(
        jt, jnp.asarray(packed), jnp.asarray(vbits), jnp.uint32(cutoff), k=13,
        rows=rows, stride=stride))
    got = tcov.coverage13_packed(tt, torch.from_numpy(packed), torch.from_numpy(vbits),
                                 rows, stride, cutoff)
    assert got.dtype == torch.uint32 and got.shape == (rows, stride - 13)
    np.testing.assert_array_equal(got.numpy(), want)


#: (rows, stride, bases) of the shapes where a tiled coverage kernel could
#: break (csrc/dna23.cuh tile_run): one row longer than many tiles, rows of
#: one window (stride k + 1: None), windows that end mid-tile and mid-run,
#: rows wider than a tile, rows of all N, and rows of valid bases that fill
#: packed to its last word; a row ends in a newline unless its bases are
#: all valid
EDGE_SHAPES = {"one long row": (1, (1 << 16) + 1, "ACGTN"),
               "one window a row": (300, None, "ACGTN"),
               "13 x 100": (13, 100, "ACGTN"),
               "3 x 5000": (3, 5000, "ACGTN"),
               "all N": (40, 151, "N"),
               "to the last word": (16, 151, "ACGT")}


def edge_matrix(shape: str, k: int, seed: int, text: bytes | None = None) -> np.ndarray:
    """The ASCII rows of EDGE_SHAPES[shape] for k-mers: random bases (1%
    N), or stretches of ``text`` (repeated as needed; a byte outside ACGT
    reads A where every base must be valid)."""
    rows, stride, bases = EDGE_SHAPES[shape]
    stride = stride or k + 1
    rng = np.random.default_rng(seed)
    if bases == "N":
        return np.full((rows, stride), ord("N"), np.uint8)
    if text is None:
        p = np.array([0.2475] * 4 + [0.01])
        mat = np.frombuffer(b"ACGTN", np.uint8)[rng.choice(5, size=(rows, stride), p=p)]
    else:
        src = np.frombuffer(text, np.uint8)
        src = np.tile(src, rows * stride // src.size + 2)
        start = rng.integers(0, src.size - rows * stride)
        mat = src[start:start + rows * stride].reshape(rows, stride).copy()
    if "N" in bases:
        mat[:, -1] = ord("\n")
    else:
        mat[~np.isin(mat, np.frombuffer(b"ACGT", np.uint8))] = ord("A")
    return mat


@pytest.mark.parametrize("cutoff", [0, 10, 2**32 - 1])
@pytest.mark.parametrize("shape", list(EDGE_SHAPES))
def test_coverage13_packed_edges_match_jax(tables, shape, cutoff):
    """K4's plain version on packed buffers of exactly rows * stride bases
    (rounded up to a word), against aindex_tpu's on the same rows with its
    k-byte tail."""
    jt, tt = tables
    mat = edge_matrix(shape, 13, 5)
    rows, stride = mat.shape
    tail = np.full(13, ord("\n"), np.uint8)
    packed, vbits = jcodec.pack_ascii_chunk(np.concatenate([mat.ravel(), tail]))
    want = np.asarray(jcov._coverage_dense_packed(
        jt, jnp.asarray(packed), jnp.asarray(vbits), jnp.uint32(cutoff), k=13,
        rows=rows, stride=stride))
    packed, vbits = tcodec.pack_ascii_chunk(mat.ravel())
    got = tcov.coverage13_packed(tt, torch.from_numpy(packed.view(np.int32)),
                                 torch.from_numpy(vbits), rows, stride, cutoff)
    assert got.shape == (rows, stride - 13)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cutoff", [0, 10])
def test_coverage_dense_single(tables, cutoff):
    jt, tt = tables
    for seq in _seqs(2):
        want = jcov.coverage_dense(jt, seq, 13, cutoff)
        got = tcov.coverage_dense(tt, seq, 13, cutoff)
        assert got.dtype == want.dtype, seq
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cutoff", [0, 10])
def test_coverage_dense_batch(tables, cutoff):
    jt, tt = tables
    seqs = _seqs(3) + _seqs(4)
    want = jcov.coverage_dense_batch(jt, seqs, 13, cutoff)
    got = tcov.coverage_dense_batch(tt, seqs, 13, cutoff)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_rejects_bad_arguments(tables):
    _, tt = tables
    packed = torch.zeros(2, dtype=torch.int32)
    vbits = torch.zeros(4, dtype=torch.uint8)
    with pytest.raises(ValueError):
        tcov.coverage13_packed(tt, packed, vbits, 1, 33, 0)      # 33 > 32 bases
    with pytest.raises(ValueError):
        tcov.coverage13_packed(tt, packed, vbits, 1, 13, 0)      # no window
    with pytest.raises(ValueError):
        tcov.coverage13_packed(tt, packed, vbits, 1, 20, -1)
    with pytest.raises(ValueError):
        tcov.coverage13_packed(tt[:-1], packed, vbits, 1, 20, 0)


def test_coverage_dense_positional_k():
    """aindex_tpu's call form coverage_dense(t, seq, 13) binds 13 to k in
    both packages, and the cutoff keeps its default of 0."""
    rng = np.random.default_rng(7)
    t = rng.integers(0, 30, size=SPACE_13).astype(np.uint32)
    seq = bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=60)]).decode()
    want = jcov.coverage_dense(jnp.asarray(t), seq, 13)
    got = tcov.coverage_dense(torch.from_numpy(t), seq, 13)
    assert (want < 13).any()
    np.testing.assert_array_equal(got, want)
    wants = jcov.coverage_dense_batch(jnp.asarray(t), [seq, seq[:20]], 13)
    gots = tcov.coverage_dense_batch(torch.from_numpy(t), [seq, seq[:20]], 13)
    for g, w in zip(gots, wants):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [12, 23])
def test_coverage_dense_other_k_raises(k):
    t = torch.zeros(SPACE_13, dtype=torch.uint32)
    with pytest.raises(ValueError, match="k=13"):
        tcov.coverage_dense(t, "ACGT" * 10, k)
    with pytest.raises(ValueError, match="k=13"):
        tcov.coverage_dense_batch(t, ["ACGT" * 10], k)
