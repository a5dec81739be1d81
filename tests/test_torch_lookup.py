"""K3 (aindex_torch.kernels.lookup): the plain version of gather13 against
every dense gather of aindex_tpu, on whole uint8/uint16/uint32 4^13
tables, with codes over the whole uint32 range. Equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aindex_tpu.constants import SPACE_13
from aindex_tpu.index import dense13 as jd
from aindex_tpu.kernels.lookup import gather_tf_both_13, gather_tf_valid
from aindex_torch.constants import HALF_13
from aindex_torch.index import dense13 as td
from aindex_torch.kernels import lookup as tl
from test_torch_host import jax_native  # noqa: F401 (a fixture)

#: aindex_tpu's native library loads before anything here builds through it
pytestmark = pytest.mark.usefixtures("jax_native")

EDGES = np.array([0, 7, SPACE_13 - 1, SPACE_13, SPACE_13 + 5, 2 ** 31 - 1, 2 ** 31,
                  2 ** 31 + SPACE_13, 2 ** 32 - SPACE_13, 2 ** 32 - 1], dtype=np.uint32)
WIDTHS = {8: np.uint8, 16: np.uint16, 32: np.uint32}


@pytest.fixture(scope="module", params=[8, 16, 32], ids=["u8", "u16", "u32"])
def tables(request):
    """(numpy, jax, torch) copies of one random table of the given width."""
    dtype = WIDTHS[request.param]
    rng = np.random.default_rng(request.param)
    t = rng.integers(0, np.iinfo(dtype).max, size=SPACE_13, dtype=np.uint64,
                     endpoint=True).astype(dtype)
    return t, jnp.asarray(t), torch.from_numpy(t)


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(9)
    codes = np.concatenate([EDGES, rng.integers(0, 2 ** 32, size=1 << 15,
                                                dtype=np.uint64).astype(np.uint32),
                            rng.integers(0, SPACE_13, size=1 << 15).astype(np.uint32)])
    valid = rng.random(codes.size) < 0.8
    valid[:EDGES.size] = True
    alphabet = np.frombuffer(b"ACGTACGTACGTacgtN~\nx", dtype=np.uint8)
    ascii = alphabet[rng.integers(0, alphabet.size, size=(1 << 14, 13))]
    ascii[: 1 << 12] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(1 << 12, 13))]
    return codes, valid, ascii


def _np(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.uint32
    return t.numpy()


def test_codes_no_mask(tables, queries):
    t, jt, tt = tables
    codes, _, _ = queries
    want = np.asarray(jd._gather_codes_u32(jt, jnp.asarray(codes)))
    np.testing.assert_array_equal(_np(tl.gather13(tt, torch.from_numpy(codes))), want)
    # int32 storage of the same bits reads the same entries
    got = tl.gather13(tt, torch.from_numpy(codes.view(np.int32)))
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("fn", ["gather_tf_valid", "_gather_total", "_gather_codes_valid_u32"])
def test_codes_masked(tables, queries, fn):
    t, jt, tt = tables
    codes, valid, _ = queries
    jfn = {"gather_tf_valid": gather_tf_valid, "_gather_total": jd._gather_total,
           "_gather_codes_valid_u32": jd._gather_codes_valid_u32}[fn]
    want = np.asarray(jfn(jt, jnp.asarray(codes), jnp.asarray(valid)))
    got = tl.gather13(tt, torch.from_numpy(codes), torch.from_numpy(valid))
    np.testing.assert_array_equal(_np(got), want)


def test_codes_both(tables, queries):
    t, jt, tt = tables
    codes, valid, _ = queries
    jf, jr = gather_tf_both_13(jt, jnp.asarray(codes), jnp.asarray(valid))
    f, r = tl.gather13(tt, torch.from_numpy(codes), torch.from_numpy(valid), both=True)
    np.testing.assert_array_equal(_np(f), np.asarray(jf))
    np.testing.assert_array_equal(_np(r), np.asarray(jr))


@pytest.mark.parametrize("both", [False, True], ids=["fwd", "both"])
def test_ascii_rows(tables, queries, both):
    t, jt, tt = tables
    _, _, ascii = queries
    jcodes, jvalid = jd._encode_batch_dev(jnp.asarray(ascii))
    got = tl.gather13(tt, ascii=torch.from_numpy(ascii), both=both)
    if both:
        jf, jr = gather_tf_both_13(jt, jcodes, jvalid)
        np.testing.assert_array_equal(_np(got[0]), np.asarray(jf))
        np.testing.assert_array_equal(_np(got[1]), np.asarray(jr))
    else:
        want = np.asarray(jd._gather_codes_valid_u32(jt, jcodes, jvalid))
        np.testing.assert_array_equal(_np(got), want)


def test_out_of_range_codes_follow_jax_gather(tables):
    """JAX casts to int32, adds the length to a negative index and clamps:
    on a length-4 table t[[7, -1, 2]] reads t[3], t[3], t[2]."""
    t, jt, tt = tables
    small = jnp.arange(10, 14, dtype=jnp.uint32)
    np.testing.assert_array_equal(np.asarray(small[jnp.array([7, -1, 2], jnp.int32)]),
                                  [13, 13, 12])
    want = np.asarray(jd._gather_codes_u32(jt, jnp.asarray(EDGES)))
    idx = np.array([0, 7, SPACE_13 - 1, SPACE_13 - 1, SPACE_13 - 1, SPACE_13 - 1, 0,
                    0, 0, SPACE_13 - 1])
    np.testing.assert_array_equal(want, t[idx].astype(np.uint32))
    np.testing.assert_array_equal(_np(tl.gather13(tt, torch.from_numpy(EDGES))), want)
    np.testing.assert_array_equal(tl.jax_index(torch.from_numpy(EDGES)).numpy(), idx)


def test_shapes_and_empty(tables):
    _, _, tt = tables
    codes = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    assert tl.gather13(tt, codes).shape == (3, 4)
    assert tl.gather13(tt, codes[:0]).shape == (0, 4)
    assert tl.gather13(tt, ascii=torch.zeros((0, 13), dtype=torch.uint8)).shape == (0,)


def test_rejects_bad_arguments(tables):
    _, _, tt = tables
    codes = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tl.gather13(tt[:-1], codes)
    with pytest.raises(ValueError):
        tl.gather13(tt, codes.to(torch.int64))
    with pytest.raises(ValueError):
        tl.gather13(tt, codes, torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError):
        tl.gather13(tt)
    with pytest.raises(ValueError):
        tl.gather13(tt, ascii=torch.zeros((2, 12), dtype=torch.uint8))


# -- the half total table (gather13_half) ------------------------------------------

#: count-table entries below which each width's totals narrow to it (the
#: uint32 table's adds wrap)
HALF_TF_TOP = {8: 1 << 7, 16: 1 << 15, 32: 1 << 32}


@pytest.fixture(scope="module", params=[8, 16, 32], ids=["u8", "u16", "u32"])
def half_tables(request):
    """(aindex_tpu's narrowed total table, the port's narrowed half total
    table) of one random count table whose totals narrow to the width."""
    rng = np.random.default_rng(100 + request.param)
    tf = rng.integers(0, HALF_TF_TOP[request.param], size=SPACE_13,
                      dtype=np.uint64).astype(np.uint32)
    full = jd._narrow(jd._build_total_table(jnp.asarray(tf)))
    half = td._narrow(td.total13_half(torch.from_numpy(tf)))
    assert np.dtype(WIDTHS[request.param]) == full.dtype
    assert str(half.dtype) == f"torch.{full.dtype}" and half.shape == (HALF_13,)
    return full, half


@pytest.mark.parametrize("fn", ["_gather_codes_u32", "_gather_total", "_gather_codes_valid_u32"])
def test_half_codes(half_tables, queries, fn):
    """Codes over the whole uint32 range (4^13, 2^31 - 1, 2^31, 2^32 - 1
    among them), masked or not, read in the half table what aindex_tpu's
    gathers read in the full one."""
    full, half = half_tables
    codes, valid, _ = queries
    if fn == "_gather_codes_u32":
        want = np.asarray(jd._gather_codes_u32(full, jnp.asarray(codes)))
        got = tl.gather13(half, torch.from_numpy(codes))
    else:
        want = np.asarray(getattr(jd, fn)(full, jnp.asarray(codes), jnp.asarray(valid)))
        got = tl.gather13(half, torch.from_numpy(codes), torch.from_numpy(valid))
    np.testing.assert_array_equal(_np(got), want)


def test_half_ascii_rows(half_tables, queries):
    full, half = half_tables
    _, _, ascii = queries
    jcodes, jvalid = jd._encode_batch_dev(jnp.asarray(ascii))
    want = np.asarray(jd._gather_codes_valid_u32(full, jcodes, jvalid))
    np.testing.assert_array_equal(_np(tl.gather13(half, ascii=torch.from_numpy(ascii))), want)


def test_half_rejects_both(half_tables):
    _, half = half_tables
    with pytest.raises(ValueError, match="half total table"):
        tl.gather13(half, torch.zeros(4, dtype=torch.int32), both=True)
    with pytest.raises(ValueError):
        tl.gather13(half[:-1], torch.zeros(4, dtype=torch.int32))
