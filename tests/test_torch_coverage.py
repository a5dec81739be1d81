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
from aindex_torch.kernels import coverage as tcov

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


@pytest.mark.parametrize("cutoff", [0, 10])
def test_coverage_dense_single(tables, cutoff):
    jt, tt = tables
    for seq in _seqs(2):
        want = jcov.coverage_dense(jt, seq, 13, cutoff)
        got = tcov.coverage_dense(tt, seq, cutoff)
        assert got.dtype == want.dtype, seq
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cutoff", [0, 10])
def test_coverage_dense_batch(tables, cutoff):
    jt, tt = tables
    seqs = _seqs(3) + _seqs(4)
    want = jcov.coverage_dense_batch(jt, seqs, 13, cutoff)
    got = tcov.coverage_dense_batch(tt, seqs, cutoff)
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
