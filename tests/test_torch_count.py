"""K1 (aindex_torch.kernels.count): the plain version of count13_packed
against aindex_tpu's count_batch_13_packed on whole 4^13 tables, and the
wrapper's device rule. Counts are integers: equality is exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aindex_tpu.constants import SPACE_13
from aindex_tpu.core import codec as jcodec
from aindex_tpu.kernels.count import count_batch_13_packed
from aindex_torch.kernels import count as tcount
from test_torch_host import jax_native  # noqa: F401 (a fixture)

#: aindex_tpu's native library loads before anything here builds through it
pytestmark = pytest.mark.usefixtures("jax_native")

_jax_count = jax.jit(functools.partial(count_batch_13_packed, k=13, space=SPACE_13))

ALPHABET = np.frombuffer(b"ACGTACGTACGTacgtN~\n", dtype=np.uint8)


@pytest.fixture(scope="module")
def start_table():
    """A nonzero start table with entries near 2^32, so wraparound shows."""
    rng = np.random.default_rng(3)
    tf = np.zeros(SPACE_13, dtype=np.uint32)
    hot = rng.integers(0, SPACE_13, size=1 << 12)
    tf[hot] = rng.integers(2 ** 32 - 3, 2 ** 32, size=hot.size, dtype=np.uint64)
    return tf


@pytest.mark.parametrize("n_bytes,seed", [(1 << 12, 1), (1 << 16, 2), (4112, 3)])
def test_count13_packed_plain_matches_jax(start_table, n_bytes, seed):
    rng = np.random.default_rng(seed)
    chunk = ALPHABET[rng.integers(0, ALPHABET.size, size=n_bytes)]
    # a repeated read makes some codes hit many times
    chunk[:60] = np.frombuffer(b"ACGT" * 15, np.uint8)
    chunk[100:160] = chunk[:60]
    packed, vbits = jcodec.pack_ascii_chunk(chunk)
    want = np.asarray(_jax_count(jnp.asarray(start_table), jnp.asarray(packed),
                                 jnp.asarray(vbits)))
    counts = torch.from_numpy(start_table.copy())
    got = tcount.count13_packed(counts, torch.from_numpy(packed), torch.from_numpy(vbits))
    assert got is counts                     # in place
    np.testing.assert_array_equal(counts.numpy(), want)


def test_count13_packed_int32_storage_and_empty_chunk(start_table):
    counts = torch.from_numpy(start_table.view(np.int32).copy())
    empty = torch.zeros(0, dtype=torch.int32)
    tcount.count13_packed(counts, empty, torch.zeros(0, dtype=torch.uint8))
    np.testing.assert_array_equal(counts.numpy().view(np.uint32), start_table)


def test_count13_packed_rejects_bad_arguments():
    counts = torch.zeros(SPACE_13, dtype=torch.int32)
    packed = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tcount.count13_packed(counts[:-1], packed, torch.zeros(8, dtype=torch.uint8))
    with pytest.raises(ValueError):
        tcount.count13_packed(counts, packed, torch.zeros(7, dtype=torch.uint8))
    with pytest.raises(ValueError):
        tcount.count13_packed(counts, packed.to(torch.int64), torch.zeros(8, dtype=torch.uint8))


def test_count13_packed_no_fallback_on_other_devices():
    """Only a CPU tensor takes the plain version; any other device either
    launches the kernel or raises."""
    meta = torch.empty(SPACE_13, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tcount.count13_packed(meta, torch.empty(4, dtype=torch.int32, device="meta"),
                              torch.empty(8, dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        tcount.count13_packed(torch.zeros(SPACE_13, dtype=torch.int32),
                              torch.empty(4, dtype=torch.int32, device="meta"),
                              torch.zeros(8, dtype=torch.uint8))
