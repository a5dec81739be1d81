"""Parity of aindex_torch.kernels.encode (plain PyTorch) with
aindex_tpu.kernels.encode (JAX) on random bytes with N, lowercase, '~'
and newlines. All outputs are integers: equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aindex_tpu.core import codec as jcodec
from aindex_tpu.kernels import encode as jenc
from aindex_torch.kernels import encode as tenc

ALPHABET = np.frombuffer(b"ACGTacgtN~\nxACGTACGT", dtype=np.uint8)


def random_ascii(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ALPHABET[rng.integers(0, ALPHABET.size, size=n)]


def test_ascii_to_base_codes_every_byte():
    raw = np.arange(256, dtype=np.uint8)
    got = tenc.ascii_to_base_codes(torch.from_numpy(raw)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jenc.ascii_to_base_codes(jnp.asarray(raw))))


@pytest.mark.parametrize("shape", [(4096,), (7, 160)])
def test_ascii_to_base_codes_random(shape):
    raw = random_ascii(1, int(np.prod(shape))).reshape(shape)
    got = tenc.ascii_to_base_codes(torch.from_numpy(raw)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jenc.ascii_to_base_codes(jnp.asarray(raw))))


@pytest.mark.parametrize("n", [16, 4096, 4099])
def test_unpack_base_codes(n):
    packed, vbits = jcodec.pack_ascii_chunk(random_ascii(n, n))
    got = tenc.unpack_base_codes(torch.from_numpy(packed), torch.from_numpy(vbits)).numpy()
    want = np.asarray(jenc.unpack_base_codes(jnp.asarray(packed), jnp.asarray(vbits)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 5, 13, 16])
def test_window_codes(k):
    base = jcodec.bytes_to_base_codes(random_ascii(k, 3 * 200).reshape(3, 200))
    codes, valid = tenc.window_codes(torch.from_numpy(base), k)
    jcodes, jvalid = jenc.window_codes(jnp.asarray(base), k, out_dtype=jnp.uint32)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_window_codes_too_short():
    with pytest.raises(ValueError):
        tenc.window_codes(torch.zeros(12, dtype=torch.uint8), 13)


def test_packed_window_codes():
    packed, vbits = jcodec.pack_ascii_chunk(random_ascii(3, 8192))
    codes, valid = tenc.packed_window_codes(torch.from_numpy(packed),
                                            torch.from_numpy(vbits), 13)
    jcodes, jvalid = jenc.packed_window_codes(jnp.asarray(packed), jnp.asarray(vbits), 13)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("storage", ["uint32", "int32", "int64"])
def test_revcomp_code13_full_uint32_range(storage):
    rng = np.random.default_rng(5)
    codes = np.concatenate([
        rng.integers(0, 1 << 32, size=1 << 16, dtype=np.uint64).astype(np.uint32),
        np.arange(4 ** 13 - 300, 4 ** 13 + 300, dtype=np.uint32),
        np.array([0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], dtype=np.uint32)])
    want = np.asarray(jenc.revcomp_code13(jnp.asarray(codes), 13))
    arg = {"uint32": torch.from_numpy(codes),
           "int32": torch.from_numpy(codes.view(np.int32)),
           "int64": torch.from_numpy(codes.astype(np.int64))}[storage]
    np.testing.assert_array_equal(tenc.revcomp_code13(arg).numpy(), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32])
def test_table_values_reads_unsigned(dtype):
    vals = np.array([0, 1, np.iinfo(dtype).max, np.iinfo(dtype).max // 2 + 1], dtype=dtype)
    got = tenc.table_values(torch.from_numpy(vals), torch.tensor([3, 2, 1, 0]))
    np.testing.assert_array_equal(got.numpy(), vals[::-1].astype(np.int64))
