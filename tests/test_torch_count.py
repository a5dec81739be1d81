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


# -- the counter of a build's chunks ------------------------------------------

#: word counts of the chunks a counter takes: 1, 15, 16 and 17 words, an
#: empty chunk, then seeded lengths; the last chunk is short
_SIZES = (16, 240, 0, 256, 272)


def _chunks(n_chunks: int, seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """``n_chunks`` packed chunks of seeded reads (a poly-A run in each, so
    some codes hit many times); the last of several is 1-40 bytes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_chunks):
        if i < len(_SIZES) and n_chunks > len(_SIZES):
            n = _SIZES[i]
        elif i == n_chunks - 1 and n_chunks > 1:
            n = int(rng.integers(1, 41))
        else:
            n = int(rng.integers(100, 3000))
        chunk = ALPHABET[rng.integers(0, ALPHABET.size, size=n)]
        chunk[:min(n, 40)] = ord("A")
        out.append(jcodec.pack_ascii_chunk(chunk))
    return out


@functools.lru_cache(maxsize=8)
def _jax_sum(n_chunks: int, seed: int) -> np.ndarray:
    """aindex_tpu's count_batch_13_packed summed over the chunks, from the
    start table (module fixture's seed)."""
    rng = np.random.default_rng(3)
    tf = np.zeros(SPACE_13, dtype=np.uint32)
    hot = rng.integers(0, SPACE_13, size=1 << 12)
    tf[hot] = rng.integers(2 ** 32 - 3, 2 ** 32, size=hot.size, dtype=np.uint64)
    table = jnp.asarray(tf)
    for packed, vbits in _chunks(n_chunks, seed):
        if packed.size:
            table = _jax_count(table, jnp.asarray(packed), jnp.asarray(vbits))
    return np.asarray(table)


@pytest.mark.parametrize("piece", [None, 700], ids=["default piece", "piece 700"])
@pytest.mark.parametrize("seed", [5, 6])
@pytest.mark.parametrize("n_chunks", [1, 2, 9])
def test_counter_matches_jax_sum(start_table, monkeypatch, n_chunks, seed, piece):
    """A PackedCounter over the chunks gives aindex_tpu's per-chunk counts
    summed, bit for bit (wrapping past 2^32); a small piece counts several
    times in one build, and a chunk larger than the piece by itself."""
    if piece is not None:
        monkeypatch.setattr(tcount, "PLAIN_PIECE", piece)
    counted = []
    real = tcount._count_buffer
    monkeypatch.setattr(tcount, "_count_buffer",
                        lambda c, p, v: counted.append(p.numel()) or real(c, p, v))
    counts = torch.from_numpy(start_table.copy())
    counter = tcount.PackedCounter(counts)
    for packed, vbits in _chunks(n_chunks, seed):
        counter.add(torch.from_numpy(packed.view(np.int32)), torch.from_numpy(vbits))
    assert counter.finish() is counts
    np.testing.assert_array_equal(counts.numpy(), _jax_sum(n_chunks, seed))
    if piece is not None and n_chunks == 9:
        assert len(counted) > 1
    n_counts = len(counted)
    assert counter.finish() is counts and len(counted) == n_counts   # empty: no count
    np.testing.assert_array_equal(counts.numpy(), _jax_sum(n_chunks, seed))


def test_counter_keeps_windows_inside_chunks():
    """Two chunks of 32 valid bases each: counted through one counter they
    add their own 20 windows each, none of the 12 that would cross from one
    into the other, which counting the words back to back adds."""
    rng = np.random.default_rng(9)
    a, b = (np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=32)] for _ in range(2))
    pa, va = jcodec.pack_ascii_chunk(a)
    pb, vb = jcodec.pack_ascii_chunk(b)
    counts = torch.zeros(SPACE_13, dtype=torch.int32)
    counter = tcount.PackedCounter(counts)
    for p, v in ((pa, va), (pb, vb)):
        counter.add(torch.from_numpy(p.view(np.int32)), torch.from_numpy(v))
    counter.finish()
    want = np.asarray(_jax_count(_jax_count(jnp.zeros(SPACE_13, jnp.uint32), pa, va), pb, vb))
    np.testing.assert_array_equal(counts.numpy().view(np.uint32), want)
    assert int(counts.sum()) == 40
    joined = torch.zeros(SPACE_13, dtype=torch.int32)
    tcount.count13_packed_plain(joined, torch.from_numpy(np.concatenate([pa, pb]).view(np.int32)),
                                torch.from_numpy(np.concatenate([va, vb])))
    assert int(joined.sum()) == 52


def test_counter_rejects_other_devices_and_bad_chunks():
    counter = tcount.PackedCounter(torch.zeros(SPACE_13, dtype=torch.int32))
    with pytest.raises(ValueError, match="different devices"):
        counter.add(torch.empty(4, dtype=torch.int32, device="meta"),
                    torch.empty(8, dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError):
        counter.add(torch.zeros(4, dtype=torch.int32), torch.zeros(7, dtype=torch.uint8))
    with pytest.raises(ValueError):
        tcount.PackedCounter(torch.zeros(SPACE_13 - 1, dtype=torch.int32))
