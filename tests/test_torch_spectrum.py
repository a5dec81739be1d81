"""K5 (aindex_torch.kernels.spectrum): the plain version of spectrum23
against aindex_tpu's chunk_spectrum_packed and sorted_spectrum, whole padded
arrays included; merge_spectra; the 64-bit reverse complement; and the
chunked spectrum of both packages. Keys and counts are integers: equality is
exact, dtypes included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aindex_tpu.core import codec as jcodec
from aindex_tpu.core.reads import ReadsStore
from aindex_tpu.index import sparse23 as jsparse
from aindex_tpu.kernels import encode as jencode
from aindex_tpu.kernels import spectrum as jspec
from aindex_torch.core.reads import stream_blob_chunks
from aindex_torch.index import sparse23 as tsparse
from aindex_torch.kernels import encode as tencode
from aindex_torch.kernels import spectrum as tspec


def _chunk(case: str) -> np.ndarray:
    rng = np.random.default_rng(CASES.index(case))
    acgt = np.frombuffer(b"ACGT", np.uint8)
    if case == "reads_n_runs_newlines":
        chunk = acgt[rng.integers(0, 4, size=1 << 14)]
        chunk[150::151] = ord("\n")
        for start in rng.integers(0, chunk.size - 40, size=30):
            chunk[start:start + rng.integers(1, 30)] = ord("N")
        chunk[:300] = np.frombuffer(b"ACGT" * 75, np.uint8)   # repeats
        return chunk
    if case == "mixed_alphabet":
        alpha = np.frombuffer(b"ACGTACGTacgtN~\n", np.uint8)
        return alpha[rng.integers(0, alpha.size, size=4096)]
    if case == "empty":                       # no valid window at all
        return np.frombuffer(b"N" * 64 + b"\n" * 64, np.uint8).copy()
    if case == "one_window":                  # exactly one valid 23-mer
        chunk = np.full(256, ord("\n"), np.uint8)
        chunk[100:123] = acgt[rng.integers(0, 4, size=23)]
        return chunk
    if case == "palindromes":                 # keys equal to their revcomp
        return np.frombuffer(b"ACGTACGTACGTACGTACGTACGT" * 40 + b"\n" * 64, np.uint8).copy()
    raise ValueError(case)


CASES = ["reads_n_runs_newlines", "mixed_alphabet", "empty", "one_window", "palindromes"]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32 if a.dtype == np.uint32
                                                         else np.int64 if a.dtype == np.uint64
                                                         else a.dtype))


def _np_keys(keys: torch.Tensor) -> np.ndarray:
    return keys.numpy().view(np.uint64)


def _np_counts(counts: torch.Tensor) -> np.ndarray:
    assert counts.dtype == torch.uint32
    return counts.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", [23, 31])
def test_chunk_spectrum_packed_matches_jax(case, k):
    packed, vbits = jcodec.pack_ascii_chunk(_chunk(case))
    jk, jc, jn = jspec.chunk_spectrum_packed(jnp.asarray(packed), jnp.asarray(vbits), k)
    tk, tc, tn = tspec.chunk_spectrum_packed(_t(packed), _t(vbits), k)
    assert tk.dtype == torch.int64 and tn.dtype == torch.int32
    np.testing.assert_array_equal(_np_keys(tk), np.asarray(jk))
    np.testing.assert_array_equal(_np_counts(tc), np.asarray(jc))
    assert int(tn) == int(jn)


@pytest.mark.parametrize("seed", [0, 1])
def test_sorted_spectrum_keys_mode_matches_jax(seed):
    """Flat uint64 keys: duplicates, the sentinel, keys above 2^63."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**64 - 1, size=300, dtype=np.uint64)
    keyed = pool[rng.integers(0, pool.size, size=5000)]
    keyed[rng.random(keyed.size) < 0.1] = jspec.SENTINEL
    jk, jc, jn = jspec.sorted_spectrum(jnp.asarray(keyed))
    tk, tc, tn = tspec.sorted_spectrum(_t(keyed))
    np.testing.assert_array_equal(_np_keys(tk), np.asarray(jk))
    np.testing.assert_array_equal(_np_counts(tc), np.asarray(jc))
    assert int(tn) == int(jn) == np.unique(keyed[keyed != jspec.SENTINEL]).size


def test_wrapper_runs_plain_on_cpu_and_checks_inputs():
    packed, vbits = jcodec.pack_ascii_chunk(_chunk("mixed_alphabet"))
    got = tspec.spectrum23(_t(packed), _t(vbits), 23)
    want = tspec.spectrum23_plain(_t(packed), _t(vbits), 23)
    assert all(torch.equal(a.view(torch.int32) if a.dtype == torch.uint32 else a,
                           b.view(torch.int32) if b.dtype == torch.uint32 else b)
               for a, b in zip(got, want))
    with pytest.raises(ValueError, match="exactly one"):
        tspec.spectrum23()
    with pytest.raises(ValueError, match="int64"):
        tspec.spectrum23(keys=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="outside"):
        tspec.spectrum23(_t(packed), _t(vbits), 32)
    with pytest.raises(ValueError, match="unsupported device"):
        tspec.spectrum23(keys=torch.zeros(4, dtype=torch.int64, device="meta"))


def test_sentinel_is_jax_sentinel():
    assert tspec.SENTINEL == jspec.SENTINEL
    assert np.int64(tspec.SENTINEL_I64).view(np.uint64) == jspec.SENTINEL


@pytest.mark.parametrize("n_parts", [0, 1, 4])
def test_merge_spectra_matches_jax(n_parts):
    rng = np.random.default_rng(n_parts)
    parts = []
    for _ in range(n_parts):
        keys = np.unique(rng.integers(0, 2**46, size=500).astype(np.uint64) % 1000)
        parts.append((keys, rng.integers(1, 2**32, size=keys.size, dtype=np.uint64)
                      .astype(np.uint32)))
    tk, tc = tspec.merge_spectra(parts)
    jk, jc = jspec.merge_spectra(parts)
    assert tk.dtype == jk.dtype and tc.dtype == jc.dtype
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tc, jc)


@pytest.mark.parametrize("k", [1, 13, 23, 31])
def test_revcomp_and_canonical_code64_match_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 2**64 - 1, size=4000, dtype=np.uint64)
    codes[:2000] &= np.uint64((1 << (2 * k)) - 1)
    rc = tencode.revcomp_code64(_t(codes), k).numpy().view(np.uint64)
    np.testing.assert_array_equal(rc, np.asarray(jencode.revcomp_code64(jnp.asarray(codes), k)))
    canon = tencode.canonical_code64(_t(codes), k).numpy().view(np.uint64)
    np.testing.assert_array_equal(
        canon, np.asarray(jencode.canonical_code64(jnp.asarray(codes), k)))


@pytest.mark.parametrize("chunk", [128, 4096, 1 << 22])
def test_count_canonical_kmers_matches_jax(random_reads, chunk):
    blob = ReadsStore.from_sequences(random_reads).blob
    tk, tc = tsparse.count_canonical_kmers(blob, chunk=chunk, device="cpu")
    jk, jc = jsparse.count_canonical_kmers(blob, chunk=chunk, reduce="device")
    assert tk.dtype == jk.dtype and tc.dtype == jc.dtype
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tc, jc)


def test_count_canonical_kmers_stream_matches_jax_and_reports_progress(random_reads):
    pieces = [np.frombuffer((r + "\n").encode(), np.uint8) for r in random_reads]
    seen_t, seen_j = [], []
    tk, tc = tsparse.count_canonical_kmers_stream(iter(pieces), chunk=256,
                                                  on_progress=seen_t.append, device="cpu")
    jk, jc = jsparse.count_canonical_kmers_stream(iter(pieces), chunk=256,
                                                  on_progress=seen_j.append)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tc, jc)
    assert seen_t == seen_j and len(seen_t) == len(list(stream_blob_chunks(iter(pieces), 23, 256)))
