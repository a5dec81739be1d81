"""The facade: aindex_torch.AIndex on the CPU against aindex_tpu.api.AIndex,
built from the same sequences for k = 13 (dense), 23 (quotient table), 27
(the wide cuckoo table) and 31 (the MPHF walk), every public method a case
of one parametrised test; the golden reference set and save/load round
trips through ``load_from_prefix``; and the error cases. Answers are
integers, strings and integer arrays: equality is exact."""

import enum
import inspect
import os
import types

import numpy as np
import pytest
import torch

from aindex_tpu.api import AIndex as JAIndex
from aindex_tpu.core import codec as jcodec
from aindex_torch import AIndex as TAIndex
from aindex_torch.parallel import distributed as tdist
from aindex_torch.parallel.mesh import make_mesh as t_make_mesh
from test_torch_host import jax_native  # noqa: F401 (a fixture)

#: aindex_tpu's native library loads before anything here builds through it
pytestmark = pytest.mark.usefixtures("jax_native")

GOLD = os.path.join(os.path.dirname(__file__), "golden_ref")
KS = [13, 23, 27, 31]


def norm(x):
    """A comparable plain-Python form of a facade result."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            x = x.view(torch.int32).numpy().view(np.uint32)
        else:
            x = x.numpy()
    if hasattr(x, "__array__") and not isinstance(x, np.ndarray):
        x = np.asarray(x)
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    if isinstance(x, enum.Enum):
        return int(x.value)
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, types.GeneratorType)) or inspect.isgenerator(x):
        return [norm(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def outcome(fn, *args):
    """("ok", result) or ("raise", exception type name, message)."""
    try:
        return ("ok", norm(fn(*args)))
    except Exception as e:  # the comparison is of the errors too
        return ("raise", type(e).__name__, str(e))


_BUILT: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _clear(jax_native):
    """aindex_tpu's native library is loaded before _BUILT fills, and
    _BUILT is emptied after the module."""
    yield
    _BUILT.clear()


def built(k: int, random_reads):
    if k not in _BUILT:
        _BUILT[k] = (TAIndex.build_from_sequences(random_reads, kmer_size=k, device="cpu"),
                     JAIndex.build_from_sequences(random_reads, kmer_size=k))
    return _BUILT[k]


def kmers_of(k: int, random_reads) -> list[str]:
    """Windows of the reads (N and '~' ones included), reverse complements,
    absent, all-A, lowercase and N-containing k-mers."""
    out = [r[i:i + k] for r in random_reads[:30] for i in range(0, len(r) - k + 1, 7)]
    out += [jcodec.revcomp(km) for km in out[:20]]
    return out + ["A" * k, "T" * k, ("acgt" * 8)[:k], ("ACGTN" * 7)[:k]]


def codes_of(k: int, random_reads) -> np.ndarray:
    codes, _ = jcodec.encode_kmers([km for km in kmers_of(k, random_reads)
                                    if set(km) <= set("ACGT")], k)
    return codes.astype(np.uint32) if k == 13 else codes


#: method -> arguments (k, kmers, random_reads) -> positional args
METHODS = {
    "get_tf_value": lambda k, km, rr: (km[0],),
    "get_tf_values": lambda k, km, rr: (km,),
    "__getitem__": lambda k, km, rr: (km[3],),
    "__contains__": lambda k, km, rr: ("A" * k,),
    "get": lambda k, km, rr: (km[1], -1),
    "__len__": lambda k, km, rr: (),
    "get_tf_values_13mer": lambda k, km, rr: (km,),
    "get_total_tf_value_13mer": lambda k, km, rr: (km[2],),
    "get_total_tf_values_13mer": lambda k, km, rr: (km,),
    "get_tf_both_directions_13mer": lambda k, km, rr: (km[4],),
    "get_tf_both_directions_13mer_batch": lambda k, km, rr: (km,),
    "get_tf_values_23mer": lambda k, km, rr: (km,),
    "get_total_tf_value_23mer": lambda k, km, rr: (km[5],),
    "get_total_tf_values_23mer": lambda k, km, rr: (km,),
    "get_tf_both_directions_23mer": lambda k, km, rr: (km[6],),
    "get_tf_both_directions_23mer_batch": lambda k, km, rr: (km,),
    "get_tf_values_codes_13mer": lambda k, km, rr: (codes_of(k, rr),),
    "get_total_tf_values_codes_13mer": lambda k, km, rr: (codes_of(k, rr),),
    "get_tf_values_codes_23mer": lambda k, km, rr: (codes_of(k, rr),),
    "get_reverse_complement_13mer": lambda k, km, rr: (km[0],),
    "get_reverse_complement_23mer": lambda k, km, rr: (km[0],),
    "get_hash_value": lambda k, km, rr: (km[0],),
    "get_hash_values": lambda k, km, rr: (km,),
    "get_hash_size": lambda k, km, rr: (),
    "get_kid_by_kmer": lambda k, km, rr: (km[2],),
    "get_kmer_by_kid": lambda k, km, rr: (5,),
    "get_strand": lambda k, km, rr: (km[-6],),
    "get_kmer_info": lambda k, km, rr: (7,),
    "get_kmer_info_by_kid": lambda k, km, rr: (9,),
    "get_positions": lambda k, km, rr: (km[1],),
    "get_positions_13mer": lambda k, km, rr: (km[1],),
    "pos": lambda k, km, rr: (km[2],),
    "get_positions_batch": lambda k, km, rr: (km,),
    "get_rid": lambda k, km, rr: (200,),
    "get_start": lambda k, km, rr: (200,),
    "get_rid2poses": lambda k, km, rr: (km[0],),
    "get_read_by_rid": lambda k, km, rr: (3,),
    "get_read": lambda k, km, rr: (10, 50, True),
    "get_reads_by_kmer": lambda k, km, rr: (km[0], 5),
    "get_reads_se_by_kmer": lambda k, km, rr: (km[1],),
    "debug_kmer_tf_values": lambda k, km, rr: ([0, 1, 2, 3, 50],),
    "iter_reads": lambda k, km, rr: (),
    "iter_reads_se": lambda k, km, rr: (),
    "get_header": lambda k, km, rr: (100,),
    "get_reads_size": lambda k, km, rr: (),
    "iter_sequence_kmers": lambda k, km, rr: (rr[0], k),
    "get_sequence_coverage": lambda k, km, rr: (rr[1], 0),
    "get_sequence_coverage_batch": lambda k, km, rr: (rr, 1),
    "print_sequence_coverage": lambda k, km, rr: (rr[2],),
    "iter_kmers_by_frequency": lambda k, km, rr: (2, 50),
    "get_top_kmers": lambda k, km, rr: (20,),
    "get_kmer_frequency_stats": lambda k, km, rr: (),
    "get_13mer_statistics": lambda k, km, rr: (),
    "get_23mer_statistics": lambda k, km, rr: (),
    "set_stats": lambda k, km, rr: (5,),
    "print_and_set_coverage": lambda k, km, rr: (3,),
    "get_13mer_tf_array": lambda k, km, rr: (),
    "get_tf_by_index_13mer": lambda k, km, rr: (12345,),
    "get_index_info": lambda k, km, rr: (),
    "debruijn_next": lambda k, km, rr: (km[0],),
    "debruijn_prev": lambda k, km, rr: (km[0], 1),
    "debruijn_next_info": lambda k, km, rr: (km[3],),
    "debruijn_prev_info": lambda k, km, rr: (km[3],),
    "debruijn_next_info_batch": lambda k, km, rr: (km[:40],),
    "debruijn_prev_info_batch": lambda k, km, rr: (km[:40], 1),
}
PROPERTIES = ["aindex_loaded", "n_reads", "n_kmers", "reads_size", "max_tf"]


def test_every_public_method_is_a_case():
    public = {n for n, _ in inspect.getmembers(JAIndex) if not n.startswith("_")}
    loaders = {"load", "load_hash", "load_hash_file", "load_13mer_index",
               "load_23mer_index", "load_13mer_aindex", "load_aindex", "load_reads",
               "load_reads_in_memory", "load_reads_index", "load_from_prefix",
               "load_from_prefix_13mer", "load_from_prefix_23mer",
               "load_13mer_index_static", "load_aindex_from_prefix_13mer",
               "load_aindex_from_prefix_23mer", "build_from_sequences", "save", "shard_to",
               "save_values"}
    assert public <= set(METHODS) | set(PROPERTIES) | loaders
    ported = {n for n, _ in inspect.getmembers(TAIndex) if not n.startswith("_")}
    assert public <= ported


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("k", KS)
def test_method(random_reads, k, method):
    t, j = built(k, random_reads)
    args = METHODS[method](k, kmers_of(k, random_reads), random_reads)
    assert outcome(getattr(t, method), *args) == outcome(getattr(j, method), *args)


@pytest.mark.parametrize("prop", PROPERTIES)
@pytest.mark.parametrize("k", KS)
def test_property(random_reads, k, prop):
    t, j = built(k, random_reads)
    assert getattr(t, prop) == getattr(j, prop)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_unloaded(random_reads, method):
    """An AIndex with nothing loaded: tf queries give 0, the rest raise as
    aindex_tpu's does."""
    args = METHODS[method](23, kmers_of(23, random_reads), random_reads)
    assert outcome(getattr(TAIndex(device="cpu"), method), *args) == \
        outcome(getattr(JAIndex(), method), *args)


@pytest.mark.parametrize("k", KS)
def test_save_values(random_reads, tmp_path, k):
    t, j = built(k, random_reads)
    assert t.save_values(str(tmp_path / "t.txt")) == j.save_values(str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


@pytest.mark.parametrize("k", [23, 27, 31])
def test_save_load_round_trip(random_reads, tmp_path, k):
    """save writes aindex_tpu's bytes; load_from_prefix at the index's k
    brings back the same answers (aindex_tpu's loader takes k = 23 only;
    its own index is the reference for the other k)."""
    t, j = built(k, random_reads)
    t.save(str(tmp_path / "t"))
    j.save(str(tmp_path / "j"))
    for ext in (".pf", ".tf.bin", ".kmers.bin", ".index.bin", ".indices.bin", ".reads"):
        assert (tmp_path / f"t{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes(), ext
    back = TAIndex.load_from_prefix(str(tmp_path / "t"), kmer_size=k, load_reads=True,
                                    device="cpu")
    km = kmers_of(k, random_reads)
    want = j if k != 23 else JAIndex.load_from_prefix(str(tmp_path / "j"), load_reads=True)
    for method in ("get_tf_values", "get_positions_batch", "get_sequence_coverage_batch",
                   "debruijn_next_info_batch"):
        args = METHODS[method](k, km, random_reads)
        assert outcome(getattr(back, method), *args) == outcome(getattr(want, method), *args)
    assert back.n_reads == want.n_reads and back.aindex_loaded


def test_golden_reference_prefix():
    """The reference-built p.23 set through load_from_prefix (emphf .pf,
    reference-keyed queries, slot-keyed CSR, reads found by the stripped
    prefix)."""
    prefix = os.path.join(GOLD, "p.23")
    t = TAIndex.load_from_prefix(prefix, load_reads=True, device="cpu")
    j = JAIndex.load_from_prefix(prefix, load_reads=True)
    kmers = [line.split()[0] for line in open(prefix + ".dat")]
    kmers += [jcodec.revcomp(km) for km in kmers]
    for method in ("get_tf_values", "get_positions_batch", "get_hash_values",
                   "get_tf_both_directions_23mer_batch", "debruijn_prev_info_batch"):
        assert outcome(getattr(t, method), kmers) == outcome(getattr(j, method), kmers)
    for km in kmers[:25]:
        for method in ("get_kid_by_kmer", "get_strand", "get_rid2poses", "get_reads_by_kmer"):
            assert outcome(getattr(t, method), km) == outcome(getattr(j, method), km)
    assert t.get_index_info() == j.get_index_info()


def test_error_cases(random_reads):
    t, _ = built(23, random_reads)
    with pytest.raises(ValueError, match="mixed k-mer lengths"):
        t.get_tf_values(["A" * 23, "A" * 13])
    with pytest.raises(ValueError, match="mixed k-mer lengths"):
        t.get_positions_batch(["A" * 23, "A" * 13])
    with pytest.raises(ValueError, match="Only 13-mers and 23-mers"):
        t.get_positions("A" * 21)
    t31, _ = built(31, random_reads)
    with pytest.raises(ValueError, match="Only 13-mers and 23-mers"):
        t31.get_positions("A" * 31)
    assert t.get_tf_value("ACGTN" * 4 + "ACG") == 0 and t["N" * 23] == 0
    # a mesh build shards its sparse index and closes the index's own
    # device path, which then raises (the facade serves the queries)
    tdist.ensure_group(device="cpu")
    s = TAIndex.build_from_sequences(random_reads, build_aindex=False,
                                     mesh=t_make_mesh(1, 1, device_type="cpu"), device="cpu")
    assert s.get_tf_values(["A" * 23]) == t.get_tf_values(["A" * 23])
    with pytest.raises(RuntimeError, match="released by shard_to"):
        s.sparse23.get_tf_values(["A" * 23])
    with pytest.raises(FileNotFoundError, match="auto-detect"):
        TAIndex.load_from_prefix(os.path.join(GOLD, "missing"), device="cpu")


def test_top_level_names():
    """Every name aindex_tpu exports at its top level resolves in
    aindex_torch: code moved from one package to the other imports the
    same names (``from aindex_torch import AindexWrapper, get_revcomp``)."""
    import aindex_torch
    import aindex_tpu
    missing = [name for name in aindex_tpu.__all__ if not hasattr(aindex_torch, name)]
    assert missing == []
    assert set(aindex_tpu.__all__) <= set(aindex_torch.__all__)
    assert aindex_torch.AindexWrapper is aindex_torch.AIndex


def test_get_revcomp():
    """aindex_torch.get_revcomp equals aindex_tpu.get_revcomp on seeded
    strings over ACGT, N, lowercase and the '~' separator, empty and
    one-character strings among them."""
    import aindex_torch
    import aindex_tpu
    rng = np.random.default_rng(16)
    alphabet = np.array(list("ACGTNacgtn~"))
    strings = ["", "A", "N", "n", "~", "ACGT" * 8, "N" * 23, "acgtn" * 5]
    strings += ["".join(alphabet[rng.integers(0, len(alphabet), size=n)])
                for n in rng.integers(0, 160, size=300)]
    assert [aindex_torch.get_revcomp(s) for s in strings] == \
        [aindex_tpu.get_revcomp(s) for s in strings]
