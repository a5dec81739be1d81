"""End-to-end index build pipeline (in-process), the library body of the
CLI's ``compute-aindex``.

Counterpart of aindex_tpu/pipeline/build.py. The reference chains five
separate C++ binaries through the filesystem (reference:
scripts/compute_aindex.py: compute_reads -> kmer_counter ->
compute_mphf_seq -> compute_index -> compute_aindex). Here each phase is a
function call producing the same artifact set, byte for byte as
aindex_tpu's, so a failed phase can be rerun from its input artifacts
(they double as checkpoints):

  <prefix>.reads, .ridx[, .header]      reads preparation
  <prefix>.dat                          text k-mer spectrum (sparse k)
  <prefix>.pf, .tf.bin, .kmers.bin      frequency index
  <prefix>.index.bin, .indices.bin      positional index

The port runs in one process on one device, ``BuildConfig.device``: the
card unless the caller asks for the CPU. The multi-device paths (``mesh``,
``n_devices`` > 1) are not ported yet and raise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time

import numpy as np
from torch.profiler import record_function

from aindex_torch.constants import K13, K23, SPACE_13
from aindex_torch.core import codec
from aindex_torch.core.reads import ReadsStore
from aindex_torch.index.dense13 import Dense13Index
from aindex_torch.index.positional import PositionalIndex
from aindex_torch.index.sparse23 import Sparse23Index, count_canonical_kmers
from aindex_torch.io import fastq as io_fastq
from aindex_torch.kernels.spectrum import merge_spectra
from aindex_torch.pipeline.progress import make_progress

logger = logging.getLogger("aindex_torch.pipeline")

_NO_MESH = ("multi-device builds (mesh, n_devices > 1) are not ported to "
            "aindex_torch yet (multi-GPU, ROADMAP slice 5)")


@dataclasses.dataclass
class BuildConfig:
    """One typed config for the whole pipeline (the reference's settings are
    three uncoordinated layers of globals and argv).

    ``device`` is the one device every phase runs on. ``mesh`` and
    ``n_devices`` > 1 select aindex_tpu's multi-device paths, which are not
    ported: they raise ``NotImplementedError``."""
    prefix: str
    k: int = K23
    min_tf: int = 1
    build_aindex: bool = True
    keep_dat: bool = False
    chunk: int = 1 << 22
    mesh: object | None = None
    n_devices: int | None = None
    progress: bool = False        # live per-phase progress bars / log lines
    profile_dir: str | None = None  # torch.profiler trace output (opt-in)
    dat_path: str | None = None   # pre-computed text spectrum ('kmer\tcount'
    # per line) from an EXTERNAL counter: skips the counting phase, the
    # equivalent of the reference pipeline's jellyfish option (reference:
    # scripts/compute_aindex.py:109-187); any counter that can dump text
    # counts can seed the build
    skip_existing: bool = False   # artifact-gated resume (the reference
    # pipeline gates each stage on its outputs,
    # reference: scripts/compute_aindex.py:185-228)
    device: str = "cuda"

    def check_single_device(self) -> None:
        if self.mesh is not None or (self.n_devices is not None and self.n_devices > 1):
            raise NotImplementedError(_NO_MESH)


def _artifacts_ok(*paths: str, min_size: int = 1) -> bool:
    """True when every artifact exists and is non-trivially sized: the
    gate condition the reference pipeline checks before each stage
    (reference: scripts/compute_aindex.py:185-187,210-212,226-228)."""
    return all(os.path.exists(p) and os.path.getsize(p) >= min_size
               for p in paths)


def prepare_reads(inputs: list[str], read_type: str | None, prefix: str,
                  skip_existing: bool = False) -> ReadsStore:
    """Phase 1: raw input file(s) -> <prefix>.reads + .ridx (+ .header).

    ``inputs`` is any number of files. Exactly two FASTQ files with no
    explicit ``read_type`` are treated as a pair (aindex/cli.py:380-399
    semantics); any other se/fasta/reads list is stream-concatenated into
    one reads set, as the reference pipeline does for comma-separated
    inputs (reference: scripts/compute_aindex.py:125-131). Format is
    sniffed when ``read_type`` is None.
    """
    t0 = time.time()
    if skip_existing and _artifacts_ok(prefix + ".reads", prefix + ".ridx"):
        store = ReadsStore.from_reads_file(prefix + ".reads", prefix + ".ridx")
        logger.info("prepare_reads: resumed from existing artifacts "
                    "(%d reads, %d bytes)", store.n_reads, store.reads_size)
        return store
    if read_type is None:
        fmt = io_fastq.sniff_format(inputs[0])
        if fmt == "fastq":
            read_type = "fastq" if len(inputs) == 2 else "se"
        else:
            read_type = fmt
    if read_type == "fastq":
        if len(inputs) != 2:
            raise ValueError("paired fastq requires exactly two input files "
                             "(use read_type='se' to concatenate singles)")
        io_fastq.compute_reads(inputs[0], inputs[1], read_type, prefix)
    else:
        io_fastq.compute_reads(list(inputs), None, read_type, prefix)
    store = ReadsStore.from_reads_file(prefix + ".reads", prefix + ".ridx")
    logger.info("prepare_reads: %d reads, %d bytes (%.2fs)",
                store.n_reads, store.reads_size, time.time() - t0)
    return store


def save_dat(keys: np.ndarray, counts: np.ndarray, k: int, path: str) -> None:
    """Text spectrum 'kmer\\ttf' sorted by tf desc: the reference counter's
    output format (reference: src/count_kmers.cpp:362-382)."""
    order = np.argsort(counts, kind="stable")[::-1]
    keys, counts = keys[order], counts[order]
    with open(path, "w") as f:
        block = 1 << 16
        for start in range(0, len(keys), block):
            kmers = codec.decode_kmers(keys[start:start + block], k)
            tfs = counts[start:start + block]
            f.write("".join(f"{km}\t{int(tf)}\n" for km, tf in zip(kmers, tfs)))


def load_dat(path: str, k: int, block: int = 1 << 20
             ) -> tuple[np.ndarray, np.ndarray]:
    """Parse a text spectrum ('kmer\\tcount' per line, any order) into
    (codes, counts), the input side of the external-counter option.
    Counts for duplicate canonical forms are merged; non-ACGT rows raise.

    Streamed in blocks of ``block`` lines: a jellyfish-scale dump has
    10^8+ rows, and holding them as Python strings would cost ~100 bytes
    each; per-block encode keeps residency at ~16 bytes/key."""
    parts: list[tuple[np.ndarray, np.ndarray]] = []
    kmers: list[str] = []
    counts: list[int] = []

    def flush():
        if not kmers:
            return
        codes, valid = codec.encode_kmers(kmers, k)
        if not valid.all():
            bad = [km for km, v in zip(kmers, valid) if not v][:3]
            raise ValueError(f"{path}: non-ACGT k-mers (e.g. {bad})")
        canon = codec.canonical_code(codes, k)
        keys, inv = np.unique(canon, return_inverse=True)
        merged = np.zeros(keys.size, dtype=np.uint64)
        np.add.at(merged, inv, np.asarray(counts, dtype=np.uint64))
        parts.append((keys, merged))
        kmers.clear()
        counts.clear()

    with open(path) as f:
        for line in f:
            cols = line.split()
            if not cols:
                continue
            if len(cols) < 2:
                # mirror the non-ACGT validation: a row without a count
                # column is a malformed spectrum, not a zero-tf key
                raise ValueError(
                    f"{path}: spectrum row without a count column: "
                    f"{line.rstrip()!r}")
            kmers.append(cols[0])
            counts.append(int(cols[1]))
            if len(kmers) >= block:
                flush()
    flush()
    if not parts:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    return merge_spectra(parts)


def _phase_progress(cfg: BuildConfig, total: int, label: str):
    return make_progress(total, label, cfg.progress)


def build_dense13(store: ReadsStore, cfg: BuildConfig) -> Dense13Index:
    """Phase 2a (13-mer): dense count -> <prefix>.tf.bin (uint64 x 4^13)."""
    cfg.check_single_device()
    t0 = time.time()
    tf_path = cfg.prefix + ".tf.bin"
    if cfg.skip_existing and _artifacts_ok(tf_path) \
            and os.path.getsize(tf_path) == SPACE_13 * 8:
        index = Dense13Index.load(tf_path, device=cfg.device)
        logger.info("build_dense13: resumed from %s", tf_path)
        return index
    prog = _phase_progress(cfg, store.reads_size, "count 13-mers")
    index = Dense13Index.build_from_blob(
        store.blob, chunk=cfg.chunk, on_progress=prog.step if prog else None,
        device=cfg.device)
    if prog:
        prog.close()
    index.save(tf_path)
    logger.info("build_dense13: %s (%.2fs)", index.stats(), time.time() - t0)
    return index


def build_sparse(store: ReadsStore, cfg: BuildConfig) -> Sparse23Index:
    """Phase 2b (sparse k): canonical count -> MPHF -> .pf/.tf.bin/.kmers.bin."""
    cfg.check_single_device()
    t0 = time.time()
    triple = (cfg.prefix + ".pf", cfg.prefix + ".tf.bin",
              cfg.prefix + ".kmers.bin")
    if cfg.skip_existing and _artifacts_ok(*triple):
        try:
            index = Sparse23Index.load(cfg.prefix, cfg.k, device=cfg.device)
            logger.info("build_sparse: resumed from %s.{pf,tf.bin,kmers.bin}",
                        cfg.prefix)
            return index
        except ValueError as e:  # inconsistent artifacts: rebuild
            logger.warning("build_sparse: stale artifacts (%s); rebuilding", e)
    if cfg.dat_path:
        keys, counts = load_dat(cfg.dat_path, cfg.k)
        logger.info("build_sparse: spectrum from external counter %s "
                    "(%d keys)", cfg.dat_path, len(keys))
    else:
        prog = _phase_progress(cfg, store.reads_size, f"count {cfg.k}-mers")
        keys, counts = count_canonical_kmers(
            store.blob, cfg.k, cfg.chunk, on_progress=prog.step if prog else None,
            device=cfg.device)
        if prog:
            prog.close()
    if cfg.min_tf > 1:
        keep = counts >= cfg.min_tf
        keys, counts = keys[keep], counts[keep]
    if cfg.keep_dat:
        save_dat(keys, counts, cfg.k, cfg.prefix + ".dat")
    index = Sparse23Index.from_spectrum(keys, counts, cfg.k, device=cfg.device)
    index.save(cfg.prefix)
    logger.info("build_sparse: n=%d (%.2fs)", index.n, time.time() - t0)
    return index


def build_positional(store: ReadsStore, index, cfg: BuildConfig) -> PositionalIndex:
    """Phase 3: positional index -> .index.bin + .indices.bin."""
    cfg.check_single_device()
    t0 = time.time()
    idx_path = cfg.prefix + ".index.bin"
    ind_path = cfg.prefix + ".indices.bin"
    if cfg.skip_existing and _artifacts_ok(idx_path, ind_path, min_size=8):
        n_slots = (4 ** K13 if isinstance(index, Dense13Index) else index.n)
        offsets = np.fromfile(ind_path, dtype=np.uint64)
        if len(offsets) == n_slots + 1 and \
                os.path.getsize(idx_path) == int(offsets[-1]) * 8:
            pos = PositionalIndex.load(idx_path, ind_path)
            logger.info("build_positional: resumed from %s", idx_path)
            return pos
        logger.warning("build_positional: stale artifacts; rebuilding")
    prog = _phase_progress(cfg, store.reads_size, "positional index")
    cb = prog.step if prog else None
    if isinstance(index, Dense13Index):
        # the uint32 device table sizes the CSR, as in aindex_tpu, even
        # where the host keeps an exact uint64 table
        pos = PositionalIndex.build_dense13(store.blob, chunk=cfg.chunk, tf=index.tf,
                                            on_progress=cb, device=cfg.device)
    else:
        pos = PositionalIndex.build_sparse23(store.blob, index, chunk=cfg.chunk,
                                             on_progress=cb)
    if prog:
        prog.close()
    with record_function("positional.save"):
        pos.save(cfg.prefix)
    logger.info("build_positional: %d positions (%.2fs)", pos.total,
                time.time() - t0)
    return pos


@contextlib.contextmanager
def _profiled(profile_dir: str | None):
    """A torch.profiler trace of the block (CPU, and the card when there is
    one), written as ``<profile_dir>/build_all.trace.json``; nothing when
    ``profile_dir`` is None."""
    if not profile_dir:
        yield
        return
    import torch
    from torch import profiler
    activities = [profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "build_all.trace.json"))


def build_all(inputs: list[str], cfg: BuildConfig,
              read_type: str | None = None) -> dict:
    """The full pipeline (CLI ``compute-aindex`` equivalent,
    scripts/compute_aindex.py in the reference). With
    ``cfg.skip_existing``, each phase is gated on its output artifacts and
    resumes from them: rerunning a finished build is a no-op. With
    ``cfg.profile_dir``, the whole build runs under a torch.profiler trace
    (view in Perfetto or chrome://tracing); each phase is a
    ``record_function`` range named ``build_all.<phase>``."""
    cfg.check_single_device()
    out_dir = os.path.dirname(cfg.prefix)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with _profiled(cfg.profile_dir):
        with record_function("build_all.reads"):
            store = prepare_reads(inputs, read_type, cfg.prefix,
                                  skip_existing=cfg.skip_existing)
        with record_function("build_all.count"):
            if cfg.k == K13:
                index = build_dense13(store, cfg)
            else:
                index = build_sparse(store, cfg)
        artifacts = {
            "reads": cfg.prefix + ".reads",
            "ridx": cfg.prefix + ".ridx",
            "tf": cfg.prefix + ".tf.bin",
        }
        if cfg.k != K13:
            artifacts["pf"] = cfg.prefix + ".pf"
            artifacts["kmers"] = cfg.prefix + ".kmers.bin"
        if cfg.build_aindex:
            with record_function("build_all.positional"):
                build_positional(store, index, cfg)
            artifacts["index"] = cfg.prefix + ".index.bin"
            artifacts["indices"] = cfg.prefix + ".indices.bin"
    return artifacts
