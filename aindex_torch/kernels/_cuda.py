"""Build, load and count the port's hand-written CUDA kernels.

Each ``aindex_torch/csrc/*.cu`` source (with the ``csrc/*.cuh`` headers it
includes) is compiled by ``nvcc`` for ``sm_90a`` into its own shared library
with a plain C interface and loaded with ctypes; a source may hold several C
entries (K10 and K11 each hold a query, a coverage and a fill entry, K9 a
chunk and a pairs-in entry; K1, K15 and K16 share ``count13.cu``; K2 has its
half-table entry, K3 its half-table, table-length and total entries, K5 its
ASCII spectrum and canonical-windows entries, K7 its ASCII-rows entry), each
a ``Kernel`` of its own with its own count. Nothing is built or loaded when
this module is imported: the first launch builds every library, one ``nvcc``
per source, all started together. Libraries are named by a hash of their
source, every header it includes (followed transitively) and the flags, so
an edited source or header is rebuilt and an unchanged one is reused.

Each C entry launches on the stream it is given (PyTorch's current stream),
allocates nothing and returns ``cudaGetLastError()``; ``Kernel.launch``
raises if that is not 0 and otherwise adds one to the kernel's
``launches`` count, the counter ``launch.<kernel>`` of ``aindex_torch.trace``.
``build_all`` runs in the timed span ``aindex.kernels.compile`` and counts
``kernels.compiled`` (``nvcc`` runs) and ``kernels.loaded`` (libraries).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

from aindex_torch import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_ULL = ctypes.c_ulonglong


def _with_headers(source: str) -> list[str]:
    """``source`` and every ``csrc`` header it includes, transitively, in a
    fixed order (the library name hashes them all)."""
    seen: list[str] = []
    todo = [source]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            text = f.read()
        todo += [os.path.join(CSRC, name.decode()) for name in _INCLUDE.findall(text)
                 if os.path.exists(os.path.join(CSRC, name.decode()))]
    return seen


class Kernel:
    """One C entry point of one CUDA source, with its launch count."""

    def __init__(self, name: str, source: str, argtypes: list, replaces: str):
        self.name = name
        self.source = os.path.join(CSRC, source)
        self.argtypes = argtypes
        self.replaces = replaces
        self.build_log = ""
        self._lib: ctypes.CDLL | None = None
        self._counter = "launch." + name

    @property
    def launches(self) -> int:
        """Launches counted since the last ``reset_launches``."""
        return int(trace.counters().get(self._counter, 0))

    def library_path(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in _with_headers(self.source):
            with open(path, "rb") as f:
                h.update(f.read())
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, f"{stem}.{h.hexdigest()[:16]}.so")

    def _load(self, path: str) -> None:
        lib = ctypes.CDLL(path)
        fn = getattr(lib, self.name)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        lib.dna13_error_string.argtypes = [ctypes.c_int]
        lib.dna13_error_string.restype = ctypes.c_char_p
        self._lib = lib

    def launch(self, *args) -> None:
        """Call the C entry (building every kernel on first use) and raise
        on a nonzero CUDA error code."""
        if self._lib is None:
            build_all()
        rc = getattr(self._lib, self.name)(*args)
        if rc != 0:
            msg = self._lib.dna13_error_string(rc).decode()
            raise RuntimeError(f"CUDA kernel {self.name} failed: error {rc} ({msg})")
        trace.count(self._counter)


# The engine entries of probe.cuh and fill.cuh take the engine as a host
# pointer array p and a host parameter array u (``kernels/probe.py``).
# query: p, u, codes, valid, ascii, k, n, rule, tf, slot, strand, stream
_QUERY_ARGS = [_P, _P, _P, _P, _P, _I, _LL, _I, _P, _P, _P, _P]
# coverage: p, u, packed, vbits, n_words, rows, stride, k, rule, cutoff, out, stream
_COVERAGE_ARGS = [_P, _P, _P, _P, _LL, _LL, _LL, _I, _I, ctypes.c_uint, _P, _P]
# fill: p, u, packed, vbits, n_words, k, off, rule, n_slots, slot_bits, idx_bits,
# offsets, cursor, positions, total, scratch, stream
_FILL_ARGS = [_P, _P, _P, _P, _LL, _I, _LL, _I, _LL, _I, _I, _P, _P, _P, _LL, _P, _P]


def _probe_kernels(query: str, coverage: str, fill: str, source: str,
                   replaces_query: str, replaces_coverage: str,
                   replaces_fill: str) -> list["Kernel"]:
    """The query, coverage and fill entries of one engine's source."""
    return [Kernel(query, source, _QUERY_ARGS, replaces_query),
            Kernel(coverage, source, _COVERAGE_ARGS, replaces_coverage),
            Kernel(fill, source, _FILL_ARGS, replaces_fill)]


KERNELS: dict[str, Kernel] = {
    k.name: k for k in (
        # counts, packed, vbits, n_words, scratch, stream
        Kernel("count13_packed", "count13.cu", [_P, _P, _P, _LL, _P, _P],
               "aindex_tpu/kernels/count.py:69"),
        # counts, codes, valid, n, space, scratch, stream
        Kernel("scatter_count", "count13.cu", [_P, _P, _P, _LL, _LL, _P, _P],
               "aindex_tpu/kernels/count.py:31"),
        # counts, ascii, rows, len, k, space, stream
        Kernel("count13_rows", "count13.cu", [_P, _P, _LL, _LL, _I, _LL, _P],
               "aindex_tpu/kernels/count.py:54"),
        # tf, out, stream
        Kernel("total13", "total13.cu", [_P, _P, _P], "aindex_tpu/index/dense13.py:83"),
        Kernel("total13_half", "total13.cu", [_P, _P, _P], "aindex_tpu/index/dense13.py:83"),
        # table, width, codes, valid, ascii, n, out, out_rc, stream
        Kernel("gather13", "gather13.cu", [_P, ctypes.c_int, _P, _P, _P, _LL, _P, _P, _P],
               "aindex_tpu/kernels/lookup.py:32"),
        # table, width, codes, valid, ascii, n, out, stream
        Kernel("gather13_half", "gather13.cu", [_P, _I, _P, _P, _P, _LL, _P, _P],
               "aindex_tpu/index/dense13.py:103"),
        # table, width, n_table, codes, n, out, stream
        Kernel("gather13_table", "gather13.cu", [_P, _I, _LL, _P, _LL, _P, _P],
               "aindex_tpu/kernels/lookup.py:22"),
        # table, width, n_table, codes, valid, k, n, out, stream
        Kernel("gather13_total", "gather13.cu", [_P, _I, _LL, _P, _P, _I, _LL, _P, _P],
               "aindex_tpu/kernels/lookup.py:39"),
        # table, width, packed, vbits, n_words, rows, stride, cutoff, out, stream
        Kernel("coverage13_packed", "coverage13.cu",
               [_P, ctypes.c_int, _P, _P, _LL, _LL, _LL, ctypes.c_uint, _P, _P],
               "aindex_tpu/kernels/coverage.py:32"),
        # packed, vbits, n_words, k, keys_in, n_in, key_bits, keys_out, counts,
        # counters, scratch, stream
        Kernel("spectrum23", "spectrum23.cu",
               [_P, _P, _LL, _I, _P, _LL, _I, _P, _P, _P, _P, _P],
               "aindex_tpu/kernels/spectrum.py:48"),
        # ascii, rows, len, k, keys_out, counts, counters, scratch, stream
        Kernel("spectrum23_ascii", "spectrum23.cu", [_P, _LL, _LL, _I, _P, _P, _P, _P, _P],
               "aindex_tpu/kernels/spectrum.py:33"),
        # ascii, rows, len, k, keys_out, valid_out, stream
        Kernel("canonical23_ascii", "spectrum23.cu", [_P, _LL, _LL, _I, _P, _P, _P],
               "aindex_tpu/index/sparse23.py:38"),
        Kernel("quot23", "quot23.cu", _QUERY_ARGS, "aindex_tpu/index/quotcuckoo.py:310"),
        Kernel("quotcov23", "quotcov23.cu", _COVERAGE_ARGS,
               "aindex_tpu/index/quotcuckoo.py:353"),
        # p, u, ascii, rows, len, k, out, stream
        Kernel("quotcov23_rows", "quotcov23.cu", [_P, _P, _P, _LL, _LL, _I, _P, _P],
               "aindex_tpu/index/quotcuckoo.py:329"),
        # tf, n, offsets, scratch, stream
        Kernel("csr_offsets", "csr.cu", [_P, _LL, _P, _P, _P],
               "aindex_tpu/index/positional.py:39"),
        Kernel("posfill", "posfill.cu", _FILL_ARGS, "aindex_tpu/index/positional.py:47"),
        *_probe_kernels("cuckoo64", "cuckoocov64", "cuckoofill64", "cuckoo64.cu",
                        "aindex_tpu/index/cuckoo.py:142", "aindex_tpu/index/sparse23.py:172",
                        "aindex_tpu/index/positional.py:205"),
        *_probe_kernels("mphfwalk", "mphfcov", "mphffill", "mphfwalk.cu",
                        "aindex_tpu/kernels/lookup.py:100", "aindex_tpu/index/sparse23.py:172",
                        "aindex_tpu/index/positional.py:205"),
        # g, records, node_lo, n_nodes, n_keys, domain, seed, codes, valid, packed, vbits,
        # n_words, stride, k, canonical, n, fwd_out, out, stream
        Kernel("shardwalk", "shard23.cu",
               [_P, _P, _LL, _LL, _ULL, _ULL, _ULL, _P, _P, _P, _P, _LL, _LL, _I, _I, _LL, _P,
                _P, _P], "aindex_tpu/parallel/query23.py:62"),
        # keys_in, weights_in, weight_bytes, n, lo, hi, key_bits, keys_out, counts_out,
        # counters, scratch, stream
        Kernel("spectrummerge", "merge23.cu", [_P, _P, _I, _LL, _ULL, _ULL, _I, _P, _P, _P, _P, _P],
               "aindex_tpu/kernels/spectrum.py:149"),
        # engine, p, u, rule, packed, vbits, n_words, k, n_slots, m, n_dest, cap, slots,
        # buckets, counters, stream
        Kernel("posbucket", "posbucket.cu",
               [_I, _P, _P, _I, _P, _P, _LL, _I, _LL, _LL, _I, _LL, _P, _P, _P, _P],
               "aindex_tpu/parallel/positional.py:133"),
        # rec, n_src, cols, packed, roff, lo, n_slots, slot_bits, idx_bits, offsets, cursor,
        # positions, total, scratch, stream
        Kernel("posfill_pairs", "posfill.cu",
               [_P, _LL, _LL, _I, _P, _LL, _LL, _I, _I, _P, _P, _P, _LL, _P, _P],
               "aindex_tpu/parallel/positional.py:119"),
    )
}

_build_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of aindex_torch are "
                       "built from source at first use and need the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def build_all() -> float:
    """Build (or reuse) and load every kernel; returns the seconds spent.

    One ``nvcc`` per source, all running at once; a library is written
    under a temporary name and renamed, so concurrent builders never load a
    half-written file."""
    with _build_lock:
        todo = [k for k in KERNELS.values() if k._lib is None]
        if not todo:
            return 0.0
        with trace.span("aindex.kernels.compile", timed=True) as timed:
            _build(todo)
        return timed.seconds


def _build(todo: list[Kernel]) -> None:
    """``build_all``'s work on the kernels not loaded yet."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}   # library path -> (tmp path, nvcc process or None)
    for k in todo:
        out = k.library_path()
        if out in procs:
            continue
        if os.path.exists(out):
            procs[out] = (None, None)
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, k.source]
        procs[out] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT))
        trace.count("kernels.compiled")
    failed = []
    logs = {}
    for out, (tmp, proc) in procs.items():
        if proc is None:
            continue
        log, _ = proc.communicate()
        logs[out] = log.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(out)}:\n{logs[out]}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for k in todo:
        k.build_log = logs.get(k.library_path(), "")
        k._load(k.library_path())
    trace.count("kernels.loaded", len(procs))


def on_cuda(*tensors) -> bool:
    """Which version a wrapper runs: False (the plain PyTorch version) when
    its tensors lie on the CPU, True (the kernel) when they lie on one CUDA
    device. Anything else raises; there is no fallback between the two."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"unsupported device {dev}: aindex_torch runs on cpu or cuda")


def stream(device) -> int:
    """Handle of PyTorch's current stream on ``device``, for a C entry."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def reset_launches() -> None:
    trace.reset("launch.")


def launches() -> dict[str, int]:
    """Each kernel's launches since the last ``reset_launches``."""
    counts = trace.counters()
    return {name: int(counts.get(k._counter, 0)) for name, k in KERNELS.items()}
