"""Build, load and count the port's hand-written CUDA kernels.

Each ``aindex_torch/csrc/*.cu`` source (with the ``csrc/*.cuh`` headers it
includes) is compiled by ``nvcc`` for ``sm_90a`` into its own shared library with a
plain C interface and loaded with ctypes. Nothing is built or loaded when
this module is imported: the first launch builds every kernel, one ``nvcc``
per source, all started together. Libraries are named by a hash of their
source, every header it includes (followed transitively) and the flags, so
an edited source or header is rebuilt and an unchanged one is reused.

Each C entry launches on the stream it is given (PyTorch's current stream),
allocates nothing and returns ``cudaGetLastError()``; ``Kernel.launch``
raises if that is not 0 and otherwise adds one to the kernel's
``launches`` count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

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
        self.launches = 0
        self.build_log = ""
        self._lib: ctypes.CDLL | None = None

    def library_path(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in _with_headers(self.source):
            with open(path, "rb") as f:
                h.update(f.read())
        return os.path.join(BUILD_DIR, f"{self.name}.{h.hexdigest()[:16]}.so")

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
        self.launches += 1


KERNELS: dict[str, Kernel] = {
    k.name: k for k in (
        # counts, packed, vbits, n_words, stream
        Kernel("count13_packed", "count13.cu", [_P, _P, _P, _LL, _P],
               "aindex_tpu/kernels/count.py:69"),
        # tf, out, stream
        Kernel("total13", "total13.cu", [_P, _P, _P], "aindex_tpu/index/dense13.py:83"),
        # table, width, codes, valid, ascii, n, out, out_rc, stream
        Kernel("gather13", "gather13.cu", [_P, ctypes.c_int, _P, _P, _P, _LL, _P, _P, _P],
               "aindex_tpu/kernels/lookup.py:32"),
        # table, width, packed, vbits, n_words, rows, stride, cutoff, out, stream
        Kernel("coverage13_packed", "coverage13.cu",
               [_P, ctypes.c_int, _P, _P, _LL, _LL, _LL, ctypes.c_uint, _P, _P],
               "aindex_tpu/kernels/coverage.py:32"),
        # packed, vbits, n_words, k, keys_in, n_in, key_bits, keys_out, counts,
        # counters, keys_a, keys_b, idx, start, hist, sums, stream
        Kernel("spectrum23", "spectrum23.cu",
               [_P, _P, _LL, _I, _P, _LL, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
               "aindex_tpu/kernels/spectrum.py:48"),
        # half0, half1, slot0, slot1, m, lb, w, m1a, m1b, m2a, m2b, codes, valid,
        # ascii, k, n, canon, tf, slot, strand, stream
        Kernel("quot23", "quot23.cu",
               [_P, _P, _P, _P, _LL, _I, _I, _ULL, _ULL, _ULL, _ULL, _P, _P, _P, _I, _LL,
                _I, _P, _P, _P, _P],
               "aindex_tpu/index/quotcuckoo.py:310"),
        # half0, half1, m, lb, w, m1a, m1b, m2a, m2b, packed, vbits, n_words, rows,
        # stride, k, cutoff, out, stream
        Kernel("quotcov23", "quotcov23.cu",
               [_P, _P, _LL, _I, _I, _ULL, _ULL, _ULL, _ULL, _P, _P, _LL, _LL, _LL, _I,
                ctypes.c_uint, _P, _P],
               "aindex_tpu/index/quotcuckoo.py:353"),
        # tf, n, offsets, sums, stream
        Kernel("csr_offsets", "csr.cu", [_P, _LL, _P, _P, _P],
               "aindex_tpu/index/positional.py:39"),
        # packed, vbits, n_words, k, off, half0, half1, slot0, slot1, m, lb, w,
        # m1a, m1b, m2a, m2b, n_slots, slot_bits, idx_bits, offsets, cursor,
        # positions, total, counters, keys_a, keys_b, idx, hist, sums, stream
        Kernel("posfill", "posfill.cu",
               [_P, _P, _LL, _I, _LL, _P, _P, _P, _P, _LL, _I, _I, _ULL, _ULL, _ULL, _ULL,
                _LL, _I, _I, _P, _P, _P, _LL, _P, _P, _P, _P, _P, _P, _P],
               "aindex_tpu/index/positional.py:47"),
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
        t0 = time.perf_counter()
        todo = [k for k in KERNELS.values() if k._lib is None]
        if not todo:
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for k in todo:
            out = k.library_path()
            if os.path.exists(out):
                procs.append((k, out, None, None))
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, k.source]
            procs.append((k, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for k, out, tmp, proc in procs:
            if proc is not None:
                log, _ = proc.communicate()
                k.build_log = log.decode(errors="replace")
                if proc.returncode != 0:
                    failed.append(f"{k.name}:\n{k.build_log}")
                    if os.path.exists(tmp):
                        os.remove(tmp)
                    continue
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for k, out, _, _ in procs:
            k._load(out)
        return time.perf_counter() - t0


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
    for k in KERNELS.values():
        k.launches = 0


def launches() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
