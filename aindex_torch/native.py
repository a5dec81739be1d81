"""ctypes bridge to the repository's native host runtime.

The C++ source ``native/aindex_host.cpp`` (shared with aindex_tpu) holds
the serial host phases: MPHF peeling, quotient-cuckoo insertion and reads
preparation. This module compiles it with ``g++`` at first use into
``build/native/`` (git-ignored; the source directory is never written),
under a name hashed from the source and the flags, and loads it with
ctypes. Only the entries that aindex_torch calls are bound:
``mphf_try_build``, ``quot_build`` and the ``compute_reads_*`` family.

Nothing is built when this module is imported. A library is written under
a temporary name and renamed, so concurrent builders (test workers) never
load a half-written file. A failed build raises: callers at main-path
sizes need the native code and must not fall back to the pure-Python
peel or insertion, which would run for hours at millions of keys.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_REPO, "native", "aindex_host.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "native")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread", "-shared")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64
_I32 = ctypes.c_int32

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _configure(lib: ctypes.CDLL) -> None:
    lib.mphf_try_build.restype = _I32
    lib.mphf_try_build.argtypes = [_P, _I64, _U64, _U64, _P, _P]
    lib.quot_build.restype = _I32
    lib.quot_build.argtypes = [_P, _P, _P, _I64, _U64, _I32, _I32,
                               _U64, _U64, _U64, _U64, _P, _P]
    lib.compute_reads_fastq.restype = _I64
    lib.compute_reads_fastq.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.c_char_p]
    lib.compute_reads_fasta.restype = _I64
    lib.compute_reads_fasta.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.compute_reads_plain.restype = _I64
    lib.compute_reads_plain.argtypes = [ctypes.c_char_p, ctypes.c_char_p, _I32]


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libaindex_host.{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless a build of this source exists; returns
    its path. Raises when no C++ compiler is found or the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found: aindex_torch builds "
                           "native/aindex_host.cpp at first use for the MPHF "
                           "and quotient-cuckoo builds and compute_reads")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _configure(lib)
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built or can be built here (builds it)."""
    try:
        get_lib()
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return False
    return True


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def mphf_try_build(keys: np.ndarray, seed: int, domain: int
                   ) -> tuple[np.ndarray, np.ndarray] | None:
    """One seed trial of hypergraph peeling: (g uint8[3*domain] with 3 =
    unassigned, owner int64[n] = the node that owns each key), or None
    when the trial does not peel."""
    lib = get_lib()
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    g = np.empty(3 * domain, dtype=np.uint8)
    owner = np.empty(len(keys), dtype=np.int64)
    ok = lib.mphf_try_build(_ptr(keys), len(keys), seed, domain, _ptr(g), _ptr(owner))
    return (g, owner) if ok else None


def quot_build(keys: np.ndarray, tf: np.ndarray, slot: np.ndarray, m: int,
               lb: int, w: int, mults: tuple[int, int, int, int]
               ) -> tuple[np.ndarray, np.ndarray] | None:
    """Quotient-cuckoo insertion: (fp_tf uint32[2m, 2], slot int32[2m]), or
    None on an eviction cycle (the caller re-derives multipliers or grows
    the table). The layout is index/quotcuckoo.py's."""
    lib = get_lib()
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    tf = np.ascontiguousarray(tf, dtype=np.uint32)
    slot = np.ascontiguousarray(slot, dtype=np.int32)
    fp_tf = np.empty((2 * m, 2), dtype=np.uint32)
    slot_col = np.empty(2 * m, dtype=np.int32)
    ok = lib.quot_build(_ptr(keys), _ptr(tf), _ptr(slot), len(keys), m, lb, w,
                        *(int(x) for x in mults), _ptr(fp_tf), _ptr(slot_col))
    return (fp_tf, slot_col) if ok else None


def compute_reads_native(input1: str, input2: str | None, read_type: str,
                         output_prefix: str) -> int | None:
    """Native reads preparation (reference: src/compute_reads.cpp);
    returns the number of reads, or None for a combination the native
    reader does not take (the caller then uses the Python reader)."""
    lib = get_lib()
    if read_type == "fastq":
        if not input2:
            return None
        n = lib.compute_reads_fastq(input1.encode(), input2.encode(),
                                    output_prefix.encode())
    elif read_type == "se":
        n = lib.compute_reads_fastq(input1.encode(), None, output_prefix.encode())
    elif read_type == "fasta":
        n = lib.compute_reads_fasta(input1.encode(), output_prefix.encode())
    elif read_type == "reads":
        copy = int(os.path.abspath(input1) != os.path.abspath(output_prefix + ".reads"))
        n = lib.compute_reads_plain(input1.encode(), output_prefix.encode(), copy)
    else:
        return None
    return int(n) if n >= 0 else None
