#!/usr/bin/env python3
"""Design variants of the packed coverage kernels on one CUDA card, each
beside this tree's and a checkout's kernel, in turns.

    python3 scripts/coverage_variants.py parent=DIR [PART ...]

DIR is a checkout of an earlier commit (``git archive`` of it unpacked
into ``dist/parent``). PART is any of runs, k4, match and sass (all when
none is named):

* runs: this tree's coverage entries of the bucketed engines and the MPHF
  walk (K7 ``quotcov23``, ``cuckoocov64``, ``mphfcov``) built with 1, 2, 4
  and 8 windows a thread (``Buckets::RUN``, ``Mphf::RUN`` of
  csrc/probe.cuh), on chip_smoke.py's corpus indexed at k = 23, 29 and 31;
* k4: a K4 on the tiled front end of csrc/dna23.cuh (``tile_run``; its
  source is written below) with 1, 2 and 4 windows a thread, beside this
  tree's K4 (one thread a window), on u8 and u32 random tables;
* match: the checkout's own K7 and ``cuckoocov64`` with only its bucket
  match rewritten as this tree's selects (``Buckets::match``);
* sass: the local (LDL, STL) and global (LDG, STG) loads and stores of
  each coverage kernel of this tree's and the checkout's ``quotcov23.cu``
  (``cuobjdump -sass``), with ptxas's registers and stack frames.

Each variant's answers equal this tree's on 8 batches of 10,000 rows
(chip_smoke.py ``coverage_batches`` / ``dense_coverage_batches``), then
each kernel is timed twice in turns (first to last, then last to first):
torch.profiler device time a launch over the 8-batch rotation, and CUDA
events over 48 calls on one batch, all through this tree's wrapper.
Exits nonzero without a card.
"""

import collections
import ctypes
import os
import re
import shutil
import subprocess
import sys
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "build", "coverage_variants")
PARTS = ("runs", "k4", "match", "sass")

#: a K4 on the tiled front end: a warp a tile of 32 * RUN windows, each
#: thread's run rolled along the staged words, its table reads together
TILED_K4 = r"""
#include "dna23.cuh"
namespace {
constexpr int RUN = RUN_VALUE;
template <typename T>
__global__ void __launch_bounds__(dna13::BLOCK)
    k4_tiled(const T* __restrict__ table, const unsigned* __restrict__ packed,
             const unsigned char* __restrict__ vbits, long long n_words, long long rows,
             long long stride, long long n_stage, unsigned long long recip, unsigned cutoff,
             unsigned* __restrict__ out) {
  extern __shared__ uint4 stage[];
  dna23::Run<RUN> w;
  const dna23::PackedSource src{packed, vbits, n_words, stride, dna13::K};
  dna23::tile_run(reinterpret_cast<unsigned*>(stage), n_stage, src, rows, recip, &w);
  if (!w.count) return;
  unsigned tf[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) tf[j] = w.ok[j] ? static_cast<unsigned>(table[w.fwd[j]]) : 0u;
#pragma unroll
  for (int j = 0; j < RUN; ++j) tf[j] = tf[j] >= cutoff ? tf[j] : 0u;
  dna23::store_run(out, w.first, w.count, tf);
}
template <typename T>
void launch(const void* table, const void* packed, const void* vbits, long long n_words,
            long long rows, long long stride, unsigned cutoff, void* out, cudaStream_t s) {
  constexpr long long TILE = dna23::tile_outputs<RUN>();
  const long long n_stage = dna23::stage_words<RUN>(stride - dna13::K, dna13::K);
  k4_tiled<T><<<static_cast<unsigned>((rows * (stride - dna13::K) + TILE - 1) / TILE),
                dna13::BLOCK, dna23::stage_bytes(n_stage), s>>>(
      static_cast<const T*>(table), static_cast<const unsigned*>(packed),
      static_cast<const unsigned char*>(vbits), n_words, rows, stride, n_stage,
      dna23::reciprocal(stride - dna13::K), cutoff, static_cast<unsigned*>(out));
}
}  // namespace
DNA13_EXPORT_ERROR_STRING
extern "C" int coverage13_packed(const void* table, int width, const void* packed,
                                 const void* vbits, long long n_words, long long rows,
                                 long long stride, unsigned cutoff, void* out, void* stream) {
  if (rows <= 0 || stride <= dna13::K) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 8: launch<uint8_t>(table, packed, vbits, n_words, rows, stride, cutoff, out, s); break;
    case 32: launch<uint32_t>(table, packed, vbits, n_words, rows, stride, cutoff, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

#: the checkout's bucket match (a loop returning at the first hit) and the
#: same match as selects
LOOP_MATCH = """#pragma unroll
      for (int j = 0; j < BUCKET; ++j) {
        if (r[j].x == lo && (r[j].y & ~MARK) == hi) {
          *tf = r[j].z;
          *ref = static_cast<int>(r[j].w);
          return true;
        }
      }"""
SELECT_MATCH = """bool hit = false;
      unsigned t = 0u, s = 0u;
#pragma unroll
      for (int j = BUCKET - 1; j >= 0; --j) {
        const bool m = r[j].x == lo && (r[j].y & ~MARK) == hi;
        t = m ? r[j].z : t;
        s = m ? r[j].w : s;
        hit |= m;
      }
      if (hit) {
        *tf = t;
        *ref = static_cast<int>(s);
        return true;
      }"""
#: a translation unit of the engines' coverage entries
PROBE_TU = ('#include "probe.cuh"\nDNA13_EXPORT_ERROR_STRING\n'
            "PROBE_COVERAGE_ENTRY(quotcov23, probe::Buckets)\n"
            "PROBE_COVERAGE_ENTRY(cuckoocov64, probe::Buckets)\n"
            "PROBE_COVERAGE_ENTRY(mphfcov, probe::Mphf)\n")


def nvcc(csrc: str, source: str, lib: str) -> str:
    from aindex_torch.kernels import _cuda
    r = subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", csrc, "-o", lib, source],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc {source}:\n{r.stdout}{r.stderr}")
    return r.stdout + r.stderr


def variant(tag: str, csrc: str, edits: list, sources: dict) -> ctypes.CDLL:
    """A copy of ``csrc`` with each (file, old, new) edit made and each
    name -> text source written, built into one library."""
    d = os.path.join(OUT, re.sub(r"\W+", "_", tag))
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, os.path.join(d, "csrc"))
    for name, old, new in edits:
        path = os.path.join(d, "csrc", name)
        with open(path) as f:
            text = f.read()
        edited = re.sub(old, new, text)
        if edited == text:
            raise RuntimeError(f"{tag}: {old!r} not found in {name}")
        with open(path, "w") as f:
            f.write(edited)
    for name, text in sources.items():
        with open(os.path.join(d, "csrc", name), "w") as f:
            f.write(text)
    lib = os.path.join(d, "variant.so")
    log = nvcc(os.path.join(d, "csrc"), os.path.join(d, "csrc", next(iter(sources))), lib)
    regs = re.findall(r"Used (\d+) registers", log)
    stack = re.findall(r"(\d+) bytes stack frame", log)
    print(f"{tag}: registers {regs}, stack frames {stack}")
    return ctypes.CDLL(lib)


def entry(lib, name: str):
    from aindex_torch.kernels import _cuda
    fn = getattr(lib, name)
    fn.argtypes = _cuda.KERNELS[name].argtypes
    fn.restype = ctypes.c_int
    return fn


def side_by_side(card: str, label: str, name: str, fn, n_batches: int, others: dict,
                 reps: int = 48, kernel: tuple = ("coverage",)) -> None:
    """This tree's kernel ``name`` and each of ``others`` (tag -> C entry)
    through this tree's wrapper ``fn(b)``: equal answers on every batch,
    then device time a launch (cold rotation; device kernels named by a
    word of ``kernel``) and warm CUDA events, each twice in turns."""
    import chip_smoke as c
    from aindex_torch.kernels import _cuda
    kern = _cuda.KERNELS[name]
    own = kern._lib
    libs = {"this tree": own}
    for tag, f in others.items():
        libs[tag] = types.SimpleNamespace(**{name: f,
                                             "dna13_error_string": own.dna13_error_string})
    ref = [fn(b) for b in range(n_batches)]
    times = {tag: [] for tag in libs}
    try:
        for tag, lib in libs.items():
            kern._lib = lib
            for b in range(n_batches):
                got = fn(b)
                for x, y in zip(*((v if isinstance(v, tuple) else (v,)) for v in (got, ref[b]))):
                    c.max_abs_err(x, y)
        rotation = [b % n_batches for b in range(reps)]
        for tag in list(libs) + list(libs)[::-1]:
            kern._lib = libs[tag]
            times[tag].append((c.device_ms_per_call(fn, rotation, kernel=kernel)[0],
                               c.cuda_ms(lambda: fn(0), reps)))
    finally:
        kern._lib = own
    for tag, ts in times.items():
        print(f"{name} {label}, {tag}: device cold " + " / ".join(f"{d:.4f}" for d, _ in ts)
              + " ms, warm events " + " / ".join(f"{w:.4f}" for _, w in ts)
              + f" ms ({card})")


def sass_counts(lib: str, words: tuple = ("coverage",)) -> None:
    """Per kernel of ``lib`` whose name holds a word of ``words``: its LDL,
    STL, LDG and STG."""
    from aindex_torch.kernels import _cuda
    cuobjdump = os.path.join(os.path.dirname(_cuda.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    for body in re.split(r"\n\s+Function : ", sass)[1:]:
        name = body.splitlines()[0].strip()
        if not any(word in name for word in words):
            continue
        ops = collections.Counter(m.group(1) for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body))
        print(f"  {name}: {sum(ops.values())} instructions, " + ", ".join(
            f"{op} {ops[op]}" for op in ("LDL", "STL", "LDG", "STG")))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("coverage_variants: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as c
    from aindex_torch import Sparse23Index
    from aindex_torch.kernels import _cuda, probe
    from aindex_torch.kernels.coverage import coverage13_packed
    parents = [a for a in sys.argv[1:] if a.startswith(c.PARENT_ARG)]
    parts = [a for a in sys.argv[1:] if not a.startswith(c.PARENT_ARG)] or list(PARTS)
    if len(parents) != 1 or set(parts) - set(PARTS):
        print(f"usage: coverage_variants.py parent=DIR [{' '.join(PARTS)}]", file=sys.stderr)
        return 2
    c.PARENT = os.path.abspath(parents[0][len(c.PARENT_ARG):])
    parent_csrc = os.path.join(c.PARENT, "aindex_torch", "csrc")
    dev = torch.device("cuda", 0)
    card = c.card_line()
    print(card)
    _cuda.build_all()
    os.makedirs(OUT, exist_ok=True)

    if "sass" in parts:
        for tag, csrc in (("this tree", _cuda.CSRC), ("parent", parent_csrc)):
            lib = os.path.join(OUT, f"sass_{tag.replace(' ', '_')}.so")
            log = nvcc(csrc, os.path.join(csrc, "quotcov23.cu"), lib)
            print(f"{tag} quotcov23.cu: registers {re.findall(r'Used (\d+) registers', log)}, "
                  f"stack frames {re.findall(r'(\d+) bytes stack frame', log)}")
            sass_counts(lib)

    if "k4" in parts:
        batches = c.dense_coverage_batches(dev, np.random.default_rng(7))
        gen = torch.Generator(device=dev).manual_seed(7)
        others = {f"tiled, {run} a thread": entry(variant(
            f"tiled K4 {run}", _cuda.CSRC, [],
            {"k4_tiled.cu": TILED_K4.replace("RUN_VALUE", str(run))}), "coverage13_packed")
            for run in (1, 2, 4)}
        others["parent"] = c.parent_engines(c.PARENT)["coverage13_packed"]
        for dtype, view in ((torch.uint8, None), (torch.int32, torch.uint32)):
            table = torch.randint(0, 64, (c.SPACE,), dtype=dtype, device=dev, generator=gen)
            table = table.view(view) if view is not None else table
            side_by_side(card, f"{table.dtype}, {c.N_SEQ} x {c.READ_LEN + 1}",
                         "coverage13_packed", lambda b: coverage13_packed(table, *batches[b], 0),
                         len(batches), others)
        del batches, table

    runs = {}
    if "runs" in parts:
        for run in (1, 2, 4, 8):
            runs[run] = variant(
                f"engines, {run} a thread", _cuda.CSRC,
                [("probe.cuh", r"static constexpr int RUN = \d+;",
                  f"static constexpr int RUN = {run};")], {"probe_variant.cu": PROBE_TU})
    selects = None
    if "match" in parts:
        selects = variant("parent, bucket match as selects", parent_csrc,
                          [("probe.cuh", re.escape(LOOP_MATCH), SELECT_MATCH.replace("\\", r"\\"))],
                          {"probe_variant.cu": PROBE_TU})
    if runs or selects is not None:
        _, reads = c.scale_corpus(c.COVERAGE, 1)
        blob = c.corpus_blob(reads)
        parent = c.parent_engines(c.PARENT)
        for k, name in ((c.K23, "quotcov23"), (29, "cuckoocov64"), (31, "mphfcov")):
            if not runs and name == "mphfcov":
                continue
            index = Sparse23Index.build_from_blob(blob, k=k, device=dev)
            t = index.tables
            batches = c.coverage_batches(dev, reads, k)
            others = {f"{run} a thread": entry(lib, name) for run, lib in runs.items()}
            if selects is not None and name != "mphfcov":
                others["parent, bucket match as selects"] = entry(selects, name)
            others["parent"] = parent[name]
            side_by_side(card, f"k={k}, {c.N_SEQ} x {c.READ_LEN + 1}", name,
                         lambda b: probe.coverage(t, *batches[b], k, 0, index.rule),
                         len(batches), others)
            del index, t, batches
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
