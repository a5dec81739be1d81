#!/usr/bin/env python3
"""The two kernels of the staged ASCII front end on one CUDA card:
K7's ASCII-rows entry ``quotcov23_rows`` and K5's ``canonical23_ascii``.

    python3 scripts/ascii_profile.py [parent=DIR]

Builds the kernels and prints, for each kernel on the tiled front end
(csrc/dna23.cuh ``tile_run``: the coverage kernels of ``quotcov23.cu``,
``cuckoo64.cu`` and ``mphfwalk.cu``, the canonical kernel of
``spectrum23.cu``), ptxas's stack frame and the local (LDL, STL) and global
(LDG, STG) loads and stores of its SASS (``cuobjdump -sass``), and the same
for the checkout's ``quotcov23.cu`` and ``spectrum23.cu``. Times random
reads by width (chip_smoke.py ``width_test``: the floors' rates), indexes
chip_smoke.py's corpus at k = 23 (the quotient table), times K7 ``quotcov23``
four ways (chip_smoke.py ``clocks``) on 8 batches of 10,000 corpus reads,
then runs chip_smoke.py ``ascii_front_end``: both kernels held exactly to
their plain versions at the front end's edge shapes, and timed four ways
(``quotcov23_rows`` on the same reads, beside K7 and the random-read
floor; ``canonical23_ascii`` on 8 corpus chunks of 2^22 bytes, beside its
byte bound). Last, ``canonical23_ascii`` built with 2, 4 and 8 windows a
thread (``CANONICAL_RUN`` of csrc/spectrum23.cu) side by side on the same
chunks, in turns. With ``parent=DIR`` (a checkout, e.g. ``git archive`` of
the parent unpacked into ``dist/parent``), every timing has that
checkout's entry beside this tree's, in turns, after equal answers. Exits
nonzero without a card.
"""

import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

#: windows a thread of canonical23_ascii, timed side by side
RUNS = (2, 4, 8)

#: canonical23_ascii with its keys stored through shared memory: each
#: thread writes its run's keys to the warp's slice, and the warp stores the
#: tile's keys with 16-byte stores of consecutive lanes (512 bytes an
#: instruction, where the design's own 16-byte stores of a run lie 8 RUN
#: bytes apart across lanes)
TRANSPOSED = r"""
#include "dna23.cuh"
namespace {
constexpr int RUN = RUN_VALUE;
__global__ void __launch_bounds__(dna13::BLOCK)
    canonical_transposed(dna23::AsciiSource src, long long rows, long long n_stage,
                         unsigned long long recip, unsigned long long* __restrict__ keys,
                         bool* __restrict__ flags) {
  extern __shared__ uint4 stage[];
  unsigned long long* out_s =
      reinterpret_cast<unsigned long long*>(stage) + (threadIdx.x >> 5) * 32 * RUN;
  unsigned* words =
      reinterpret_cast<unsigned*>(reinterpret_cast<unsigned long long*>(stage) + dna13::BLOCK * RUN);
  const long long n = rows * src.width();
  const long long t0 =
      (static_cast<long long>(blockIdx.x) * dna13::BLOCK + (threadIdx.x & ~31)) * RUN;
  if (t0 >= n) return;
  const int lane = threadIdx.x & 31;
  dna23::Run<RUN> w;
  dna23::tile_run(words, n_stage, src, rows, recip, &w);
#pragma unroll
  for (int j = 0; j < RUN; ++j)
    out_s[lane * RUN + j] = w.rc[j] < w.fwd[j] ? w.rc[j] : w.fwd[j];
  if (w.count) {
    unsigned long long bytes = 0;
#pragma unroll
    for (int j = 0; j < RUN; ++j) bytes |= static_cast<unsigned long long>(w.ok[j]) << (8 * j);
    unsigned char* f = reinterpret_cast<unsigned char*>(flags + w.first);
    if (w.count == RUN && RUN == 4) {
      __stcs(reinterpret_cast<unsigned*>(f), static_cast<unsigned>(bytes));
    } else if (w.count == RUN && RUN == 8) {
      __stcs(reinterpret_cast<unsigned long long*>(f), bytes);
    } else {
#pragma unroll
      for (int j = 0; j < RUN; ++j)
        if (j < w.count) __stcs(f + j, static_cast<unsigned char>(w.ok[j]));
    }
  }
  __syncwarp();
  const long long live = n - t0 < 32 * RUN ? n - t0 : 32 * RUN;
  if (live == 32 * RUN) {
#pragma unroll
    for (int i = 0; i < RUN / 2; ++i)
      __stcs(reinterpret_cast<ulonglong2*>(keys + t0) + lane + 32 * i,
             reinterpret_cast<const ulonglong2*>(out_s)[lane + 32 * i]);
  } else {
    for (int i = lane; i < live; i += 32) __stcs(keys + t0 + i, out_s[i]);
  }
}
}  // namespace
DNA13_EXPORT_ERROR_STRING
extern "C" int canonical23_ascii(const void* ascii, long long rows, long long len, int k,
                                 void* keys_out, void* valid_out, void* stream) {
  if (k < 1 || k > 31 || rows < 1 || len < k || rows * (len - k + 1) >= (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr long long TILE = dna23::tile_outputs<RUN>();
  const dna23::AsciiSource src{static_cast<const unsigned char*>(ascii), rows * len, len, k};
  const long long width = src.width();
  const long long n_stage = dna23::stage_words<RUN>(width, k);
  canonical_transposed<<<static_cast<unsigned>((rows * width + TILE - 1) / TILE), dna13::BLOCK,
                         dna23::stage_bytes(n_stage) + dna13::BLOCK * RUN * 8,
                         static_cast<cudaStream_t>(stream)>>>(
      src, rows, n_stage, dna23::reciprocal(width), static_cast<unsigned long long*>(keys_out),
      static_cast<bool*>(valid_out));
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ascii_profile: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as c
    import coverage_variants as v
    from aindex_torch import Sparse23Index
    from aindex_torch.core.reads import blob_chunks
    from aindex_torch.kernels import _cuda
    from aindex_torch.kernels.spectrum import ascii_canonical
    for arg in sys.argv[1:]:
        c.check(arg.startswith(c.PARENT_ARG), f"argument {arg!r} (takes only parent=DIR)")
        c.PARENT = os.path.abspath(arg[len(c.PARENT_ARG):])
    dev = torch.device("cuda", 0)
    card = c.card_line()
    print(card)
    t_start = time.perf_counter()
    print(f"kernels built in {_cuda.build_all():.1f} s")
    words = ("coverage", "canonical", "ascii_windows")
    trees = {"this tree": _cuda.CSRC}
    if c.PARENT is not None:
        c.parent_engines(c.PARENT)
        trees["parent"] = os.path.join(c.PARENT, "aindex_torch", "csrc")
    os.makedirs(v.OUT, exist_ok=True)
    for tree, csrc in trees.items():
        for src in ("quotcov23", "cuckoo64", "mphfwalk", "spectrum23"):
            if tree == "parent" and src in ("cuckoo64", "mphfwalk"):
                continue
            lib = os.path.join(v.OUT, f"sass_{tree.replace(' ', '_')}_{src}.so")
            log = v.nvcc(csrc, os.path.join(csrc, f"{src}.cu"), lib)
            frames = {name: b for name, b in c.stack_frames(log).items()
                      if any(word in name for word in words)}
            print(f"{tree} {src}.cu: stack frames {frames}")
            v.sass_counts(lib, words)
    c.width_test(dev, card)

    _, reads = c.scale_corpus(c.COVERAGE, 1)
    index = Sparse23Index.build_from_blob(c.corpus_blob(reads), k=c.K23, device=dev)
    c.engine_coverage_clocks(card, index, "quotcov23", c.coverage_batches(dev, reads, c.K23))
    c.ascii_front_end(dev, card, reads, index)
    del index
    torch.cuda.empty_cache()

    chunks = [torch.from_numpy(piece).to(dev) for (piece, _), _ in
              zip(blob_chunks(c.corpus_blob(reads), c.K23, c.CHUNK_BYTES), range(c.N_COLD))]
    default = int(re.search(r"constexpr int CANONICAL_RUN = (\d+);",
                            open(os.path.join(_cuda.CSRC, "spectrum23.cu")).read()).group(1))
    others = {f"{run} a thread": v.entry(v.variant(
        f"canonical {run} a thread", _cuda.CSRC,
        [("spectrum23.cu", r"constexpr int CANONICAL_RUN = \d+;",
          f"constexpr int CANONICAL_RUN = {run};")],
        {"canonical_variant.cu": '#include "spectrum23.cu"\n'}), "canonical23_ascii")
        for run in RUNS if run != default}
    for run in (4, 8):
        others[f"keys through shared memory, {run} a thread"] = v.entry(v.variant(
            f"canonical transposed {run}", _cuda.CSRC, [],
            {"canonical_transposed.cu": TRANSPOSED.replace("RUN_VALUE", str(run))}),
            "canonical23_ascii")
    if c.PARENT is not None:
        others["parent"] = c.parent_engines(c.PARENT)["canonical23_ascii"]
    v.side_by_side(card, f"corpus chunks of 2^22 bytes, k={c.K23} (this tree: {default} a thread)",
                   "canonical23_ascii", lambda b: ascii_canonical(chunks[b], c.K23), len(chunks),
                   others, kernel=("canonical", "ascii_windows"))
    print(f"ascii_profile total: {time.perf_counter() - t_start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
