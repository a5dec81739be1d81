"""aindex_torch: the PyTorch/CUDA port of aindex_tpu for NVIDIA Hopper.

This package holds the dense 13-mer index (``Dense13Index``: counting, the
fused forward + reverse-complement table, batched queries and per-position
coverage) and the sparse canonical 23-mer index (``Sparse23Index``: the
device spectrum, the MPHF and quotient cuckoo builds, verified queries,
coverage and De Bruijn continuations), the positional index
(``PositionalIndex``: the CSR from each k-mer slot to every position of
the k-mer in the reads) and the ``pipeline`` that builds the whole
artifact set from a reads file (``pipeline.build.build_all``, the
``compute-aindex`` body). Each device step is a hand-written
CUDA kernel on a CUDA device and that kernel's plain PyTorch version on the
CPU. It imports torch and numpy only, never JAX or aindex_tpu, which stays
the reference it is tested against.
"""

__version__ = "0.1.0"

from aindex_torch.core.codec import hamming_distance, revcomp  # noqa: E402
from aindex_torch.index.dense13 import Dense13Index  # noqa: E402
from aindex_torch.index.positional import PositionalIndex  # noqa: E402
from aindex_torch.index.sparse23 import Sparse23Index  # noqa: E402

__all__ = ["Dense13Index", "PositionalIndex", "Sparse23Index", "revcomp", "hamming_distance",
           "__version__"]
