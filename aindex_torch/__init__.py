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

``AIndex`` (api.py) is the user-facing facade over all of them, and
``aindex-torch`` / ``python -m aindex_torch`` (cli.py) the command line.
``parallel`` holds the multi-device paths on ``torch.distributed``: the
data-parallel builds and the node-sharded query engine over a (data,
index) device mesh.
"""

__version__ = "0.1.0"

from aindex_torch.api import AIndex  # noqa: E402
from aindex_torch.core.codec import hamming_distance, revcomp  # noqa: E402
from aindex_torch.index.dense13 import Dense13Index  # noqa: E402
from aindex_torch.index.positional import PositionalIndex  # noqa: E402
from aindex_torch.index.sparse23 import Sparse23Index  # noqa: E402

#: aindex_tpu's top-level names: the reference's pybind name
#: (``from aindex_cpp import AindexWrapper``) for the facade, and
#: ``get_revcomp`` for ``revcomp``
AindexWrapper = AIndex
get_revcomp = revcomp

__all__ = ["AIndex", "AindexWrapper", "Dense13Index", "PositionalIndex", "Sparse23Index",
           "get_revcomp", "revcomp", "hamming_distance", "__version__"]
