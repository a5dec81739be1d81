"""K11 mphfwalk (``aindex_torch/csrc/mphfwalk.cu`` on ``probe.cuh``): the
sparse canonical codes-in query on the MPHF walk, the engine of k = 31.
Each int64 code is read, canonicalised, walked to its owner node and
verified against the node record's full key, and a uint32 answer written;
the reference's logical entry is an 8-byte key and a 4-byte count a
distinct canonical key, as for K6: the algorithm's work, not the walk's
g-values and 16-byte node records. Its kernel is ``probe.cuh``'s
``query_kernel`` on ``probe::Mphf``."""

from kmerbench.roofline import call_bytes as _call_bytes

PATTERN = r"(^|::)query_kernel<probe::Mphf\b"
ENTRY_BYTES = 12


def call_bytes(stats) -> int:
    return _call_bytes(stats, ENTRY_BYTES)
