"""K6 quot23 (``aindex_torch/csrc/quot23.cu`` on ``probe.cuh``): the
sparse canonical 23-mer codes-in query on the quotient cuckoo table. Each
int64 code is read, canonicalised and probed, and a uint32 answer
written; the reference's logical entry is an 8-byte key and a 4-byte
count a distinct canonical key. Its kernel is ``probe.cuh``'s
``query_kernel`` on ``probe::Buckets``, which K10 (``cuckoo64.cu``)
shares: a configuration names the one it runs (``"kernel"``)."""

from kmerbench.roofline import call_bytes as _call_bytes

PATTERN = r"(^|::)query_kernel<probe::Buckets\b"
ENTRY_BYTES = 12


def call_bytes(stats) -> int:
    return _call_bytes(stats, ENTRY_BYTES)
