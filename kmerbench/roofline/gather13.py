"""K3 gather13 (``aindex_torch/csrc/gather13.cu``): the dense 13-mer
codes-in total query. Each int32 code is read, its fwd + rc total looked
up, and a uint32 answer written; the reference's logical entry is one
4-byte count a distinct code."""

from kmerbench.roofline import call_bytes as _call_bytes

PATTERN = r"(^|::)gather13_kernel<"
ENTRY_BYTES = 4


def call_bytes(stats) -> int:
    return _call_bytes(stats, ENTRY_BYTES)
