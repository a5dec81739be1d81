"""Global constants for aindex_torch (copied from aindex_tpu.constants).

Encoding convention matches the reference (A=00, C=01, G=10, T=11;
reference: src/kmers.hpp:15-20) so that k-mer integer codes are
directly comparable across implementations.
"""

# 2-bit nucleotide codes (A=0, C=1, G=2, T=3).
CODE_A = 0
CODE_C = 1
CODE_G = 2
CODE_T = 3

ALPHABET = "ACGT"

# Dense 13-mer mode: the complete k-mer space is indexed directly by the
# 2-bit code of the k-mer (no MPHF needed on the device; cf. SURVEY.md section 7.1).
K13 = 13
SPACE_13 = 4**K13  # 67,108,864
# The half total table: a fwd+rc total at one code of each reverse-complement
# pair (kernels/encode.py half_index13; no 13-mer is its own reverse complement).
HALF_13 = SPACE_13 // 2  # 33,554,432

# Sparse canonical 23-mer mode.
K23 = 23
MASK_23 = (1 << 46) - 1  # 46-bit mask used by De Bruijn extensions
                         # (reference: src/debrujin.cpp:34-37)

# Characters that terminate / invalidate a k-mer window inside the reads
# blob: newline separates reads, '~' separates paired subreads, 'N'/other
# letters are undetermined bases (reference: src/hash.cpp:1006-1012).
SEPARATOR = "~"
READ_TERMINATOR = "\n"

# Sentinel code for invalid bases in host/device base-code arrays.
INVALID_CODE = 255

# File-format defaults (mirrors the reference artifact set, README.md:810-821).
SUFFIX_READS = ".reads"
SUFFIX_RIDX = ".ridx"
SUFFIX_HEADER = ".header"
SUFFIX_PF = ".pf"
SUFFIX_TF = ".tf.bin"
SUFFIX_KMERS_BIN = ".kmers.bin"
SUFFIX_INDEX = ".index.bin"
SUFFIX_INDICES = ".indices.bin"
SUFFIX_DAT = ".dat"

# On-disk tf widths: the reference writes uint64 for the dense 13-mer table
# (reference: src/count_kmers13.cpp:368-378) and uint32 per MPHF slot for
# the sparse 23-mer table (reference: src/compute_index.cpp:59-67). We
# standardise on those widths (resolving the reference's own uint32/uint64
# mismatch at src/compute_aindex13.cpp:46-47 in favour of uint64).
TF13_DTYPE = "uint64"
TF23_DTYPE = "uint32"
