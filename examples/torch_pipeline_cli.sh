#!/bin/sh
# End-to-end pipeline via the port's CLI, mirroring the reference's
# `aindex compute-aindex` workflow: the counterpart of pipeline_cli.sh.
# Builds on the card; DEVICE=cpu runs the plain versions on the CPU, and
# PYTHON names the interpreter (default: python).
# Run from the repository root: sh examples/torch_pipeline_cli.sh [PREFIX]
set -e
PREFIX=${1:-${TMPDIR:-/tmp}/aindex_torch_demo/p23}
mkdir -p "$(dirname "$PREFIX")"

"${PYTHON:-python}" -m aindex_torch compute-aindex \
    -i tests/data/test_R1.fastq,tests/data/test_R2.fastq \
    -t fastq -o "$PREFIX" -k 23 --keep-dat --device "${DEVICE:-cuda}"

"${PYTHON:-python}" -m aindex_torch info -p "$PREFIX" --stats --device "${DEVICE:-cuda}"
