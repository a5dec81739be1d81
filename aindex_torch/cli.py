"""aindex-torch command-line interface (``aindex-torch`` or ``python -m
aindex_torch``).

Counterpart of aindex_tpu/cli.py: the reference CLI's subcommand surface
(aindex/cli.py:1319-1332: generate, build-hash, count, count-direct,
compute-reads, compute-aindex, compute-aindex-direct, compute-index,
reads-to-fasta, version, info, platform, api-docs, plus analyze), every
subcommand in-process. The subcommands that build or load an index take
``--device`` (default ``cuda``: the card, and there the kernels; ``cpu``
runs their plain versions). ``compute-aindex --devices N`` builds on a
``data`` mesh over min(N, world size) ranks (a world of one when the
process has joined no job), and ``--distributed`` joins the job
``torchrun`` started and builds over every rank of it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from aindex_torch.constants import K13, K23, SPACE_13


# ---------------------------------------------------------------------------
# safety validation (aindex/cli.py:23-76 semantics)
# ---------------------------------------------------------------------------

def _check_distinct(inputs: list[str], outputs: list[str]) -> None:
    in_abs = {os.path.abspath(p) for p in inputs if p}
    for out in outputs:
        if out and os.path.abspath(out) in in_abs:
            raise SystemExit(f"error: output path {out!r} is also an input — refusing "
                             f"to overwrite input data")


def _warn_overwrite(paths: list[str]) -> None:
    for p in paths:
        if p and os.path.exists(p):
            print(f"warning: {p} exists and will be overwritten", file=sys.stderr)


def _split_inputs(arg: str) -> list[str]:
    return [p for p in arg.split(",") if p]


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def cmd_compute_reads(args) -> int:
    from aindex_torch.io.fastq import compute_reads
    inputs = _split_inputs(args.input)
    _check_distinct(inputs, [args.output + ".reads", args.output + ".ridx"])
    _warn_overwrite([args.output + ".reads"])
    read_type = args.type
    if read_type is None:
        from aindex_torch.io.fastq import sniff_format
        fmt = sniff_format(inputs[0])
        read_type = ("fastq" if len(inputs) == 2 else "se") if fmt == "fastq" else fmt
    if read_type == "fastq":
        if len(inputs) != 2:
            raise SystemExit("error: paired fastq requires exactly two "
                             "comma-separated inputs")
        result = compute_reads(inputs[0], inputs[1], read_type, args.output)
    else:
        result = compute_reads(inputs, None, read_type, args.output)
    print(f"wrote {result['reads']} ({result['n_reads']} reads), {result['ridx']}")
    return 0


def cmd_count(args) -> int:
    """Count straight off the input files, streaming: sequences feed the
    device in fixed-size chunks and are never materialised as a Python
    list, so a multi-GB FASTQ counts in steady memory."""
    from aindex_torch.io.fastq import iter_sequence_bytes
    inputs = _split_inputs(args.input)

    def pieces():
        for path in inputs:
            yield from iter_sequence_bytes(path)

    if args.kmer_size == K13:
        from aindex_torch.index.dense13 import Dense13Index
        out = args.output if args.output.endswith(".tf.bin") else args.output + ".tf.bin"
        _check_distinct(inputs, [out])
        index = Dense13Index.build_from_stream(pieces(), device=args.device)
        index.save(out)
        s = index.stats()
        print(f"wrote {out}: {s['non_zero_kmers']} distinct 13-mers, "
              f"total {s['total_count']}")
    else:
        from aindex_torch.index.sparse23 import count_canonical_kmers_stream
        from aindex_torch.pipeline.build import save_dat
        out = args.output if args.output.endswith(".dat") else args.output + ".dat"
        _check_distinct(inputs, [out])
        keys, counts = count_canonical_kmers_stream(pieces(), args.kmer_size,
                                                    device=args.device)
        if args.min_count > 1:
            keep = counts >= args.min_count
            keys, counts = keys[keep], counts[keep]
        save_dat(keys, counts, args.kmer_size, out)
        print(f"wrote {out}: {len(keys)} distinct canonical {args.kmer_size}-mers")
    return 0


def cmd_build_hash(args) -> int:
    import numpy as np
    from aindex_torch.core import codec
    from aindex_torch.index.mphf import MPHF
    if args.kmer_size == K13 and not args.force:
        print("13-mer mode is code-indexed (the 2-bit k-mer code is the "
              "slot id) — no hash needed. Use --force to build one anyway.")
        return 0
    kmers = []
    with open(args.input) as f:
        for line in f:
            km = line.split()[0].strip()
            if km:
                kmers.append(km)
    codes, valid = codec.encode_kmers(kmers, args.kmer_size)
    if not valid.all():
        raise SystemExit("error: kmers file contains non-ACGT entries")
    out = args.output if args.output.endswith(".pf") else args.output + ".pf"
    _check_distinct([args.input], [out])
    mphf = MPHF.build(np.unique(codes))
    mphf.save(out)
    print(f"wrote {out}: MPHF over {mphf.n} keys (domain {mphf.domain})")
    return 0


def cmd_generate(args) -> int:
    import numpy as np
    from aindex_torch.core import codec
    n = SPACE_13
    if args.binary:
        with open(args.output, "wb") as f:
            f.write(b"KMR3")
            np.arange(n, dtype=np.uint32).tofile(f)
    else:
        with open(args.output, "w") as f:
            block = 1 << 16
            for start in range(0, n, block):
                codes = np.arange(start, min(start + block, n), dtype=np.uint64)
                f.write("\n".join(codec.decode_kmers(codes, K13)))
                f.write("\n")
    print(f"wrote {args.output}: all {n} 13-mers in code order")
    return 0


def cmd_compute_index(args) -> int:
    import numpy as np
    from aindex_torch.core import codec
    from aindex_torch.index.sparse23 import Sparse23Index
    kmers, counts = [], []
    with open(args.dat) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            kmers.append(parts[0])
            counts.append(int(parts[1]) if len(parts) > 1 and not args.mock_dat else 0)
    k = len(kmers[0]) if kmers else K23
    codes, valid = codec.encode_kmers(kmers, k)
    if not valid.all():
        raise SystemExit("error: .dat contains non-ACGT k-mers")
    index = Sparse23Index.from_spectrum(
        np.asarray(codes), np.asarray(counts, dtype=np.uint64), k, device=args.device)
    index.save(args.output)
    print(f"wrote {args.output}.pf/.tf.bin/.kmers.bin: {index.n} slots (k={k})")
    return 0


def cmd_compute_aindex(args) -> int:
    from aindex_torch.pipeline.build import BuildConfig, build_all
    inputs = _split_inputs(args.input)
    _check_distinct(inputs, [args.output + ".reads"])
    cfg = BuildConfig(prefix=args.output, k=args.kmer_size,
                      min_tf=args.min_count, build_aindex=not args.no_aindex,
                      keep_dat=args.keep_dat,
                      n_devices=getattr(args, "devices", None),
                      progress=getattr(args, "progress", False),
                      profile_dir=getattr(args, "profile_dir", None),
                      skip_existing=getattr(args, "skip_existing", False),
                      dat_path=getattr(args, "dat", None), device=args.device)
    if getattr(args, "distributed", False):
        import torch
        from aindex_torch.parallel import distributed
        distributed.initialize(device=args.device)
        distributed.ensure_group(device=args.device)  # outside a job: a world of one
        cfg.mesh = distributed.global_mesh(device_type=torch.device(args.device).type)
    artifacts = build_all(inputs, cfg, read_type=args.type)
    print("pipeline complete:")
    for name, path in artifacts.items():
        size = os.path.getsize(path) if os.path.exists(path) else 0
        print(f"  {name:8s} {path} ({size} bytes)")
    return 0


def cmd_reads_to_fasta(args) -> int:
    from aindex_torch.io.fastq import reads_to_fasta
    _check_distinct([args.input], [args.output])
    n = reads_to_fasta(args.input, args.output)
    print(f"wrote {args.output}: {n} records")
    return 0


def cmd_analyze(args) -> int:
    """Standalone k-mer analysis report: argument plumbing over
    aindex_torch.analysis (the equivalent of the reference's
    analyze_kmers.py; see that module for record/summary semantics)."""
    from aindex_torch.analysis import analyze_kmers, write_report
    from aindex_torch.io.fastq import read_sequences

    inputs = _split_inputs(args.input)
    _check_distinct(inputs, [args.output, args.output + ".summary"])
    seqs = []
    for path in inputs:
        seqs.extend(read_sequences(path))
    analysis = analyze_kmers(seqs, args.kmer_size, args.min_count)
    write_report(analysis, args.output)
    print(f"Analysis completed. Found {len(analysis.keys)} unique k-mers.")
    print(f"Results saved to: {args.output}")
    print(f"Summary saved to: {args.output}.summary")
    return 0


def cmd_info(args) -> int:
    from aindex_torch.api import AIndex
    index = AIndex.load_from_prefix(args.prefix, load_aindex=True,
                                    load_reads=args.reads, device=args.device)
    print(index.get_index_info())
    if args.stats:
        stats = (index.get_13mer_statistics() if index.dense13 is not None
                 else index.get_23mer_statistics())
        print(json.dumps(stats, indent=2))
    if args.coverage:
        index.print_and_set_coverage(args.coverage)
    if args.save_values:
        zeros, ones, other = index.save_values(args.save_values,
                                               not args.keep_zeros)
        print(f"\tZeros: {zeros}\n\tOnes: {ones}\n\tOther: {other}")
        print(f"values saved to: {args.save_values}")
    return 0


def cmd_platform(args) -> int:
    import torch
    print(f"torch {torch.__version__}")
    print(f"CUDA: {torch.version.cuda or 'none'} "
          f"({'available' if torch.cuda.is_available() else 'not available'})")
    for i in range(torch.cuda.device_count()):
        print(f"  {i}: {torch.cuda.get_device_name(i)} (cuda)")
    return 0


def cmd_version(args) -> int:
    from aindex_torch import __version__
    print(__version__)
    return 0


def cmd_api_docs(args) -> int:
    from aindex_torch.api import AIndex
    print(AIndex.__doc__)
    for name in sorted(dir(AIndex)):
        if name.startswith("_"):
            continue
        member = getattr(AIndex, name)
        doc = (member.__doc__ or "").strip().split("\n")[0]
        print(f"  {name}: {doc}")
    return 0


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="aindex-torch",
        description="k-mer index on a CUDA card: build and query pipelines.")
    sub = parser.add_subparsers(dest="command")
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda",
                     help="device of the index: cuda (the default; the card and "
                          "its kernels) or cpu")

    p = sub.add_parser("compute-reads", help="FASTQ/FASTA/plain -> .reads + .ridx")
    p.add_argument("-i", "--input", required=True,
                   help="comma-separated input file list (exactly two for "
                        "paired FASTQ; others concatenate)")
    p.add_argument("-t", "--type", choices=["fastq", "se", "fasta", "reads"],
                   default=None, help="input type (sniffed when omitted)")
    p.add_argument("-o", "--output", required=True, help="output prefix")
    p.set_defaults(func=cmd_compute_reads)

    p = sub.add_parser("count", parents=[dev], help="count k-mers -> .tf.bin (k=13) or .dat")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-k", "--kmer-size", type=int, default=K23)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--min-count", type=int, default=1)
    p.set_defaults(func=cmd_count)

    p = sub.add_parser("count-direct", parents=[dev],
                       help="alias of count (in-process engine needs no staging)")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-k", "--kmer-size", type=int, default=K13)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--min-count", type=int, default=1)
    p.set_defaults(func=cmd_count)

    p = sub.add_parser("build-hash", help="k-mers file -> .pf MPHF")
    p.add_argument("-i", "--input", required=True, help="text file of k-mers")
    p.add_argument("-k", "--kmer-size", type=int, default=K23)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--force", action="store_true",
                   help="build an MPHF even for the code-indexed 13-mer mode")
    p.set_defaults(func=cmd_build_hash)

    p = sub.add_parser("generate", help="emit all 4^13 13-mers in code order")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--binary", action="store_true")
    p.set_defaults(func=cmd_generate)

    p = sub.add_parser("compute-index", parents=[dev], help=".dat spectrum -> sparse index artifacts")
    p.add_argument("-d", "--dat", required=True)
    p.add_argument("-o", "--output", required=True, help="output prefix")
    p.add_argument("--mock-dat", action="store_true",
                   help="input has k-mers only, no counts")
    p.set_defaults(func=cmd_compute_index)

    p = sub.add_parser("compute-aindex", parents=[dev], help="full pipeline: input -> all artifacts")
    p.add_argument("-i", "--input", required=True,
                   help="comma-separated input file list (exactly two for "
                        "paired FASTQ; others concatenate)")
    p.add_argument("-t", "--type", choices=["fastq", "se", "fasta", "reads"],
                   default=None)
    p.add_argument("-o", "--output", required=True, help="output prefix")
    p.add_argument("-k", "--kmer-size", type=int, default=K23)
    p.add_argument("--min-count", type=int, default=1)
    p.add_argument("--no-aindex", action="store_true",
                   help="skip the positional index phase")
    p.add_argument("--keep-dat", action="store_true",
                   help="also write the text .dat spectrum (sparse mode)")
    p.add_argument("--dat", default=None, metavar="FILE",
                   help="seed the sparse build from an EXTERNAL counter's "
                        "text spectrum (kmer<TAB>count per line) instead of "
                        "counting — the reference pipeline's jellyfish "
                        "option, counter-agnostic")
    p.add_argument("--devices", type=int, default=None,
                   help="build on a data-parallel mesh over min(N, world size) ranks "
                        "(one rank a device; a world of one outside a torchrun job)")
    p.add_argument("--distributed", action="store_true",
                   help="join the torchrun job (MASTER_ADDR, MASTER_PORT, RANK, "
                        "WORLD_SIZE, LOCAL_RANK) and build over every rank's device; "
                        "run as torchrun --nproc-per-node N -m aindex_torch "
                        "compute-aindex ... --distributed")
    p.add_argument("--progress", action="store_true",
                   help="live per-phase progress (bar on a TTY, log lines "
                        "otherwise)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the build here")
    p.add_argument("--skip-existing", action="store_true",
                   help="resume: skip phases whose output artifacts exist "
                        "and validate")
    p.set_defaults(func=cmd_compute_aindex)

    p = sub.add_parser("compute-aindex-direct", parents=[dev],
                       help="13-mer pipeline straight from input")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-t", "--type", default=None)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--min-count", type=int, default=1)
    p.set_defaults(func=lambda a: cmd_compute_aindex(argparse.Namespace(
        input=a.input, type=a.type, output=a.output, kmer_size=K13,
        min_count=a.min_count, no_aindex=False, keep_dat=False, device=a.device)))

    p = sub.add_parser("analyze", help="standalone k-mer analysis report "
                       "(counts + per-occurrence positions + summary)")
    p.add_argument("-i", "--input", required=True,
                   help="comma-separated FASTA/FASTQ/plain input files")
    p.add_argument("-k", "--kmer-size", type=int, default=K23)
    p.add_argument("-o", "--output", default="kmers_analysis.txt")
    p.add_argument("--min-count", type=int, default=1)
    p.set_defaults(func=cmd_analyze)

    p = sub.add_parser("reads-to-fasta", help=".reads -> FASTA")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(func=cmd_reads_to_fasta)

    p = sub.add_parser("info", parents=[dev], help="describe the artifacts at a prefix")
    p.add_argument("-p", "--prefix", required=True)
    p.add_argument("--stats", action="store_true")
    p.add_argument("--coverage", type=int, metavar="N",
                   help="print the coverage profile histogram + Z/U/D/T/C/M "
                        "summary (reference print_and_set_coverage)")
    p.add_argument("--save-values", metavar="FILE",
                   help="slot-ordered kmer\\ttf text dump (reference "
                        "save_values)")
    p.add_argument("--keep-zeros", action="store_true",
                   help="include zero-tf slots in --save-values")
    p.add_argument("--reads", action="store_true", help="also load reads")
    p.set_defaults(func=cmd_info)

    p = sub.add_parser("platform", help="torch, CUDA and device info")
    p.set_defaults(func=cmd_platform)

    p = sub.add_parser("version", help="print version")
    p.set_defaults(func=cmd_version)

    p = sub.add_parser("api-docs", help="print the AIndex API summary")
    p.set_defaults(func=cmd_api_docs)

    return parser


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "func", None):
        parser.print_help()
        return 1
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
