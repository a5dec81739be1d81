"""The read set of a configuration, made from the seed on the device.

A frozen copy of the recipe of ``scripts/make_scale_corpus.py`` (and
``chip_smoke.py``'s ``scale_corpus``), drawn with a ``torch.Generator`` on
the run's device in a few large calls: a uniform random genome of
``genome_bp`` bases, ``int(genome_bp * coverage / read_len)`` reads of
``read_len`` bases starting uniformly in ``[0, genome_bp - read_len)``, on
the forward strand, and each base replaced with probability ``error_rate``
by a uniform random base (which may be the same one).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

#: the ASCII letter of each base code, and the byte that ends a read
ASCII = b"ACGT"
NEWLINE = 10
#: reads turned into letters at a time (bounds the temporaries)
BLOCK_ROWS = 1 << 16


def generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` for one named use of the run's seed; any
    whole number is a seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + stream * 0xD1B54A32D192ED03) % (1 << 64))
    return g


@dataclass
class Corpus:
    genome: torch.Tensor   # uint8 [genome_bp], bases 0-3
    reads: torch.Tensor    # uint8 [n_reads, read_len], bases 0-3

    def sequences(self) -> list[str]:
        """The reads as ASCII strings, as a user hands them to the index:
        the letters and line ends made on the reads' device, one copy to
        the host, one split."""
        rows, length = self.reads.shape
        letters = torch.tensor(list(ASCII), dtype=torch.uint8, device=self.reads.device)
        text = torch.full((rows, length + 1), NEWLINE, dtype=torch.uint8,
                          device=self.reads.device)
        for lo in range(0, rows, BLOCK_ROWS):
            block = self.reads[lo:lo + BLOCK_ROWS].to(torch.int64)
            text[lo:lo + BLOCK_ROWS, :length] = letters[block]
        return text.cpu().numpy().tobytes().decode("ascii").split("\n")[:-1]


def make_corpus(config: dict, seed: int, device: torch.device, stream: int = 0) -> Corpus:
    """The configuration's genome and reads for ``seed``; another ``stream``
    makes another genome and its reads by the same recipe."""
    genome_bp, read_len = int(config["genome_bp"]), int(config["read_len"])
    n_reads = int(genome_bp * float(config["coverage"]) / read_len)
    g = generator(seed, stream, device)
    genome = torch.randint(0, 4, (genome_bp,), generator=g, device=device, dtype=torch.uint8)
    starts = torch.randint(0, genome_bp - read_len, (n_reads,), generator=g, device=device)
    at = starts[:, None] + torch.arange(read_len, device=device)
    reads = genome[at]
    del at
    errors = torch.rand((n_reads, read_len), generator=g, device=device) < float(config["error_rate"])
    subs = torch.randint(0, 4, (n_reads, read_len), generator=g, device=device, dtype=torch.uint8)
    reads = torch.where(errors, subs, reads)
    return Corpus(genome, reads)
