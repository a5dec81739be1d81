"""``foreign``: the ``reads`` draw over a sample of reads of which the
share ``foreign_share`` comes from a second genome, made from the seed by
the configuration's own recipe on another stream, and the rest from the
configuration's read set. Nearly every key of a foreign read is absent
from the index, so the cell holds the engine to answering 0 for a key it
does not hold; the native reads keep answers that differ from call to
call."""

from __future__ import annotations

import torch

from kmerbench import traffic
from kmerbench.corpus import Corpus, make_corpus

#: the seed's stream of the second genome (the corpus is stream 0, the
#: pool's batches 1 up)
STREAM = 1 << 20


def make_pool(mix: dict, corpus: Corpus, config: dict, seed: int, device) -> list[torch.Tensor]:
    share = float(mix["foreign_share"])
    if not 0.0 < share <= 1.0:
        raise ValueError(f"foreign_share {share} is not in (0, 1]")
    other = make_corpus(config, seed, device, stream=STREAM)
    native = round(other.reads.shape[0] * (1.0 - share) / share)
    # a corpus's reads start at uniform positions in no order, so its first
    # rows are a uniform sample of them
    sample = Corpus(other.genome, torch.cat([other.reads, corpus.reads[:native]]))
    params = {key: value for key, value in mix.items() if key != "foreign_share"}
    return traffic.make_pool({**params, "source": "reads"}, sample, config, seed, device)
