"""What a run times: the port through its facade, or the control.

``PortSystem`` builds the configuration's index with
``aindex_torch.AIndex.build_from_sequences`` (the facade's in-process
build) and answers each call through the facade method the configuration
names (``entry``). ``ControlSystem`` puts the reference's count-min sketch
(``reference/control.py``) in the port's place; the benchmark's own runs
never use it.
"""

from __future__ import annotations

import torch

from kmerbench.reference.control import SketchCounts


class PortSystem:
    """The port under test."""

    def __init__(self, config: dict, device: torch.device):
        self.config = config
        self.device = device
        self.index = None
        self._entry = None
        self._sequences = None

    def prepare(self, corpus) -> None:
        """The reads as the strings a user hands to the build."""
        self._sequences = corpus.sequences()

    def build(self) -> None:
        from aindex_torch import AIndex

        sequences, self._sequences = self._sequences, None
        self.index = AIndex.build_from_sequences(sequences, int(self.config["k"]),
                                                 build_aindex=False, device=self.device)
        self._entry = getattr(self.index, self.config["entry"])

    def call(self, codes: torch.Tensor) -> torch.Tensor:
        return self._entry(codes)

    def close(self) -> None:
        self.index = None
        self._entry = None


class ControlSystem:
    """The reference with exactness broken, in the port's place."""

    def __init__(self, config: dict, device: torch.device):
        self.config = config
        self.device = device
        self.sketch = None
        self._reads = None

    def prepare(self, corpus) -> None:
        self._reads = corpus.reads

    def build(self) -> None:
        self.sketch = SketchCounts(self._reads, int(self.config["k"]), self.config["rule"])
        self._reads = None

    def call(self, codes: torch.Tensor) -> torch.Tensor:
        return self.sketch.answers(codes)

    def close(self) -> None:
        self.sketch = None


SYSTEMS = {"port": PortSystem, "control": ControlSystem}
