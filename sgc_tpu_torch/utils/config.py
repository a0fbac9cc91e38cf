"""Experiment configuration (the counterpart of sgc_tpu/utils/config.py).

``CitationConfig`` is the citation CLI's configuration; ``tuned=True``
overrides its fields from the port's own copy of the tuned table,
``sgc_tpu_torch/configs/tuned.json``, as the reference's ``--tuned``
does with its file.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

_TUNED_PATH = Path(__file__).resolve().parent.parent / "configs" / "tuned.json"


def load_tuned(family: str, dataset: str) -> dict:
    """Tuned hyperparameters for (family, dataset); {} if absent."""
    with open(_TUNED_PATH) as f:
        table = json.load(f)
    return table.get(family, {}).get(dataset, {})


@dataclasses.dataclass
class CitationConfig:
    dataset: str = "cora"
    seed: int = 42
    epochs: int = 100
    lr: float = 0.2
    weight_decay: float = 5e-6
    hidden: int = 0
    dropout: float = 0.0
    model: str = "SGC"
    normalization: str = "AugNormAdj"
    degree: int = 2
    tuned: bool = False

    def resolve(self) -> "CitationConfig":
        """Apply the tuned table's fields (in place) when ``tuned``."""
        if self.tuned:
            family = "gcn" if self.model == "GCN" else "citation"
            for k, v in load_tuned(family, self.dataset).items():
                setattr(self, k, v)
        return self
