"""The word-embedding store (the counterpart of the store functions of
sgc_tpu/textgraph/embedding.py): a word -> vector map persisted as one
``.npz`` whose keys are the words. ``build_graph --embeddings`` reads it
(cosine + PMI word-word weights, ``TextGraphBuilder(embeddings=...)``).
The embedders that write it are not ported yet (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def save_embedding_map(path: str | Path, table: dict[str, np.ndarray]) -> None:
    """Persist a word->vector map (compressed npz)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **{w: np.asarray(v) for w, v in table.items()})


def load_embedding_map(path: str | Path) -> dict[str, np.ndarray]:
    """Load a word->vector map saved by :func:`save_embedding_map`."""
    with np.load(Path(path), allow_pickle=False) as z:
        return {w: z[w] for w in z.files}
