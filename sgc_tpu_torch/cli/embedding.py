"""Word-embedding extraction CLI (the counterpart of
sgc_tpu/cli/embedding.py, the reference run_embedding.py entry point), on
the card by default:

    python -m sgc_tpu_torch.cli.embedding --vocab data/ind.ohsumed.vocab \
        --model dmis-lab/biobert-v1.1 --pooling mean --out emb.npz

Extracts one pooled vector per vocabulary word from a pretrained
HuggingFace encoder (``--backend torch``; ``auto`` falls back to the
deterministic hash embedder when no model loads) and writes an npz
word -> vector map for build_graph's ``--embeddings``. The reference's
``_mp_fn`` hook for xla_spawn has no counterpart: one process drives the
card.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

from sgc_tpu_torch.textgraph.embedding import (
    POOLING_MODES,
    EmbedderConfig,
    WordEmbedder,
)


def read_vocab(path) -> list[str]:
    """A pickled word list (``ind.<ds>.vocab``) or plain text, one word a
    line."""
    path = Path(path)
    try:
        with open(path, "rb") as f:
            return list(pickle.load(f))
    except (pickle.UnpicklingError, UnicodeDecodeError):
        return [w.strip() for w in path.read_text().splitlines() if w.strip()]


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--vocab", required=True,
                   help="pickled word list (ind.<ds>.vocab) or plain text, "
                        "one word per line")
    p.add_argument("--model", default="bert-base-uncased")
    p.add_argument("--pooling", default="mean", choices=POOLING_MODES)
    p.add_argument("--layer", type=int, default=-1)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--max_length", type=int, default=16)
    p.add_argument("--backend", default="auto",
                   choices=("auto", "flax", "torch", "hash"),
                   help="the reference's choices; 'flax' raises (this "
                        "package runs the encoder with torch)")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    a = p.parse_args()

    emb = WordEmbedder(EmbedderConfig(
        model_name=a.model, pooling=a.pooling, layer=a.layer,
        batch_size=a.batch_size, max_length=a.max_length, backend=a.backend,
    ), device=a.device)
    table = emb.embed_vocab_to_file(read_vocab(a.vocab), a.out)
    dim = len(next(iter(table.values()))) if table else 0
    print(f"embedded {len(table)} words (dim {dim}) -> {a.out}")


if __name__ == "__main__":
    main()
