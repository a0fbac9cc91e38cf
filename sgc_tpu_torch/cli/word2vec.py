"""Word2Vec CLI (the counterpart of sgc_tpu/cli/word2vec.py, the reference
TextSGC_indexing/word2vec.py entry point), on the card by default:

    python -m sgc_tpu_torch.cli.word2vec --corpus data/ohsumed.clean.txt \
        --dim 100 --out w2v

Trains skip-gram word2vec over a cleaned one-doc-per-line corpus and
writes ``<out>.tsv`` (word, vector), ``<out>.npz`` (the embedding map for
build_graph's ``--embeddings``) and, with ``--neighbors N``,
``<out>.neighbors.txt``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from sgc_tpu_torch.textgraph.embedding import save_embedding_map
from sgc_tpu_torch.textgraph.word2vec import Word2Vec, Word2VecConfig
from sgc_tpu_torch.utils.device import resolve_device


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--corpus", required=True)
    p.add_argument("--dim", type=int, default=100)
    p.add_argument("--window", type=int, default=5)
    p.add_argument("--negatives", type=int, default=5)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--lr", type=float, default=0.025)
    p.add_argument("--min_count", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=8192)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--neighbors", type=int, default=0,
                   help="export top-N nearest neighbors per word")
    p.add_argument("--out", required=True, help="output stem")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def read_docs(path) -> list[list[str]]:
    """The corpus's non-blank lines, split on whitespace."""
    return [line.split() for line in Path(path).read_text(
        encoding="utf-8", errors="ignore").splitlines() if line.strip()]


def run(a: argparse.Namespace) -> Word2Vec:
    """Train and write the outputs; returns the trained model."""
    dev = resolve_device(a.device)
    w2v = Word2Vec(Word2VecConfig(
        dim=a.dim, window=a.window, negatives=a.negatives, lr=a.lr,
        epochs=a.epochs, batch_size=a.batch_size, min_count=a.min_count,
        seed=a.seed,
    ), device=dev).train(read_docs(a.corpus))

    w2v.save_tsv(f"{a.out}.tsv")
    save_embedding_map(f"{a.out}.npz", w2v.as_dict())
    if a.neighbors > 0:
        # nearest-neighbor export (reference word2vec.py:128-150)
        with open(f"{a.out}.neighbors.txt", "w") as f:
            for w in w2v.vocab:
                nn = ", ".join(
                    f"{x}:{s:.3f}" for x, s in w2v.most_similar(w, a.neighbors)
                )
                f.write(f"{w}\t{nn}\n")
    return w2v


def main() -> None:
    a = parser().parse_args()
    w2v = run(a)
    print(f"trained w2v: {len(w2v.vocab)} words dim {a.dim} -> "
          f"{a.out}.tsv/.npz")


if __name__ == "__main__":
    main()
