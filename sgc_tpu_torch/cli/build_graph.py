"""Offline text->graph pipeline CLI (the counterpart of
sgc_tpu/cli/build_graph.py); host work only, no device.

Drives: metadata + cleaned corpus -> TextGraphBuilder -> writes the
``ind.<ds>.{B,BC,BD,BCD}.adj`` adjacency pickles and per-phase
``ind.<ds>.{train,val,test}.{x,y}`` id/label pickles that
:func:`sgc_tpu_torch.data.textcorpus.load_corpus` consumes, with the
fork's ablation knobs: ``--win_size``, pivoted TF-IDF, chi-squared
feature selection (``--p_value``), and embedding-cosine word-word
weighting (``--embeddings``, an npz word -> vector map).

Usage:
    python -m sgc_tpu_torch.cli.build_graph \
        --metadata data/ohsumed.txt --corpus data/ohsumed.clean.txt \
        --dataset ohsumed --out data/
"""

from __future__ import annotations

import argparse

from sgc_tpu_torch.textgraph.graph import TextCorpus, TextGraphBuilder


def build_and_export(
    metadata: str,
    corpus: str,
    dataset: str,
    out: str,
    window: int = 20,
    pivoted: bool = False,
    p_value: float | None = None,
    max_features: int = 15000,
    embeddings: str | None = None,
    val_fraction: float = 0.1,
    seed: int = 42,
) -> dict:
    emb = None
    if embeddings is not None:
        from sgc_tpu_torch.textgraph.embedding import load_embedding_map

        emb = load_embedding_map(embeddings)

    tc = TextCorpus.from_files(metadata, corpus)
    builder = TextGraphBuilder(
        window=window,
        pivoted_tfidf=pivoted,
        chi2_p_value=p_value,
        chi2_max_features=max_features,
        embeddings=emb,
        val_fraction=val_fraction,
        seed=seed,
    )
    # single exporter: TextGraphBuilder.export owns the artifact contract
    return builder.export(tc, dataset, out)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--metadata", required=True,
                   help="<id>\\t<train|test>\\t<label> lines")
    p.add_argument("--corpus", required=True,
                   help="cleaned one-doc-per-line text file")
    p.add_argument("--dataset", required=True)
    p.add_argument("--out", default="data")
    p.add_argument("--win_size", type=int, default=20)
    p.add_argument("--pivoted_tfidf", action="store_true")
    p.add_argument("--p_value", type=float, default=None,
                   help="chi2 feature-selection threshold (None = off)")
    p.add_argument("--max_features", type=int, default=15000)
    p.add_argument("--embeddings", default=None,
                   help="npz word-embedding map for cosine edge weighting")
    p.add_argument("--val_fraction", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    a = p.parse_args()

    built = build_and_export(
        a.metadata, a.corpus, a.dataset, a.out,
        window=a.win_size, pivoted=a.pivoted_tfidf, p_value=a.p_value,
        max_features=a.max_features, embeddings=a.embeddings,
        val_fraction=a.val_fraction, seed=a.seed,
    )
    n_docs = sum(len(v) for v in built["index_dict"].values())
    print(
        f"exported {a.dataset}: {n_docs} docs, {len(built['vocab'])} words, "
        f"BCD nnz={built['adjs']['BCD'].nnz}"
    )


if __name__ == "__main__":
    main()
