"""Corpus assembly + cleaning CLI (reference remove_words.py entry point;
the counterpart of sgc_tpu/cli/clean_corpus.py, host only).

One command covers the reference's three offline corpus scripts:

- ``--metadata`` assembles a one-doc-per-line corpus from a metadata
  index first (reference ``downstream/TextSGC/build_corpus.py:5-25``);
- the cleaning pass tokenizes, drops stopwords, lemmatizes, and applies
  the min-frequency vocabulary cutoff (reference
  ``downstream/TextSGC/remove_words.py:79-85``; tokenizer / stopword /
  lemmatizer registries are the ``TextSGC_indexing/remove_words.py``
  ablation set, ``:45-71`` / ``:111-221``);
- ``--sentences`` additionally exports the sentence-per-line BERT
  pretraining corpus (reference
  ``TextSGC_indexing/prepare_bert.py:14-29``).

Usage:
    python -m sgc_tpu_torch.cli.clean_corpus --corpus data/ohsumed.txt \
        [--metadata data/ohsumed.meta.txt --doc_root data/corpus/] \
        [--tokenizer manual] [--stopwords nltk] [--lemmatizer none] \
        [--min_freq 5] [--out data/ohsumed.clean.txt] \
        [--sentences data/ohsumed.sent.txt]
"""

from __future__ import annotations

import argparse

from sgc_tpu_torch.textgraph.clean import (
    build_corpus_file,
    clean_corpus,
    export_sentences,
)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--corpus", required=True,
                   help="one-doc-per-line corpus file (input; or output "
                        "of the assembly step when --metadata is given)")
    p.add_argument("--metadata", default=None,
                   help="metadata index (<doc_path>\\t<split>\\t<label>); "
                        "when given, assemble --corpus from it first")
    p.add_argument("--doc_root", default=None,
                   help="root directory for metadata doc paths "
                        "(default: the metadata file's directory)")
    p.add_argument("--tokenizer", default="manual",
                   help="manual|ref|whitespace|treebank|nltk|scispacy")
    p.add_argument("--stopwords", default="nltk",
                   help="nltk|medical|nltk+medical|top50|top100|none")
    p.add_argument("--lemmatizer", default="none",
                   help="none|wordnet|bio (bio needs the BioLemmatizer jar)")
    p.add_argument("--min_freq", type=int, default=5,
                   help="keep words with corpus frequency strictly greater "
                        "than this (reference cutoff 5; use 0 for mr-style "
                        "keep-all)")
    p.add_argument("--out", default=None,
                   help="cleaned corpus path (default: <corpus>.clean.txt)")
    p.add_argument("--sentences", default=None,
                   help="also export a sentence-per-line pretraining corpus "
                        "to this path (prepare_bert format)")
    args = p.parse_args()

    if args.metadata is not None:
        docs = build_corpus_file(args.metadata, args.corpus,
                                 doc_root=args.doc_root)
        print(f"assembled {len(docs)} docs -> {args.corpus}")

    from sgc_tpu_torch.textgraph.clean import default_clean_path

    out = args.out or default_clean_path(args.corpus)
    cleaned = clean_corpus(
        args.corpus,
        out_path=out,
        tokenizer=args.tokenizer,
        stopword_list=args.stopwords,
        lemmatizer=args.lemmatizer,
        min_freq=args.min_freq,
    )
    vocab = {w for doc in cleaned for w in doc.split()}
    print(f"cleaned {len(cleaned)} docs, vocab {len(vocab)} -> {out}")

    if args.sentences is not None:
        n = export_sentences(args.corpus, args.sentences)
        print(f"exported {n} sentences -> {args.sentences}")


if __name__ == "__main__":
    main()
