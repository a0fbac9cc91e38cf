"""Corpus cleaning: tokenize -> stopwords -> lemmatize -> min-freq cutoff
(the counterpart of sgc_tpu/textgraph/clean.py; host only).

Parity: reference downstream/TextSGC/remove_words.py — clean_str
tokenization, NLTK English stopword removal, and the min-frequency-5
vocabulary cutoff (remove_words.py:79-85; mr keeps all words in the
reference, controlled here by ``min_freq``).
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path
from typing import Iterable, Sequence

from sgc_tpu_torch.textgraph.stopwords import fetch_stopwords
from sgc_tpu_torch.textgraph.tokenize import fetch_lemmatizer, fetch_tokenizer


def clean_docs(
    docs: Sequence[str],
    tokenizer: str = "manual",
    stopword_list: str = "nltk",
    lemmatizer: str = "none",
    min_freq: int = 5,
) -> list[str]:
    """Clean raw document strings into space-joined token strings."""
    tok = fetch_tokenizer(tokenizer)
    lemma = fetch_lemmatizer(lemmatizer)

    tokenized = [lemma(tok(d)) for d in docs]

    stops = fetch_stopwords(
        stopword_list, docs=(" ".join(t) for t in tokenized)
    )

    freq: Counter = Counter()
    for tokens in tokenized:
        freq.update(tokens)

    cleaned = []
    for tokens in tokenized:
        # strictly greater: the reference's cutoff = count.index(5) keeps
        # only words with frequency > 5 (remove_words.py:79-85)
        kept = [
            w for w in tokens
            if w not in stops and freq[w] > min_freq
        ]
        cleaned.append(" ".join(kept))
    return cleaned


def default_clean_path(corpus_path: str | Path) -> str:
    """The `<corpus>.clean.txt` path clean_corpus writes when out_path is
    omitted — single source of truth for callers (CLI) that print it."""
    return Path(corpus_path).with_suffix("").as_posix() + ".clean.txt"


def clean_corpus(
    corpus_path: str | Path,
    out_path: str | Path | None = None,
    **kwargs,
) -> list[str]:
    """Clean a one-doc-per-line corpus file; optionally write .clean.txt."""
    corpus_path = Path(corpus_path)
    with open(corpus_path, "r", encoding="utf-8", errors="ignore") as f:
        docs = [line.strip() for line in f]
    cleaned = clean_docs(docs, **kwargs)
    if out_path is None:
        out_path = default_clean_path(corpus_path)
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\n".join(cleaned))
    return cleaned


def build_corpus_file(
    metadata_path: str | Path,
    out_path: str | Path,
    doc_root: str | Path | None = None,
    rewrite=None,
) -> list[str]:
    """Assemble one-doc-per-line corpus from a metadata index.

    Each metadata line is ``<doc_path>\\t<train|test>\\t<label>``
    (reference downstream/TextSGC/build_corpus.py:5-25); document text is
    read from <doc_root>/<doc_path> (with a ``.txt``-suffix fallback) and
    newlines are flattened to spaces. ``rewrite(doc_path) -> path`` maps
    metadata paths onto the actual file layout when they diverge.
    """
    metadata_path = Path(metadata_path)
    root = Path(doc_root) if doc_root is not None else metadata_path.parent
    docs = []
    with open(metadata_path, "r") as f:
        for line in f:
            doc_path = line.strip().split("\t")[0]
            if rewrite is not None:
                doc_path = rewrite(doc_path)
            p = root / doc_path
            if not p.exists() and p.with_suffix(p.suffix + ".txt").exists():
                p = p.with_suffix(p.suffix + ".txt")
            with open(p, "r", encoding="utf-8", errors="ignore") as df:
                docs.append(df.read().replace("\n", " ").strip())
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\n".join(docs))
    return docs


def export_sentences(
    corpus_path, out_path, min_tokens: int = 3
) -> int:
    """One sentence per line, blank line between docs — the pretraining
    corpus format of the reference's prepare_bert.py:14-29.

    Sentence splitting is rule-based (., !, ? followed by space+capital or
    end), matching the reference's simple splitter; returns #sentences.
    """
    import re
    from pathlib import Path

    splitter = re.compile(r"(?<=[.!?])\s+(?=[A-Z0-9])")
    n = 0
    with open(corpus_path, encoding="utf-8", errors="ignore") as fi, \
            open(out_path, "w", encoding="utf-8") as fo:
        for doc in fi:
            doc = doc.strip()
            if not doc:
                continue
            for sent in splitter.split(doc):
                sent = sent.strip()
                if len(sent.split()) >= min_tokens:
                    fo.write(sent + "\n")
                    n += 1
            fo.write("\n")
    return n
