"""Heterogeneous doc-word graph construction, the Text-GCN formulation
(the counterpart of sgc_tpu/textgraph/graph.py; host numpy/scipy work,
bit for bit the reference's).

One graph over N_docs + V nodes, docs first then words, from three edge
blocks exported in every subset {B, BC, BD, BCD}:

  B  doc->word   TF-IDF (freq * idf)
  C  word->doc   the transpose of B
  D  word<->word positive PMI over sliding context windows (width 20)

The pair counts come from sparse linear algebra: with C the (windows x
vocab) count matrix, the ordered pair-count matrix is C^T C off the
diagonal and sum_w c(c-1) on it, and a word's window frequency is the
binarized column sum.

The fork's extensions: pivoted-normalized TF-IDF, chi-squared selection
of the vocabulary (:func:`chi2_select_vocab`, with the port's own
chi-squared test, :func:`chi2`, in place of scikit-learn's) and
embedding-cosine + PMI word-word weights.
"""

from __future__ import annotations

import dataclasses
import pickle
import random
from collections import Counter
from pathlib import Path

import numpy as np
import scipy.sparse as sp
from scipy import special


@dataclasses.dataclass
class TextCorpus:
    """Parsed metadata + cleaned documents for graph construction."""

    doc_tokens: list[list[str]]      # cleaned tokens per doc, metadata order
    phases: list[str]                # 'train' | 'test' per doc
    labels: list[str]                # label name per doc
    label_names: list[str]           # label vocabulary (index = class id)

    @property
    def n_docs(self) -> int:
        return len(self.doc_tokens)

    @staticmethod
    def from_files(metadata_path: str | Path, clean_corpus_path: str | Path):
        """metadata: ``<id>\\t<train|test>\\t<label>`` lines; corpus: one
        cleaned doc per line, same order (reference build_graph.py:39-67)."""
        phases, labels = [], []
        with open(metadata_path) as f:
            for line in f:
                _, phase, label = line.strip().split("\t")
                phases.append("test" if "test" in phase else "train")
                labels.append(label)
        with open(clean_corpus_path) as f:
            docs = [line.strip().split() for line in f]
        if len(docs) != len(phases):
            raise ValueError(
                f"metadata has {len(phases)} docs, corpus has {len(docs)}"
            )
        label_names = sorted(set(labels))
        return TextCorpus(docs, phases, labels, label_names)


def build_vocab(doc_tokens: list[list[str]]) -> list[str]:
    """Vocabulary in corpus-frequency order (reference build_graph.py:78)."""
    freq = Counter()
    for tokens in doc_tokens:
        freq.update(tokens)
    return [w for w, _ in freq.most_common()]


def _window_count_matrix(
    encoded_docs: list[np.ndarray], vocab_size: int, window: int
) -> sp.csr_matrix:
    """(n_windows x vocab) token-count matrix over sliding windows.

    Docs shorter than ``window`` contribute one window (reference
    build_graph.py:158-168).
    """
    rows, cols = [], []
    w_id = 0
    for tokens in encoded_docs:
        n = len(tokens)
        if n == 0:
            # the reference appends an EMPTY window for empty docs
            # (build_graph.py:164-166 `length <= window_size`), which
            # inflates n_windows — the PMI normalizer — identically here
            w_id += 1
            continue
        if n <= window:
            rows.append(np.full(n, w_id))
            cols.append(tokens)
            w_id += 1
        else:
            n_win = n - window + 1
            # window k covers tokens[k : k + window]
            idx = np.arange(n_win)[:, None] + np.arange(window)[None, :]
            rows.append((np.arange(n_win)[:, None] + w_id).repeat(window, 1).ravel())
            cols.append(tokens[idx].ravel())
            w_id += n_win
    if w_id == 0:
        return sp.csr_matrix((0, vocab_size), dtype=np.int64)
    data = np.ones(sum(len(r) for r in rows), dtype=np.int64)
    mat = sp.coo_matrix(
        (data, (np.concatenate(rows), np.concatenate(cols))),
        shape=(w_id, vocab_size),
    )
    return mat.tocsr()  # duplicate (window, word) entries sum -> counts


def pmi_word_graph(
    encoded_docs: list[np.ndarray], vocab_size: int, window: int = 20
) -> sp.coo_matrix:
    """Positive-PMI word<->word block over sliding context windows.

    pmi(i,j) = log( pair_count(i,j) * n_windows / (wf(i) * wf(j)) ), kept
    if > 0 — identical to reference build_graph.py:187-203 with pair counts
    including token multiplicity (itertools.permutations over positions).
    """
    C = _window_count_matrix(encoded_docs, vocab_size, window)
    n_windows = C.shape[0]
    if n_windows == 0:
        return sp.coo_matrix((vocab_size, vocab_size), dtype=np.float32)

    # ordered position-pair counts: off-diag = (C^T C)_ij;
    # diagonal needs sum over windows of c*(c-1) = (C^T C)_ii - colsum(C)
    pair = (C.T @ C).tocoo()
    colsum = np.asarray(C.sum(axis=0)).ravel()
    # window document frequency: number of windows containing the word
    Cb = C.copy()
    Cb.data = np.ones_like(Cb.data)
    wf = np.asarray(Cb.sum(axis=0)).ravel().astype(np.float64)

    rows, cols, counts = pair.row, pair.col, pair.data.astype(np.float64)
    on_diag = rows == cols
    counts = np.where(on_diag, counts - colsum[rows], counts)
    keep = counts > 0
    rows, cols, counts = rows[keep], cols[keep], counts[keep]

    pmi = np.log(counts * n_windows / (wf[rows] * wf[cols]))
    pos = pmi > 0
    return sp.coo_matrix(
        (pmi[pos].astype(np.float32), (rows[pos], cols[pos])),
        shape=(vocab_size, vocab_size),
    )


def doc_word_counts(
    encoded_docs: list[np.ndarray], vocab_size: int
) -> sp.csr_matrix:
    """(n_docs x vocab) raw term counts."""
    rows, cols = [], []
    for d, tokens in enumerate(encoded_docs):
        rows.append(np.full(len(tokens), d))
        cols.append(tokens)
    data = np.ones(sum(len(r) for r in rows), dtype=np.int64)
    return sp.coo_matrix(
        (data, (np.concatenate(rows), np.concatenate(cols))),
        shape=(len(encoded_docs), vocab_size),
    ).tocsr()


def tfidf_doc_word(
    counts: sp.csr_matrix, pivoted: bool = False, slope: float = 0.2
) -> sp.csr_matrix:
    """TF-IDF doc->word block.

    Standard: w = freq * log(N / df)   (reference build_graph.py:237-239;
    df = number of docs containing the word).
    Pivoted:  w = (1 + log(1 + log f)) / ((1-slope) + slope * len/avglen)
              * idf   (TextSGC_indexing/build_graph.py:453-533).
    """
    n_docs = counts.shape[0]
    df = np.asarray((counts > 0).sum(axis=0)).ravel().astype(np.float64)
    idf = np.log(n_docs / np.maximum(df, 1.0))

    out = counts.tocoo().astype(np.float64)
    if pivoted:
        doc_len = np.asarray(counts.sum(axis=1)).ravel().astype(np.float64)
        avg_len = doc_len.mean() if n_docs else 1.0
        tf = 1.0 + np.log1p(np.log(np.maximum(out.data, 1.0)) + 1e-12)
        norm = (1.0 - slope) + slope * doc_len[out.row] / avg_len
        out.data = tf / norm * idf[out.col]
    else:
        out.data = out.data * idf[out.col]
    return out.tocsr()


def chi2(X: sp.csr_matrix, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Chi-squared statistic and p-value of each (non-negative) feature
    against a two-valued target, the computation of scikit-learn's
    ``feature_selection.chi2`` for a boolean ``y``, step for step (the
    same array operations in the same order, so the same bits).

    Rows of the 2 x F observed table are the feature sums over the docs
    with ``y`` false and true; the expected table is each row's share of
    the docs times the feature's total; p = ``chdtrc(1, chi2)``.
    """
    X = sp.csr_matrix(X)
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    if np.any(X.data < 0):
        raise ValueError("Input X must be non-negative.")
    yb = np.asarray(y).astype(bool)
    pos = yb.astype(np.int64)[:, None]
    if yb.all() or not yb.any():
        # one class present: scikit-learn's binarizer gives a zero
        # column, so the table's rows are (all docs, none)
        pos = np.zeros_like(pos)
    Y = np.append(1 - pos, pos, axis=1)
    observed = Y.T @ X
    if sp.issparse(observed):
        observed = observed.toarray()
    feature_count = X.sum(axis=0).reshape(1, -1)
    class_prob = Y.mean(axis=0).reshape(1, -1)
    expected = np.dot(class_prob.T, feature_count)
    chisq = np.asarray(observed, dtype=np.float64)
    chisq -= expected
    chisq **= 2
    with np.errstate(invalid="ignore"):
        chisq /= expected
    chisq = chisq.sum(axis=0)
    return chisq, special.chdtrc(len(observed) - 1, chisq)


def chi2_select_vocab(
    counts: sp.csr_matrix,
    all_labels: np.ndarray,
    p_value: float = 0.90,
    max_features: int = 15000,
) -> np.ndarray:
    """Chi-squared vocabulary selection, as the fork's indexing variant:
    (1) cap the vocabulary at ``max_features`` by corpus frequency, (2)
    TF-IDF over ALL documents, (3) per-class one-vs-rest :func:`chi2`,
    (4) keep the union of words whose score ``1 - p`` exceeds
    ``p_value`` for any class (i.e. p < 1 - p_value). Returns kept word
    column indices into the original vocabulary.
    """
    # frequency cap first (the most frequent terms across the corpus)
    total = np.asarray(counts.sum(axis=0)).ravel()
    if counts.shape[1] > max_features:
        top = np.sort(np.argsort(-total)[:max_features])
    else:
        top = np.arange(counts.shape[1])

    X = tfidf_doc_word(counts[:, top])
    y = np.asarray(all_labels)
    selected = np.zeros(len(top), dtype=bool)
    for cat in np.unique(y):
        _, p = chi2(X, y == cat)
        score = 1.0 - np.nan_to_num(p, nan=1.0)
        selected |= score > p_value
    return np.sort(top[selected])


def embedding_cosine_graph(
    vocab: list[str],
    embeddings: dict[str, np.ndarray],
    pattern: sp.coo_matrix,
) -> sp.coo_matrix:
    """Cosine similarity on the PMI pattern's edges.

    The Bio variant adds BioBERT cosine similarity to positive-PMI edges
    (TextSGC_Bio/build_graph_v2.py:216-242). Cosine is evaluated only at
    the given sparsity pattern.
    """
    dim = len(next(iter(embeddings.values()))) if embeddings else 0
    emb = np.zeros((len(vocab), dim), dtype=np.float32)
    has = np.zeros(len(vocab), dtype=bool)
    for i, w in enumerate(vocab):
        v = embeddings.get(w)
        if v is not None:
            emb[i] = v
            has[i] = True
    norms = np.linalg.norm(emb, axis=1)
    norms[norms == 0] = 1.0
    unit = emb / norms[:, None]
    cos = np.einsum("ef,ef->e", unit[pattern.row], unit[pattern.col])
    cos = np.where(has[pattern.row] & has[pattern.col], cos, 0.0)
    return sp.coo_matrix(
        (cos.astype(np.float32), (pattern.row, pattern.col)),
        shape=pattern.shape,
    )


@dataclasses.dataclass
class TextGraphBuilder:
    """End-to-end builder with the fork's ablation knobs."""

    window: int = 20
    pivoted_tfidf: bool = False
    chi2_p_value: float | None = None    # None = no feature selection
    chi2_max_features: int = 15000
    embeddings: dict | None = None       # word -> vector, adds cosine to D
    val_fraction: float = 0.1
    seed: int = 42

    def build(self, corpus: TextCorpus) -> dict:
        """Returns dict with adjacencies {B, BC, BD, BCD}, index/label
        dicts (train/val/test), vocab, and label names."""
        vocab = build_vocab(corpus.doc_tokens)
        word_id = {w: i for i, w in enumerate(vocab)}
        encoded = [
            np.asarray([word_id[w] for w in toks], dtype=np.int64)
            for toks in corpus.doc_tokens
        ]
        n_docs, V = corpus.n_docs, len(vocab)

        counts = doc_word_counts(encoded, V)

        label_to_idx = {l: i for i, l in enumerate(corpus.label_names)}
        all_labels = np.asarray([label_to_idx[l] for l in corpus.labels])
        train_val = np.asarray(
            [i for i, p in enumerate(corpus.phases) if p == "train"]
        )
        test = np.asarray(
            [i for i, p in enumerate(corpus.phases) if p == "test"]
        )

        if self.chi2_p_value is not None:
            # reference-faithful: per-class OVR chi2 on TF-IDF of ALL docs
            # (build_graph.py:104-140; transductive text setting)
            kept = chi2_select_vocab(
                counts, all_labels,
                self.chi2_p_value, self.chi2_max_features,
            )
            remap = -np.ones(V, dtype=np.int64)
            remap[kept] = np.arange(len(kept))
            encoded = [remap[t][remap[t] >= 0] for t in encoded]
            vocab = [vocab[i] for i in kept]
            V = len(vocab)
            counts = doc_word_counts(encoded, V)

        B = tfidf_doc_word(counts, pivoted=self.pivoted_tfidf)
        D = pmi_word_graph(encoded, V, self.window)
        if self.embeddings is not None:
            D = (D + embedding_cosine_graph(vocab, self.embeddings, D)).tocoo()

        n = n_docs + V
        B_full = sp.coo_matrix(
            (B.tocoo().data, (B.tocoo().row, B.tocoo().col + n_docs)),
            shape=(n, n),
        )
        C_full = B_full.T
        D_full = sp.coo_matrix(
            (D.data, (D.row + n_docs, D.col + n_docs)), shape=(n, n)
        )

        adjs = {
            "B": B_full.tocsr(),
            "BC": (B_full + C_full).tocsr(),
            "BD": (B_full + D_full).tocsr(),
            "BCD": (B_full + C_full + D_full).tocsr(),
        }

        # shuffled train/val split (reference build_graph.py:88-103)
        rng = random.Random(self.seed)
        tv = list(train_val)
        rng.shuffle(tv)
        te = list(test)
        rng.shuffle(te)
        val_size = int(self.val_fraction * len(tv))
        train_ids = tv[: len(tv) - val_size]
        val_ids = tv[len(tv) - val_size :]

        index_dict = {
            "train": np.asarray(train_ids, dtype=np.int64),
            "val": np.asarray(val_ids, dtype=np.int64),
            "test": np.asarray(te, dtype=np.int64),
        }
        label_dict = {
            p: all_labels[idx] for p, idx in index_dict.items()
        }
        return {
            "adjs": adjs,
            "index_dict": index_dict,
            "label_dict": label_dict,
            "vocab": vocab,
            "label_names": corpus.label_names,
        }

    def export(self, corpus: TextCorpus, dataset: str, out_dir: str | Path):
        """Write reference-format pickles: ind.<ds>.{B,BC,BD,BCD}.adj and
        ind.<ds>.{train,val,test}.{x,y} (build_graph.py:258-307)."""
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        res = self.build(corpus)
        for phase, adj in res["adjs"].items():
            with open(out_dir / f"ind.{dataset}.{phase}.adj", "wb") as f:
                pickle.dump(adj, f)
        for split in ("train", "val", "test"):
            with open(out_dir / f"ind.{dataset}.{split}.x", "wb") as f:
                pickle.dump(list(map(int, res["index_dict"][split])), f)
            with open(out_dir / f"ind.{dataset}.{split}.y", "wb") as f:
                pickle.dump(list(map(int, res["label_dict"][split])), f)
        with open(out_dir / f"{dataset}_vocab.txt", "w") as f:
            f.write("\n".join(res["vocab"]))
        with open(out_dir / f"{dataset}_labels.txt", "w") as f:
            f.write("\n".join(res["label_names"]))
        # pickled vocab list for the embedding CLI (--vocab input)
        with open(out_dir / f"ind.{dataset}.vocab", "wb") as f:
            pickle.dump(res["vocab"], f)
        return res


def build_text_graph(
    metadata_path: str | Path,
    clean_corpus_path: str | Path,
    **builder_kwargs,
) -> dict:
    corpus = TextCorpus.from_files(metadata_path, clean_corpus_path)
    return TextGraphBuilder(**builder_kwargs).build(corpus)
