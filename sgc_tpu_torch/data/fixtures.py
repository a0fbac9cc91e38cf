"""Dataset files in the published formats, made from a seed.

The published Planetoid pickles and the Reddit npz pair are external
files. These writers produce files of the same names, keys and dtypes
with a planted signal, so the loaders and the CLIs can run end to end
where the real files are absent:

* :func:`write_planetoid`: ``ind.<dataset>.{x,y,tx,ty,allx,ally,graph}``
  (pickled scipy CSR features, one-hot label arrays, a dict of neighbour
  lists) and ``ind.<dataset>.test.index`` (the test ids, shuffled), with
  Citeseer's gaps (test ids missing from ``tx``) when ``test_gaps > 0``;
* :func:`write_reddit`: ``reddit_adj.npz`` (scipy sparse, the directed
  half of the edges) and ``reddit.npz`` (``feats`` float32,
  ``y_train``/``y_val``/``y_test`` and ``train_index``/``val_index``/
  ``test_index`` int64), edges and labels from the clustered recipe of
  :func:`sgc_tpu_torch.data.synthetic.clustered_edges`;
* :func:`write_text_corpus`: a TextSGC corpus, ``<dataset>.txt``
  (``<id>\t<train|test>\t<label>`` metadata lines) and
  ``<dataset>.clean.txt`` (one cleaned doc a line), which
  ``cli/build_graph.py`` turns into the doc-word graph; at the defaults
  (``COVID``) the COVID-19 corpus's published shape.
"""

from __future__ import annotations

import pickle
from collections import defaultdict
from pathlib import Path

import numpy as np
import scipy.sparse as sp

from sgc_tpu_torch.data.synthetic import REDDIT_NODES, clustered_edges

# GraphSAGE's Reddit split sizes (of 232,965 nodes; the rest are in none)
REDDIT_SPLIT = (152_410, 23_699, 55_334)

# the COVID-19 corpus's published shape: 7,362 train and 1,825 test
# abstracts, 31 subject labels, 14,832 words after cleaning (so a
# 24,019-node doc-word graph)
COVID = dict(n_train=7_362, n_test=1_825, n_classes=31, vocab=14_832)

# Pubmed's published shape and Planetoid split
PUBMED = dict(n_nodes=19_717, n_edges=44_338, n_features=500, n_classes=3,
              n_train=60, n_test=1_000)


def write_planetoid(root, dataset: str, n_nodes: int, n_edges: int,
                    n_features: int, n_classes: int, n_train: int,
                    n_test: int, seed: int = 42, test_gaps: int = 0,
                    intra: float = 0.8, words: int = 50) -> dict:
    """Write a Planetoid-format dataset into ``root``.

    Node ids: ``allx`` holds nodes ``[0, n_allx)`` (the first ``n_train``
    are ``x``, the loader's val rows follow), the test ids are the last
    ``n_test`` of ``[n_allx, n_nodes)`` after ``test_gaps`` ids are left
    out of ``tx`` (Citeseer's isolated test nodes). ``intra`` of the
    edges join nodes of one class; each node holds ``words`` draws of its
    bag of words, half from its class's own block of the vocabulary.
    Returns the index arrays and counts.
    """
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_allx = n_nodes - n_test - test_gaps
    if n_allx < n_train + 500:
        raise ValueError("n_nodes leaves no room for the 500 val rows")
    labels = rng.integers(0, n_classes, n_nodes)
    labels[:n_train] = np.arange(n_train) % n_classes

    # edges: intra-class pairs through a class-sorted node order
    src = rng.integers(0, n_nodes, n_edges)
    dst = rng.integers(0, n_nodes, n_edges)
    by_class = np.argsort(labels, kind="stable")
    sizes = np.bincount(labels, minlength=n_classes)
    starts = np.concatenate(([0], np.cumsum(sizes)[:-1]))
    same = rng.random(n_edges) < intra
    cls = labels[src[same]]
    pick = (rng.random(int(same.sum())) * sizes[cls]).astype(np.int64)
    dst[same] = by_class[starts[cls] + pick]

    # bag-of-words features with a class-dependent block of words
    block = n_features // n_classes
    own = rng.random((n_nodes, words)) < 0.5
    w_any = rng.integers(0, n_features, (n_nodes, words))
    w_own = labels[:, None] * block + rng.integers(0, block, (n_nodes, words))
    cols = np.where(own, w_own, w_any).ravel()
    rows = np.repeat(np.arange(n_nodes), words)
    feats = sp.csr_matrix(
        (rng.random(len(cols)).astype(np.float32), (rows, cols)),
        shape=(n_nodes, n_features))
    feats.sum_duplicates()

    onehot = np.eye(n_classes, dtype=np.float64)[labels]
    test_range = np.arange(n_allx, n_nodes)
    # the range's ends stay test ids, so the loader's range is all nodes
    gaps = (np.sort(rng.choice(test_range[1:-1], test_gaps, replace=False))
            if test_gaps else np.zeros(0, np.int64))
    test_ids = np.setdiff1d(test_range, gaps)
    test_index = rng.permutation(test_ids)

    graph = defaultdict(list)
    for u in range(n_nodes):
        graph[u] = []
    for u, v in zip(src.tolist(), dst.tolist()):
        graph[u].append(v)

    parts = {
        "x": feats[:n_train], "y": onehot[:n_train],
        "allx": feats[:n_allx], "ally": onehot[:n_allx],
        "tx": feats[test_index], "ty": onehot[test_index],
        "graph": graph,
    }
    for name, obj in parts.items():
        with open(root / f"ind.{dataset}.{name}", "wb") as f:
            pickle.dump(obj, f, protocol=2)
    (root / f"ind.{dataset}.test.index").write_text(
        "".join(f"{i}\n" for i in test_index))
    return {"labels": labels, "test_index": test_index, "gaps": gaps,
            "n_allx": n_allx, "n_nodes": n_nodes, "n_edges": n_edges}


def write_reddit(root, scale: float = 1.0, seed: int = 42) -> dict:
    """Write a Reddit-format pair into ``root``: at ``scale=1.0``
    Reddit's published shape (232,965 nodes, the directed half of
    11,606,919 edges, 602 features, 41 classes) with GraphSAGE's split
    sizes; smaller scales shrink every count in proportion. Edges and
    labels follow the clustered recipe (50 communities, 85% intra edges,
    planted labels, shuffled ids). Returns the counts."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    src, dst, feats, labels, _, n = clustered_edges(scale, seed,
                                                    shuffle=True)
    adj = sp.csr_matrix(
        (np.ones(len(src), np.float32), (src, dst)), shape=(n, n))
    sp.save_npz(root / "reddit_adj.npz", adj, compressed=False)

    frac = n / REDDIT_NODES
    n_tr, n_va, n_te = (int(round(k * frac)) for k in REDDIT_SPLIT)
    perm = np.random.default_rng(seed + 2).permutation(n)
    train = np.sort(perm[:n_tr]).astype(np.int64)
    val = np.sort(perm[n_tr:n_tr + n_va]).astype(np.int64)
    test = np.sort(perm[n_tr + n_va:n_tr + n_va + n_te]).astype(np.int64)
    labels = labels.astype(np.int64)
    np.savez(root / "reddit.npz", feats=feats, y_train=labels[train],
             y_val=labels[val], y_test=labels[test], train_index=train,
             val_index=val, test_index=test)
    return {"nodes": n, "directed_edges": len(src),
            "features": int(feats.shape[1]),
            "classes": int(labels.max()) + 1, "train": n_tr, "val": n_va,
            "test": n_te}


def write_text_corpus(root, dataset: str = "covid", n_train: int = 7_362,
                      n_test: int = 1_825, n_classes: int = 31,
                      vocab: int = 14_832, doc_len: float = 125.0,
                      topic: float = 0.05, topic_words: int = 400,
                      zipf: float = 1.0, seed: int = 42) -> dict:
    """Write a cleaned text corpus and its metadata into ``root``.

    Every doc has one class (class sizes fall off as ``1/sqrt(rank)``)
    and a length drawn around ``doc_len`` tokens. Each token is, with
    probability ``topic``, a word of the class's own topic list
    (``topic_words`` words of the vocabulary, Zipf-weighted within it),
    else a word of a shared Zipf(``zipf``) background over the whole
    vocabulary. Every one of the ``vocab`` words is used at least once
    (the unused ones are appended to seeded docs), so the vocabulary
    has exactly ``vocab`` words. Test docs are spread through the file.
    Returns the paths and counts.
    """
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_docs = n_train + n_test
    class_p = 1.0 / np.sqrt(np.arange(1, n_classes + 1))
    labels = rng.choice(n_classes, n_docs, p=class_p / class_p.sum())
    labels[:n_classes] = np.arange(n_classes)      # every class present
    phases = np.zeros(n_docs, bool)
    phases[rng.permutation(n_docs)[:n_test]] = True  # True = test

    lengths = np.maximum(
        rng.lognormal(np.log(doc_len) - 0.125, 0.5, n_docs).astype(int), 5)
    starts = np.concatenate(([0], np.cumsum(lengths)))
    doc_of = np.repeat(np.arange(n_docs), lengths)
    n_tok = int(starts[-1])
    bg_p = 1.0 / np.arange(1, vocab + 1) ** zipf
    tokens = rng.choice(vocab, n_tok, p=bg_p / bg_p.sum())
    # each class's topic list, drawn from the vocabulary below the most
    # frequent words; Zipf-weighted inside the list
    lists = np.stack([rng.choice(np.arange(vocab // 50, vocab), topic_words,
                                 replace=False) for _ in range(n_classes)])
    in_p = 1.0 / np.arange(1, topic_words + 1)
    own = rng.random(n_tok) < topic
    pick = rng.choice(topic_words, int(own.sum()), p=in_p / in_p.sum())
    tokens[own] = lists[labels[doc_of[own]], pick]

    docs = [tokens[starts[d]:starts[d + 1]].tolist() for d in range(n_docs)]
    unused = np.setdiff1d(np.arange(vocab), tokens)
    for w, d in zip(unused.tolist(), rng.integers(0, n_docs, len(unused))):
        docs[int(d)].append(w)

    meta = root / f"{dataset}.txt"
    corpus = root / f"{dataset}.clean.txt"
    meta.write_text("".join(
        f"doc{d}\t{'test' if phases[d] else 'train'}\tc{labels[d]:02d}\n"
        for d in range(n_docs)))
    corpus.write_text("".join(
        " ".join(f"w{w:05d}" for w in doc) + "\n" for doc in docs))
    return {"metadata": meta, "corpus": corpus, "docs": n_docs,
            "train": int(n_docs - phases.sum()), "test": int(phases.sum()),
            "classes": n_classes, "vocab": vocab,
            "tokens": int(sum(len(d) for d in docs))}
