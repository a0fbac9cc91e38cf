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
  (``COVID``) the COVID-19 corpus's published shape;
* :func:`write_scopus_csv`: a Scopus export (``id``, ``title``,
  ``abstract``, ``subject_areas``), the raw input of
  ``data/covid.py::prepare_covid_dataset``, which at the defaults gives
  the COVID-19 corpus's published split (7,362 train and 1,825 test
  abstracts over the top-35 subject labels).
"""

from __future__ import annotations

import csv
import math
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


# Scopus subject areas as the export writes them (parentheses kept; the
# prep strips them, so "Pharmacology (medical)" becomes the
# "Pharmacology medical" it regroups into "Pharmacology"). TOP: the 35
# labels the papers are drawn from; SECONDARY: labels that only appear
# beside a paper's own (each rarer than any TOP label, so never chosen);
# RARE: the sole label of a few papers, below the top 35 (dropped).
SCOPUS_CATCH_ALL = "Medicine (all)"
SCOPUS_TOP = (
    "Infectious Diseases", "Public Health, Environmental and Occupational "
    "Health", "Microbiology (medical)", "Immunology and Allergy", "Virology",
    "Pulmonary and Respiratory Medicine", "Epidemiology",
    "Pharmacology (medical)", "Cardiology and Cardiovascular Medicine",
    "Psychiatry and Mental Health", "Immunology", "Pharmacology",
    "Critical Care and Intensive Care Medicine",
    "Pediatrics, Perinatology and Child Health", "Health Policy",
    "Biochemistry", "Molecular Biology", "Multidisciplinary", "Oncology",
    "Neurology (clinical)", "Gastroenterology",
    "Radiology, Nuclear Medicine and Imaging", "Emergency Medicine",
    "Surgery", "Nursing (miscellaneous)", "Genetics", "Drug Discovery",
    "Hematology", "Endocrinology, Diabetes and Metabolism", "Nephrology",
    "Dermatology", "Obstetrics and Gynecology", "Geriatrics and Gerontology",
    "Anesthesiology and Pain Medicine", "Ophthalmology")
SCOPUS_SECONDARY = (
    "Medicine (miscellaneous)", "Cell Biology", "Structural Biology",
    "Parasitology", "Veterinary (miscellaneous)", "Ecology",
    "Applied Microbiology and Biotechnology", "Health Informatics",
    "Computer Science Applications", "Statistics and Probability",
    "Sociology and Political Science", "Economics and Econometrics",
    "Education", "Physiology", "Rheumatology", "Urology",
    "Otorhinolaryngology", "Toxicology", "Pathology and Forensic Medicine",
    "Biochemistry, Genetics and Molecular Biology (miscellaneous)")
SCOPUS_RARE = (
    "Astronomy and Astrophysics", "Geology", "Ocean Engineering", "Music",
    "Fuel Technology", "Ceramics and Composites", "Aerospace Engineering",
    "Paleontology", "Linguistics and Language", "Archeology")
# common English words the cleaning drops (all in the NLTK list)
_FILLER = ("the of and in to a with for was were is that by on as from at "
           "this these we or be are an which not have has been it its "
           "their than between after during").split()


def _label_sizes(n_docs: int, n_test: int, train_fraction: float = 0.8
                 ) -> np.ndarray:
    """Papers per TOP label, ~1/sqrt(rank), summing to ``n_docs``, such
    that the prep's per-class ``ceil(train_fraction * n)`` train split
    (after "Pharmacology (medical)" joins "Pharmacology") leaves
    ``n_test`` test papers: one paper at a time moves between the other
    labels until the count is met."""
    w = 1.0 / np.sqrt(np.arange(1, len(SCOPUS_TOP) + 1))
    sizes = np.floor(n_docs * w / w.sum()).astype(np.int64)
    sizes[0] += n_docs - sizes.sum()
    pharma = [SCOPUS_TOP.index("Pharmacology (medical)"),
              SCOPUS_TOP.index("Pharmacology")]
    free = [i for i in range(len(SCOPUS_TOP)) if i not in pharma]

    def n_tests(s):
        merged = np.append(np.delete(s, pharma), s[pharma].sum())
        return int(sum(m - math.ceil(m * train_fraction) for m in merged))

    while (t := n_tests(sizes)) != n_test:
        step = 1 if t < n_test else -1
        for a in free:
            for b in free:
                trial = sizes.copy()
                trial[a] -= 1
                trial[b] += 1
                if a != b and n_tests(trial) == t + step:
                    sizes = trial
                    break
            else:
                continue
            break
        else:
            raise ValueError(f"no split of {n_docs} papers leaves {n_test}")
    return sizes


def write_scopus_csv(path, n_train: int = 7_362, n_test: int = 1_825,
                     vocab: int = 20_000, abstract_len: float = 180.0,
                     topic: float = 0.08, topic_words: int = 300,
                     seed: int = 42) -> dict:
    """Write a Scopus-export CSV (``id``, ``title``, ``abstract``,
    ``subject_areas`` as ``"('A', 'B')"``) that ``data/covid.py::
    prepare_covid_dataset`` turns into the COVID-19 corpus's published
    shape: the top-35 subject labels ("Pharmacology (medical)" regrouped
    into "Pharmacology", so 34 classes), one label a paper, ``n_train``
    train and ``n_test`` test abstracts.

    Every kept paper has its own TOP label, "Medicine (all)" with
    probability 0.4 and one SECONDARY label with probability 0.05; the
    file also holds papers the prep drops: 80 with a RARE label only, 20
    with "Medicine (all)" only and 30 with no abstract. Abstracts are
    sentences of pseudo-words (a Zipf background over ``vocab`` words,
    a ``topic`` share from the paper's label's own ``topic_words``), with
    filler stopwords, numbers, capitals and punctuation for the cleaning
    to remove. Rows are shuffled. Returns the path and the counts.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    sizes = _label_sizes(n_train + n_test, n_test)
    syll = np.array([c + v for c in "bcdfghklmnprstvz" for v in "aeiou"])
    words = set()
    while len(words) < vocab:
        k = rng.integers(2, 5, 4 * vocab)
        parts = rng.choice(syll, (4 * vocab, 4))
        words.update("".join(p[:n]) for p, n in zip(parts.tolist(),
                                                    k.tolist()))
    words = np.array(sorted(words)[:vocab])
    words = words[rng.permutation(vocab)]
    lists = [rng.choice(np.arange(vocab // 50, vocab), topic_words,
                        replace=False) for _ in SCOPUS_TOP]

    cdfs = {n: np.cumsum(1.0 / np.arange(1, n + 1)) for n in (vocab,
                                                              topic_words)}

    def zipf_draw(n_words, size):
        cdf = cdfs[n_words]
        return np.minimum(np.searchsorted(cdf, rng.random(size) * cdf[-1],
                                          side="right"), n_words - 1)

    def text(label: int, n_tok: int) -> str:
        toks = zipf_draw(vocab, n_tok)
        own = rng.random(n_tok) < topic
        if label >= 0:
            toks[own] = lists[label][zipf_draw(topic_words, int(own.sum()))]
        out = words[toks].astype(object)
        fill = rng.random(n_tok) < 0.3
        out[fill] = rng.choice(_FILLER, int(fill.sum()))
        nums = rng.random(n_tok) < 0.01
        out[nums] = [str(x) for x in rng.integers(1, 2021, int(nums.sum()))]
        sents, i = [], 0
        while i < n_tok:
            j = min(n_tok, i + int(rng.integers(8, 25)))
            s = list(out[i:j])
            s[0] = s[0].capitalize()
            if len(s) > 6 and rng.random() < 0.5:
                s[len(s) // 2] += ","
            sents.append(" ".join(s) + ".")
            i = j
        return " ".join(sents)

    rows = []

    def add(subjects, label, abstract=True):
        n_tok = max(20, int(rng.lognormal(np.log(abstract_len), 0.35)))
        rows.append({
            "title": text(label, int(rng.integers(6, 16)))[:-1],
            "abstract": text(label, n_tok) if abstract else "",
            "subject_areas": "(" + ", ".join(f"'{s}'" for s in subjects)
                             + ("," if len(subjects) == 1 else "") + ")"})

    for label, n in enumerate(sizes.tolist()):
        for _ in range(n):
            subjects = [SCOPUS_TOP[label]]
            if rng.random() < 0.4:
                subjects.insert(int(rng.integers(0, 2)), SCOPUS_CATCH_ALL)
            if rng.random() < 0.05:
                subjects.append(str(rng.choice(SCOPUS_SECONDARY)))
            add(subjects, label)
    for i in range(80):
        add([SCOPUS_RARE[i % len(SCOPUS_RARE)]], -1)
    for _ in range(20):
        add([SCOPUS_CATCH_ALL], -1)
    for i in range(30):
        add([SCOPUS_TOP[i % len(SCOPUS_TOP)]], i % len(SCOPUS_TOP),
            abstract=False)
    order = rng.permutation(len(rows))
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=["id", "title", "abstract",
                                          "subject_areas"])
        w.writeheader()
        for k, i in enumerate(order.tolist()):
            w.writerow({"id": f"2-s2.0-{85_000_000_000 + k}", **rows[i]})
    return {"path": path, "rows": len(rows), "kept": int(sizes.sum()),
            "train": n_train, "test": n_test,
            "labels": len(SCOPUS_TOP) - 1,
            "sizes": dict(zip(SCOPUS_TOP, sizes.tolist()))}
