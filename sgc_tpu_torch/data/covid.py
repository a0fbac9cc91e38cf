"""COVID-19 Scopus dataset preparation (the fork's production workflow;
the counterpart of sgc_tpu/data/covid.py, host only, the same files byte
for byte).

Re-implements the reference's "COVID-19 dataset prep for SGC" notebook
(``my_data/COVID-19 Production/``) as a deterministic, vectorized function:

1. drop records missing abstract or subject areas,
2. parse the Scopus ``subject_areas`` list-string, strip ``()',`` chars,
3. drop catch-all labels ("Medicine all" in the reference, notebook cell
   19) from the candidate set,
4. assign each paper its **most frequent** subject (single label per
   paper — the notebook's frequency-ordered first-match loop, cell 22),
5. keep the top-N labels by count (N=35, cell 28) and regroup synonyms
   ("Pharmacology medical" -> "Pharmacology", cell 33),
6. build ``title_abstract = title + '. ' + abstract`` (cell 35),
7. per-class ceil(80%) train split in stable sorted order (cell 40),
8. export the ``<path>\\t<train|test>\\t<label>`` metadata file
   (``covid_19_production.txt``, cell 45), per-document text files
   (cell 47), and a one-doc-per-line corpus directly consumable by
   ``sgc_tpu_torch.textgraph.clean.clean_corpus`` -> build_graph CLI.
"""

from __future__ import annotations

import csv
import math
import re
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path

_STRIP = re.compile(r"[()',]")


def parse_subject_areas(raw: str) -> list[str]:
    """Split a Scopus subject-areas list-string into cleaned labels.

    The raw format is ``"('Virology', 'Medicine all', ...)"``; the
    notebook splits on ``', '`` and strips ``()',`` characters (cells 7-8).
    """
    parts = raw.split("', '")
    out = []
    for p in parts:
        cleaned = _STRIP.sub("", p).strip()
        if cleaned and cleaned.lower() != "none":
            out.append(cleaned)
    return out


@dataclass
class CovidPrepResult:
    metadata_path: Path
    corpus_path: Path
    label_counts: dict[str, int]
    n_train: int
    n_test: int


@dataclass
class CovidPrepConfig:
    top_n: int = 35                                  # notebook cell 28
    drop_labels: tuple = ("Medicine all",)           # cell 19
    regroup: dict = field(
        default_factory=lambda: {"Pharmacology medical": "Pharmacology"}
    )                                                # cell 33
    train_fraction: float = 0.8                      # cell 40
    id_col: str = "id"
    title_col: str = "title"
    abstract_col: str = "abstract"
    subjects_col: str = "subject_areas"


def prepare_covid_dataset(
    input_csv: str | Path,
    out_dir: str | Path,
    dataset_name: str = "covid_19_production",
    config: CovidPrepConfig | None = None,
    write_doc_files: bool = False,
) -> CovidPrepResult:
    """Run the full prep pipeline; returns paths to metadata + corpus."""
    cfg = config or CovidPrepConfig()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    rows = []
    with open(input_csv, newline="", encoding="utf-8", errors="ignore") as f:
        for rec in csv.DictReader(f):
            abstract = (rec.get(cfg.abstract_col) or "").strip()
            subjects_raw = (rec.get(cfg.subjects_col) or "").strip()
            if not abstract or not subjects_raw:
                continue  # dropna(subset=['abstract','subject_areas'])
            subjects = [
                s for s in parse_subject_areas(subjects_raw)
                if s not in cfg.drop_labels
            ]
            if not subjects:
                continue
            rows.append({
                "id": (rec.get(cfg.id_col) or "").strip(),
                "title": (rec.get(cfg.title_col) or "").strip(),
                "abstract": abstract,
                "subjects": subjects,
            })

    # global subject frequencies -> single most-frequent label per paper.
    # The notebook (cell 22) walks subjects in count-DESC rank order and
    # takes the paper's first match; exact-tie rank order inside pandas
    # sort is version-dependent, so ties here break by first global
    # appearance (the closest deterministic reading of value_counts).
    counts = Counter(s for r in rows for s in r["subjects"])
    first_seen: dict = {}
    for r in rows:
        for s in r["subjects"]:
            first_seen.setdefault(s, len(first_seen))
    rank = {
        s: i for i, s in enumerate(sorted(
            counts, key=lambda s: (-counts[s], first_seen[s])
        ))
    }
    for r in rows:
        r["label"] = min(r["subjects"], key=lambda s: rank[s])

    # top-N labels by single-label count, then regroup synonyms
    single_counts = Counter(r["label"] for r in rows)
    top = {l for l, _ in single_counts.most_common(cfg.top_n)}
    rows = [r for r in rows if r["label"] in top]
    for r in rows:
        r["label"] = cfg.regroup.get(r["label"], r["label"])

    # order by LABEL ONLY with a stable sort (notebook cell 38
    # sort_values('top_35_label'): within a class the original CSV row
    # order survives) — then per-class ceil(80%) train split (cell 40)
    rows.sort(key=lambda r: r["label"])
    label_counts = Counter(r["label"] for r in rows)
    seen: Counter = Counter()
    for r in rows:
        limit = math.ceil(label_counts[r["label"]] * cfg.train_fraction)
        r["phase"] = "train" if seen[r["label"]] < limit else "test"
        seen[r["label"]] += 1

    metadata_path = out / f"{dataset_name}.txt"
    corpus_path = out / f"{dataset_name}.corpus.txt"
    with open(metadata_path, "w") as fm, open(corpus_path, "w") as fc:
        for r in rows:
            # metadata paths resolve against out_dir: build_corpus_file(
            # metadata, doc_root=out_dir) works without a rewrite hook
            path = f"data/{dataset_name}/{r['phase']}/{r['id']}"
            fm.write(f"{path}\t{r['phase']}\t{r['label']}\n")
            text = f"{r['title']}. {r['abstract']}".replace("\n", " ")
            fc.write(text + "\n")
            if write_doc_files:
                doc_dir = out / "data" / dataset_name / r["phase"]
                doc_dir.mkdir(parents=True, exist_ok=True)
                (doc_dir / f"{r['id']}.txt").write_text(text)

    n_train = sum(1 for r in rows if r["phase"] == "train")
    return CovidPrepResult(
        metadata_path=metadata_path,
        corpus_path=corpus_path,
        label_counts=dict(label_counts),
        n_train=n_train,
        n_test=len(rows) - n_train,
    )
