"""The text preparation of the port, host only, against the reference's,
bit for bit: stopword lists, tokenizers and lemmatizers
(``textgraph/stopwords.py``, ``tokenize.py``, ``biolemma.py``), corpus
cleaning and assembly (``textgraph/clean.py``, ``cli/clean_corpus.py``)
and the COVID-19 Scopus prep (``data/covid.py``) on the seeded Scopus
export of ``data/fixtures.py::write_scopus_csv``, whose defaults give
the COVID-19 corpus's published split.
"""

import os
import stat
import sys

import pytest

from sgc_tpu.cli import clean_corpus as ref_clean_cli
from sgc_tpu.data import covid as ref_covid
from sgc_tpu.textgraph import biolemma as ref_bio
from sgc_tpu.textgraph import clean as ref_clean
from sgc_tpu.textgraph import stopwords as ref_stop
from sgc_tpu.textgraph import tokenize as ref_tok

from sgc_tpu_torch.cli import clean_corpus as port_clean_cli
from sgc_tpu_torch.data import covid as port_covid
from sgc_tpu_torch.data.fixtures import COVID, write_scopus_csv
from sgc_tpu_torch.textgraph import biolemma as port_bio
from sgc_tpu_torch.textgraph import clean as port_clean
from sgc_tpu_torch.textgraph import stopwords as port_stop
from sgc_tpu_torch.textgraph import tokenize as port_tok

MESSY = [
    "The SARS-CoV-2 virus (2019-nCoV) binds ACE2; it's \"novel\"... isn't it?",
    "Patients' outcomes: 95% CI [1.2-3.4], p<0.05 -- we'll see! Don't panic",
    "  Cells   were   lysed,  washed (x3) and re-suspended in PBS.\tDone.",
    "A 'quoted' sentence, with commas, and semi;colons @ #tags & $5 $$.",
    "",
    "mice studies studied flies boxes matches wolves churches women",
]


def test_stopword_lists_and_registry_match():
    assert port_stop.NLTK_ENGLISH == ref_stop.NLTK_ENGLISH
    assert port_stop.MEDICAL == ref_stop.MEDICAL
    assert port_stop.nltk_english() == ref_stop.nltk_english()
    docs = [" ".join(MESSY)] * 3 + ["a a a b b c"]
    for name in ("nltk", "medical", "nltk+medical", "top50", "top100",
                 "none"):
        assert port_stop.fetch_stopwords(name, docs) == \
            ref_stop.fetch_stopwords(name, docs), name
    for bad, docs_arg in (("top50", None), ("bogus", docs)):
        with pytest.raises(ValueError):
            port_stop.fetch_stopwords(bad, docs_arg)


def test_tokenizers_and_lemmatizers_match():
    assert [(p.pattern, r) for p, r in port_tok._CLEAN_RULES] == \
        [(p.pattern, r) for p, r in ref_tok._CLEAN_RULES]
    for s in MESSY:
        assert port_tok.clean_str(s) == ref_tok.clean_str(s)
        for strip in (True, False):
            assert port_tok.clean_str_manual(s, strip) == \
                ref_tok.clean_str_manual(s, strip)
        for name in ("manual", "ref", "whitespace", "treebank", "nltk"):
            assert port_tok.fetch_tokenizer(name)(s) == \
                ref_tok.fetch_tokenizer(name)(s), (name, s)
        toks = ref_tok.tokenize_manual(s)
        for name in ("wordnet", "none"):
            assert port_tok.fetch_lemmatizer(name)(toks) == \
                ref_tok.fetch_lemmatizer(name)(toks)
    with pytest.raises(ValueError):
        port_tok.fetch_tokenizer("bogus")
    with pytest.raises(ValueError):
        port_tok.fetch_lemmatizer("bogus")


def test_scispacy_tokenizer_with_stub(monkeypatch):
    import types

    class Tok:
        def __init__(self, text):
            self.text = text

    fake = types.ModuleType("spacy")
    fake.load = lambda name: (lambda s: [Tok(w.capitalize())
                                         for w in s.split()])
    monkeypatch.setitem(sys.modules, "spacy", fake)
    tok = port_tok.fetch_tokenizer("scispacy")
    assert tok("viral protein binding") == ["viral", "protein", "binding"]

    def broken(name):
        raise OSError("no model")

    fake.load = broken
    with pytest.raises(RuntimeError, match="en_core_sci_lg"):
        port_tok.fetch_tokenizer("scispacy")


# a stand-in for the BioLemmatizer jar's JVM: checks the argv, echoes
# token<TAB>lemma with a trailing "s" removed (the reference's test's)
FAKE_JAVA = r"""#!/bin/bash
if [[ "$*" != *"-jar"* || "$*" != *"-l"* || "$*" != *"-t"* ]]; then
  echo "unexpected argv: $*" >&2
  exit 2
fi
while IFS= read -r tok || [[ -n "$tok" ]]; do
  printf '%s\t%s NN\n' "$tok" "${tok%s}"
done
"""


@pytest.fixture()
def fake_jvm(tmp_path, monkeypatch):
    java = tmp_path / "java"
    java.write_text(FAKE_JAVA)
    java.chmod(java.stat().st_mode | stat.S_IEXEC)
    jar = tmp_path / "biolemmatizer-core-1.2-jar-with-dependencies.jar"
    jar.write_bytes(b"fake")
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}" + os.environ["PATH"])
    monkeypatch.setenv(port_bio.JAR_ENV, str(jar))
    return tmp_path


def test_biolemma_protocol_matches_with_fake_jvm(fake_jvm):
    assert port_bio.JAR_ENV == ref_bio.JAR_ENV
    toks = [f"word{i}s" for i in range(25)] + ["cells", "virus"]
    for batch in (10, 1000):
        got = port_bio.lemmatize_bio(toks, batch_size=batch)
        assert got == ref_bio.lemmatize_bio(toks, batch_size=batch)
    assert got[-2:] == ["cell", "viru"]
    assert port_tok.fetch_lemmatizer("bio")(["proteins"]) == ["protein"]
    # a tool that drops lines: the identity, keeping the alignment
    (fake_jvm / "java").write_text(
        "#!/bin/bash\nread -r tok; printf '%s\\t%s NN\\n' \"$tok\" "
        "\"$tok\"\n")
    assert port_bio.lemmatize_bio(["alpha", "betas"]) == ["alpha", "betas"]


def test_biolemma_missing_jar_clear_error(monkeypatch):
    monkeypatch.delenv(port_bio.JAR_ENV, raising=False)
    with pytest.raises(FileNotFoundError, match=port_bio.JAR_ENV):
        port_bio.lemmatize_bio(["x"])


@pytest.fixture(scope="module")
def scopus_small(tmp_path_factory):
    root = tmp_path_factory.mktemp("scopus")
    fx = write_scopus_csv(root / "scopus.csv", n_train=420, n_test=80,
                          vocab=800, abstract_len=60.0, seed=3)
    return root, fx


def test_clean_docs_match(scopus_small):
    root, fx = scopus_small
    res = port_covid.prepare_covid_dataset(fx["path"], root / "prep")
    docs = res.corpus_path.read_text().splitlines()[:150] + MESSY
    for kw in (dict(), dict(stopword_list="nltk+medical", min_freq=0),
               dict(tokenizer="treebank", lemmatizer="wordnet", min_freq=2),
               dict(stopword_list="top50", min_freq=1)):
        assert port_clean.clean_docs(docs, **kw) == \
            ref_clean.clean_docs(docs, **kw), kw
    # the reference's own case: strictly above min_freq survives
    two = ["the apple apple apple orange",
           "the apple apple apple banana weirdtoken"]
    assert port_clean.clean_docs(two, min_freq=5) == ["apple apple apple"] * 2


def test_covid_prep_files_match(scopus_small, tmp_path):
    root, fx = scopus_small
    assert port_covid.parse_subject_areas(
        "('Virology', 'Medicine (all)', 'Public Health')") == \
        ref_covid.parse_subject_areas(
            "('Virology', 'Medicine (all)', 'Public Health')")
    assert port_covid.parse_subject_areas("('None',)") == []
    for cfg in ({}, {"top_n": 5}):
        got = port_covid.prepare_covid_dataset(
            fx["path"], tmp_path / "p", dataset_name="cv",
            config=port_covid.CovidPrepConfig(**cfg), write_doc_files=True)
        want = ref_covid.prepare_covid_dataset(
            fx["path"], tmp_path / "r", dataset_name="cv",
            config=ref_covid.CovidPrepConfig(**cfg), write_doc_files=True)
        assert (got.label_counts, got.n_train, got.n_test) == \
            (want.label_counts, want.n_train, want.n_test)
        for a, b in ((got.metadata_path, want.metadata_path),
                     (got.corpus_path, want.corpus_path)):
            assert a.read_bytes() == b.read_bytes()
        docs_p = sorted((tmp_path / "p").rglob("*.txt"))
        docs_r = sorted((tmp_path / "r").rglob("*.txt"))
        assert [d.relative_to(tmp_path / "p") for d in docs_p] == \
            [d.relative_to(tmp_path / "r") for d in docs_r]
        assert all(a.read_bytes() == b.read_bytes()
                   for a, b in zip(docs_p, docs_r))
    # "Medicine (all)" is never a label; the regrouped synonym is gone
    labels = {l.split("\t")[2] for l in
              got.metadata_path.read_text().splitlines()}
    assert "Medicine all" not in labels and "Pharmacology medical" not in \
        labels
    # the metadata resolves against out_dir with no rewrite hook
    docs = port_clean.build_corpus_file(got.metadata_path,
                                        tmp_path / "round.txt",
                                        doc_root=tmp_path / "p")
    assert len(docs) == got.n_train + got.n_test


def test_scopus_fixture_gives_the_covid_split(tmp_path):
    """At its defaults the Scopus export gives the published COVID-19
    split after the prep: 7,362 train and 1,825 test abstracts over the
    top-35 labels (34 after the regroup)."""
    fx = write_scopus_csv(tmp_path / "scopus.csv")
    res = port_covid.prepare_covid_dataset(fx["path"], tmp_path / "out")
    assert (res.n_train, res.n_test) == (COVID["n_train"], COVID["n_test"])
    assert len(res.label_counts) == fx["labels"] == 34
    assert fx["rows"] > fx["kept"] == COVID["n_train"] + COVID["n_test"]
    # the labels are the top 35 with the synonym merged
    assert res.label_counts["Pharmacology"] == (
        fx["sizes"]["Pharmacology"] + fx["sizes"]["Pharmacology (medical)"])


def test_clean_corpus_and_cli_files_match(tmp_path, monkeypatch, capsys):
    docs_dir = tmp_path / "raw"
    docs_dir.mkdir()
    (docs_dir / "d0.txt").write_text(
        "The enzyme binds.\nThe enzyme folds fast today.")
    (docs_dir / "d1.txt").write_text("Enzyme and membrane interact here.")
    (docs_dir / "d2.txt").write_text(MESSY[0] + "\n" + MESSY[1])
    meta = tmp_path / "meta.txt"
    meta.write_text("d0\ttrain\tsci\nd1\ttest\tsci\nd2\ttrain\tbio")
    outs = {}
    for main, name in ((ref_clean_cli.main, "r"), (port_clean_cli.main,
                                                   "p")):
        corpus = tmp_path / f"{name}corpus.txt"
        monkeypatch.setattr(sys, "argv", [
            "clean_corpus", "--corpus", str(corpus), "--metadata",
            str(meta), "--doc_root", str(docs_dir), "--stopwords", "nltk",
            "--min_freq", "1", "--sentences",
            str(tmp_path / f"{name}sents.txt")])
        main()
        outs[name] = [corpus.read_bytes(),
                      (tmp_path / f"{name}corpus.clean.txt").read_bytes(),
                      (tmp_path / f"{name}sents.txt").read_bytes()]
    assert outs["p"] == outs["r"]
    printed = capsys.readouterr().out.splitlines()
    half = len(printed) // 2
    assert [l.replace("/r", "/p") for l in printed[:half]] == printed[half:]
    assert "cleaned 3 docs" in printed[-2]
    assert port_clean.default_clean_path("a/b.txt") == \
        ref_clean.default_clean_path("a/b.txt")
    for mod, name in ((ref_clean, "r2.txt"), (port_clean, "p2.txt")):
        mod.clean_corpus(tmp_path / "pcorpus.txt", tmp_path / name,
                         tokenizer="treebank", lemmatizer="wordnet",
                         min_freq=0)
    assert (tmp_path / "r2.txt").read_bytes() == \
        (tmp_path / "p2.txt").read_bytes()
