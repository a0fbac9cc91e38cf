"""Stopword registries (the counterpart of sgc_tpu/textgraph/stopwords.py,
with its own copy of the word lists: the port imports nothing of the
reference).

The reference removes NLTK English stopwords (reference
downstream/TextSGC/remove_words.py:12) and the _indexing variant adds
selectable lists: nltk / stanford-medical / pubmed / top-k-frequency / none
(reference downstream/TextSGC_indexing/remove_words.py:45-71,111-127).
The NLTK list is vendored below so the pipeline has no downloadable-data
dependency; if nltk's corpus data IS installed it is preferred so behavior
tracks the user's nltk version.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable

# NLTK's English stopword list (public domain word list).
NLTK_ENGLISH = frozenset("""
i me my myself we our ours ourselves you you're you've you'll you'd your
yours yourself yourselves he him his himself she she's her hers herself it
it's its itself they them their theirs themselves what which who whom this
that that'll these those am is are was were be been being have has had
having do does did doing a an the and but if or because as until while of
at by for with about against between into through during before after
above below to from up down in out on off over under again further then
once here there when where why how all any both each few more most other
some such no nor not only own same so than too very s t can will just don
don't should should've now d ll m o re ve y ain aren aren't couldn
couldn't didn didn't doesn doesn't hadn hadn't hasn hasn't haven haven't
isn isn't ma mightn mightn't mustn mustn't needn needn't shan shan't
shouldn shouldn't wasn wasn't weren weren't won won't wouldn wouldn't
""".split())

# The Stanford + PubMed medical-stopword lists from the _indexing variant
# (reference downstream/TextSGC_indexing/remove_words.py:45-71): clinical
# boilerplate terms that dominate biomedical abstracts.
MEDICAL = frozenset("""
patient patients disease diseases treatment treatments clinical study
studies result results method methods conclusion conclusions objective
objectives background significance significant group groups case cases
control controls year years day days week weeks month months age aged
male female men women use used using show showed shown found find
findings report reported reporting associated association increase
increased decrease decreased high higher low lower level levels effect
effects analysis data
""".split())


def nltk_english() -> frozenset[str]:
    try:
        from nltk.corpus import stopwords

        return frozenset(stopwords.words("english"))
    except Exception:
        return NLTK_ENGLISH


def top_k_frequency(docs: Iterable[str], k: int) -> frozenset[str]:
    """The k most frequent tokens of the corpus as stopwords (top50/top100
    lists of reference downstream/TextSGC_indexing/remove_words.py:111-127)."""
    freq = Counter()
    for doc in docs:
        freq.update(doc.split())
    return frozenset(w for w, _ in freq.most_common(k))


def fetch_stopwords(name: str, docs: Iterable[str] | None = None) -> frozenset[str]:
    """Registry: 'nltk' | 'medical' | 'nltk+medical' | 'top50' | 'top100' | 'none'."""
    if name == "nltk":
        return nltk_english()
    if name == "medical":
        return MEDICAL
    if name == "nltk+medical":
        return nltk_english() | MEDICAL
    if name in ("top50", "top100"):
        if docs is None:
            raise ValueError(f"stopword list {name!r} needs the corpus")
        return top_k_frequency(docs, int(name[3:]))
    if name == "none":
        return frozenset()
    raise ValueError(f"unknown stopword list {name!r}")
