"""Tokenizer and lemmatizer registries (the counterpart of
sgc_tpu/textgraph/tokenize.py; host strings, the same rules bit for bit).

Parity targets: the `clean_str` regex tokenizer (reference
downstream/TextSGC/utils.py:93-108 — strip punctuation, split clitics,
lowercase), the manual variant with digit stripping
(downstream/TextSGC_indexing/utils.py:152-170), and the _indexing
tokenizer menu {manual, nltk, treebank, scispacy, ref}
(downstream/TextSGC_indexing/remove_words.py:131-221). scispacy and the
BioLemmatizer jar are external tools; they register only when importable /
present so the rest of the pipeline has zero optional-dependency cost.
"""

from __future__ import annotations

import re
from typing import Callable


# The reference's cleaning pass as a DATA TABLE (behavioral parity with
# downstream/TextSGC/utils.py:93-108 — the exact rule sequence, including
# its idiosyncrasies, defines the tokenization and therefore the vocab/
# graph; note rules 3-13 are dead after rule 2 strips every non-
# alphanumeric character, but they are kept because parity means applying
# the same function, dead branches and all).
_CLEAN_RULES: list[tuple[re.Pattern, str]] = [
    (re.compile(r"[?|$|.|!]"), ""),            # sentence punctuation
    (re.compile(r"[^a-zA-Z0-9 ]"), ""),        # anything non-alphanumeric
    (re.compile(r"\'s"), " 's"),               # clitic splits (dead: no
    (re.compile(r"\'ve"), " 've"),             # apostrophes survive rule 2)
    (re.compile(r"n\'t"), " n't"),
    (re.compile(r"\'re"), " 're"),
    (re.compile(r"\'d"), " 'd"),
    (re.compile(r"\'ll"), " 'll"),
    (re.compile(r","), " , "),                 # separator spacing (dead)
    (re.compile(r"!"), " ! "),
    (re.compile(r"\("), r" \( "),
    (re.compile(r"\)"), r" \) "),
    (re.compile(r"\?"), r" \? "),
    (re.compile(r"\s{2,}"), " "),              # whitespace collapse
]


def clean_str(s: str) -> str:
    """Reference clean_str: punctuation strip, clitic split, lowercase."""
    for pattern, repl in _CLEAN_RULES:
        s = pattern.sub(repl, s)
    return s.strip().lower()


def clean_str_manual(s: str, strip_digits: bool = True) -> str:
    """_indexing manual cleaner: also removes standalone numbers
    (reference downstream/TextSGC_indexing/utils.py:152-170,
    build_graph_v2.py:72-75)."""
    s = clean_str(s)
    if strip_digits:
        s = " ".join(w for w in s.split() if not w.isdigit())
    return s


def tokenize_manual(s: str) -> list[str]:
    return clean_str(s).split()


def tokenize_whitespace(s: str) -> list[str]:
    return s.lower().split()


_TREEBANK_RULES = [
    (re.compile(r"^\""), r"`` "),
    (re.compile(r"([ (\[{<])\""), r"\1 `` "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    (re.compile(r"([^\.])(\.)([\]\)}>\"\']*)\s*$"), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"[\]\[\(\)\{\}<>]"), r" \g<0> "),
    (re.compile(r"--"), r" -- "),
    (re.compile(r"\""), r" '' "),
    (re.compile(r"([^'])' "), r"\1 ' "),
    (re.compile(r"'([sSmMdD]) "), r" '\1 "),
    (re.compile(r"('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r" \1 "),
    (re.compile(r",([^\d])"), r" , \1"),
]


def tokenize_treebank(s: str) -> list[str]:
    """Penn-Treebank-style tokenizer (pure-regex re-implementation; used
    when nltk's punkt data is unavailable). Mirrors the rule set of the
    classic sed script; lowercases to match the reference pipeline."""
    try:
        from nltk.tokenize import TreebankWordTokenizer

        return [t.lower() for t in TreebankWordTokenizer().tokenize(s)]
    except Exception:
        pass
    s = s + " "
    for pattern, repl in _TREEBANK_RULES:
        s = pattern.sub(repl, s)
    return s.lower().split()


def tokenize_nltk(s: str) -> list[str]:
    """nltk.word_tokenize when punkt data exists, else treebank fallback."""
    try:
        from nltk.tokenize import word_tokenize

        return [t.lower() for t in word_tokenize(s)]
    except Exception:
        return tokenize_treebank(s)


_TOKENIZERS: dict[str, Callable[[str], list[str]]] = {
    "manual": tokenize_manual,
    "ref": tokenize_manual,
    "whitespace": tokenize_whitespace,
    "treebank": tokenize_treebank,
    "nltk": tokenize_nltk,
}


def fetch_tokenizer(name: str) -> Callable[[str], list[str]]:
    if name == "scispacy":
        try:
            import spacy

            nlp = spacy.load("en_core_sci_lg")
            return lambda s: [t.text.lower() for t in nlp(s)]
        except Exception as e:
            raise RuntimeError(
                "scispacy tokenizer requires spacy + en_core_sci_lg"
            ) from e
    try:
        return _TOKENIZERS[name]
    except KeyError:
        raise ValueError(
            f"unknown tokenizer {name!r}; known: {sorted(_TOKENIZERS)} + scispacy"
        ) from None


# ----------------------------------------------------------------- lemmas

_WN_SUFFIXES = [
    # (suffix, replacement) rules approximating WordNet morphy for the
    # common English inflections; used when wordnet data is unavailable.
    ("sses", "ss"), ("ies", "y"), ("ves", "f"), ("xes", "x"), ("zes", "z"),
    ("ches", "ch"), ("shes", "sh"), ("men", "man"), ("ing", ""),
    ("ied", "y"), ("ed", ""), ("s", ""),
]


def lemmatize_wordnet(tokens: list[str]) -> list[str]:
    """POS-aware WordNet lemmatizer (reference
    downstream/TextSGC_indexing/remove_words.py:172-190) with a rule-based
    fallback when the wordnet corpus is not installed."""
    try:
        from nltk.corpus import wordnet
        from nltk.stem import WordNetLemmatizer
        from nltk import pos_tag

        wnl = WordNetLemmatizer()
        tag_map = {"J": wordnet.ADJ, "V": wordnet.VERB,
                   "N": wordnet.NOUN, "R": wordnet.ADV}
        out = []
        for word, tag in pos_tag(tokens):
            pos = tag_map.get(tag[:1], wordnet.NOUN)
            out.append(wnl.lemmatize(word, pos))
        return out
    except Exception:
        out = []
        for w in tokens:
            if len(w) > 3:
                for suf, rep in _WN_SUFFIXES:
                    if w.endswith(suf) and len(w) - len(suf) + len(rep) >= 3:
                        w = w[: len(w) - len(suf)] + rep
                        break
            out.append(w)
        return out


def lemmatize_none(tokens: list[str]) -> list[str]:
    return tokens


def fetch_lemmatizer(name: str) -> Callable[[list[str]], list[str]]:
    """Registry: 'wordnet' | 'none' | 'bio' (BioLemmatizer jar, external)."""
    if name == "wordnet":
        return lemmatize_wordnet
    if name == "none":
        return lemmatize_none
    if name == "bio":
        from sgc_tpu_torch.textgraph.biolemma import lemmatize_bio

        return lemmatize_bio
    raise ValueError(f"unknown lemmatizer {name!r}")
