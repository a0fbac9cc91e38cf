"""Skip-gram word2vec with negative sampling (the counterpart of
sgc_tpu/textgraph/word2vec.py), trained on the card.

The reference trains gensim-style SGNS as one jitted step per minibatch
(word2vec.py:83-128); the port runs the same step as a short sequence of
launches:

* ``build_vocab`` and ``skipgram_pairs`` are copies of the reference's
  (host numpy; the pairs match bit for bit);
* the draw is split from the step: :func:`draw_uniforms` draws the
  ``(B, K)`` uniforms from a ``torch.Generator`` on the card, and
  :func:`sgns_step` takes them, so a test can pass the reference's;
  the negatives are ``min(searchsorted(cdf, u), V - 1)`` over the
  unigram^0.75 CDF (word2vec.py:94-99; ``torch.searchsorted``'s default
  side is the reference's);
* the three scatter-adds of the update (word2vec.py:116-120) are two
  launches of kernel B (``ops.spmm.spmm_segment`` over
  ``ops.spmm.scatter_graph``): ``in_emb`` gets ``-lr * grad`` of the
  centers, ``out_emb`` those of the contexts and then of the ``B * K``
  negatives, in one CSR whose rows are the step's word ids, stably
  sorted. No float atomics: two fits give the same bits. The sums run
  in another order than XLA's sequential scatter (each row's updates are
  summed first, then added to the table), so the tables agree with the
  reference to f32 rounding, not bit for bit.

Batches are fixed-size, the remainder of each epoch's numpy permutation
dropped (word2vec.py:179-181). The trained vectors come back as
``dict[word, np.ndarray]`` for ``build_graph --embeddings``.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sgc_tpu_torch.ops.spmm import scatter_graph, spmm_segment
from sgc_tpu_torch.utils.device import resolve_device


@dataclass
class Word2VecConfig:
    dim: int = 100                # gensim default size=100
    window: int = 5               # symmetric context window
    negatives: int = 5            # negative samples per positive pair
    lr: float = 0.025             # gensim default alpha
    epochs: int = 5
    batch_size: int = 8192
    min_count: int = 1
    seed: int = 42


def build_vocab(
    docs: Sequence[Sequence[str]], min_count: int = 1
) -> tuple[list[str], dict[str, int], np.ndarray]:
    """Vocabulary + counts from tokenized docs (gensim build_vocab analog)."""
    counts = Counter(w for d in docs for w in d)
    vocab = sorted(w for w, c in counts.items() if c >= min_count)
    word_id = {w: i for i, w in enumerate(vocab)}
    freq = np.array([counts[w] for w in vocab], dtype=np.float64)
    return vocab, word_id, freq


def skipgram_pairs(
    docs: Sequence[Sequence[str]], word_id: dict[str, int], window: int
) -> np.ndarray:
    """All (center, context) id pairs, vectorized per offset: for each
    offset d in 1..window, token[i] with token[i+d], both directions,
    concatenated across docs."""
    outs = []
    for doc in docs:
        ids = np.array([word_id[w] for w in doc if w in word_id], dtype=np.int32)
        n = len(ids)
        for d in range(1, window + 1):
            if n <= d:
                break
            a, b = ids[:-d], ids[d:]
            outs.append(np.stack([a, b], axis=1))
            outs.append(np.stack([b, a], axis=1))
    if not outs:
        return np.zeros((0, 2), dtype=np.int32)
    return np.concatenate(outs, axis=0)


def noise_cdf(freq: np.ndarray, device) -> torch.Tensor:
    """The unigram^0.75 CDF, summed in float64 on the host and cast to
    f32, as the reference builds it (word2vec.py:154-155)."""
    noise = freq ** 0.75
    return torch.tensor(np.cumsum(noise / noise.sum()), dtype=torch.float32,
                        device=device)


def init_table(generator: torch.Generator, n_words: int, dim: int,
               device) -> torch.Tensor:
    """``uniform(-0.5, 0.5) / dim`` (word2vec.py:158-162), drawn on the
    generator's device and placed on ``device``."""
    t = torch.empty((n_words, dim), dtype=torch.float32,
                    device=generator.device)
    return (t.uniform_(-0.5, 0.5, generator=generator) / dim).to(device)


def draw_uniforms(generator: torch.Generator, batch: int,
                  negatives: int) -> torch.Tensor:
    """One step's ``(batch, negatives)`` uniforms in [0, 1)."""
    return torch.rand((batch, negatives), generator=generator,
                      device=generator.device)


def sgns_step(in_emb: torch.Tensor, out_emb: torch.Tensor,
              centers: torch.Tensor, contexts: torch.Tensor, u: torch.Tensor,
              cdf: torch.Tensor, lr: float):
    """One SGNS minibatch step (word2vec.py:83-128): returns the updated
    ``(in_emb, out_emb)`` and the mean loss. Every gradient is taken from
    the tables as they were before the step; the updates are kernel B
    (see the module docstring)."""
    (g_in, rows_in), (g_out, rows_out), loss = sgns_updates(
        in_emb, out_emb, centers, contexts, u, cdf, lr)
    return (spmm_segment(g_in, rows_in, dense=in_emb),
            spmm_segment(g_out, rows_out, dense=out_emb), loss)


def sgns_updates(in_emb: torch.Tensor, out_emb: torch.Tensor,
                 centers: torch.Tensor, contexts: torch.Tensor,
                 u: torch.Tensor, cdf: torch.Tensor, lr: float):
    """The step's gradients as kernel B's operands: ``((graph, rows)`` of
    ``in_emb``'s update, ``(graph, rows)`` of ``out_emb``'s, the loss),
    each graph ``scatter_graph(ids, V, -lr)`` over the rows' word ids."""
    n_words, dim = in_emb.shape
    negs = torch.clamp(torch.searchsorted(cdf, u), max=n_words - 1)

    v_c = in_emb[centers]                                  # (B, D)
    u_pos = out_emb[contexts]                              # (B, D)
    u_neg = out_emb[negs]                                  # (B, K, D)

    pos_logit = (v_c * u_pos).sum(dim=-1)                  # (B,)
    neg_logit = torch.einsum("bd,bkd->bk", v_c, u_neg)     # (B, K)

    # grad of -log s(x) is -s(-x); of -log s(-x) is s(x)
    g_pos = -torch.sigmoid(-pos_logit)
    g_neg = torch.sigmoid(neg_logit)

    grad_vc = g_pos[:, None] * u_pos + torch.einsum("bk,bkd->bd", g_neg,
                                                    u_neg)
    grad_upos = g_pos[:, None] * v_c
    grad_uneg = g_neg[..., None] * v_c[:, None, :]

    out_ids = torch.cat([contexts.reshape(-1).long(), negs.reshape(-1)])
    out_rows = torch.cat([grad_upos, grad_uneg.reshape(-1, dim)])
    loss = (F.softplus(-pos_logit)
            + F.softplus(neg_logit).sum(dim=-1)).mean()
    return ((scatter_graph(centers, n_words, -lr), grad_vc.contiguous()),
            (scatter_graph(out_ids, n_words, -lr), out_rows), loss)


class Word2Vec:
    """SGNS word2vec (gensim.Word2Vec analog), trained on ``device``
    (``None`` -> the card)."""

    def __init__(self, config: Word2VecConfig | None = None, device=None):
        self.config = config or Word2VecConfig()
        self.device = device
        self.vocab: list[str] = []
        self.word_id: dict[str, int] = {}
        self.vectors: np.ndarray | None = None

    def train(
        self,
        docs: Sequence[Sequence[str]],
        init_vectors: dict[str, np.ndarray] | None = None,
    ) -> "Word2Vec":
        """Fit on a corpus. ``init_vectors`` warm-starts words found in a
        pretrained map (the reference fine-tunes GoogleNews vectors,
        word2vec.py:16-76); out-of-map words get random init."""
        cfg = self.config
        dev = resolve_device(self.device)
        self.vocab, self.word_id, freq = build_vocab(docs, cfg.min_count)
        v = len(self.vocab)
        if v == 0:
            self.vectors = np.zeros((0, cfg.dim), np.float32)
            return self

        pairs = skipgram_pairs(docs, self.word_id, cfg.window)
        if len(pairs) == 0:
            self.vectors = np.zeros((v, cfg.dim), np.float32)
            return self

        cdf = noise_cdf(freq, dev)
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        in_emb = init_table(generator, v, cfg.dim, dev)
        if init_vectors:
            rows = [(i, np.asarray(vec, np.float32))
                    for i, vec in ((i, init_vectors.get(w))
                                   for i, w in enumerate(self.vocab))
                    if vec is not None and len(vec) == cfg.dim]
            if rows:
                at = torch.tensor([i for i, _ in rows], device=dev)
                in_emb[at] = torch.from_numpy(
                    np.stack([r for _, r in rows])).to(dev)
        out_emb = torch.zeros((v, cfg.dim), dtype=torch.float32, device=dev)

        pairs_d = torch.from_numpy(pairs).to(dev)
        b = min(cfg.batch_size, len(pairs))
        rng = np.random.default_rng(cfg.seed)
        for _ in range(cfg.epochs):
            perm = torch.from_numpy(rng.permutation(len(pairs))).to(dev)
            # fixed-size batches only; the remainder is dropped
            for s in range(0, len(pairs) - b + 1, b):
                batch = pairs_d[perm[s:s + b]]
                in_emb, out_emb, _ = sgns_step(
                    in_emb, out_emb, batch[:, 0], batch[:, 1],
                    draw_uniforms(generator, b, cfg.negatives), cdf, cfg.lr)
        self.vectors = in_emb.cpu().numpy()
        return self

    # -- queries ------------------------------------------------------------

    def __contains__(self, word: str) -> bool:
        return word in self.word_id

    def __getitem__(self, word: str) -> np.ndarray:
        return self.vectors[self.word_id[word]]

    def as_dict(self) -> dict[str, np.ndarray]:
        return {w: self.vectors[i] for i, w in enumerate(self.vocab)}

    def most_similar(self, word: str, topn: int = 10) -> list[tuple[str, float]]:
        """Cosine nearest neighbors (reference word2vec.py:128-150 export)."""
        if word not in self.word_id:
            return []
        vecs = self.vectors / (
            np.linalg.norm(self.vectors, axis=1, keepdims=True) + 1e-12
        )
        q = vecs[self.word_id[word]]
        sims = vecs @ q
        order = np.argsort(-sims)
        out = []
        for i in order:
            if i == self.word_id[word]:
                continue
            out.append((self.vocab[i], float(sims[i])))
            if len(out) >= topn:
                break
        return out

    def save_tsv(self, path) -> None:
        """word \\t v0 v1 ... export (reference biobert_get_tsv.py:5-25)."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "w") as f:
            for i, w in enumerate(self.vocab):
                vec = " ".join(f"{x:.6f}" for x in self.vectors[i])
                f.write(f"{w}\t{vec}\n")
