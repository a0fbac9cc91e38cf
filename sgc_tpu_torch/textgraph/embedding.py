"""Word embeddings for the doc-word graph (the counterpart of
sgc_tpu/textgraph/embedding.py): the store, a word -> vector map
persisted as one ``.npz`` whose keys are the words, which ``build_graph
--embeddings`` reads (cosine + PMI word-word weights,
``TextGraphBuilder(embeddings=...)``); and the embedders that write it
(the reference's ``run_embedding.py``, :class:`WordEmbedder`).

The embedder runs a HuggingFace PyTorch encoder on the card (backend
``torch``; ``transformers`` is imported lazily, as in the reference).
The reference's ``flax`` backend has no counterpart here and raises,
naming ``torch``. ``auto`` falls back to :func:`hash_embedding` with a
warning when no model loads (the reference's documented behaviour for
missing weights), but only on a load error (``LOAD_ERRORS``); the model
is moved to the card outside that ``try``, so a fault of the card
raises. The forward runs under ``torch.inference_mode()`` and leaves the
process's grad mode alone, where the reference switches it off for the
whole process (embedding.py:168).
"""

from __future__ import annotations

import hashlib
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from sgc_tpu_torch.utils.device import resolve_device

POOLING_MODES = ("none", "first", "mean", "sum")
BACKENDS = ("auto", "torch", "hash")
# what ``from_pretrained`` raises for a model or tokenizer it cannot load
# (``transformers`` missing, no such files, an unknown name)
LOAD_ERRORS = (ImportError, OSError, ValueError)


def save_embedding_map(path: str | Path, table: dict[str, np.ndarray]) -> None:
    """Persist a word->vector map (compressed npz)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **{w: np.asarray(v) for w, v in table.items()})


def load_embedding_map(path: str | Path) -> dict[str, np.ndarray]:
    """Load a word->vector map saved by :func:`save_embedding_map`."""
    with np.load(Path(path), allow_pickle=False) as z:
        return {w: z[w] for w in z.files}


# ---------------------------------------------------------------------------
# Deterministic fallback embedder (hermetic tests, no downloads)
# ---------------------------------------------------------------------------


def hash_embedding(word: str, dim: int = 64) -> np.ndarray:
    """Deterministic unit-norm pseudo-embedding seeded by the sha256 of the
    word (the reference's, bit for bit); used when no pretrained model is
    available and in tests."""
    seed = int.from_bytes(hashlib.sha256(word.encode()).digest()[:8], "little")
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(dim).astype(np.float32)
    return v / (np.linalg.norm(v) + 1e-12)


# ---------------------------------------------------------------------------
# Transformer embedder
# ---------------------------------------------------------------------------


@dataclass
class EmbedderConfig:
    model_name: str = "bert-base-uncased"
    pooling: str = "mean"          # none | first | mean | sum
    layer: int = -1                # hidden-states layer to read (-1 = last)
    batch_size: int = 64
    max_length: int = 16           # subword budget per vocab word
    backend: str = "auto"          # auto | torch | hash
    hash_dim: int = 64             # fallback dimensionality


@dataclass
class WordEmbedder:
    """One vector per vocabulary word from a pretrained encoder (the
    reference's ``run_embedding.py`` Embedder): tokenize each word, run
    the encoder on ``device`` (``None`` -> the card), pool the subword
    token vectors. Backends: ``torch`` (HF ``AutoModel``), ``hash``
    (:func:`hash_embedding`), ``auto`` (torch, else hash with a warning)."""

    config: EmbedderConfig = field(default_factory=EmbedderConfig)
    device: object = None

    def __post_init__(self):
        self._backend = None
        self._model = None
        self._tokenizer = None
        self._device = None

    # -- backend resolution -------------------------------------------------

    def _resolve_backend(self) -> str:
        if self._backend is not None:
            return self._backend
        want = self.config.backend
        if want == "flax":
            raise ValueError(
                "backend 'flax' runs the encoder with JAX, which this "
                "package does not use: pass backend='torch' (or 'auto' or "
                "'hash')")
        if want not in BACKENDS:
            raise ValueError(f"unknown backend {want!r}; one of {BACKENDS}")
        if want == "hash":
            self._backend = "hash"
            return self._backend
        dev = resolve_device(self.device)
        try:
            self._load_model()
        except LOAD_ERRORS as e:
            error = f"torch: {type(e).__name__}: {e}"
            if want != "auto":
                # an explicitly requested backend must not degrade into
                # hash pseudo-embeddings: the cosine edge weights built
                # from them would be garbage with no error
                raise RuntimeError(
                    f"embedding backend {want!r} for model "
                    f"{self.config.model_name!r} failed to load: {error}"
                ) from e
            warnings.warn(
                f"no pretrained embedding backend available ({error}); "
                "falling back to deterministic hash pseudo-embeddings",
                stacklevel=3,
            )
            self._backend = "hash"
            return self._backend
        # outside the try: a fault of the card raises, never hash vectors
        self._model.to(dev)
        self._device = dev
        self._backend = "torch"
        return self._backend

    def _load_model(self) -> None:
        from transformers import AutoModel, AutoTokenizer

        self._tokenizer = AutoTokenizer.from_pretrained(self.config.model_name)
        self._model = AutoModel.from_pretrained(
            self.config.model_name, output_hidden_states=True
        )
        self._model.eval()

    # -- pooling (reference run_embedding.py:190-212) -----------------------

    def _pool(self, token_vecs: np.ndarray) -> np.ndarray:
        mode = self.config.pooling
        if mode not in POOLING_MODES:
            raise ValueError(f"unknown pooling {mode!r}; one of {POOLING_MODES}")
        if mode == "none":
            return token_vecs
        if mode == "first":
            return token_vecs[0]
        if mode == "sum":
            return token_vecs.sum(axis=0)
        return token_vecs.mean(axis=0)

    # -- batched forward ----------------------------------------------------

    def _encode_batch(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """The chosen hidden layer ``(B, L, H)``, on the host. Runs under
        ``inference_mode``: the process's grad mode is left alone (the
        reference switches it off process-wide, embedding.py:168)."""
        import torch

        with torch.inference_mode():
            out = self._model(
                input_ids=torch.from_numpy(ids).long().to(self._device),
                attention_mask=torch.from_numpy(mask).long().to(self._device),
            )
            return out.hidden_states[self.config.layer].float().cpu().numpy()

    # -- public API ---------------------------------------------------------

    def embed_words(self, words: Sequence[str]) -> dict[str, np.ndarray]:
        """Return word -> pooled vector for every word in ``words``."""
        backend = self._resolve_backend()
        if backend == "hash":
            return {w: hash_embedding(w, self.config.hash_dim) for w in words}

        cfg = self.config
        table: dict[str, np.ndarray] = {}
        # fixed-shape batches, the last padded, as the reference batches
        for start in range(0, len(words), cfg.batch_size):
            chunk = list(words[start : start + cfg.batch_size])
            enc = self._tokenizer(
                chunk,
                padding="max_length",
                truncation=True,
                max_length=cfg.max_length,
                return_tensors="np",
            )
            ids = enc["input_ids"].astype(np.int32)
            mask = enc["attention_mask"].astype(np.int32)
            if ids.shape[0] < cfg.batch_size:  # pad batch to static size
                pad = cfg.batch_size - ids.shape[0]
                ids = np.pad(ids, ((0, pad), (0, 0)))
                mask = np.pad(mask, ((0, pad), (0, 0)))
            hidden = self._encode_batch(ids, mask)
            for i, w in enumerate(chunk):
                n_tok = int(mask[i].sum())
                # strip [CLS]/[SEP]-style specials when present (>=3 tokens)
                lo, hi = (1, n_tok - 1) if n_tok >= 3 else (0, n_tok)
                table[w] = self._pool(hidden[i, lo:hi].astype(np.float32))
        return table

    def embed_vocab_to_file(
        self, words: Iterable[str], path: str | Path
    ) -> dict[str, np.ndarray]:
        table = self.embed_words(list(words))
        save_embedding_map(path, table)
        return table
