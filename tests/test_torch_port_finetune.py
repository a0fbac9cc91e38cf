"""The pretrained fine-tune of the port (``sgc_tpu_torch/train/finetune.py``)
against the reference's (``sgc_tpu/train/finetune.py``), on the CPU.

The reference fine-tunes a flax ``FlaxBertForSequenceClassification``;
the port a PyTorch ``BertForSequenceClassification`` holding the same
weights (``load_flax_weights_in_pytorch_model``), with the same word-piece
tokenizer, both built locally from a ``BertConfig`` (no download;
``transformers`` only). Both keep dropout off (the reference's
``train=False``), so the runs compare step for step.

Tolerances: the logits before training 1e-5 of max (two frameworks'
f32 BERT forwards); after the fine-tune (6 Adam steps), the logits of
every text within 1e-4 of max and the predictions equal: the gradients
agree to f32 rounding, and Adam divides each element by its own
magnitude, so an element whose gradient sits at the rounding noise can
step differently (measured 3.3e-6 and 6.2e-6 of max).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from sgc_tpu.train import finetune as ref  # noqa: E402

from sgc_tpu_torch.train import finetune as port  # noqa: E402

CPU = "cpu"
LOGIT_TOL = 1e-5
TRAINED_TOL = 1e-4


@pytest.fixture(scope="module")
def tiny_bert(tmp_path_factory):
    """The reference's tiny flax BERT and tokenizer, and a factory of torch
    copies of its initial weights."""
    from transformers import (
        BertConfig,
        BertForSequenceClassification,
        BertTokenizer,
    )
    from transformers.modeling_flax_pytorch_utils import (
        load_flax_weights_in_pytorch_model,
    )
    from transformers.models.bert.modeling_flax_bert import (
        FlaxBertForSequenceClassification,
    )

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
             "aa", "bb", "cc", "xx", "yy", "zz"]
    vf = tmp_path_factory.mktemp("bert") / "vocab.txt"
    vf.write_text("\n".join(vocab))
    tok = BertTokenizer(vocab_file=str(vf))
    cfg = BertConfig(
        vocab_size=len(vocab), hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=32, num_labels=2,
    )
    flax_model = FlaxBertForSequenceClassification(cfg, seed=0)

    def torch_copy():
        return load_flax_weights_in_pytorch_model(
            BertForSequenceClassification(cfg), flax_model.params)

    return tok, flax_model, torch_copy


def toy_task(n=48, seed=0):
    rng = np.random.default_rng(seed)
    words = {0: ["aa", "bb", "cc"], 1: ["xx", "yy", "zz"]}
    texts, labels = [], []
    for _ in range(n):
        y = int(rng.integers(0, 2))
        texts.append(" ".join(rng.choice(words[y], 4)))
        labels.append(y)
    return texts, np.asarray(labels)


def flax_logits(model, params, tok, texts, max_length):
    enc = tok(texts, padding="max_length", truncation=True,
              max_length=max_length, return_tensors="np")
    return np.asarray(model(input_ids=enc["input_ids"],
                            attention_mask=enc["attention_mask"],
                            params=params, train=False).logits)


@torch.no_grad()
def torch_logits(model, tok, texts, max_length):
    enc = tok(texts, padding="max_length", truncation=True,
              max_length=max_length, return_tensors="pt")
    return model(input_ids=enc["input_ids"],
                 attention_mask=enc["attention_mask"]).logits.numpy()


def rel_err(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("head_only", [False, True])
def test_finetune_matches_reference(tiny_bert, head_only):
    tok, flax_model, torch_copy = tiny_bert
    texts, labels = toy_task(24)
    probe = texts + ["", "aa xx", "zz zz bb"]
    kw = dict(lr=5e-3, epochs=2, batch_size=8, max_length=8,
              head_only=head_only)
    model = torch_copy()
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert rel_err(torch_logits(model.eval(), tok, probe, 8),
                   flax_logits(flax_model, flax_model.params, tok, probe,
                               8)) <= LOGIT_TOL

    ref_predict, (params, _) = ref.finetune_pretrained(
        texts, labels, 2, ref.FinetuneConfig(**kw), tokenizer=tok,
        model=flax_model)
    predict, (trained, _) = port.finetune_pretrained(
        texts, labels, 2, port.FinetuneConfig(**kw), tokenizer=tok,
        model=model, device=CPU)
    assert not trained.training          # dropout stayed off
    want = flax_logits(flax_model, params, tok, probe, 8)
    assert rel_err(torch_logits(trained, tok, probe, 8), want) <= \
        TRAINED_TOL
    np.testing.assert_array_equal(predict(probe), ref_predict(probe))
    for n, p in trained.named_parameters():
        moved = not torch.equal(p.detach(), start[n])
        assert moved == (not head_only or "classifier" in n), n


def test_finetune_learns_toy_task(tiny_bert):
    """The reference's own case, on the port."""
    tok, _, torch_copy = tiny_bert
    texts, labels = toy_task()
    predict, _ = port.finetune_pretrained(
        texts, labels, 2,
        port.FinetuneConfig(lr=5e-3, epochs=8, batch_size=16, max_length=8),
        tokenizer=tok, model=torch_copy(), device=CPU)
    acc = float((predict(texts) == labels).mean())
    assert acc > 0.9, f"toy fine-tune accuracy {acc}"


def test_head_mask_over_torch_names(tiny_bert):
    _, _, torch_copy = tiny_bert
    names = [n for n, _ in torch_copy().named_parameters()]
    mask = port._head_mask(names)
    head = [n for n in names if "classifier" in n]
    assert head and all(mask[n] == 1.0 for n in head)
    assert all(mask[n] == 0.0 for n in names if n not in head)


def test_head_mask_rejects_unrecognized_and_knows_xlnet():
    with pytest.raises(ValueError, match="no classification-head"):
        port._head_mask(["encoder.w"])
    mask = port._head_mask(["transformer.w", "logits_proj.kernel",
                            "sequence_summary.summary.weight"])
    assert mask == {"transformer.w": 0.0, "logits_proj.kernel": 1.0,
                    "sequence_summary.summary.weight": 1.0}
