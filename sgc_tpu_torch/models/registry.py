"""Model registry (the counterpart of sgc_tpu/models/registry.py).

``get_model(name)`` returns the ``(init_fn, apply_fn)`` pair of a model:

  SGC: ``init_sgc(generator, nfeat, nclass, **kw) -> SGC``,
       ``sgc_apply(model, x)``;
  GCN: ``init_gcn(generator, nfeat, nhid, nclass, device=None) -> GCN``,
       ``gcn_apply(model, x, graph, **kw)``;
  GCNII: ``init_gcnii(generator, nfeat, nhid, nclass, n_layers,
         device=None) -> GCNII``, ``gcnii_apply(model, x, graph_scaled,
         alpha, lamda, dropout=0.0, generator=None)``.
"""

from __future__ import annotations

from sgc_tpu_torch.models.gcn import gcn_apply, init_gcn
from sgc_tpu_torch.models.gcnii import gcnii_apply, init_gcnii
from sgc_tpu_torch.models.sgc import init_sgc, sgc_apply

_MODELS = {
    "SGC": (init_sgc, sgc_apply),
    "GCN": (init_gcn, gcn_apply),
    "GCNII": (init_gcnii, gcnii_apply),
}


def get_model(name: str):
    try:
        return _MODELS[name]
    except KeyError:
        raise NotImplementedError(
            f"model:{name} is not implemented! known: {sorted(_MODELS)}"
        ) from None


def register_model(name: str, init_fn, apply_fn) -> None:
    _MODELS[name] = (init_fn, apply_fn)
