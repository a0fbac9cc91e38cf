"""Model registry (the counterpart of sgc_tpu/models/registry.py).

``get_model(name)`` returns the ``(init_fn, apply_fn)`` pair of a model:
for SGC, ``init_sgc(generator, nfeat, nclass, **kw) -> SGC`` and
``sgc_apply(model, x)``. The reference's GCN is not ported yet.
"""

from __future__ import annotations

from sgc_tpu_torch.models.sgc import init_sgc, sgc_apply

_MODELS = {
    "SGC": (init_sgc, sgc_apply),
}

# models of the reference the port does not have yet, with the ROADMAP
# entry that will bring each
_NOT_PORTED = {
    "GCN": "ROADMAP queue 1 item 11 (other models)",
}


def get_model(name: str):
    try:
        return _MODELS[name]
    except KeyError:
        pass
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet: {_NOT_PORTED[name]}")
    raise NotImplementedError(
        f"model:{name} is not implemented! known: {sorted(_MODELS)}")


def register_model(name: str, init_fn, apply_fn) -> None:
    _MODELS[name] = (init_fn, apply_fn)
