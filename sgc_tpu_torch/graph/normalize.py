"""Adjacency normalization (the counterpart of sgc_tpu/graph/normalize.py).

Host-side scipy algebra, bit for bit the reference's. Only the transform
the main path uses is registered so far; the reference's other entries
(TextAugNormAdj, RWalkAdj, NormAdj, NoNorm) wait for the citation and text
slices of the port.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def aug_normalized_adjacency(adj: sp.spmatrix) -> sp.coo_matrix:
    """S = (D+I)^-1/2 (A+I) (D+I)^-1/2 ("AugNormAdj")."""
    adj = sp.coo_matrix(adj + sp.eye(adj.shape[0]))
    row_sum = np.asarray(adj.sum(1)).ravel()
    with np.errstate(divide="ignore"):
        d_inv_sqrt = np.power(row_sum, -0.5)
    d_inv_sqrt[np.isinf(d_inv_sqrt)] = 0.0
    d = sp.diags(d_inv_sqrt)
    return (d @ adj @ d).tocoo()


_NORMALIZATIONS = {
    "AugNormAdj": aug_normalized_adjacency,
}


def fetch_normalization(name: str):
    """Registry lookup by the reference's names."""
    try:
        return _NORMALIZATIONS[name]
    except KeyError:
        raise ValueError(
            f"Invalid normalization {name!r}; known: {sorted(_NORMALIZATIONS)}"
        ) from None
