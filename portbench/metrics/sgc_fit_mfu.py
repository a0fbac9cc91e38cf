"""``sgc_fit_mfu``: a fit's model operations over (the profiled window's
time per fit x the configuration's peak), in %.

Operations, from the shapes and the algorithm's products as they stand:
the hops (2 F an edge, the full operator's edges for each hop but the
last and the train rows' edges for the last); the head on ``Z = [P, 1]``
(n train rows, d = F + 1, C classes): the Gram matrix ``Z^T Z`` (2 n
d^2) and, in each Newton step, ``Z v``, ``Z^T (P - Y)`` and ``Z D`` (3 x
2 n d C).
"""

from portbench.peaks import FLOPS
from portbench.readers import traced_step_s


def fit_ops(c: dict) -> float:
    f, n, k = c["features"], c["n_train"], c["classes"]
    d = f + 1
    hops = 2.0 * f * ((c["degree"] - 1) * c["nnz"] + c["nnz_final"])
    return hops + 2.0 * n * d * d + c["newton_steps"] * 3 * 2.0 * n * d * k


def read(run):
    t = traced_step_s(run)
    if not t:
        return None
    return 100.0 * fit_ops(run.counts) / (t * FLOPS[run.config["peak"]])
