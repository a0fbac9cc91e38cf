"""``gat_step_mfu``: a training step's model operations over (the
profiled window's time per step x the configuration's peak), in %.

Operations, from the shapes and the algorithm's products as they stand:
forward, each layer's projection (2 n F_in H F), attention scores (2 x 2
n H F) and aggregation (2 nnz H F); the backward takes two products of
each forward product's size (one a gradient of each operand), but the
first projection needs only its weights' gradient.
"""

from portbench.peaks import FLOPS
from portbench.readers import traced_step_s


def step_ops(c: dict) -> float:
    n, nnz = c["n"], c["nnz"]
    forward = 0.0
    for layer in c["layers"]:
        hf = layer["heads"] * layer["f_out"]
        forward += 2.0 * n * layer["f_in"] * hf + 4.0 * n * hf \
            + 2.0 * nnz * hf
    first = c["layers"][0]
    return 3.0 * forward \
        - 2.0 * n * first["f_in"] * first["heads"] * first["f_out"]


def read(run):
    t = traced_step_s(run)
    if not t:
        return None
    return 100.0 * step_ops(run.counts) / (t * FLOPS[run.config["peak"]])
