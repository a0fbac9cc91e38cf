"""``gcnii_step_mfu``: a GCNII training step's model operations over
(the profiled window's time per step x the configuration's peak), in %.

Operations, from the shapes and the algorithm's products as they stand:
forward, the input layer (2 n F H), each layer's propagation (2 nnz H)
and identity-mapping product (2 n H H), the output layer (2 n H C); the
backward takes two products of each forward product's size (one a
gradient of each operand), but the input layer needs only its weights'
gradient.
"""

from portbench.peaks import FLOPS
from portbench.readers import traced_step_s


def step_ops(c: dict) -> float:
    n, h, layers = c["n"], c["hidden"], c["layers"]
    first = 2.0 * n * c["features"] * h
    forward = (first + layers * (2.0 * c["nnz"] * h + 2.0 * n * h * h)
               + 2.0 * n * h * c["classes"])
    return 3.0 * forward - first


def read(run):
    t = traced_step_s(run)
    if not t:
        return None
    return 100.0 * step_ops(run.counts) / (t * FLOPS[run.config["peak"]])
