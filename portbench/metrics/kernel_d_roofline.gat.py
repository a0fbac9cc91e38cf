"""``kernel_d_roofline.gat``: the least time of a step's attention-value
gradients (the SDDMMs, one a head and layer) over kernel D's device time
a step in the profiled window (kernels named ``sddmm_kernel``), in %.

The work is counted per layer over all its heads together (H heads of F
features): 2 F H operations an edge; both operands (``[n, H F]`` each),
the edge index (row and column, 8 bytes an edge) and the output (H
values an edge) once each. A launch that serves several heads therefore
still reads under 100%.
"""

from portbench.peaks import least_seconds
from portbench.trace import kernel_seconds


def sddmm_least_s(c: dict) -> float:
    nnz, n = c["nnz"], c["n"]
    total = 0.0
    for layer in c["layers"]:
        hf = layer["heads"] * layer["f_out"]
        nbytes = 2 * n * hf * 4 + nnz * 8 + nnz * layer["heads"] * 4
        total += least_seconds(2.0 * nnz * hf, nbytes)
    return total


def read(run):
    d = kernel_seconds(run.trace, "sddmm_kernel")
    if not d:
        return None
    return 100.0 * sddmm_least_s(run.counts) / d
