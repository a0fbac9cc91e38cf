"""``kernel_b_roofline.gcnii``: the least time of a GCNII step's sparse
products over kernel B's device time a step in the profiled window
(kernels named ``csr_spmm_kernel``), in %.

A step runs ``layers`` products over the operator forward and as many
over its transpose backward, each at F = ``hidden``. Each is counted as
kernel B's rule counts a hop (``hop_roofline.sgc``): 2 F operations an
edge; each edge's column and value (8 bytes), the row pointer, each x row
the edges use and the output once; a launch that adds a dense operand
(the program's ``within.csr_spmm_dense`` count a traced step, 0 where the
program has no such counter) reads it once more, ``[n, F]``. Each
launch's least time is the larger of its operations at the FP32 peak and
its bytes at the HBM rate.
"""

from portbench.peaks import least_seconds
from portbench.program_trace import count
from portbench.trace import kernel_seconds


def products_least_s(c: dict, dense_launches: float) -> float:
    n, nnz, f, layers = c["n"], c["nnz"], c["hidden"], c["layers"]
    ops = 2.0 * nnz * f
    index = nnz * 8 + (n + 1) * 4
    fwd = index + (c["used_cols"] + n) * f * 4
    bwd = index + (c["used_cols_t"] + n) * f * 4
    dense = min(dense_launches, layers)
    return (dense * least_seconds(ops, fwd + n * f * 4)
            + (layers - dense) * least_seconds(ops, fwd)
            + layers * least_seconds(ops, bwd))


def read(run):
    b = kernel_seconds(run.trace, "csr_spmm_kernel")
    if not b:
        return None
    dense = count(run, "within.csr_spmm_dense") or 0.0
    return 100.0 * products_least_s(run.counts, dense) / b
