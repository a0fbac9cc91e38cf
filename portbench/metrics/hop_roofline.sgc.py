"""``hop_roofline.sgc``: the least time of a fit's hops over their mean
time (``hops_ms.sgc``), in %.

The work is counted as kernel B's rule counts a sparse product, whichever
kernel implements the hop: 2 F operations an edge; each edge's column
and value (8 bytes), the row pointer, each x row the edges use and the
output once. The full hops run over the whole operator, the last over
the train rows' edges. Each hop's least time is the larger of its
operations at the FP32 peak and its bytes at the HBM rate.
"""

from portbench.peaks import least_seconds
from portbench.readers import span_ms


def hop_least_s(c: dict) -> float:
    f = c["features"]
    full = least_seconds(
        2.0 * c["nnz"] * f,
        c["nnz"] * 8 + (c["n"] + 1) * 4 + (c["used_cols"] + c["n"]) * f * 4)
    last = least_seconds(
        2.0 * c["nnz_final"] * f,
        c["nnz_final"] * 8 + (c["n_train"] + 1) * 4
        + (c["used_cols_final"] + c["n_train"]) * f * 4)
    return (c["degree"] - 1) * full + last


def read(run):
    hops = span_ms(run, "hops")
    if not hops:
        return None
    return 100.0 * hop_least_s(run.counts) * 1e3 / hops
