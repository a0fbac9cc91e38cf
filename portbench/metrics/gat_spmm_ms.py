"""``gat_spmm_ms``: the attention-weighted aggregation of a GAT step,
the device ms of the ``gat.spmm`` spans (``ops/autograd.py``
``SpmmSegmentFn``, forward kernel B, backward kernels D and B over the
transpose) per traced step."""

from portbench.program_trace import span_ms


def read(run):
    return span_ms(run, "gat.spmm")
