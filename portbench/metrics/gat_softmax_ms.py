"""``gat_softmax_ms``: the per-row softmax of a GAT step, the device ms
of the ``gat.softmax`` spans (``ops/autograd.py`` ``SegmentSoftmaxFn``:
the row max scatter, the exponentials, the kernel-B row sums) per traced
step."""

from portbench.program_trace import span_ms


def read(run):
    return span_ms(run, "gat.softmax")
