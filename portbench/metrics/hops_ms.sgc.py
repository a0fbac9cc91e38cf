"""``hops_ms.sgc``: a fit's hops (``khop_traceable``), the mean over the
window's fits; CUDA events at the fit's start and after the hops."""

from portbench.readers import span_ms


def read(run):
    return span_ms(run, "hops")
