"""``prop_ms.sgc``: a fit's hops as the program times them, the device
ms of its ``prop.hop`` spans (one a hop, ``graph/locality.py``) per
traced fit; CUDA events inside the program."""

from portbench.program_trace import span_ms


def read(run):
    return span_ms(run, "prop.hop")
