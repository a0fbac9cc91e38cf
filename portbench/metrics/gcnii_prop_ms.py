"""``gcnii_prop_ms``: the propagation of a GCNII step, the device ms of
the ``gcnii.prop`` spans (``ops/autograd.py`` ``SpmmSegmentFn`` as
``models/gcnii.py`` calls it: forward one kernel-B launch a layer with
the initial residual added in it, backward kernel B over the cached
transpose) per traced step."""

from portbench.program_trace import span_ms


def read(run):
    return span_ms(run, "gcnii.prop")
