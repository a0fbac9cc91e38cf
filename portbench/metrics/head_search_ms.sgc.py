"""``head_search_ms.sgc``: the line search inside the Newton steps (the
batched loss over the step grid, the argmin, the update), the device ms
of its ``head.search`` spans (one a step, inside ``head.step``) summed
over a traced fit."""

from portbench.program_trace import span_ms


def read(run):
    return span_ms(run, "head.search")
