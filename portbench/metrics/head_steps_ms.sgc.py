"""``head_steps_ms.sgc``: the Newton head's steps, the device ms of its
``head.step`` spans (one a step, ``train/optim.py``) summed over a
traced fit."""

from portbench.program_trace import span_ms


def read(run):
    return span_ms(run, "head.step")
