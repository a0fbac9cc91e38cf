"""``head_factor_ms.sgc``: the Newton head's set-up (``Z``, the Gram
matrix, the ridge, the Cholesky factor, the one-hot targets), the device
ms of its ``head.factor`` span (``train/optim.py``) per traced fit."""

from portbench.program_trace import span_ms


def read(run):
    return span_ms(run, "head.factor")
