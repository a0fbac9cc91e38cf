"""``head_ms.sgc``: a fit's head (``train_linear`` with the Newton
trainer, to its closing synchronize), the mean over the window's fits;
CUDA events after the hops and after the synchronize."""

from portbench.readers import span_ms


def read(run):
    return span_ms(run, "head")
