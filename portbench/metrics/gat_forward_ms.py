"""``gat_forward_ms``: a step's forward (both ``multi_head_gat`` layers
and the loss), the mean over the window's steps; CUDA events at the
step's start (``zero_grad`` included) and after the loss."""

from portbench.readers import span_ms


def read(run):
    return span_ms(run, "forward")
