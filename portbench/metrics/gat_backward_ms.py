"""``gat_backward_ms``: a step's ``backward()`` through the port's
autograd Functions (kernels B and D), the mean over the window's steps;
CUDA events after the loss and after the backward."""

from portbench.readers import span_ms


def read(run):
    return span_ms(run, "backward")
