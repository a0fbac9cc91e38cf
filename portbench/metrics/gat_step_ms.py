"""``gat_step_ms``: the window's seconds x 1000 over the training steps
it completed; host clock."""

from portbench.readers import window_ms


def read(run):
    return window_ms(run)
