"""``sgc_fit_ms``: the window's seconds x 1000 over the fits it
completed; host clock."""

from portbench.readers import window_ms


def read(run):
    return window_ms(run)
