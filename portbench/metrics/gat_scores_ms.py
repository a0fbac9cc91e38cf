"""``gat_scores_ms``: the edge scores of a GAT step, the device ms of
the ``gat.scores`` spans (``ops/autograd.py`` ``EdgeScoresFn``: the
forward's gathers, the backward's row and column sums on kernel B) per
traced step."""

from portbench.program_trace import span_ms


def read(run):
    return span_ms(run, "gat.scores")
