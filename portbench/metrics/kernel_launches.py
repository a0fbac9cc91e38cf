"""``kernel_launches.<cell group>``: the port's hand-written kernels
launched in a step, the sum of the program's ``launch.<C entry>``
counters per traced step (each launch counted once; sub-counts such as
``within.*`` are not added)."""

from portbench.program_trace import count


def read(run):
    return count(run, "launch.")
