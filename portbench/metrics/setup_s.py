"""``setup_s``: from the process's start to the first timed step (graph
generation, kernel build or load, the program's set-up, the warm
steps); host clock."""


def read(run):
    return run.setup_s
