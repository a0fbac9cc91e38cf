"""``device_idle.<cell group>``: the share of the profiled window in
which no kernel, copy or memset runs on the device (the union of their
intervals), in %."""

from portbench.trace import idle_percent


def read(run):
    return idle_percent(run.trace)
