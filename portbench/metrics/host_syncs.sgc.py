"""``host_syncs.sgc``: the times a fit's head blocks the host on the
card (reads of device values, library calls that read an error flag
back, a copy from pageable memory, the closing synchronize), the
program's ``host_sync`` counter per traced fit."""

from portbench.program_trace import count


def read(run):
    return count(run, "host_sync")
