"""``step_p95_ms.<cell group>``: the 95th percentile of the window's step times, each
from CUDA events at the step's start and after its closing synchronize,
over all steps of the window."""

import numpy as np


def read(run):
    if not run.step_ms:
        return None
    return float(np.percentile(run.step_ms, 95))
