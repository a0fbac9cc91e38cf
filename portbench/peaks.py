"""The card's peaks (NVIDIA H100 SXM data sheet, dense, at the full 700 W
power limit), frozen here so that every roofline share and utilization
of the benchmark divides by the same numbers."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"fp32": 67e12}    # by a configuration's ``peak``: FP32 outside
                           # the tensor cores


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time of work of ``ops`` FP32 operations and ``nbytes``
    bytes: the larger of the two over their peaks."""
    return max(ops / FLOPS["fp32"], nbytes / HBM_BYTES_PER_S)
