"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W power limit): the yardstick of every roofline and mfu share.
A card set below 700 W (`power_limit` in the result's `device`) runs
slower under load; the shares are stated against these peaks all the
same."""

HBM_BYTES_PER_S = 3.35e12
# outside the tensor cores: none of the port's kernels uses them
FLOPS = {"float32": 67e12, "float64": 34e12}


def least_seconds(ops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take for the work: the larger of the
    operations over the peak rate and the bytes over the bandwidth."""
    return max(ops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
