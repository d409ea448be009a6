"""Device time a step of the operations launched inside the 3-D step's
`fst.h3d.pad` span: the halo padding's torch ops, its `cat`s first
(portbench/spans.py)."""

from portbench import spans


def read(ctx):
    sp = spans.of(ctx)
    return None if sp is None else sp.device_ms_per_step("fst.h3d.pad")
