"""The mean over frames of the device's idle stretch that ends at the first
device operation launched inside the frame's `fst.run` span: the wait
between a frame's readback and its first step's work (portbench/spans.py)."""

from portbench import spans


def read(ctx):
    sp = spans.of(ctx)
    return None if sp is None else sp.frame_gap_ms()
