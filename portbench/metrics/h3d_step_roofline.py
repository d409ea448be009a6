"""Kernel #2's least time at the cell's shape and dtype (counts/
h3d_step.py, unpadded bytes; peaks.py) over the mean device time of its
launches."""


def read(ctx):
    return ctx.roofline("h3d_step")
