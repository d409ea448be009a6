"""Kernel #1's least time at the cell's shape and dtype (counts/
h2d_step.py, peaks.py) over the mean device time of its launches."""


def read(ctx):
    return ctx.roofline("h2d_step")
