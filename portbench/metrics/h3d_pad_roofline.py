"""Kernel p4's least time at the cell's shape and dtype (counts/
h3d_pad.py; peaks.py) over the mean device time of its launches."""


def read(ctx):
    return ctx.roofline("h3d_pad")
