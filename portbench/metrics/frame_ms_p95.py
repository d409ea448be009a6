"""The 95th percentile of every frame of the window, a frame timed from
the start of its enqueue to its clock arriving on the host."""

from portbench.stats import percentile


def read(ctx):
    return percentile(ctx.window.frames, 95) * 1e3
