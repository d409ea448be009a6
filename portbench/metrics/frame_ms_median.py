"""The median frame of the window (host clock), steadier than its tail."""

import statistics


def read(ctx):
    return statistics.median(ctx.window.frames) * 1e3
