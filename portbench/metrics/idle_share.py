"""The share of the traced window in which no operation ran on the device:
1 - the union of the device operations' intervals over the window."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return (1.0 - ctx.trace.busy_s / ctx.trace.window_s) * 100.0
