"""Device launches a step in the traced window: the port's kernels as its
LaunchCounters count them, plus every other device operation the profiler
recorded."""


def read(ctx):
    others = ctx.device_others()
    if others is None:
        return None
    return (ctx.trace.port_launches + len(others)) / ctx.trace.steps
