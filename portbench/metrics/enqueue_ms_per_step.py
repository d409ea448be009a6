"""The host's time inside the program's `run` calls of the window (the
benchmark's span around each frame's call, before its readback), a step."""


def read(ctx):
    return sum(ctx.window.enqueue) / ctx.window.steps * 1e3
