"""Seconds from the process's first statement to the window's start:
imports, CUDA context, the kernel library (its build in a new checkout),
the initial state and one warm frame."""


def read(ctx):
    return ctx.setup_s
