"""Cell-steps completed in the window over the window's seconds, in
millions: every cell of the grid, every step of every frame, the window
bracketed by syncs."""


def read(ctx):
    return ctx.work["cells"] * ctx.window.steps / ctx.window.seconds / 1e6
