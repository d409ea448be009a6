"""The host's time inside the program's `fst.step` spans less its
synchronising calls there, a step: enqueueing a step, the kernels'
wrappers and the torch ops' dispatch included (portbench/spans.py)."""

from portbench import spans


def read(ctx):
    sp = spans.of(ctx)
    return None if sp is None else sp.dispatch_ms_per_step()
