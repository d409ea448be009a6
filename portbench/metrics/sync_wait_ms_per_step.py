"""The host's time inside the synchronising runtime calls of the program's
`fst.step` spans, a step: what the step waits for the device
(portbench/spans.py)."""

from portbench import spans


def read(ctx):
    sp = spans.of(ctx)
    return None if sp is None else sp.sync_wait_ms_per_step()
