"""Synchronising CUDA runtime calls the host makes inside the program's
`fst.step` spans, a step (a stream, device or event sync, or a synchronous
copy): each waits for the device to drain (portbench/spans.py)."""

from portbench import spans


def read(ctx):
    sp = spans.of(ctx)
    return None if sp is None else sp.syncs_per_step()
