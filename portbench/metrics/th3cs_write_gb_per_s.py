"""A frame's bytes (`frame_bytes`, one index a cell) over the host's time
a frame inside th3cs's `fst.th3cs.write` spans: the rate at which the
writer takes a frame (CRC, write, header patch) in GB/s
(portbench/spans.py).  Nothing where the window holds no such span."""

from portbench import spans


def read(ctx):
    sp = spans.of(ctx)
    if sp is None or not sp.frames:
        return None
    inside = sum(e - s for n, s, e in sp.spans if n == "fst.th3cs.write")
    if inside <= 0:
        return None
    per_frame_s = inside * 1e-6 / len(sp.frames)
    return ctx.work["frame_bytes"] / per_frame_s / 1e9
