"""The host's time a frame inside th3cs's `fst.th3cs.collect` (the
frame's volume copied to the host, with the wait for the device) and
`fst.th3cs.write` (the CRC, the write, the header patch) spans
(portbench/spans.py).  Nothing where the window holds no such span."""

from portbench import spans

EXPORT = ("fst.th3cs.collect", "fst.th3cs.write")


def read(ctx):
    sp = spans.of(ctx)
    if sp is None or not sp.frames:
        return None
    inside = [e - s for n, s, e in sp.spans if n in EXPORT]
    if not inside:
        return None
    return sum(inside) * 1e-3 / len(sp.frames)
