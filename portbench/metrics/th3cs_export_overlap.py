"""The share of the host's time inside th3cs's `fst.th3cs.collect` and
`fst.th3cs.write` spans during which some operation ran on the device:
how much of the export the device's work hides (portbench/spans.py).
Nothing where the window holds no such span."""

from portbench import spans

EXPORT = ("fst.th3cs.collect", "fst.th3cs.write")


def read(ctx):
    sp = spans.of(ctx)
    if sp is None:
        return None
    inside = [(s, e) for n, s, e in sp.spans if n in EXPORT]
    total = sum(e - s for s, e in inside)
    if total <= 0:
        return None
    covered = sum(max(0.0, min(e, be) - max(s, bs))
                  for s, e in inside for bs, be in sp.busy)
    return covered / total * 100.0
