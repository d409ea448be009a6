"""Device time a frame of the operations launched inside th3cs's
`fst.th3cs.vis` and `fst.th3cs.quantize` spans: the schlieren of the
frame's state and its 8-bit quantization (portbench/spans.py).  Nothing
where the window holds no such span."""

from portbench import spans

DEVICE_WORK = ("fst.th3cs.vis", "fst.th3cs.quantize")


def read(ctx):
    sp = spans.of(ctx)
    if sp is None or not sp.frames or not any(
            s[0] in DEVICE_WORK for s in sp.spans):
        return None
    per_step = sum(sp.device_ms_per_step(n) for n in DEVICE_WORK)
    return per_step * sp.steps / len(sp.frames)
