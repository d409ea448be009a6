"""The numbers that decide `correct`: how far a state lies from the
reference's, field by field.

A state is a dict of tensors: the grid fields the reference module names
in FIELDS, and the clock scalars in CLOCK.  Each grid field's largest
absolute difference is taken over every cell and divided by the field's
scale, a constant of the configuration (reference.scales); a clock
scalar's difference by the reference's magnitude.  A difference that is
not finite reads infinity."""

from __future__ import annotations

import math

import torch


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def field_err(prog: dict, ref: dict, fields, scales: dict) -> float:
    worst = 0.0
    for k in fields:
        d = (prog[k].to(torch.float64) - ref[k].to(torch.float64)).abs()
        worst = max(worst, _finite(float(d.max())) / scales[k])
    return worst


def clock_err(prog: dict, ref: dict, clock) -> float:
    worst = 0.0
    for k in clock:
        p, r = float(prog[k]), float(ref[k])
        worst = max(worst, _finite(abs(p - r) / max(abs(r), 1e-300)))
    return worst
