"""Slope limiters as elementwise select dataflow.

Port of fluidsims_tpu.ops.limiters: minmod and the monotonized-central
limiter of the reference (tau_hypersonic_cuda.cu:217-228,
tau_hypersonic.c:49-61), branches written as `torch.where` selects.
"""

from __future__ import annotations

import torch

__all__ = ["minmod", "mc_limiter", "minmod3"]


def minmod(a, b):
    """minmod(a,b): 0 on sign disagreement, else the smaller magnitude."""
    pick_a = torch.abs(a) < torch.abs(b)
    same_sign = a * b > 0.0
    return torch.where(same_sign, torch.where(pick_a, a, b), 0.0)


def minmod3(a, b, c):
    return minmod(a, minmod(b, c))


def mc_limiter(dl, dc, dr):
    """Monotonized-central limiter.

    dl = q_i - q_{i-1}, dr = q_{i+1} - q_i, dc = 0.5*(q_{i+1} - q_{i-1}).
    """
    mm1 = minmod(dl, dr)
    mm2 = minmod(dc, 2.0 * dl)
    mm3 = minmod(dc, 2.0 * dr)
    return minmod(mm1, minmod(mm2, mm3))
