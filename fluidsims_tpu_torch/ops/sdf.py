"""Analytic signed-distance functions for solid geometry masks.

Port of fluidsims_tpu.ops.sdf: the sphere-cone capsule
(tau_hypersonic_cuda.cu:633-686), circle (tau_hypersonic.c:460-466) and
sphere (tau_hypersonic_3d_cuda.cu:173-178), elementwise over coordinate
tensors; negative = inside solid.
"""

from __future__ import annotations

import math

import torch

__all__ = ["sd_segment", "sd_sphere_cone_capsule", "sd_circle", "sd_sphere",
           "spherecone_xb"]


def sd_circle(x, y, cx, cy, r):
    return torch.sqrt((x - cx) ** 2 + (y - cy) ** 2) - r


def sd_sphere(x, y, z, cx, cy, cz, r):
    return torch.sqrt((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2) - r


def sd_segment(px, py, ax, ay, bx, by):
    """Distance from point (px,py) to segment (a,b)
    (tau_hypersonic_cuda.cu:633-642)."""
    abx, aby = bx - ax, by - ay
    apx, apy = px - ax, py - ay
    denom = abx * abx + aby * aby + 1e-30
    t = torch.clamp((apx * abx + apy * aby) / denom, 0.0, 1.0)
    qx, qy = ax + t * abx, ay + t * aby
    return torch.sqrt((px - qx) ** 2 + (py - qy) ** 2)


def spherecone_xb(Rb: float, Rn: float, theta: float) -> float:
    """Axial station of the cone base (tau_hypersonic_cuda.cu:729-737)."""
    st, ct, tt = math.sin(theta), math.cos(theta), math.tan(theta)
    xt = Rn * (1.0 - st)
    rt = Rn * ct
    return xt + (Rb - rt) / max(tt, 1e-30)


def sd_sphere_cone_capsule(x, y, Rb: float, Rn: float, theta: float):
    """Signed distance to a sphere-cone capsule profile revolved about y=0
    (tau_hypersonic_cuda.cu:644-686). Negative inside.

    Rb: base radius, Rn: nose radius, theta: cone half-angle. The body spans
    x in [0, xb] with a spherical nose of radius Rn tangent to a conical
    flank ending at radius Rb.
    """
    r = torch.abs(y)

    st, ct, tt = math.sin(theta), math.cos(theta), math.tan(theta)
    xt = Rn * (1.0 - st)
    rt = Rn * ct
    xb = xt + (Rb - rt) / max(tt, 1e-30)

    # Radial profile of the body at station x (negative = no body there).
    dxn = x - Rn
    inside_sph = Rn * Rn - dxn * dxn
    r_sphere = torch.sqrt(torch.clamp_min(inside_sph, 0.0))
    r_cone = rt + (x - xt) * tt
    rprof = torch.where(
        x < 0.0,
        -1.0,
        torch.where(x <= xt, r_sphere, torch.where(x <= xb, r_cone, -1.0)),
    )
    inside = (x >= 0.0) & (x <= xb) & (r <= rprof)

    d_sphere = torch.abs(torch.sqrt((x - Rn) ** 2 + r * r) - Rn)
    d_cone = sd_segment(x, r, xt, rt, xb, Rb)
    d_base = sd_segment(x, y, xb, -Rb, xb, Rb)
    d_rim = torch.sqrt((x - xb) ** 2 + (r - Rb) ** 2)

    d = torch.minimum(torch.minimum(d_sphere, d_cone),
                      torch.minimum(d_base, d_rim))
    return torch.where(inside, -d, d)
