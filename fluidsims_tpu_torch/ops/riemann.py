"""Approximate Riemann solvers as branch-free select dataflow.

Port of fluidsims_tpu.ops.riemann: HLLE (tau_hypersonic_cuda.cu:483-509)
and HLLC with HLLE fallback on pathological star states
(tau_hypersonic_cuda.cu:519-606).  Every branch is computed for every face
and `torch.where` picks the valid one; the CUDA kernel
(csrc/hypersonic2d_step.cu) takes the branches instead and selects the same
values.
"""

from __future__ import annotations

import torch

from .euler2d import (
    Cons,
    EPS_P,
    c_add,
    c_scale,
    c_sub,
    c_where,
    cons_to_prim,
    flux,
    sound_speed,
)

__all__ = ["hlle", "hllc"]

_TINY = 1e-14


def _safe_div(num, den):
    """num/den with den sanitized where |den| is tiny (result is selected
    away by the caller in exactly those places)."""
    den_safe = torch.where(torch.abs(den) < _TINY, 1.0, den)
    return num / den_safe


def _normal_vel(p, axis: int):
    return p.u if axis == 0 else p.v


def _tangent_vel(p, axis: int):
    return p.v if axis == 0 else p.u


def hlle(UL: Cons, UR: Cons, gamma: float, axis: int) -> Cons:
    """HLLE two-wave flux along `axis` (0=x, 1=y)."""
    L = cons_to_prim(UL, gamma)
    R = cons_to_prim(UR, gamma)
    uL = _normal_vel(L, axis)
    uR = _normal_vel(R, axis)
    aL = sound_speed(L, gamma)
    aR = sound_speed(R, gamma)
    SL = torch.minimum(uL - aL, uR - aR)
    SR = torch.maximum(uL + aL, uR + aR)

    FL = flux(UL, gamma, axis)
    FR = flux(UR, gamma, axis)

    denom = SR - SL
    mid_degenerate = c_scale(0.5, c_add(FL, FR))
    inv = _safe_div(torch.ones_like(denom), denom)
    interior = c_scale(
        inv,
        c_add(
            c_add(c_scale(SR, FL), c_scale(-SL, FR)),
            c_scale(SL * SR, c_sub(UR, UL)),
        ),
    )
    mid = c_where(torch.abs(denom) < _TINY, mid_degenerate, interior)
    return c_where(SL >= 0.0, FL, c_where(SR <= 0.0, FR, mid))


def hllc(UL: Cons, UR: Cons, gamma: float, axis: int) -> Cons:
    """HLLC three-wave flux with per-face HLLE fallback on degenerate or
    non-finite star states (tau_hypersonic_cuda.cu:548-571)."""
    L = cons_to_prim(UL, gamma)
    R = cons_to_prim(UR, gamma)

    unL = _normal_vel(L, axis)
    unR = _normal_vel(R, axis)
    utL = _tangent_vel(L, axis)
    utR = _tangent_vel(R, axis)

    aL = sound_speed(L, gamma)
    aR = sound_speed(R, gamma)
    SL = torch.minimum(unL - aL, unR - aR)
    SR = torch.maximum(unL + aL, unR + aR)

    FL = flux(UL, gamma, axis)
    FR = flux(UR, gamma, axis)

    rhoL, rhoR = L.rho, R.rho
    pL, pR = L.p, R.p

    num = pR - pL + rhoL * unL * (SL - unL) - rhoR * unR * (SR - unR)
    den = rhoL * (SL - unL) - rhoR * (SR - unR)
    SM = _safe_div(num, den)

    bad = (torch.abs(den) < _TINY) | ~torch.isfinite(num) | ~torch.isfinite(den)
    bad |= ~torch.isfinite(SM)

    pStar = torch.clamp_min(pL + rhoL * (SL - unL) * (SM - unL), EPS_P)

    dLS = SL - SM
    dRS = SR - SM
    bad |= (torch.abs(dLS) < _TINY) | (torch.abs(dRS) < _TINY)

    rhoStarL = rhoL * _safe_div(SL - unL, dLS)
    rhoStarR = rhoR * _safe_div(SR - unR, dRS)
    bad |= ~(rhoStarL > 0.0) | ~(rhoStarR > 0.0)
    bad |= ~torch.isfinite(rhoStarL) | ~torch.isfinite(rhoStarR)

    EStarL = _safe_div((SL - unL) * UL.E - pL * unL + pStar * SM, dLS)
    EStarR = _safe_div((SR - unR) * UR.E - pR * unR + pStar * SM, dRS)
    bad |= ~torch.isfinite(EStarL) | ~torch.isfinite(EStarR)

    momNL = rhoStarL * SM
    momTL = rhoStarL * utL
    momNR = rhoStarR * SM
    momTR = rhoStarR * utR
    if axis == 0:
        UStarL = Cons(rho=rhoStarL, mx=momNL, my=momTL, E=EStarL)
        UStarR = Cons(rho=rhoStarR, mx=momNR, my=momTR, E=EStarR)
    else:
        UStarL = Cons(rho=rhoStarL, mx=momTL, my=momNL, E=EStarL)
        UStarR = Cons(rho=rhoStarR, mx=momTR, my=momNR, E=EStarR)

    F_left_star = c_add(FL, c_scale(SL, c_sub(UStarL, UL)))
    F_right_star = c_add(FR, c_scale(SR, c_sub(UStarR, UR)))

    star = c_where(SM >= 0.0, F_left_star, F_right_star)
    interior = c_where(bad, hlle(UL, UR, gamma, axis), star)
    return c_where(SL >= 0.0, FL, c_where(SR <= 0.0, FR, interior))
