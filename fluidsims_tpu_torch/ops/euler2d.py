"""2-D compressible Euler primitives (ideal gas), elementwise over tensors.

Port of fluidsims_tpu.ops.euler2d — the device math of the flagship
reference solver: cons<->prim with positivity floors
(tau_hypersonic_cuda.cu:143-174), axis fluxes (:194-215), wall ghost states
(:262-264), inflow state (:230-238), MUSCL face reconstruction with
positivity contraction (:373-425) and the MUSCL-Hancock half-step
predictor (:443-471).

Fields are tensors bundled in `Cons` / `Prim` NamedTuples, so one code path
serves 0-d tensors (unit tests), whole grids and face arrays.  The floors
use `torch.clamp_min` / `torch.maximum`, which propagate NaN as
`jnp.maximum` does; the repair step of the solver relies on that.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .limiters import mc_limiter

__all__ = [
    "EPS_RHO",
    "EPS_P",
    "Cons",
    "Prim",
    "cons_to_prim",
    "prim_to_cons",
    "sound_speed",
    "flux",
    "wall_ghost",
    "inflow_prim",
    "c_add",
    "c_sub",
    "c_scale",
    "c_where",
    "p_where",
    "reconstruct_faces",
    "enforce_positive_faces",
    "half_step_predict",
    "clamp_prim",
]

# Positivity floors (tau_hypersonic_cuda.cu:32-33). Representable in float32
# (min normal ~1.2e-38).
EPS_RHO = 1e-25
EPS_P = 1e-25


class Cons(NamedTuple):
    """Conserved state (rho, rho*u, rho*v, total energy)."""

    rho: torch.Tensor
    mx: torch.Tensor
    my: torch.Tensor
    E: torch.Tensor


class Prim(NamedTuple):
    """Primitive state (rho, u, v, p)."""

    rho: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor


def c_add(a: Cons, b: Cons) -> Cons:
    return type(a)(*(x + y for x, y in zip(a, b)))


def c_sub(a: Cons, b: Cons) -> Cons:
    return type(a)(*(x - y for x, y in zip(a, b)))


def c_scale(s, a: Cons) -> Cons:
    return type(a)(*(s * x for x in a))


def c_where(sel, a: Cons, b: Cons) -> Cons:
    return type(a)(*(torch.where(sel, x, y) for x, y in zip(a, b)))


def p_where(sel, a: Prim, b: Prim) -> Prim:
    return c_where(sel, a, b)


def cons_to_prim(c: Cons, gamma: float) -> Prim:
    rho = torch.clamp_min(c.rho, EPS_RHO)
    inv = torch.reciprocal(rho)
    u = c.mx * inv
    v = c.my * inv
    kin = 0.5 * rho * (u * u + v * v)
    eint = c.E - kin
    p = (gamma - 1.0) * torch.clamp_min(eint, EPS_P)
    return Prim(rho=rho, u=u, v=v, p=p)


def prim_to_cons(p: Prim, gamma: float) -> Cons:
    rho = torch.clamp_min(p.rho, EPS_RHO)
    pr = torch.clamp_min(p.p, EPS_P)
    return Cons(
        rho=rho,
        mx=rho * p.u,
        my=rho * p.v,
        E=pr / (gamma - 1.0) + 0.5 * rho * (p.u * p.u + p.v * p.v),
    )


def sound_speed(p: Prim, gamma: float):
    return torch.sqrt(
        gamma * torch.clamp_min(p.p, EPS_P) / torch.clamp_min(p.rho, EPS_RHO))


def flux(c: Cons, gamma: float, axis: int) -> Cons:
    """Physical flux along axis (0 = x, 1 = y)."""
    p = cons_to_prim(c, gamma)
    if axis == 0:
        un = p.u
        return Cons(rho=c.mx, mx=c.mx * un + p.p, my=c.my * un, E=(c.E + p.p) * un)
    un = p.v
    return Cons(rho=c.my, mx=c.mx * un, my=c.my * un + p.p, E=(c.E + p.p) * un)


def wall_ghost(inside: Prim) -> Prim:
    """No-slip wall ghost: negate both velocity components
    (tau_hypersonic_cuda.cu:262-264)."""
    return Prim(rho=inside.rho, u=-inside.u, v=-inside.v, p=inside.p)


def inflow_prim(gamma: float, mach: float, dtype=torch.float32,
                device=None) -> Prim:
    """Nondimensional supersonic inflow: rho=1, p=1, u=M*a, v=0, as 0-d
    tensors (u = M*sqrt(gamma) is formed in double, then rounded once)."""
    a = math.sqrt(gamma)

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return Prim(rho=scalar(1.0), u=scalar(mach * a), v=scalar(0.0),
                p=scalar(1.0))


def clamp_prim(q: Prim) -> Prim:
    return Prim(
        rho=torch.clamp_min(q.rho, EPS_RHO), u=q.u, v=q.v,
        p=torch.clamp_min(q.p, EPS_P),
    )


def enforce_positive_faces(qm: Prim, qc: Prim, qp: Prim) -> tuple[Prim, Prim]:
    """Contract reconstructed face states toward the cell center until both
    are positive (8 fixed rounds; tau_hypersonic_cuda.cu:373-398).

    Each round blends only where the pair is still invalid, so a valid pair
    is left untouched and stays valid — the CUDA kernel may therefore stop
    early per face pair and compute the same values.
    """

    def blend(a: Prim, c: Prim, sel) -> Prim:
        half = Prim(
            rho=0.5 * (a.rho + c.rho),
            u=0.5 * (a.u + c.u),
            v=0.5 * (a.v + c.v),
            p=0.5 * (a.p + c.p),
        )
        return p_where(sel, half, a)

    for _ in range(8):
        bad = (
            (qm.rho <= EPS_RHO)
            | (qp.rho <= EPS_RHO)
            | (qm.p <= EPS_P)
            | (qp.p <= EPS_P)
        )
        qm = blend(qm, qc, bad)
        qp = blend(qp, qc, bad)

    return clamp_prim(qm), clamp_prim(qp)


def reconstruct_faces(qm: Prim, qc: Prim, qp: Prim) -> tuple[Prim, Prim]:
    """MC-limited linear reconstruction to the two faces of a cell
    (tau_hypersonic_cuda.cu:400-425). Returns (qL, qR) = (low face, high face).
    """

    def slope(m, c, p):
        return mc_limiter(c - m, 0.5 * (p - m), p - c)

    s = Prim(*(slope(m, c, p) for m, c, p in zip(qm, qc, qp)))
    qL = Prim(*(c - 0.5 * d for c, d in zip(qc, s)))
    qR = Prim(*(c + 0.5 * d for c, d in zip(qc, s)))
    return enforce_positive_faces(qL, qc, qR)


def half_step_predict(q: Prim, dF: Cons, half_dt_dn, gamma: float) -> Prim:
    """MUSCL-Hancock half-step predictor (tau_hypersonic_cuda.cu:443-455):
    advance a face state by half a step of the cell's flux difference."""
    c = prim_to_cons(q, gamma)
    c = Cons(*(x - half_dt_dn * d for x, d in zip(c, dF)))
    return clamp_prim(cons_to_prim(c, gamma))
