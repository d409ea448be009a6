"""Plain PyTorch reference of the 3-D two-temperature sphere flow
(configuration `hypersonic3d-sphere`): a frozen, self-contained copy of
the whole-grid step as the upstream tau_hypersonic_3d_cuda.cu states it:
log-space state (:109-171, :213-232), WENO5 faces (:534-598), HLLC with
entropy fix and shock-sensor HLL blending (:366-460), solid-aware stencil
degradation and wall-mirrored Riemann problems (:1095-1163), inflow at
x < 0, transmissive outflow, periodic y and z, repair, Landau-Teller
relaxation, sponges (:1284-1344), and the τ clock with its dτ feedback
(:1680-1704).

It imports nothing of the program: the solid mask (and its halo), the
padding, the inflow state, dt and dτ are worked out here from the
configuration file.  Every function computes in the dtype of its inputs,
so the same code gives the reference and the lower-precision control.
Interface: as portbench/reference/hypersonic2d-capsule.py.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

FIELDS = ("xi", "phix", "phiy", "phiz", "lam", "zet")
CLOCK = ("t", "dtau")

RHO_P_FLOOR = 1e-30
THERMAL_ENERGY_FLOOR = 1e-12
DENOM_EPS = 1e-12
NEWTON_TEMP_FLOOR = 1e-6
TAU_VIB_MIN = 1e-9
WENO_EPS = 1e-6
HALO = 3
_ARR_AX = {0: 2, 1: 1, 2: 0}


class Config:
    """The configuration file's physics on the traffic's n^3 grid, with
    dx = dy = dz = 1/n (the upstream's unit box)."""

    def __init__(self, cfg: dict, traffic: dict):
        n = int(traffic["n"])
        self.nx = self.ny = self.nz = n
        self.dx = self.dy = self.dz = 1.0 / n
        for k in ("cfl", "u_ref", "R", "gamma_floor", "Twall", "tau_vib",
                  "theta_v", "sdf_cx", "sdf_cy", "sdf_cz", "sdf_r",
                  "inflow_r", "inflow_p", "inflow_u", "inflow_v", "inflow_w",
                  "sponge_strength", "sponge_out_strength", "t0", "dtau0"):
            setattr(self, k, float(cfg[k]))
        self.sponge_n = int(cfg["sponge_n"])
        self.sponge_out_n = int(cfg["sponge_out_n"])
        if cfg["outflow"] != "transmissive":
            raise ValueError("the reference states the transmissive outflow")
        self.amplitude = float(cfg["perturbation"]["amplitude"])


def _s(ref, c):
    return torch.full((), c, dtype=ref.dtype, device=ref.device)


def div(a, c):
    return torch.div(a, _s(a, c))


def rdiv(c, a):
    return torch.div(_s(a, c), a)


def _map(f, *qs):
    return tuple(f(*vals) for vals in zip(*qs))


# ------------------------------ thermodynamics -----------------------------
# A primitive state is (r, u, v, w, p, ev); a conserved one (r, mx, my, mz,
# Et, Ev).

def evib_eq(c, T):
    a = rdiv(c.theta_v, torch.clamp_min(T, NEWTON_TEMP_FLOOR))
    return rdiv(c.R * c.theta_v,
                torch.clamp_min(torch.exp(a) - 1.0, NEWTON_TEMP_FLOOR))


def evib_eq_py(c, T):
    a = c.theta_v / max(T, NEWTON_TEMP_FLOOR)
    if a > 700.0:
        return 0.0
    return (c.R * c.theta_v) / max(math.exp(a) - 1.0, NEWTON_TEMP_FLOOR)


def inflow_values(c):
    r = max(c.inflow_r, RHO_P_FLOOR)
    p = max(c.inflow_p, RHO_P_FLOOR)
    return (r, c.inflow_u, c.inflow_v, c.inflow_w, p,
            evib_eq_py(c, p / (r * c.R)))


def prim_to_cons(c, q):
    r, u, v, w, p, ev = q
    ke = 0.5 * (u * u + v * v + w * w)
    e_th = p / torch.clamp_min((c.gamma_floor - 1.0) * r, RHO_P_FLOOR)
    return (r, r * u, r * v, r * w, r * (ke + e_th + ev), r * ev)


def cons_to_prim(c, U):
    r = torch.clamp_min(U[0], RHO_P_FLOOR)
    u, v, w = U[1] / r, U[2] / r, U[3] / r
    ke = 0.5 * (u * u + v * v + w * w)
    ev = torch.clamp_min(U[5] / r, 0.0)
    e_th = torch.clamp_min(U[4] / r - ke - ev, THERMAL_ENERGY_FLOOR)
    p = torch.clamp_min((c.gamma_floor - 1.0) * r * e_th, RHO_P_FLOOR)
    return (r, u, v, w, p, ev)


def soundspeed(c, q):
    return torch.sqrt(torch.clamp_min(c.gamma_floor * q[4] / q[0], DENOM_EPS))


def axis_flux(c, q, axis):
    r, u, v, w, p, ev = q
    un = (u, v, w)[axis]
    H = (p / r) + (0.5 * (u * u + v * v + w * w) + ev) \
        + p / torch.clamp_min((c.gamma_floor - 1.0) * r, RHO_P_FLOOR)
    mom = [r * u * un, r * v * un, r * w * un]
    mom[axis] = mom[axis] + p
    return (r * un, mom[0], mom[1], mom[2], r * H * un, r * ev * un)


# ------------------------------ Riemann solver -----------------------------

def _signed(x):
    m = torch.clamp_min(torch.abs(x), DENOM_EPS)
    return torch.where(x >= 0.0, m, -m)


def _entropy_fix(s, a_ref):
    d = 0.1 * a_ref
    as_ = torch.abs(s)
    sm = 0.5 * (as_ * as_ / torch.clamp_min(d, DENOM_EPS) + d)
    sgn = torch.where(s >= 0.0, 1.0, -1.0).to(s.dtype)
    return torch.where(as_ >= d, s, sgn * sm)


def hllc(c, L, R, axis):
    aL, aR = soundspeed(c, L), soundspeed(c, R)
    unL, unR = L[1 + axis], R[1 + axis]
    sL = torch.minimum(unL - aL, unR - aR)
    sR = torch.maximum(unL + aL, unR + aR)
    aRef = torch.maximum(aL, aR)
    sL, sR = _entropy_fix(sL, aRef), _entropy_fix(sR, aRef)
    UL, UR = prim_to_cons(c, L), prim_to_cons(c, R)
    FL, FR = axis_flux(c, L, axis), axis_flux(c, R, axis)

    denom = _signed(L[0] * (sL - unL) - R[0] * (sR - unR))
    sM = (R[4] - L[4] + L[0] * unL * (sL - unL) - R[0] * unR * (sR - unR)) \
        / denom
    pStar = 0.5 * ((L[4] + L[0] * (sL - unL) * (sM - unL))
                   + (R[4] + R[0] * (sR - unR) * (sM - unR)))
    cross = [(L[1], R[1]), (L[2], R[2]), (L[3], R[3])]
    del cross[axis]
    crossflow = sum(torch.abs(a) + torch.abs(b) for a, b in cross) * 0.5
    align = torch.clamp(
        1.0 - crossflow / torch.clamp_min(aRef, DENOM_EPS), 0.0, 1.0)
    dp = torch.abs(R[4] - L[4]) / torch.clamp_min(R[4] + L[4], DENOM_EPS)
    dr = torch.abs(R[0] - L[0]) / torch.clamp_min(R[0] + L[0], DENOM_EPS)
    alpha = torch.clamp(5.0 * 0.5 * (dp + dr), 0.0, 1.0) * align

    inv = torch.div(torch.ones_like(sR), _signed(sR - sL))
    FHLL = _map(lambda fl, fr, ul, ur:
                (sR * fl - sL * fr + sL * sR * (ur - ul)) * inv, FL, FR, UL, UR)

    def star_side(q, U, F, sS, unS):
        d = _signed(sS - sM)
        rStar = q[0] * (sS - unS) / d
        EStar = ((sS - unS) * U[4] - q[4] * unS + pStar * sM) / d
        EvStar = U[5] * (sS - unS) / d
        mom = [rStar * q[1], rStar * q[2], rStar * q[3]]
        mom[axis] = rStar * sM
        Us = (rStar, mom[0], mom[1], mom[2], EStar, EvStar)
        return _map(lambda f, us, u: f + sS * (us - u), F, Us, U)

    Fs = _map(lambda a, b: torch.where(sM >= 0.0, a, b),
              star_side(L, UL, FL, sL, unL), star_side(R, UR, FR, sR, unR))
    blended = _map(lambda fs, fh: (1.0 - alpha) * fs + alpha * fh, Fs, FHLL)
    return _map(lambda fl, fr, bl: torch.where(
        sL >= 0.0, fl, torch.where(sR <= 0.0, fr, bl)), FL, FR, blended)


def _mirror(q, axis):
    q = list(q)
    q[1 + axis] = -q[1 + axis]
    return tuple(q)


def hllc_wall(c, q, axis, left):
    """The wall pair's flux: hllc(q, mirror(q)) or hllc(mirror(q), q), in
    its closed form (sL = -(|un| + a), sM = 0, no HLL blending)."""
    L = q if left else _mirror(q, axis)
    a = soundspeed(c, L)
    unL = L[1 + axis]
    sL = -(torch.abs(unL) + a)
    UL, FL = prim_to_cons(c, L), axis_flux(c, L, axis)
    d = _signed(sL)
    rStar = L[0] * (sL - unL) / d
    EStar = ((sL - unL) * UL[4] - L[4] * unL) / d
    EvStar = UL[5] * (sL - unL) / d
    mom = [rStar * L[1], rStar * L[2], rStar * L[3]]
    mom[axis] = torch.zeros_like(rStar)
    Us = (rStar, mom[0], mom[1], mom[2], EStar, EvStar)
    return _map(lambda f, us, u: f + sL * (us - u), FL, Us, UL)


# ---------------------------------- WENO5 -----------------------------------

def weno_lr(fp, axis, n):
    """Both WENO5 face values of every face along `axis` of a halo-3
    padded array (Jiang-Shu weights, eps 1e-6, linear weights 0.1, 0.6,
    0.3; the right-biased value the mirror), each cell's smoothness
    weights shared by the two sides."""
    def s(off, length):
        return torch.narrow(fp, axis, off, length)

    def sub(a, j0, length):
        return torch.narrow(a, axis, j0, length)

    d2 = s(0, n + 4) - 2.0 * s(1, n + 4) + s(2, n + 4)
    D = (13.0 / 12.0) * d2 * d2
    cd = s(3, n + 2) - s(1, n + 2)
    C = 0.25 * cd * cd
    gd = s(0, n + 2) - 4.0 * s(1, n + 2) + 3.0 * s(2, n + 2)
    G = 0.25 * gd * gd
    fd = 3.0 * s(2, n + 2) - 4.0 * s(3, n + 2) + s(4, n + 2)
    F = 0.25 * fd * fd
    A = (2.0 * s(0, n + 1) - 7.0 * s(1, n + 1) + 11.0 * s(2, n + 1)) \
        * (1.0 / 6.0)
    M = (-s(1, n + 1) + 5.0 * s(2, n + 1) + 2.0 * s(3, n + 1)) * (1.0 / 6.0)
    N = (2.0 * s(2, n + 1) + 5.0 * s(3, n + 1) - s(4, n + 1)) * (1.0 / 6.0)
    B = (11.0 * s(3, n + 1) - 7.0 * s(4, n + 1) + 2.0 * s(5, n + 1)) \
        * (1.0 / 6.0)
    inv = []
    for S in (sub(D, 0, n + 2) + G, sub(D, 1, n + 2) + C,
              sub(D, 2, n + 2) + F):
        t = WENO_EPS + S
        inv.append(torch.div(torch.ones_like(t), t * t))
    a0 = 0.1 * sub(inv[0], 0, n + 1)
    a1 = 0.6 * sub(inv[1], 0, n + 1)
    a2 = 0.3 * sub(inv[2], 0, n + 1)
    Lf = (a0 * A + a1 * M + a2 * N) / (a0 + a1 + a2)
    r0 = 0.1 * sub(inv[2], 1, n + 1)
    r1 = 0.6 * sub(inv[1], 1, n + 1)
    r2 = 0.3 * sub(inv[0], 1, n + 1)
    Rf = (r0 * B + r1 * N + r2 * M) / (r0 + r1 + r2)
    return Lf, Rf


# ------------------------------- state, BCs --------------------------------

def build_solid(c, pad=0):
    x = (np.arange(-pad, c.nx + pad) + 0.5) * c.dx
    y = (np.arange(-pad, c.ny + pad) + 0.5) * c.dy
    z = (np.arange(-pad, c.nz + pad) + 0.5) * c.dz
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    return np.sqrt((X - c.sdf_cx) ** 2 + (Y - c.sdf_cy) ** 2
                   + (Z - c.sdf_cz) ** 2) - c.sdf_r < 0.0


def encode(c, q):
    return (torch.log(torch.clamp_min(q[0], RHO_P_FLOOR)),
            torch.asinh(div(q[1], c.u_ref)), torch.asinh(div(q[2], c.u_ref)),
            torch.asinh(div(q[3], c.u_ref)),
            torch.log(torch.clamp_min(q[4], RHO_P_FLOOR)),
            torch.log(torch.clamp_min(q[5], RHO_P_FLOOR)))


def decode(c, f):
    return (torch.exp(f[0]), c.u_ref * torch.sinh(f[1]),
            c.u_ref * torch.sinh(f[2]), c.u_ref * torch.sinh(f[3]),
            torch.exp(f[4]), torch.exp(f[5]))


def _floor(q):
    return (torch.clamp_min(q[0], RHO_P_FLOOR), q[1], q[2], q[3],
            torch.clamp_min(q[4], RHO_P_FLOOR), torch.clamp_min(q[5], 0.0))


def _wall(c, q):
    """Isothermal no-slip wall ghost (:511-521)."""
    p = torch.clamp_min(q[4], RHO_P_FLOOR)
    r = torch.clamp_min(div(p, c.R * max(c.Twall, NEWTON_TEMP_FLOOR)),
                        RHO_P_FLOOR)
    z = torch.zeros_like(q[1])
    ev = evib_eq(c, _s(q[4], c.Twall)).expand_as(q[4])
    return (r, z, z, z, p, ev)


def _padded(c, q, solid_pad, infl):
    """Halo-3 prims: x- the inflow, x+ the transmissive outflow column
    (pressure relaxed where subsonic, the inflow where the flow reverses),
    y and z periodic; the wall ghost in solid cells of the padded mask."""
    qR = tuple(f[:, :, -1] for f in q)
    aR = soundspeed(c, qR)
    un = qR[1]
    p_amb = max(c.inflow_p, RHO_P_FLOOR)
    relax = torch.clamp_min(qR[4] + 0.05 * (p_amb - qR[4]), RHO_P_FLOOR)
    q_out = (torch.clamp_min(qR[0], RHO_P_FLOOR), qR[1], qR[2], qR[3],
             torch.clamp_min(torch.where(un < aR, relax, qR[4]), RHO_P_FLOOR),
             torch.clamp_min(qR[5], 0.0))
    q_out = tuple(torch.where(un < 0.0, i, o) for i, o in zip(infl, q_out))

    def pad(f, out, left):
        nz, ny, _ = f.shape
        f = torch.cat([left.expand(nz, ny, HALO), f,
                       out[:, :, None].expand(nz, ny, HALO)], dim=2)
        f = torch.cat([f[:, -HALO:, :], f, f[:, :HALO, :]], dim=1)
        return torch.cat([f[-HALO:, :, :], f, f[:HALO, :, :]], dim=0)

    qp = tuple(pad(f, o, i) for f, o, i in zip(q, q_out, infl))
    return tuple(torch.where(solid_pad, w, f)
                 for w, f in zip(_wall(c, qp), qp))


def _sl(f, axis, lo, hi_off):
    starts = [HALO, HALO, HALO]
    sizes = [f.shape[d] - 2 * HALO for d in range(3)]
    starts[axis] = lo
    sizes[axis] += hi_off
    return f[tuple(slice(a, a + n) for a, n in zip(starts, sizes))]


def _core(c, qp, solid_pad, dt, gain):
    """WENO faces -> HLLC with wall mirroring -> update -> repair ->
    Landau-Teller -> sponges, on the padded prims; the new interior."""
    dtype = qp[0].dtype
    q0 = tuple(f[HALO:-HALO, HALO:-HALO, HALO:-HALO] for f in qp)
    U0 = prim_to_cons(c, q0)
    inv_d = (1.0 / c.dx, 1.0 / c.dy, 1.0 / c.dz)
    dU = None
    for axis in range(3):
        ax = _ARR_AX[axis]
        q_0 = tuple(_sl(f, ax, HALO - 1, 1) for f in qp)
        q_1 = tuple(_sl(f, ax, HALO, 1) for f in qp)

        def crop(f):
            sl = [slice(HALO, f.shape[d] - HALO) for d in range(3)]
            sl[ax] = slice(None)
            return f[tuple(sl)]

        n = qp[0].shape[ax] - 2 * HALO
        lr = [weno_lr(crop(f), ax, n) for f in qp]
        L = _floor(tuple(x[0] for x in lr))
        R = _floor(tuple(x[1] for x in lr))
        s_any = None
        for off in (-2, -1, 0, 1, 2, 3):
            s = _sl(solid_pad, ax, HALO - 1 + off, 1)
            s_any = s if s_any is None else (s_any | s)
        L = tuple(torch.where(s_any, a, b) for a, b in zip(_floor(q_0), L))
        R = tuple(torch.where(s_any, a, b) for a, b in zip(_floor(q_1), R))
        F = hllc(c, L, R, axis)
        face_solid = _sl(solid_pad, ax, HALO - 1, 1) | _sl(solid_pad, ax,
                                                           HALO, 1)
        F_wl = hllc_wall(c, q_0, axis, True)
        F_wr = hllc_wall(c, q_1, axis, False)
        m = F[0].shape[ax]

        def lo(f):
            return torch.narrow(f, ax, 0, m - 1)

        def hi(f):
            return torch.narrow(f, ax, 1, m - 1)

        Fm = tuple(torch.where(lo(face_solid), lo(w), lo(f))
                   for f, w in zip(F, F_wr))
        Fp = tuple(torch.where(hi(face_solid), hi(w), hi(f))
                   for f, w in zip(F, F_wl))
        contrib = tuple(-(p - mm) * inv_d[axis] for p, mm in zip(Fp, Fm))
        dU = contrib if dU is None else tuple(a + b for a, b in
                                              zip(dU, contrib))

    q1 = cons_to_prim(c, tuple(u + dt * d for u, d in zip(U0, dU)))
    bad = torch.zeros_like(q1[0], dtype=torch.bool)
    for f in q1:
        bad |= ~torch.isfinite(f)
    bad |= (q1[0] <= 0.0) | (q1[4] <= 0.0) | (q1[5] < 0.0)
    infl = tuple(torch.tensor(v, dtype=dtype, device=q1[0].device)
                 for v in inflow_values(c))
    q1 = tuple(torch.where(bad, i, f) for i, f in zip(infl, q1))

    T1 = q1[4] / (q1[0] * c.R)
    relax = div(dt, max(c.tau_vib, TAU_VIB_MIN))
    q1 = q1[:5] + (torch.clamp_min(q1[5] + (evib_eq(c, T1) - q1[5]) * relax,
                                   0.0),)

    tgt_r = max(c.inflow_r, RHO_P_FLOOR)
    tgt_p = max(c.inflow_p, RHO_P_FLOOR)
    tgt_ev = evib_eq_py(c, tgt_p / (tgt_r * c.R))

    def sponge(q, lo_col, hi_col, k_of, tgt_uvw):
        lo_col, hi_col = max(lo_col, 0), min(hi_col, c.nx)
        if lo_col >= hi_col:
            return q
        sub = tuple(f[:, :, lo_col:hi_col] for f in q)
        xs = (torch.arange(hi_col - lo_col, device=sub[0].device).to(dtype)
              + lo_col).view(1, 1, -1)
        k = k_of(xs)
        new = (torch.clamp_min(sub[0] + k * (tgt_r - sub[0]), RHO_P_FLOOR),
               sub[1] + k * (tgt_uvw[0] - sub[1]),
               sub[2] + k * (tgt_uvw[1] - sub[2]),
               sub[3] + k * (tgt_uvw[2] - sub[3]),
               torch.clamp_min(sub[4] + k * (tgt_p - sub[4]), RHO_P_FLOOR),
               torch.clamp_min(sub[5] + k * (tgt_ev - sub[5]), 0.0))
        out = tuple(f.clone() for f in q)
        for o, g in zip(out, new):
            o[:, :, lo_col:hi_col] = g
        return out

    if c.sponge_n > 0:
        def k_in(xs):
            ramp = torch.clamp(1.0 - div(xs, c.sponge_n), 0.0, 1.0)
            return c.sponge_strength * (ramp * ramp)
        q1 = sponge(q1, 0, c.sponge_n, k_in,
                    (gain * c.inflow_u, gain * c.inflow_v, gain * c.inflow_w))
    if c.sponge_out_n > 0:
        def k_out(xs):
            xo = xs - (c.nx - c.sponge_out_n)
            ramp = torch.clamp(div(xo, c.sponge_out_n), 0.0, 1.0) \
                * (xo >= 0).to(dtype)
            return c.sponge_out_strength * (ramp * ramp)
        q1 = sponge(q1, c.nx - c.sponge_out_n, c.nx, k_out, (0.0, 0.0, 0.0))
    return q1


def max_wavespeed(c, q1, solid):
    a = soundspeed(c, q1)
    ssum = div(torch.abs(q1[1]) + a, c.dx) + div(torch.abs(q1[2]) + a, c.dy) \
        + div(torch.abs(q1[3]) + a, c.dz)
    return torch.amax(torch.where(torch.isfinite(ssum) & ~solid, ssum, 0.0))


def dtau_feedback(dtau, dt, dt_cfl):
    return torch.clamp(torch.where(
        dt > 1.10 * dt_cfl, dtau * 0.80,
        torch.where(dt < 0.85 * dt_cfl, dtau * 1.10, dtau)), 1e-7, 5e-2)


def step(c, f, solid, solid_pad, t, dtau):
    t = t * torch.exp(dtau)
    dt = t * dtau
    gain = torch.clamp(div(t, 0.02), 0.0, 1.0)
    q = decode(c, f)
    infl = tuple(torch.tensor(v, dtype=q[0].dtype, device=q[0].device)
                 for v in inflow_values(c))
    q1 = _core(c, _padded(c, q, solid_pad, infl), solid_pad, dt, gain)
    dt_cfl = rdiv(c.cfl, torch.clamp_min(max_wavespeed(c, q1, solid), 1e-9))
    new_dtau = dtau_feedback(dtau, dt, dt_cfl)
    kept = tuple(torch.where(solid, o, n) for n, o in zip(encode(c, q1), f))
    return kept, t, new_dtau


class Reference:
    # standard normal fields of the seeded perturbation: ln rho, ln p
    noise_fields = 2

    def __init__(self, cfg: dict, traffic: dict, device):
        self.c = Config(cfg, traffic)
        self.device = torch.device(device)
        self.dtype = getattr(torch, traffic["dtype"])
        self.noise_shape = (self.c.nz, self.c.ny, self.c.nx)
        # the encoded fields are logarithms and asinh of u / u_ref: an
        # absolute difference is already a relative one
        self.scales = {k: 1.0 for k in FIELDS}

    @functools.cached_property
    def solid(self):
        return torch.from_numpy(build_solid(self.c)).to(self.device)

    @functools.cached_property
    def solid_pad(self):
        return torch.from_numpy(build_solid(self.c, pad=HALO)).to(self.device)

    def work(self) -> dict:
        """The units of work the rate and the kernels' counts use: every
        cell of the grid, the fluid cells, the grid's (nz, ny, nx) and the
        stated precision."""
        return {"cells": self.solid.numel(),
                "shape": tuple(self.solid.shape),
                "fluid_cells": int((~self.solid).sum()),
                "itemsize": self.dtype.itemsize,
                "dtype": str(self.dtype).removeprefix("torch.")}

    def perturb(self, state: dict, noise) -> dict:
        """The seeded perturbation: ln rho and ln p of every cell shifted
        by amplitude * noise (a solid cell keeps its value through every
        step and no step reads it, so no mask is needed)."""
        a = self.c.amplitude
        out = dict(state)
        for key, nz in (("xi", noise[0]), ("lam", noise[1])):
            out[key] = state[key] + a * nz.to(state[key].dtype)
        return out

    def init(self, dtype, noise) -> dict:
        """Quiescent inflow-density gas, the wall state in solid cells
        (:939-985), then the perturbation."""
        c, dev = self.c, self.device
        r, _, _, _, p, ev_f = inflow_values(c)
        rw = max(p / (c.R * max(c.Twall, NEWTON_TEMP_FLOOR)), RHO_P_FLOOR)
        evw = evib_eq_py(c, c.Twall)

        def full(v):
            return torch.full(self.noise_shape, v, dtype=dtype, device=dev)

        q = (torch.where(self.solid, full(rw), full(r)), full(0.0), full(0.0),
             full(0.0), full(p), torch.where(self.solid, full(evw), full(ev_f)))
        state = dict(zip(FIELDS, encode(c, q)))
        state["t"] = torch.tensor(c.t0, dtype=dtype, device=dev)
        state["dtau"] = torch.tensor(c.dtau0, dtype=dtype, device=dev)
        return self.perturb(state, noise)

    def frame(self, state: dict, n: int, dtype) -> dict:
        f = tuple(state[k].to(dtype) for k in FIELDS)
        t, dtau = state["t"].to(dtype), state["dtau"].to(dtype)
        for _ in range(n):
            f, t, dtau = step(self.c, f, self.solid, self.solid_pad, t, dtau)
        return dict(zip(FIELDS, f), t=t, dtau=dtau)
