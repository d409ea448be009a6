"""3-D hypersonic flow past a sphere with two-temperature vibrational
nonequilibrium, WENO5 + HLLC, log-space state, τ-clock with feedback dτ.

Port of fluidsims_tpu.solvers.hypersonic3d.  Behavioral spec:
tau_hypersonic_3d_cuda.cu —
  * log-space state ξ=ln ρ, φ=asinh(u/u_ref), λ=ln p, ζ=ln e_vib
    (:109-171, encode/decode :213-232)
  * two-temperature EOS; T_v from e_vib by a 3-iteration Newton solve
  * WENO5 faces (:534-598) + HLLC with entropy-fixed wavespeeds and
    shock-sensor HLL blending scaled by flow alignment (:366-460)
  * solid-aware stencil degradation and wall-mirrored Riemann problems at
    faces touching the sphere (:1095-1163)
  * isothermal wall ghost state; inflow at x<0, transmissive (or LODI
    characteristic) outflow at x>=nx; y, z periodic
  * Landau–Teller vibrational relaxation, inflow/outflow sponges, repair
    of non-finite cells to inflow, τ clock with dτ feedback (:1680-1704)

The functions here are the plain PyTorch version, written as the JAX module
writes them.  On the GPU the step runs its prologue (decode and BC
padding, `_padded_prims(_decode(...))`), its cell update
(`step_core_padded`) and the masked max-wavespeed reduction through three
hand-written CUDA kernels (kernels/hypersonic3d_cuda.py); `step` picks
them by default, and their wrappers take the plain versions below only
for CPU tensors.  The rest of a step (τ arithmetic, encode) is torch on
the device; dt, gain and dτ stay 0-d device tensors and are never read by
the host.  The prologue kernel takes the inflow state as a launch
argument, so a step copies nothing from the host and never waits for the
device.

Every quotient with a Python-number operand is taken tensor by tensor
(`_div`, `_rdiv`): on the GPU `tensor / c` multiplies by a rounded
reciprocal and `c / tensor` does so on every device, one rounding more
than JAX's division and the CUDA kernels'.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.clock import dtau_feedback
from ..core.config import BaseConfig
from ..core.device import resolve_device
from ..core.metrics import span
from ..core.stepper import run_steps
from ..ops.scalar import div, rdiv, scalar
from ..ops.weno import weno5_lr_slab

__all__ = [
    "Hypersonic3DConfig",
    "Hypersonic3DState",
    "PrimT",
    "ConsT",
    "default_config",
    "init",
    "step",
    "run",
    "vis_field",
    "VIS_MODES",
    "outflow_reflection_metric",
]

RHO_P_FLOOR = 1e-30
THERMAL_ENERGY_FLOOR = 1e-12
DENOM_EPS = 1e-12
NEWTON_TEMP_FLOOR = 1e-6
TAU_VIB_MIN = 1e-9
HALO = 3  # WENO5 stencil reach


@dataclass(frozen=True)
class Hypersonic3DConfig(BaseConfig):
    nx: int = 64
    ny: int = 64
    nz: int = 64
    dx: float = 1.0 / 64
    dy: float = 1.0 / 64
    dz: float = 1.0 / 64
    cfl: float = 0.3333
    u_ref: float = 10.0
    R: float = 10.0
    gamma_floor: float = 1.1
    Twall: float = 0.02
    tau_vib: float = 2e-4
    theta_v: float = 0.2
    sdf_cx: float = 0.5
    sdf_cy: float = 0.5
    sdf_cz: float = 0.5
    sdf_r: float = 0.25
    inflow_r: float = 0.02
    inflow_p: float = 0.02
    inflow_u: float = 100.0
    inflow_v: float = 0.0
    inflow_w: float = 0.0
    sponge_n: int = 24
    sponge_strength: float = 0.05
    sponge_out_n: int = 24
    sponge_out_strength: float = 0.05
    t0: float = 1e-5
    dtau0: float = 1e-3
    outflow: str = "transmissive"   # or "characteristic" (LODI-gated)
    dtype: str = "float32"

    def validate(self):
        self._require(self.outflow in ("transmissive", "characteristic"),
                      "outflow must be transmissive or characteristic")
        self._require(self.nx > 0 and self.ny > 0 and self.nz > 0,
                      "grid dims must be positive")
        self._require(self.gamma_floor > 1.0, "gamma must be > 1")
        self._require(self.cfl > 0.0, "cfl must be > 0")
        self._require(self.u_ref > 0.0, "u_ref must be > 0")
        self._require(self.R > 0.0, "R must be > 0")
        self._require(self.sdf_r > 0.0, "sdf_r must be > 0")


def default_config(n: int = 64, **kw) -> Hypersonic3DConfig:
    base = dict(nx=n, ny=n, nz=n, dx=1.0 / n, dy=1.0 / n, dz=1.0 / n)
    base.update(kw)
    return Hypersonic3DConfig(**base)


class PrimT(NamedTuple):
    """Primitive fields (density, velocities, pressure, vibrational energy).
    T and T_v are derived on demand."""

    r: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    p: torch.Tensor
    ev: torch.Tensor


class ConsT(NamedTuple):
    r: torch.Tensor
    mx: torch.Tensor
    my: torch.Tensor
    mz: torch.Tensor
    Et: torch.Tensor
    Ev: torch.Tensor


class Hypersonic3DState(NamedTuple):
    xi: torch.Tensor    # ln rho, (nz, ny, nx)
    phix: torch.Tensor  # asinh(u/u_ref)
    phiy: torch.Tensor
    phiz: torch.Tensor
    lam: torch.Tensor   # ln p
    zet: torch.Tensor   # ln e_vib
    solid: torch.Tensor  # bool
    t: torch.Tensor
    dtau: torch.Tensor


def _pmap(f, *qs):
    return type(qs[0])(*(f(*vals) for vals in zip(*qs)))


# ------------------------- EOS / thermodynamics ----------------------------


def _tv_newton(cfg, evib, Tseed):
    """3-iteration Newton solve for T_v from e_vib
    (Tv_from_evib_seed, :191-204)."""
    Tv = torch.clamp_min(torch.clamp_min(Tseed, NEWTON_TEMP_FLOOR), cfg.Twall)
    rth = cfg.R * cfg.theta_v
    for _ in range(3):
        a = rdiv(cfg.theta_v, torch.clamp_min(Tv, NEWTON_TEMP_FLOOR))
        ea = torch.exp(a)
        denom = torch.clamp_min(ea - 1.0, NEWTON_TEMP_FLOOR)
        f = rdiv(rth, denom) - evib
        df = rth * (ea * rdiv(cfg.theta_v, Tv * Tv)) / (denom * denom)
        Tv = torch.clamp_min(Tv - f / torch.clamp_min(df, DENOM_EPS),
                             NEWTON_TEMP_FLOOR)
    return Tv


def evib_eq(cfg, T):
    """Equilibrium vibrational energy at temperature T (:206-211)."""
    a = rdiv(cfg.theta_v, torch.clamp_min(T, NEWTON_TEMP_FLOOR))
    denom = torch.clamp_min(torch.exp(a) - 1.0, NEWTON_TEMP_FLOOR)
    return rdiv(cfg.R * cfg.theta_v, denom)


def tv_from_evib(cfg, evib, T):
    return _tv_newton(cfg, evib, T)


def _temp(cfg, q: PrimT):
    return q.p / (q.r * cfg.R)


def prim_to_cons(cfg, q: PrimT) -> ConsT:
    ke = 0.5 * (q.u * q.u + q.v * q.v + q.w * q.w)
    e_th = q.p / torch.clamp_min((cfg.gamma_floor - 1.0) * q.r, RHO_P_FLOOR)
    return ConsT(
        r=q.r, mx=q.r * q.u, my=q.r * q.v, mz=q.r * q.w,
        Et=q.r * (ke + e_th + q.ev), Ev=q.r * q.ev,
    )


def cons_to_prim(cfg, U: ConsT) -> PrimT:
    r = torch.clamp_min(U.r, RHO_P_FLOOR)
    u = U.mx / r
    v = U.my / r
    w = U.mz / r
    ke = 0.5 * (u * u + v * v + w * w)
    ev = torch.clamp_min(U.Ev / r, 0.0)
    e_th = torch.clamp_min(U.Et / r - ke - ev, THERMAL_ENERGY_FLOOR)
    p = torch.clamp_min((cfg.gamma_floor - 1.0) * r * e_th, RHO_P_FLOOR)
    return PrimT(r=r, u=u, v=v, w=w, p=p, ev=ev)


def soundspeed(cfg, q: PrimT):
    return torch.sqrt(torch.clamp_min(cfg.gamma_floor * q.p / q.r, DENOM_EPS))


def axis_flux(cfg, q: PrimT, axis: int) -> ConsT:
    un = (q.u, q.v, q.w)[axis]
    H = (q.p / q.r) + (0.5 * (q.u * q.u + q.v * q.v + q.w * q.w) + q.ev) \
        + q.p / torch.clamp_min((cfg.gamma_floor - 1.0) * q.r, RHO_P_FLOOR)
    mom = [q.r * q.u * un, q.r * q.v * un, q.r * q.w * un]
    mom[axis] = mom[axis] + q.p
    return ConsT(r=q.r * un, mx=mom[0], my=mom[1], mz=mom[2],
                 Et=q.r * H * un, Ev=q.r * q.ev * un)


# --------------------------- Riemann solver --------------------------------


def _signed_denom(x):
    m = torch.clamp_min(torch.abs(x), DENOM_EPS)
    return torch.where(x >= 0.0, m, -m)


def _entropy_fix(s, a_ref):
    """Harten entropy fix on wave speed estimates (:366-374)."""
    d = 0.1 * a_ref
    as_ = torch.abs(s)
    sm = 0.5 * (as_ * as_ / torch.clamp_min(d, DENOM_EPS) + d)
    sgn = torch.where(s >= 0.0, 1.0, -1.0).to(s.dtype)
    return torch.where(as_ >= d, s, sgn * sm)


def _shock_sensor(L: PrimT, R: PrimT):
    dp = torch.abs(R.p - L.p) / torch.clamp_min(R.p + L.p, DENOM_EPS)
    dr = torch.abs(R.r - L.r) / torch.clamp_min(R.r + L.r, DENOM_EPS)
    return torch.clamp(5.0 * 0.5 * (dp + dr), 0.0, 1.0)


def _crossflow_speed(L: PrimT, R: PrimT, axis: int):
    comps = [(L.u, R.u), (L.v, R.v), (L.w, R.w)]
    del comps[axis]
    total = sum(torch.abs(a) + torch.abs(b) for a, b in comps)
    return total * 0.5


def hllc_flux(cfg, L: PrimT, R: PrimT, axis: int) -> ConsT:
    """HLLC with entropy fix and shock-sensor HLL blending (:383-460)."""
    aL = soundspeed(cfg, L)
    aR = soundspeed(cfg, R)
    unL = (L.u, L.v, L.w)[axis]
    unR = (R.u, R.v, R.w)[axis]
    sL = torch.minimum(unL - aL, unR - aR)
    sR = torch.maximum(unL + aL, unR + aR)
    aRef = torch.maximum(aL, aR)
    sL = _entropy_fix(sL, aRef)
    sR = _entropy_fix(sR, aRef)

    UL = prim_to_cons(cfg, L)
    UR = prim_to_cons(cfg, R)
    FL = axis_flux(cfg, L, axis)
    FR = axis_flux(cfg, R, axis)

    denom = _signed_denom(L.r * (sL - unL) - R.r * (sR - unR))
    sM = (R.p - L.p + L.r * unL * (sL - unL) - R.r * unR * (sR - unR)) / denom

    pStar = 0.5 * (
        (L.p + L.r * (sL - unL) * (sM - unL))
        + (R.p + R.r * (sR - unR) * (sM - unR))
    )

    align = torch.clamp(
        1.0 - _crossflow_speed(L, R, axis) / torch.clamp_min(aRef, DENOM_EPS),
        0.0, 1.0,
    )
    alpha = _shock_sensor(L, R) * align

    invSRL = torch.div(torch.ones_like(sR), _signed_denom(sR - sL))
    FHLL = _pmap(
        lambda fl, fr, ul, ur: (sR * fl - sL * fr + sL * sR * (ur - ul)) * invSRL,
        FL, FR, UL, UR,
    )

    def star_side(qS, US, FS, sS, unS):
        d = _signed_denom(sS - sM)
        rStar = qS.r * (sS - unS) / d
        EStar = ((sS - unS) * US.Et - qS.p * unS + pStar * sM) / d
        EvStar = US.Ev * (sS - unS) / d
        mom = [rStar * qS.u, rStar * qS.v, rStar * qS.w]
        mom[axis] = rStar * sM
        UStar = ConsT(r=rStar, mx=mom[0], my=mom[1], mz=mom[2],
                      Et=EStar, Ev=EvStar)
        return _pmap(lambda f, us, u: f + sS * (us - u), FS, UStar, US)

    F_left = star_side(L, UL, FL, sL, unL)
    F_right = star_side(R, UR, FR, sR, unR)
    F_star = _pmap(lambda a, b: torch.where(sM >= 0.0, a, b), F_left, F_right)
    blended = _pmap(lambda fs, fh: (1.0 - alpha) * fs + alpha * fh, F_star, FHLL)

    return _pmap(
        lambda fl, fr, bl: torch.where(sL >= 0.0, fl,
                                       torch.where(sR <= 0.0, fr, bl)),
        FL, FR, blended,
    )


def hllc_wall_flux(cfg, q: PrimT, axis: int, left: bool = True) -> ConsT:
    """hllc_flux(q, mirror(q)) if `left` else hllc_flux(mirror(q), q),
    specialized for the symmetric wall pair (:1128-1131, 1148-1151): the
    wave estimates collapse to sL = -(|un|+a), sR = +(|un|+a) (the entropy
    fix is the identity), the contact speed sM is exactly zero, the shock
    sensor is exactly zero, and the interface flux is the L-side star
    flux.  Bitwise equal to the generic path up to +-0 (tested)."""
    L = q if left else _mirror(q, axis)
    a = soundspeed(cfg, L)
    unL = (L.u, L.v, L.w)[axis]
    s = torch.abs(unL) + a
    sL = -s
    UL = prim_to_cons(cfg, L)
    FL = axis_flux(cfg, L, axis)
    # (pStar enters the generic EStar only as pStar * sM == +-0: dropped)
    d = _signed_denom(sL)
    rStar = L.r * (sL - unL) / d
    EStar = ((sL - unL) * UL.Et - L.p * unL) / d
    EvStar = UL.Ev * (sL - unL) / d
    mom = [rStar * L.u, rStar * L.v, rStar * L.w]
    mom[axis] = torch.zeros_like(rStar)     # rStar * sM with sM == 0
    UStar = ConsT(r=rStar, mx=mom[0], my=mom[1], mz=mom[2],
                  Et=EStar, Ev=EvStar)
    return _pmap(lambda f, us, u: f + sL * (us - u), FL, UStar, UL)


def _mirror(q: PrimT, axis: int) -> PrimT:
    comps = {"u": q.u, "v": q.v, "w": q.w}
    key = ("u", "v", "w")[axis]
    comps[key] = -comps[key]
    return PrimT(r=q.r, u=comps["u"], v=comps["v"], w=comps["w"], p=q.p,
                 ev=q.ev)


# --------------------------- state / geometry ------------------------------


def _pwall(cfg, q: PrimT) -> PrimT:
    """Isothermal no-slip wall ghost (apply_wall, :511-521)."""
    p_keep = torch.clamp_min(q.p, RHO_P_FLOOR)
    r = torch.clamp_min(
        div(p_keep, cfg.R * max(cfg.Twall, NEWTON_TEMP_FLOOR)), RHO_P_FLOOR)
    z = torch.zeros_like(q.u)
    # the wall temperature is one constant: its evib_eq is the same value
    # in every cell
    ev = evib_eq(cfg, scalar(q.p, cfg.Twall)).expand_as(q.p)
    return PrimT(r=r, u=z, v=z, w=z, p=p_keep, ev=ev)


def evib_eq_py(cfg, T: float) -> float:
    """Host-side evib_eq for static config-derived constants."""
    a = cfg.theta_v / max(T, NEWTON_TEMP_FLOOR)
    if a > 700.0:  # exp would overflow float64; e_vib^eq underflows to 0
        return 0.0
    denom = max(math.exp(a) - 1.0, NEWTON_TEMP_FLOOR)
    return (cfg.R * cfg.theta_v) / denom


def inflow_values(cfg) -> tuple:
    """The inflow primitives (r, u, v, w, p, ev) as Python floats."""
    r = max(cfg.inflow_r, RHO_P_FLOOR)
    p = max(cfg.inflow_p, RHO_P_FLOOR)
    ev = evib_eq_py(cfg, p / (r * cfg.R))
    return (r, cfg.inflow_u, cfg.inflow_v, cfg.inflow_w, p, ev)


def inflow_prim(cfg, dtype=None, device=None) -> PrimT:
    """The inflow state as 0-d tensors in `dtype` (the config's by
    default), made anew on each call.  On a CUDA device each of the six is
    a blocking copy from the host that waits for the stream to drain.  The
    plain versions call this (`_padded_prims`, which `vis_field` uses too,
    and `step_core_padded`); the step's CUDA kernels take the inflow state
    as a launch argument instead."""
    dt = dtype or cfg.torch_dtype
    return PrimT(*(torch.tensor(v, dtype=dt, device=device)
                   for v in inflow_values(cfg)))


def build_solid(cfg, pad: int = 0) -> np.ndarray:
    """Sphere SDF rasterized at cell centers (k_build_solid_mask :759-770),
    optionally evaluated on a halo-extended grid (cell_is_solid extends the
    SDF beyond the domain, :180-189)."""
    x = (np.arange(-pad, cfg.nx + pad) + 0.5) * cfg.dx
    y = (np.arange(-pad, cfg.ny + pad) + 0.5) * cfg.dy
    z = (np.arange(-pad, cfg.nz + pad) + 0.5) * cfg.dz
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    d = np.sqrt(
        (X - cfg.sdf_cx) ** 2 + (Y - cfg.sdf_cy) ** 2 + (Z - cfg.sdf_cz) ** 2
    ) - cfg.sdf_r
    return d < 0.0


@functools.lru_cache(maxsize=8)
def solid_pad_of(cfg, device) -> torch.Tensor:
    """The halo-3 solid mask of cfg's static geometry on `device` (bool,
    (nz+6, ny+6, nx+6)), built once per config and device."""
    return torch.from_numpy(build_solid(cfg, pad=HALO)).to(device)


def _encode(cfg, q: PrimT):
    xi = torch.log(torch.clamp_min(q.r, RHO_P_FLOOR))
    phix = torch.asinh(div(q.u, cfg.u_ref))
    phiy = torch.asinh(div(q.v, cfg.u_ref))
    phiz = torch.asinh(div(q.w, cfg.u_ref))
    lam = torch.log(torch.clamp_min(q.p, RHO_P_FLOOR))
    zet = torch.log(torch.clamp_min(q.ev, RHO_P_FLOOR))
    return xi, phix, phiy, phiz, lam, zet


def _decode(cfg, xi, phix, phiy, phiz, lam, zet) -> PrimT:
    return PrimT(
        r=torch.exp(xi),
        u=cfg.u_ref * torch.sinh(phix),
        v=cfg.u_ref * torch.sinh(phiy),
        w=cfg.u_ref * torch.sinh(phiz),
        p=torch.exp(lam),
        ev=torch.exp(zet),
    )


def init(cfg: Hypersonic3DConfig, device=None) -> Hypersonic3DState:
    """Quiescent inflow-density gas; solid cells hold the wall state
    (k_init, :939-985).  `device=None` means the GPU (raises where there
    is none)."""
    if device is None:
        device = resolve_device("cuda")
    dt = cfg.torch_dtype
    shape = (cfg.nz, cfg.ny, cfg.nx)
    solid = torch.from_numpy(build_solid(cfg)).to(device)

    r = max(cfg.inflow_r, RHO_P_FLOOR)
    p = max(cfg.inflow_p, RHO_P_FLOOR)
    T = p / (r * cfg.R)
    ev_f = evib_eq_py(cfg, T)

    # wall cells: T=Twall, same p, rho from ideal gas, ev at wall temp
    rw = max(p / (cfg.R * max(cfg.Twall, NEWTON_TEMP_FLOOR)), RHO_P_FLOOR)
    evw = evib_eq_py(cfg, cfg.Twall)

    def full(v):
        return torch.full(shape, v, dtype=dt, device=device)

    q = PrimT(
        r=torch.where(solid, full(rw), full(r)),
        u=full(0.0), v=full(0.0), w=full(0.0),
        p=full(p),
        ev=torch.where(solid, full(evw), full(ev_f)),
    )
    xi, phix, phiy, phiz, lam, zet = _encode(cfg, q)
    return Hypersonic3DState(
        xi=xi, phix=phix, phiy=phiy, phiz=phiz, lam=lam, zet=zet,
        solid=solid,
        t=torch.tensor(cfg.t0, dtype=dt, device=device),
        dtau=torch.tensor(cfg.dtau0, dtype=dt, device=device),
    )


# ------------------------------- stepping ----------------------------------


def _pad_field(cfg, f, outflow_col, left_val):
    """Halo-3 padding: x- side = the inflow constant `left_val`, x+ side =
    outflow ghost column(s), y/z periodic wrap.  `outflow_col` is (nz, ny)
    — one column repeated HALO times (transmissive) — or (nz, ny, HALO)
    with per-ghost values (characteristic)."""
    nz, ny, _ = f.shape
    left = left_val.expand(nz, ny, HALO)
    if outflow_col.ndim == 2:
        right = outflow_col[:, :, None].expand(nz, ny, HALO)
    else:
        right = outflow_col
    f = torch.cat([left, f, right], dim=2)
    f = torch.cat([f[:, -HALO:, :], f, f[:, :HALO, :]], dim=1)   # y periodic
    return torch.cat([f[-HALO:, :, :], f, f[:HALO, :, :]], dim=0)  # z periodic


def _outflow_transmissive(cfg, q: PrimT, infl):
    """Transmissive outflow ghost with subsonic pressure relaxation and
    reversed-flow inflow snap (outflow_prim_transmissive, :691-722).
    Returns one (nz, ny) column per component."""
    qR = PrimT(*(f[:, :, -1] for f in q))
    aR = soundspeed(cfg, qR)
    un = qR.u
    p_amb = max(cfg.inflow_p, RHO_P_FLOOR)
    relax_p = torch.clamp_min(qR.p + 0.05 * (p_amb - qR.p), RHO_P_FLOOR)
    p_out = torch.where(un < aR, relax_p, qR.p)
    q_out = PrimT(
        r=torch.clamp_min(qR.r, RHO_P_FLOOR), u=qR.u, v=qR.v, w=qR.w,
        p=torch.clamp_min(p_out, RHO_P_FLOOR), ev=torch.clamp_min(qR.ev, 0.0),
    )
    # reversed flow at the outlet snaps to inflow (:705-708)
    return PrimT(*(torch.where(un < 0.0, i, o) for i, o in zip(infl, q_out)))


def _outflow_characteristic(cfg, q: PrimT, infl):
    """LODI characteristic outflow ghosts (outflow_prim_characteristic,
    :624-690): linear extrapolation from the last two columns decomposed
    into waves against the inflow target, with outgoing-only gating on
    sign(un -/+ a) and sign(un).  Returns (nz, ny, HALO) per component —
    ghost g uses the g-fold extrapolation."""
    qR = PrimT(*(f[:, :, -1] for f in q))
    qL = PrimT(*(f[:, :, -2] for f in q)) if cfg.nx > 1 else qR
    a = soundspeed(cfg, qR)
    a2 = a * a
    rho_ref = torch.clamp_min(qR.r, RHO_P_FLOOR)
    un = qR.u
    qT = infl
    zero = torch.zeros((), dtype=a.dtype, device=a.device)

    cols = []
    for g in range(1, HALO + 1):
        gf = float(g)
        ex = PrimT(
            r=torch.clamp_min(qR.r + gf * (qR.r - qL.r), RHO_P_FLOOR),
            u=qR.u + gf * (qR.u - qL.u),
            v=qR.v + gf * (qR.v - qL.v),
            w=qR.w + gf * (qR.w - qL.w),
            p=torch.clamp_min(qR.p + gf * (qR.p - qL.p), RHO_P_FLOOR),
            ev=torch.clamp_min(qR.ev + gf * (qR.ev - qL.ev), 0.0),
        )
        drho, du, dp = ex.r - qT.r, ex.u - qT.u, ex.p - qT.p
        L1 = 0.5 * (dp / a2 - rho_ref * du / a)
        L5 = 0.5 * (dp / a2 + rho_ref * du / a)
        L2 = drho - dp / a2
        L3, L4, L6 = ex.v - qT.v, ex.w - qT.w, ex.ev - qT.ev
        L1 = torch.where(un - a < 0.0, zero, L1)
        incoming = un < 0.0
        L2 = torch.where(incoming, zero, L2)
        L3 = torch.where(incoming, zero, L3)
        L4 = torch.where(incoming, zero, L4)
        L6 = torch.where(incoming, zero, L6)
        L5 = torch.where(un + a < 0.0, zero, L5)
        cols.append(PrimT(
            r=torch.clamp_min(qT.r + L1 + L2 + L5, RHO_P_FLOOR),
            u=qT.u + (L5 - L1) / torch.clamp_min(rho_ref * a, DENOM_EPS),
            v=qT.v + L3,
            w=qT.w + L4,
            p=torch.clamp_min(qT.p + a2 * (L1 + L5), RHO_P_FLOOR),
            ev=torch.clamp_min(qT.ev + L6, 0.0),
        ))
    return PrimT(*(torch.stack(fs, dim=-1) for fs in zip(*cols)))


def _padded_prims(cfg, q: PrimT, solid_pad):
    """Build halo-extended primitive fields with all BCs resolved
    (prim_at_xbc semantics + apply_wall on solid cells, :724-751)."""
    infl = inflow_prim(cfg, q.r.dtype, q.r.device)

    if cfg.outflow == "characteristic":
        q_out = _outflow_characteristic(cfg, q, infl)
    else:
        q_out = _outflow_transmissive(cfg, q, infl)

    qp = PrimT(*(_pad_field(cfg, comp, out_col, infl_val)
                 for comp, out_col, infl_val in zip(q, q_out, infl)))

    # wall substitution on (extended) solid cells
    wall = _pwall(cfg, qp)
    return PrimT(*(torch.where(solid_pad, w, f) for w, f in zip(wall, qp)))


def _sl(f, axis, lo, hi_off):
    """Static slice on the padded (nz+2H, ny+2H, nx+2H) array: the window
    starting at halo offset `lo` with domain extent (+hi_off) along `axis`,
    full domain extent on the other axes."""
    starts = [HALO, HALO, HALO]
    sizes = [f.shape[0] - 2 * HALO, f.shape[1] - 2 * HALO, f.shape[2] - 2 * HALO]
    starts[axis] = lo
    sizes[axis] = sizes[axis] + hi_off
    return f[tuple(slice(st, st + n) for st, n in zip(starts, sizes))]


_ARR_AX = {0: 2, 1: 1, 2: 0}  # spatial axis (0=x, 1=y, 2=z) -> array axis


def _floor_prim(q):
    return PrimT(
        r=torch.clamp_min(q.r, RHO_P_FLOOR), u=q.u, v=q.v, w=q.w,
        p=torch.clamp_min(q.p, RHO_P_FLOOR), ev=torch.clamp_min(q.ev, 0.0),
    )


def _face_prims(cfg, qp: PrimT, solid_pad, axis: int):
    """WENO5 (or first-order near solids) L/R states on every interior+boundary
    face along `axis`: face arrays have domain extent +1 along `axis`.

    Face k sits between padded cells k+H-1 and k+H (k in [0, n]).
    """
    arr_ax = _ARR_AX[axis]

    def shifted(off):
        # value of padded cell (face_index + H - 1 + off) => slice start
        return PrimT(*(_sl(f, arr_ax, HALO - 1 + off, 1) for f in qp))

    q_0 = shifted(0)     # left cell of the face
    q_p1 = shifted(1)    # right cell of the face

    def crop_other(f):
        sl = [slice(HALO, f.shape[d] - HALO) for d in range(3)]
        sl[arr_ax] = slice(None)
        return f[tuple(sl)]

    lr = [weno5_lr_slab(crop_other(f), arr_ax, HALO) for f in qp]
    L = _floor_prim(PrimT(*(x[0] for x in lr)))
    R = _floor_prim(PrimT(*(x[1] for x in lr)))

    # stencil degradation: any solid in the 6-cell line -> first-order pair
    # (q_0, q_p1) (:1132-1138,1152-1158)
    s_any = None
    for off in (-2, -1, 0, 1, 2, 3):
        s = _sl(solid_pad, arr_ax, HALO - 1 + off, 1)
        s_any = s if s_any is None else (s_any | s)
    L = PrimT(*(torch.where(s_any, a, b) for a, b in zip(_floor_prim(q_0), L)))
    R = PrimT(*(torch.where(s_any, a, b) for a, b in zip(_floor_prim(q_p1), R)))
    return L, R, q_0, q_p1


def solid_box_from_mask(solid_pad) -> tuple | None:
    """Static inclusive bounds ((zlo,zhi),(ylo,yhi),(xlo,xhi)) of the solid
    in PADDED coordinates, from a concrete halo-extended mask (numpy or a
    tensor, read to the host).  Returns None when no cell is solid.  The
    wall-mirror fluxes only need computing on this box: everywhere else
    face_solid is false and the flux select never reads them."""
    if isinstance(solid_pad, torch.Tensor):
        solid_pad = solid_pad.cpu().numpy()
    m = np.asarray(solid_pad)
    if not m.any():
        return None
    out = []
    for d in range(3):
        ax = tuple(i for i in range(3) if i != d)
        hit = np.nonzero(m.any(axis=ax))[0]
        out.append((int(hit[0]), int(hit[-1])))
    return tuple(out)


def _boxed_wall_flux(cfg, qface: PrimT, spatial_axis: int, left: bool,
                     solid_box) -> ConsT:
    """hllc_wall_flux computed only on the static face sub-box that can
    touch a solid cell (zeros elsewhere).  `solid_box` is
    solid_box_from_mask output (padded coords); entries may extend past
    the window (they are clamped).  Every value the downstream
    `where(face_solid, ...)` can select is bitwise the dense call's."""
    arr_ax = _ARR_AX[spatial_axis]
    shape = qface.r.shape

    def zeros():
        return ConsT(*(torch.zeros(shape, dtype=qface.r.dtype,
                                   device=qface.r.device) for _ in range(6)))

    if solid_box is None:
        return zeros()
    slices = []
    for d in range(3):
        lo, hi = solid_box[d]
        if d == arr_ax:
            # face k reads padded cells k+H-1 and k+H -> solid faces span
            # k in [lo-H, hi-H+1]
            a, b = lo - HALO, hi - HALO + 2
        else:
            # face arrays index interior cells (padded j+H)
            a, b = lo - HALO, hi - HALO + 1
        a, b = max(a, 0), min(b, shape[d])
        if a >= b:
            return zeros()
        slices.append((a, b))
    idx = tuple(slice(a, b) for a, b in slices)
    Fs = hllc_wall_flux(cfg, PrimT(*(f[idx] for f in qface)), spatial_axis,
                        left=left)
    out = zeros()
    for o, f in zip(out, Fs):
        o[idx] = f
    return out


def step_core_padded(cfg: Hypersonic3DConfig, qp: PrimT, solid_pad,
                     dt, inflow_gain, x0: int = 0,
                     solid_box="dense", sponge_mode: str = "slab") -> PrimT:
    """The full cell update on a halo-extended window of BC-resolved
    primitives: WENO faces -> HLLC with wall mirroring -> conservative
    update -> repair -> Landau-Teller -> sponges.  Window-agnostic along
    every axis; `x0` is the global x index of the window's first interior
    column (the sponge ramps are functions of global x).  `dt` and
    `inflow_gain` are 0-d tensors.

    `solid_box`: "dense" computes the wall-mirror fluxes at every face; a
    solid_box_from_mask value (or None for no solid) restricts them to the
    static sub-box that can touch the solid — the same values, since the
    flux select reads them only inside it.  `sponge_mode` "slab" applies
    each sponge to its x-column slab only, "dense" to the whole window
    (the ramp is 0 outside the slab, so only -0.0 velocity signs differ).
    This is the plain version of the CUDA step kernel
    (csrc/hypersonic3d_step.cu), which computes the slab form."""
    dtype = qp.r.dtype
    q0_cell = PrimT(*(f[HALO:-HALO, HALO:-HALO, HALO:-HALO] for f in qp))

    fluxes = []
    for axis in range(3):
        arr_ax = _ARR_AX[axis]
        L, R, qface_l, qface_r = _face_prims(cfg, qp, solid_pad, axis)
        F = hllc_flux(cfg, L, R, axis)

        # wall-mirror override where the face touches a solid cell
        # (:1128-1131, 1148-1151). This is per-SIDE: the cell left of the
        # face uses (q_left, mirror(q_left)); the right cell uses
        # (mirror(q_right), q_right).
        sl = _sl(solid_pad, arr_ax, HALO - 1, 1)
        sr = _sl(solid_pad, arr_ax, HALO, 1)
        face_solid = sl | sr

        if isinstance(solid_box, str) and solid_box == "dense":
            F_from_left = hllc_wall_flux(cfg, qface_l, axis, left=True)
            F_from_right = hllc_wall_flux(cfg, qface_r, axis, left=False)
        else:
            F_from_left = _boxed_wall_flux(cfg, qface_l, axis, True, solid_box)
            F_from_right = _boxed_wall_flux(cfg, qface_r, axis, False,
                                            solid_box)
        fluxes.append((F, face_solid, F_from_left, F_from_right, arr_ax))

    U0 = prim_to_cons(cfg, q0_cell)

    inv_d = (1.0 / cfg.dx, 1.0 / cfg.dy, 1.0 / cfg.dz)
    dU = None
    for axis in range(3):
        F, face_solid, F_wl, F_wr, arr_ax = fluxes[axis]
        n = F.r.shape[arr_ax]

        def lo(f):
            return torch.narrow(f, arr_ax, 0, n - 1)

        def hi(f):
            return torch.narrow(f, arr_ax, 1, n - 1)

        # minus-face flux of each cell: face k; wall override -> mirrored
        # Riemann problem seen from this (right-of-face) cell.
        Fm = ConsT(*(torch.where(lo(face_solid), lo(w), lo(f))
                     for f, w in zip(F, F_wr)))
        # plus-face flux: face k+1; wall override from this (left) cell.
        Fp = ConsT(*(torch.where(hi(face_solid), hi(w), hi(f))
                     for f, w in zip(F, F_wl)))
        contrib = ConsT(*(-(p - m) * inv_d[axis] for p, m in zip(Fp, Fm)))
        dU = contrib if dU is None else ConsT(*(a + b for a, b in zip(dU, contrib)))

    U1 = ConsT(*(u + dt * d for u, d in zip(U0, dU)))
    q1 = cons_to_prim(cfg, U1)

    # non-finite / non-physical repair -> inflow (:1284-1289)
    bad = torch.zeros_like(q1.r, dtype=torch.bool)
    for f in q1:
        bad |= ~torch.isfinite(f)
    bad |= (q1.r <= 0.0) | (q1.p <= 0.0) | (q1.ev < 0.0)
    infl = inflow_prim(cfg, dtype, q1.r.device)
    q1 = PrimT(*(torch.where(bad, i, f) for i, f in zip(infl, q1)))

    # Landau–Teller relaxation (:1290-1293)
    T1 = _temp(cfg, q1)
    ev_eq = evib_eq(cfg, T1)
    relax = div(dt, max(cfg.tau_vib, TAU_VIB_MIN))
    q1 = q1._replace(ev=torch.clamp_min(q1.ev + (ev_eq - q1.ev) * relax, 0.0))

    # sponge layers (:1295-1344).  Each sponge transforms only its static
    # x-column slab ("slab"); outside it the ramp is exactly 0.0 and the
    # post-repair fields satisfy the floors, so "dense" gives the same
    # values but for -0.0 velocity signs.
    def sponge_slab(q, g_lo, g_hi, fn):
        wx = q.r.shape[2]
        col_lo, col_hi = max(g_lo - x0, 0), min(g_hi - x0, wx)
        if col_lo >= col_hi:
            return q
        if sponge_mode == "dense":
            return fn(q, 0)
        sub = fn(PrimT(*(f[:, :, col_lo:col_hi] for f in q)), col_lo)
        out = PrimT(*(f.clone() for f in q))
        for o, g in zip(out, sub):
            o[:, :, col_lo:col_hi] = g
        return out

    def xs_of(sub, col_lo):
        return (torch.arange(sub.r.shape[2], device=sub.r.device).to(dtype)
                + (x0 + col_lo)).view(1, 1, -1)

    tgtT = max(cfg.inflow_p, RHO_P_FLOOR) / (
        max(cfg.inflow_r, RHO_P_FLOOR) * cfg.R
    )
    tgt_ev = evib_eq_py(cfg, tgtT)
    tgt_r = max(cfg.inflow_r, RHO_P_FLOOR)
    tgt_p = max(cfg.inflow_p, RHO_P_FLOOR)
    if cfg.sponge_n > 0:
        def sponge_in(sub, col_lo):
            sramp = torch.clamp(1.0 - div(xs_of(sub, col_lo), cfg.sponge_n),
                                0.0, 1.0)
            k_in = cfg.sponge_strength * (sramp * sramp)
            tgt_u = inflow_gain * cfg.inflow_u
            tgt_v = inflow_gain * cfg.inflow_v
            tgt_w = inflow_gain * cfg.inflow_w
            return PrimT(
                r=torch.clamp_min(sub.r + k_in * (tgt_r - sub.r), RHO_P_FLOOR),
                u=sub.u + k_in * (tgt_u - sub.u),
                v=sub.v + k_in * (tgt_v - sub.v),
                w=sub.w + k_in * (tgt_w - sub.w),
                p=torch.clamp_min(sub.p + k_in * (tgt_p - sub.p), RHO_P_FLOOR),
                ev=torch.clamp_min(sub.ev + k_in * (tgt_ev - sub.ev), 0.0),
            )

        q1 = sponge_slab(q1, 0, cfg.sponge_n, sponge_in)
    if cfg.sponge_out_n > 0:
        def sponge_out(sub, col_lo):
            xo = xs_of(sub, col_lo) - (cfg.nx - cfg.sponge_out_n)
            oramp = torch.clamp(div(xo, cfg.sponge_out_n), 0.0, 1.0) \
                * (xo >= 0).to(dtype)
            k_out = cfg.sponge_out_strength * (oramp * oramp)
            return PrimT(
                r=torch.clamp_min(sub.r + k_out * (tgt_r - sub.r), RHO_P_FLOOR),
                u=sub.u + k_out * (0.0 - sub.u),
                v=sub.v + k_out * (0.0 - sub.v),
                w=sub.w + k_out * (0.0 - sub.w),
                p=torch.clamp_min(sub.p + k_out * (tgt_p - sub.p), RHO_P_FLOOR),
                ev=torch.clamp_min(sub.ev + k_out * (tgt_ev - sub.ev), 0.0),
            )

        q1 = sponge_slab(q1, cfg.nx - cfg.sponge_out_n, cfg.nx, sponge_out)

    return q1


def max_wavespeed(cfg, q1: PrimT, solid) -> torch.Tensor:
    """Max over fluid cells of (|u|+a)/dx + (|v|+a)/dy + (|w|+a)/dz, with
    non-finite sums and solid cells counted as 0 (the atomicMaxFloat
    reduction of :1345-1351).  The plain version of the wavespeed kernel
    (csrc/hypersonic3d_wavespeed.cu)."""
    a1 = soundspeed(cfg, q1)
    ssum = div(torch.abs(q1.u) + a1, cfg.dx) \
        + div(torch.abs(q1.v) + a1, cfg.dy) \
        + div(torch.abs(q1.w) + a1, cfg.dz)
    ssum = torch.where(torch.isfinite(ssum) & ~solid, ssum, 0.0)
    return torch.amax(ssum)


def step(cfg: Hypersonic3DConfig, s: Hypersonic3DState,
         solid_pad=None, wavespeed_reduce=None,
         core=None, gain_mul=None, wavespeed=None,
         pad=None) -> Hypersonic3DState:
    """One step.  `solid_pad` (halo-3 extended solid mask) and
    `wavespeed_reduce` (a cross-device max) are hooks for a sharded
    runner; `gain_mul` multiplies the inflow ramp (the interactive a_gain
    nudge, tau_hypersonic_3d_cuda.cu:1658-1661) and may be a 0-d tensor.

    `pad(s, solid_pad) -> PrimT` is the prologue (the state's encoded
    fields to halo-3 padded, BC-resolved primitives), `core(qp, solid_pad,
    dt, gain) -> PrimT` the cell-update engine and `wavespeed(q1, solid)
    -> 0-d tensor` the masked max-wavespeed reduction.  All three default
    to the CUDA kernels of kernels.hypersonic3d_cuda, whose wrappers run
    their plain versions (_padded_prims of _decode, step_core_padded,
    max_wavespeed) for CPU tensors.  dt never leaves the device.  Under a
    profiler the phases are the spans `fst.h3d.tau`, `.pad`, `.update`,
    `.dt` (the wavespeed, its reduce and the dτ feedback) and
    `.encode`."""
    from ..kernels import hypersonic3d_cuda as hk

    solid = s.solid
    if solid_pad is None:
        solid_pad = solid_pad_of(cfg, solid.device)

    # τ advance (pre-step, :1680-1683)
    with span("fst.h3d.tau"):
        t = s.t * torch.exp(s.dtau)
        dt = t * s.dtau
        inflow_gain = torch.clamp(div(t, 0.02), 0.0, 1.0)
        if gain_mul is not None:
            inflow_gain = inflow_gain * gain_mul

    with span("fst.h3d.pad"):
        if pad is None:
            qp = hk.pad(cfg, s, solid_pad)
        else:
            qp = pad(s, solid_pad)

    with span("fst.h3d.update"):
        if core is None:
            q1 = hk.step_core(cfg, qp, solid_pad, dt, inflow_gain)
        else:
            q1 = core(qp, solid_pad, dt, inflow_gain)

    with span("fst.h3d.dt"):
        if wavespeed is None:
            maxs = hk.wavespeed(cfg, q1, solid)
        else:
            maxs = wavespeed(q1, solid)
        if wavespeed_reduce is not None:
            maxs = wavespeed_reduce(maxs)

        # dτ feedback controller (:1697-1704), shared deadband helper
        dt_cfl = rdiv(cfg.cfl, torch.clamp_min(maxs, 1e-9))
        dtau = dtau_feedback(s.dtau, dt, dt_cfl)

    with span("fst.h3d.encode"):
        new = _encode(cfg, q1)
        old = (s.xi, s.phix, s.phiy, s.phiz, s.lam, s.zet)
        # solid cells keep their previous state (:1063-1072)
        kept = [torch.where(solid, o, n) for n, o in zip(new, old)]
    return Hypersonic3DState(*kept, solid=solid, t=t, dtau=dtau)


def run(cfg: Hypersonic3DConfig, s: Hypersonic3DState, n_steps: int,
        gain_mul=None, core=None, wavespeed=None,
        pad=None) -> Hypersonic3DState:
    return run_steps(lambda st: step(cfg, st, gain_mul=gain_mul, core=core,
                                     wavespeed=wavespeed, pad=pad),
                     s, n_steps)


# ------------------------------ view modes ---------------------------------

def outflow_reflection_metric(cfg, s: Hypersonic3DState, nprobe: int = 6):
    """Outflow-reflection diagnostic: max |p - p_inflow| over the last
    `nprobe` x-columns (k_outflow_reflection_metric,
    tau_hypersonic_3d_cuda.cu:1389-1410)."""
    nprobe = max(1, min(int(nprobe), cfg.nx))
    p = torch.exp(s.lam[:, :, -nprobe:])
    p_ref = max(cfg.inflow_p, RHO_P_FLOOR)
    return torch.amax(torch.abs(p - p_ref))


VIS_MODES = [
    "schlieren", "log_rho", "log_p", "speed", "mach", "vorticity",
    "divergence", "q_criterion",
]


def vis_field(cfg, s: Hypersonic3DState, mode: str):
    """Diagnostic scalar volume (k_vis, :800-905); zero inside solids."""
    if mode not in VIS_MODES:
        raise ValueError(f"unknown vis mode {mode}")
    q = _decode(cfg, s.xi, s.phix, s.phiy, s.phiz, s.lam, s.zet)
    qp = _padded_prims(cfg, q, solid_pad_of(cfg, s.xi.device))
    qc = PrimT(*(f[HALO:-HALO, HALO:-HALO, HALO:-HALO] for f in qp))

    if mode == "log_rho":
        out = torch.log1p(torch.clamp_min(qc.r, 0.0))
    elif mode == "log_p":
        out = torch.log1p(torch.clamp_min(qc.p, 0.0))
    elif mode == "speed":
        out = torch.sqrt(qc.u * qc.u + qc.v * qc.v + qc.w * qc.w)
    elif mode == "mach":
        out = torch.sqrt(qc.u * qc.u + qc.v * qc.v + qc.w * qc.w) \
            / torch.clamp_min(soundspeed(cfg, qc), DENOM_EPS)
    else:
        def nb(axis, off):
            return PrimT(*(_sl(f, _ARR_AX[axis], HALO + off, 0) for f in qp))

        qxm, qxp = nb(0, -1), nb(0, 1)
        qym, qyp = nb(1, -1), nb(1, 1)
        qzm, qzp = nb(2, -1), nb(2, 1)
        i2x, i2y, i2z = 0.5 / cfg.dx, 0.5 / cfg.dy, 0.5 / cfg.dz

        if mode == "schlieren":
            gx = (qxp.r - qxm.r) * i2x
            gy = (qyp.r - qym.r) * i2y
            gz = (qzp.r - qzm.r) * i2z
            out = torch.sqrt(gx * gx + gy * gy + gz * gz)
        else:
            dudx, dudy, dudz = (qxp.u - qxm.u) * i2x, (qyp.u - qym.u) * i2y, \
                (qzp.u - qzm.u) * i2z
            dvdx, dvdy, dvdz = (qxp.v - qxm.v) * i2x, (qyp.v - qym.v) * i2y, \
                (qzp.v - qzm.v) * i2z
            dwdx, dwdy, dwdz = (qxp.w - qxm.w) * i2x, (qyp.w - qym.w) * i2y, \
                (qzp.w - qzm.w) * i2z
            if mode == "divergence":
                out = dudx + dvdy + dwdz
            elif mode == "vorticity":
                wx = dwdy - dvdz
                wy = dudz - dwdx
                wz = dvdx - dudy
                out = torch.sqrt(wx * wx + wy * wy + wz * wz)
            else:  # q_criterion
                O12 = 0.5 * (dudy - dvdx)
                O13 = 0.5 * (dudz - dwdx)
                O23 = 0.5 * (dvdz - dwdy)
                Om2 = 2.0 * (O12 * O12 + O13 * O13 + O23 * O23)
                S12 = 0.5 * (dudy + dvdx)
                S13 = 0.5 * (dudz + dwdx)
                S23 = 0.5 * (dvdz + dwdy)
                Sm2 = dudx * dudx + dvdy * dvdy + dwdz * dwdz \
                    + 2.0 * (S12 * S12 + S13 * S13 + S23 * S23)
                out = 0.5 * (Om2 - Sm2)

    return torch.where(s.solid, 0.0, out)
