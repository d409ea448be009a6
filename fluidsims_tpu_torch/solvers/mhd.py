"""2-D ideal MHD with hyperbolic/parabolic GLM divergence cleaning (port of
fluidsims_tpu.solvers.mhd).

Behavioral spec: tau_mhd.c — 7-component state (rho, mx, my, E, Bx, By, psi)
(:37-38); MUSCL reconstruction in CONSERVED variables with this file's own
MC-limiter composition mc(dl,dc,dr) = minmod(minmod(dl,dr),
minmod(dc, minmod(2dl,2dr))) (:48-49, 129-142 — note: different from the
hypersonic solvers' mc_limiter); GLM-augmented fluxes with cleaning speed
ch (:78-99); an HLLD-oriented wave model whose star states gate a robust
HLL flux (hlld_glm_flux :103-127 — the returned interior flux is always
HLL; SL/SR are widened by ±ch); face-pair conservative update over interior
cells only (:164-171); psi damping exp(-alpha ch dt/min(dx,dy)) and
invalid-update revert to the previous state (:172-173); Brio–Wu and
Orszag–Tang initial conditions (:144-157); dt = CFL*min(dx,dy)/(maxs+ch)
with ch = maxs (:160-162); view modes rho/p/|B|/|divB| (:178-183).

Squares are written as products (JAX's `x**2` is `x*x`), and every
quotient with a Python-number operand is one true division (ops.scalar).

Engines (`resolve_engine`): 'cuda' — the hand-written K-step kernel
(kernels/mhd_cuda.py), `n // block_k` launches of block_k steps then
`n % block_k` of one step; the default on a CUDA device.  'torch' —
`step` below; the default on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import BaseConfig
from ..core.device import resolve_block_engine, resolve_device
from ..core.stepper import run_steps
from ..ops.limiters import minmod
from ..ops.scalar import div, rdiv
from ..ops.shift import shift_clamped, shift_wrapped

__all__ = ["MHDConfig", "MHDState", "ConsM", "PrimM", "EPS_RHO", "EPS_P",
           "GLM_ALPHA", "FIELDS", "cons_to_prim", "prim_to_cons",
           "fast_speed", "glm_flux", "hlld_glm_flux", "default_face_masks",
           "init", "step_core", "step", "run", "view_field",
           "resolve_engine"]

EPS_RHO = 1e-8
EPS_P = 1e-8
GLM_ALPHA = 0.18
FIELDS = ("rho", "mx", "my", "E", "Bx", "By", "psi")


class ConsM(NamedTuple):
    rho: torch.Tensor
    mx: torch.Tensor
    my: torch.Tensor
    E: torch.Tensor
    Bx: torch.Tensor
    By: torch.Tensor
    psi: torch.Tensor


class PrimM(NamedTuple):
    rho: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor
    Bx: torch.Tensor
    By: torch.Tensor
    psi: torch.Tensor


@dataclass(frozen=True)
class MHDConfig(BaseConfig):
    nx: int = 320
    ny: int = 220
    gamma: float = 1.4
    cfl: float = 0.22
    problem: str = "briowu"   # or "orszag-tang"
    # The reference's FHLL uses F = (SR FL - SL FR - SL SR (UR-UL))/(SR-SL)
    # (tau_mhd.c:123) — the OPPOSITE sign of the standard dissipative HLL
    # term. That anti-diffusive flux is kept as the default for behavioral
    # parity (the reference survives via its invalid-cell revert, :173);
    # stable_hll=True switches to the textbook sign.
    stable_hll: bool = False
    dtype: str = "float32"
    engine: str = "auto"      # auto | torch | cuda (K steps a launch)
    block_k: int = 8          # steps per kernel launch (cuda)

    def validate(self):
        self._require(self.nx > 4 and self.ny > 4, "grid too small")
        self._require(self.gamma > 1.0, "gamma must be > 1")
        self._require(self.problem in ("briowu", "orszag-tang"),
                      f"unknown problem {self.problem}")
        self._require(self.engine in ("auto", "torch", "cuda"),
                      "engine must be auto, torch or cuda")
        self._require(self.block_k >= 1, "block_k must be >= 1")


class MHDState(NamedTuple):
    U: ConsM
    t: torch.Tensor


def _map(f, *cs):
    return ConsM(*(f(*vals) for vals in zip(*cs)))


def cons_to_prim(U: ConsM, gamma: float) -> PrimM:
    rho = torch.clamp_min(U.rho, EPS_RHO)
    u = U.mx / rho
    v = U.my / rho
    ek = 0.5 * rho * (u * u + v * v)
    em = 0.5 * (U.Bx * U.Bx + U.By * U.By)
    p = torch.clamp_min((gamma - 1.0) * (U.E - ek - em), EPS_P)
    return PrimM(rho=rho, u=u, v=v, p=p, Bx=U.Bx, By=U.By, psi=U.psi)


def prim_to_cons(q: PrimM, gamma: float) -> ConsM:
    rho = torch.clamp_min(q.rho, EPS_RHO)
    p = torch.clamp_min(q.p, EPS_P)
    return ConsM(
        rho=rho, mx=rho * q.u, my=rho * q.v,
        E=div(p, gamma - 1.0) + 0.5 * rho * (q.u * q.u + q.v * q.v)
        + 0.5 * (q.Bx * q.Bx + q.By * q.By),
        Bx=q.Bx, By=q.By, psi=q.psi,
    )


def fast_speed(q: PrimM, gamma: float, xdir: bool):
    """Fast magnetosonic speed estimate (tau_mhd.c:70-76)."""
    a2 = gamma * q.p / q.rho
    b2 = (q.Bx * q.Bx + q.By * q.By) / q.rho
    bn = q.Bx if xdir else q.By
    bn2 = bn * bn / q.rho
    disc = torch.clamp_min((a2 + b2) * (a2 + b2) - 4.0 * a2 * bn2, 0.0)
    return torch.sqrt(0.5 * ((a2 + b2) + torch.sqrt(disc)))


def glm_flux(U: ConsM, gamma: float, ch, xdir: bool) -> ConsM:
    """GLM-augmented ideal-MHD flux (flux_x/flux_y, tau_mhd.c:78-99)."""
    q = cons_to_prim(U, gamma)
    pt = q.p + 0.5 * (q.Bx * q.Bx + q.By * q.By)
    vb = q.u * q.Bx + q.v * q.By
    if xdir:
        return ConsM(
            rho=U.mx,
            mx=U.mx * q.u + pt - q.Bx * q.Bx,
            my=U.my * q.u - q.Bx * q.By,
            E=(U.E + pt) * q.u - q.Bx * vb,
            Bx=q.psi,
            By=q.u * q.By - q.v * q.Bx,
            psi=ch * ch * q.Bx,
        )
    return ConsM(
        rho=U.my,
        mx=U.mx * q.v - q.By * q.Bx,
        my=U.my * q.v + pt - q.By * q.By,
        E=(U.E + pt) * q.v - q.By * vb,
        Bx=q.v * q.Bx - q.u * q.By,
        By=q.psi,
        psi=ch * ch * q.By,
    )


def hlld_glm_flux(UL: ConsM, UR: ConsM, gamma: float, ch, xdir: bool,
                  stable: bool = False) -> ConsM:
    """HLLD-oriented wave model gating a robust HLL flux
    (tau_mhd.c:103-127): the interior flux is the HLL flux in either case,
    exactly as the reference, where the HLLD branch falls through to
    FHLL.  `stable` picks the textbook dissipative sign, else the
    reference's anti-diffusive one."""
    L = cons_to_prim(UL, gamma)
    R = cons_to_prim(UR, gamma)
    unL = L.u if xdir else L.v
    unR = R.u if xdir else R.v
    cfL = fast_speed(L, gamma, xdir)
    cfR = fast_speed(R, gamma, xdir)
    SL = torch.minimum(torch.minimum(unL - cfL, unR - cfR), -ch)
    SR = torch.maximum(torch.maximum(unL + cfL, unR + cfR), ch)

    FL = glm_flux(UL, gamma, ch, xdir)
    FR = glm_flux(UR, gamma, ch, xdir)

    inv = rdiv(1.0, SR - SL)  # SR >= ch > 0 > -ch >= SL, never degenerate
    sgn = 1.0 if stable else -1.0
    FHLL = _map(
        lambda fl, fr, ul, ur: (SR * fl - SL * fr
                                + sgn * SL * SR * (ur - ul)) * inv,
        FL, FR, UL, UR,
    )
    return _map(
        lambda fl, fr, fh: torch.where(SL >= 0.0, fl,
                                       torch.where(SR <= 0.0, fr, fh)),
        FL, FR, FHLL,
    )


def _mc(dl, dc, dr):
    """This solver's own limiter composition (tau_mhd.c:49)."""
    return minmod(minmod(dl, dr), minmod(dc, minmod(2.0 * dl, 2.0 * dr)))


def _slopes(U: ConsM, dy: int, dx: int, shift=shift_clamped) -> ConsM:
    """MC-limited slopes on conserved variables (slope_at/slope_y_at,
    tau_mhd.c:129-142), with edge-clamped neighbors (only interior values
    are consumed)."""

    def s(f):
        fm = shift(f, -dy, -dx)
        fp = shift(f, dy, dx)
        return _mc(f - fm, 0.5 * (fp - fm), fp - f)

    return ConsM(*(s(f) for f in U))


def init(cfg: MHDConfig, device=None) -> MHDState:
    """Brio–Wu or Orszag–Tang, drawn with the JAX module's numpy code and
    converted to conserved variables in the working dtype.  `device=None`
    means the GPU (raises where there is none)."""
    if device is None:
        device = resolve_device("cuda")
    nx, ny = cfg.nx, cfg.ny
    X = (np.arange(nx)[None, :] + 0.5) / nx
    Y = (np.arange(ny)[:, None] + 0.5) / ny
    g = cfg.gamma

    if cfg.problem == "briowu":
        left = X < 0.5
        rho = np.where(left, 1.0, 0.125) * np.ones((ny, nx))
        p = np.where(left, 1.0, 0.1) * np.ones((ny, nx))
        By = np.where(left, 1.0, -1.0) * np.ones((ny, nx))
        Bx = np.full((ny, nx), 0.75)
        u = np.zeros((ny, nx))
        v = 0.03 * np.sin(12.0 * Y) * np.ones((ny, nx))
    else:
        rho = np.full((ny, nx), g * g)
        p = np.full((ny, nx), g)
        u = (-np.sin(2 * np.pi * Y)) * np.ones((ny, nx))
        v = np.sin(2 * np.pi * X) * np.ones((ny, nx))
        Bx = (-np.sin(2 * np.pi * Y) / np.sqrt(4 * np.pi)) * np.ones((ny, nx))
        By = (np.sin(4 * np.pi * X) / np.sqrt(4 * np.pi)) * np.ones((ny, nx))

    dt = cfg.torch_dtype

    def t_(a):
        return torch.tensor(a, dtype=dt, device=device)

    q = PrimM(rho=t_(rho), u=t_(u), v=t_(v), p=t_(p), Bx=t_(Bx), By=t_(By),
              psi=torch.zeros((ny, nx), dtype=dt, device=device))
    return MHDState(U=prim_to_cons(q, g),
                    t=torch.zeros((), dtype=dt, device=device))


def _zero_shift_x(fx):
    """fxm[y, x] = fx[y, x-1], zero-filled at x=0 (the pair term of the
    conservative face-scatter update)."""
    return torch.nn.functional.pad(fx, (1, 0))[:, :-1]


def _zero_shift_y(fy):
    return torch.nn.functional.pad(fy, (0, 0, 1, 0))[:-1, :]


def default_face_masks(nx: int, ny: int, device=None):
    """Interior face bands: x faces (flux between cells x and x+1) for
    x in [1, nx-3], y in [1, ny-2] (tau_mhd.c:164-167); y faces for
    y in [1, ny-3], x in [1, nx-2]."""
    mx_face = np.zeros((ny, nx), bool)
    mx_face[1:ny - 1, 1:nx - 2] = True
    my_face = np.zeros((ny, nx), bool)
    my_face[1:ny - 2, 1:nx - 1] = True
    return (torch.tensor(mx_face, device=device),
            torch.tensor(my_face, device=device))


def step_core(cfg: MHDConfig, U: ConsM, *, shift=shift_clamped,
              zero_shift_x=_zero_shift_x, zero_shift_y=_zero_shift_y,
              face_masks=None, dxdy=None, wavespeed_reduce=None):
    """One MHD+GLM step on the raw conserved fields; returns (Un, dt).

    Hooks for a sharded runner (all default to the dense single-device
    step): the shift primitives, `face_masks=(mx, my)` when a slab's
    global column range differs from [0, nx), `dxdy` when cfg.nx is a
    local width, `wavespeed_reduce` (an all-reduce MAX over ranks)."""
    g = cfg.gamma
    nx, ny = cfg.nx, cfg.ny
    dx, dy = dxdy if dxdy is not None else (1.0 / nx, 1.0 / ny)

    q = cons_to_prim(U, g)
    maxs = torch.max(
        torch.hypot(q.u, q.v)
        + torch.maximum(fast_speed(q, g, True), fast_speed(q, g, False))
    )
    if wavespeed_reduce is not None:
        maxs = wavespeed_reduce(maxs)
    maxs = torch.clamp_min(maxs, 1e-6)
    ch = maxs
    dt = rdiv(cfg.cfl * min(dx, dy), torch.clamp_min(maxs + ch, 1e-6))

    if face_masks is None:
        mx_face, my_face = default_face_masks(nx, ny, U.rho.device)
    else:
        mx_face, my_face = face_masks

    Sx = _slopes(U, 0, 1, shift)
    qL = _map(lambda u_, sl: u_ + 0.5 * sl, U, Sx)
    qR_all = _map(lambda u_, sl: u_ - 0.5 * sl, U, Sx)
    qR = ConsM(*(shift(f, 0, 1) for f in qR_all))
    Fx = hlld_glm_flux(qL, qR, g, ch, True, cfg.stable_hll)
    Fx = _map(lambda f: torch.where(mx_face, f, 0.0), Fx)

    Sy = _slopes(U, 1, 0, shift)
    qB = _map(lambda u_, sl: u_ + 0.5 * sl, U, Sy)
    qT_all = _map(lambda u_, sl: u_ - 0.5 * sl, U, Sy)
    qT = ConsM(*(shift(f, 1, 0) for f in qT_all))
    Fy = hlld_glm_flux(qB, qT, g, ch, False, cfg.stable_hll)
    Fy = _map(lambda f: torch.where(my_face, f, 0.0), Fy)

    # conservative pair update: cell c gets -(Fx[c] - Fx[c-1])*dt/dx etc.
    dt_dx, dt_dy = div(dt, dx), div(dt, dy)

    def upd(u_, fx, fy):
        return (u_ - dt_dx * (fx - zero_shift_x(fx))
                - dt_dy * (fy - zero_shift_y(fy)))

    Un = _map(upd, U, Fx, Fy)

    # psi damping + invalid-update revert (tau_mhd.c:172-173)
    damp = torch.exp(div(-GLM_ALPHA * ch * dt, min(dx, dy)))
    Un = Un._replace(psi=Un.psi * damp)

    qn = cons_to_prim(Un, g)
    ok = torch.isfinite(Un.E) & (qn.rho > EPS_RHO) & (qn.p > EPS_P)
    for f in Un:
        ok = ok & torch.isfinite(f)
    Un = _map(lambda new, old: torch.where(ok, new, old), Un, U)
    return Un, dt


def step(cfg: MHDConfig, s: MHDState, wavespeed_reduce=None,
         face_masks=None, dxdy=None) -> MHDState:
    """One step; the hooks as in step_core (defaults: the dense
    single-device step)."""
    Un, dt = step_core(cfg, s.U, face_masks=face_masks, dxdy=dxdy,
                       wavespeed_reduce=wavespeed_reduce)
    return MHDState(U=Un, t=s.t + dt)


def view_field(cfg: MHDConfig, s: MHDState, mode: int):
    """View scalars rho / p / |B| / |divB| (draw_pixels, tau_mhd.c:178-183)."""
    q = cons_to_prim(s.U, cfg.gamma)
    if mode == 0:
        return div(q.rho - 0.1, 2.2)
    if mode == 1:
        return div(q.p, 2.0)
    if mode == 2:
        return div(torch.hypot(q.Bx, q.By), 1.6)
    d = torch.abs(
        (shift_wrapped(s.U.Bx, 0, 1) - shift_wrapped(s.U.Bx, 0, -1)) * 0.5
        * cfg.nx
        + (shift_wrapped(s.U.By, 1, 0) - shift_wrapped(s.U.By, -1, 0)) * 0.5
        * cfg.ny
    )
    return d * 0.05


def resolve_engine(cfg: MHDConfig, device) -> str:
    """The engine that steps `cfg` on `device`, by core.device.
    resolve_block_engine with the kernel's bound on block_k
    (kernels/mhd_cuda.py MAX_BLOCK_K)."""
    from ..kernels.mhd_cuda import MAX_BLOCK_K

    return resolve_block_engine(cfg.engine, device, cfg.block_k, MAX_BLOCK_K)


def run(cfg: MHDConfig, s: MHDState, n_steps: int) -> MHDState:
    """`n_steps` steps on the engine `resolve_engine` picks for the state's
    device."""
    if resolve_engine(cfg, s.t.device) == "cuda":
        from ..kernels.mhd_cuda import run_kernels

        return run_kernels(cfg, s, n_steps)
    return run_steps(lambda st: step(cfg, st), s, n_steps)
