"""2-D shallow water in log-depth (sigma = ln h) on the τ clock (port of
fluidsims_tpu.solvers.shallow_water).

Behavioral spec: tau_shallow_water.cu — state (sigma, u, v) with positivity
by construction (:2-12); periodic domain; first-order HLL fluxes per axis
(hll_x :327-358, hll_y :360-392); conservative update with depth floor then
map back to logs (update_kernel :474-513); optional explicit viscosity on
u,v (viscosity_uv :516-547); swirl + dipole-modulated Gaussian bump init
(initialize_host :238-276); τ clock dt_eff = min(t*dtau, CFL*min(dx,dy)/cmax)
then tau += dtau, t *= e^dtau (:673-692, :719-720).

The Coriolis parameter f0 is carried in the config for CLI/HUD parity but —
exactly as in the reference — never enters the dynamics (f0 appears only in
the HUD printout, tau_shallow_water.cu:578-580).

Engines (`resolve_engine`): 'cuda' — the hand-written K-step kernel
(kernels/shallow_water_cuda.py), `n // block_k` launches of block_k steps
then `n % block_k` of one step; the default on a CUDA device.  'torch' —
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
from ..ops.scalar import rdiv
from ..ops.shift import shift_wrapped

__all__ = ["H_EPS", "ShallowWaterConfig", "ShallowWaterState", "init",
           "step", "step_fields", "run", "depth", "resolve_engine"]

H_EPS = 1e-6  # depth positivity floor (update_kernel :509)


@dataclass(frozen=True)
class ShallowWaterConfig(BaseConfig):
    nx: int = 512
    ny: int = 512
    dx: float = 1.0
    dy: float = 1.0
    g: float = 9.81
    f0: float = 1.0          # parsed + displayed, not applied (see module doc)
    nu: float = 0.001
    H0: float = 1000.0
    bump_amp: float = 1.0
    bump_sigma: float = 1.0
    cfl: float = 0.5
    offx: float = 100.0
    offy: float = 100.0
    asym: float = 10.0
    swirl: float = 1.0
    swirl_rc: float = 100.0
    tau0: float = 0.0
    t0: float = 1.0
    dtau: float = 1.0
    dtype: str = "float32"
    engine: str = "auto"     # auto | torch | cuda (K steps a launch)
    block_k: int = 8         # steps per kernel launch (cuda)

    def validate(self):
        self._require(self.nx > 0 and self.ny > 0, "grid dims must be positive")
        self._require(self.g > 0, "g must be > 0")
        self._require(self.H0 > 0, "H0 must be > 0")
        self._require(self.cfl > 0, "CFL must be > 0")
        self._require(self.engine in ("auto", "torch", "cuda"),
                      "engine must be auto, torch or cuda")
        self._require(self.block_k >= 1, "block_k must be >= 1")


class ShallowWaterState(NamedTuple):
    sigma: torch.Tensor  # ln h, (ny, nx)
    u: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor
    tau: torch.Tensor


def depth(s: ShallowWaterState):
    return torch.exp(s.sigma)


def init(cfg: ShallowWaterConfig, device=None) -> ShallowWaterState:
    """The JAX module's initial state, drawn with the same numpy code.
    `device=None` means the GPU (raises where there is none)."""
    if device is None:
        device = resolve_device("cuda")
    nx, ny = cfg.nx, cfg.ny
    cx = 0.5 * nx + cfg.offx
    cy = 0.5 * ny + cfg.offy
    i = np.arange(nx)[None, :]
    j = np.arange(ny)[:, None]
    dxc = i - cx
    dyc = j - cy
    r2 = (dxc * dxc + dyc * dyc) / (cfg.bump_sigma**2)
    theta = np.arctan2(dyc, dxc)
    mod = 1.0 + cfg.asym * np.cos(theta)
    h = cfg.H0 + cfg.bump_amp * mod * np.exp(-0.5 * r2)
    sigma = np.log(np.maximum(h, 1e-6))

    rx = dxc * cfg.dx
    ry = dyc * cfg.dy
    r = np.sqrt(rx * rx + ry * ry)
    rc = cfg.swirl_rc * min(cfg.dx, cfg.dy)
    u_theta = np.where(
        (r > 0.0) & (cfg.swirl != 0.0),
        cfg.swirl * r * np.exp(-0.5 * (r / rc) ** 2),
        0.0,
    )
    rsafe = np.maximum(r, 1e-30)
    u = np.where(r > 0.0, -u_theta * ry / rsafe, 0.0)
    v = np.where(r > 0.0, u_theta * rx / rsafe, 0.0)

    dt = cfg.torch_dtype
    return ShallowWaterState(
        sigma=torch.tensor(sigma, dtype=dt, device=device),
        u=torch.tensor(u, dtype=dt, device=device),
        v=torch.tensor(v, dtype=dt, device=device),
        t=torch.tensor(cfg.t0, dtype=dt, device=device),
        tau=torch.tensor(cfg.tau0, dtype=dt, device=device),
    )


def _hll(hL, uL, vL, hR, uR, vR, g, axis):
    """HLL flux for (h, hu, hv) along one axis (tau_shallow_water.cu:327-392).
    Returns (F_h, F_mx, F_my)."""
    nL = uL if axis == 0 else vL
    nR = uR if axis == 0 else vR
    cL = torch.sqrt(g * hL)
    cR = torch.sqrt(g * hR)
    sL = torch.minimum(nL - cL, nR - cR)
    sR = torch.maximum(nL + cL, nR + cR)

    mL, mR = hL * uL, hR * uR
    nLh, nRh = hL * vL, hR * vR
    if axis == 0:
        FL = (mL, mL * uL + 0.5 * g * hL * hL, mL * vL)
        FR = (mR, mR * uR + 0.5 * g * hR * hR, mR * vR)
    else:
        FL = (nLh, mL * vL, nLh * vL + 0.5 * g * hL * hL)
        FR = (nRh, mR * vR, nRh * vR + 0.5 * g * hR * hR)
    UL = (hL, mL, nLh)
    UR = (hR, mR, nRh)

    inv = rdiv(1.0, sR - sL)
    out = []
    for fl, fr, ul, ur in zip(FL, FR, UL, UR):
        mid = (sR * fl - sL * fr + sR * sL * (ur - ul)) * inv
        out.append(torch.where(sL >= 0.0, fl, torch.where(sR <= 0.0, fr, mid)))
    return tuple(out)


def step_fields(cfg: ShallowWaterConfig, sigma, u, v, t, shift=shift_wrapped,
                wavespeed_reduce=None):
    """One step on the raw (sigma, u, v) fields; returns (sigma2, u2, v2).

    `shift` is the periodic 2-D shift primitive; `wavespeed_reduce` (an
    all-reduce MAX over ranks) extends the CFL max across devices for a
    sharded runner."""
    h = torch.exp(sigma)
    c = torch.sqrt(cfg.g * h)
    cmax = torch.max(torch.maximum(torch.abs(u) + c, torch.abs(v) + c))
    if wavespeed_reduce is not None:
        cmax = wavespeed_reduce(cmax)
    cmax = torch.clamp_min(cmax, 1e-12)
    dt = torch.minimum(t * cfg.dtau,
                       rdiv(cfg.cfl * min(cfg.dx, cfg.dy), cmax))

    # x faces between i and i+1 (stored at i)
    hR = shift(h, 0, 1)
    uR = shift(u, 0, 1)
    vR = shift(v, 0, 1)
    Fh, Fmx, Fmy = _hll(h, u, v, hR, uR, vR, cfg.g, axis=0)

    hT = shift(h, 1, 0)
    uT = shift(u, 1, 0)
    vT = shift(v, 1, 0)
    Gh, Gmx, Gmy = _hll(h, u, v, hT, uT, vT, cfg.g, axis=1)

    inv_dx, inv_dy = 1.0 / cfg.dx, 1.0 / cfg.dy
    mx = h * u
    my = h * v
    h2 = h - dt * ((Fh - shift(Fh, 0, -1)) * inv_dx
                   + (Gh - shift(Gh, -1, 0)) * inv_dy)
    mx2 = mx - dt * ((Fmx - shift(Fmx, 0, -1)) * inv_dx
                     + (Gmx - shift(Gmx, -1, 0)) * inv_dy)
    my2 = my - dt * ((Fmy - shift(Fmy, 0, -1)) * inv_dx
                     + (Gmy - shift(Gmy, -1, 0)) * inv_dy)

    h2 = torch.clamp_min(h2, H_EPS)
    u2 = mx2 / h2
    v2 = my2 / h2

    if cfg.nu > 0.0:
        inv_dx2 = inv_dx * inv_dx
        inv_dy2 = inv_dy * inv_dy

        def lap(f):
            return (
                (shift(f, 0, 1) - 2 * f + shift(f, 0, -1)) * inv_dx2
                + (shift(f, 1, 0) - 2 * f + shift(f, -1, 0)) * inv_dy2
            )

        u2 = u2 + cfg.nu * dt * lap(u2)
        v2 = v2 + cfg.nu * dt * lap(v2)

    return torch.log(h2), u2, v2


def step(cfg: ShallowWaterConfig, s: ShallowWaterState,
         wavespeed_reduce=None) -> ShallowWaterState:
    sigma2, u2, v2 = step_fields(cfg, s.sigma, s.u, s.v, s.t,
                                 wavespeed_reduce=wavespeed_reduce)
    return ShallowWaterState(
        sigma=sigma2,
        u=u2,
        v=v2,
        t=s.t * torch.exp(torch.full((), cfg.dtau, dtype=s.t.dtype,
                                     device=s.t.device)),
        tau=s.tau + cfg.dtau,
    )


def resolve_engine(cfg: ShallowWaterConfig, device) -> str:
    """The engine that steps `cfg` on `device`, by core.device.
    resolve_block_engine with the kernel's bound on block_k
    (kernels/shallow_water_cuda.py MAX_BLOCK_K)."""
    from ..kernels.shallow_water_cuda import MAX_BLOCK_K

    return resolve_block_engine(cfg.engine, device, cfg.block_k, MAX_BLOCK_K)


def run(cfg: ShallowWaterConfig, s: ShallowWaterState, n_steps: int):
    """`n_steps` steps on the engine `resolve_engine` picks for the state's
    device."""
    if resolve_engine(cfg, s.sigma.device) == "cuda":
        from ..kernels.shallow_water_cuda import run_kernels

        return run_kernels(cfg, s, n_steps)
    return run_steps(lambda st: step(cfg, st), s, n_steps)
