"""2-D viscous Burgers in asinh log-velocity state, on the τ clock (port of
fluidsims_tpu.solvers.burgers).

Behavioral spec: tau_burgers.cu — state stores phi = asinh(u/u0) so velocity
magnitude is log-compressed (:12); periodic domain; Rusanov (local
Lax–Friedrichs) face fluxes with optional MUSCL/minmod reconstruction
(flux_x_kernel :364-408, flux_y_kernel :411-455); convective update in real
velocity then re-encode (:458-487); K explicit viscosity substeps
(:490-525, :711-717); τ clock t=t0*e^tau with dt_eff=min(t*dtau, CFL/smax)
(:688-692) and post-step tau+=dtau, t*=e^dtau (:756-757, :801-802);
Cole–Hopf 1-D analytic validation (:256-273, :720-736).

The codec is the native torch.sinh / torch.asinh, as on JAX's XLA path
(the TPU kernel's tanh/log1p substitutes are a Mosaic workaround).  Every
quotient with a Python-number operand is one true division (ops.scalar).

Engines (`resolve_engine`):

* 'cuda' — the hand-written K-step kernel (kernels/burgers_cuda.py):
  `n // block_k` launches of block_k steps, then `n % block_k` launches
  of one step.  The default on a CUDA device.
* 'torch' — `step` below, the XLA dataflow of the JAX module written in
  PyTorch.  The default on the CPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import BaseConfig
from ..core.device import resolve_block_engine, resolve_device
from ..core.stepper import run_steps
from ..ops.limiters import minmod
from ..ops.scalar import div, rdiv
from ..ops.shift import shift_wrapped

__all__ = ["BurgersConfig", "BurgersState", "init", "step", "step_fields",
           "resolve_engine", "run", "velocities", "cole_hopf_exact",
           "cole_hopf_rel_l2"]


@dataclass(frozen=True)
class BurgersConfig(BaseConfig):
    nx: int = 512
    ny: int = 512
    dx: float = 1.0
    dy: float = 1.0
    nu: float = 0.1
    u0: float = 1.0
    # initial swirl + gaussian field
    amp: float = 1.0
    bsig: float = 16.0
    swirl: float = 10.0
    rc: float = 40.0
    offx: float = 0.0
    offy: float = 0.0
    asym: float = 0.0
    # time
    cfl: float = 0.45
    tau0: float = 0.0
    t0: float = 1.0
    dtau: float = 1.0
    # toggles
    muscl: bool = False
    visc_substeps: int = 1
    # Cole-Hopf 1-D validation mode
    colehopf: bool = False
    ck: int = 4
    ca: float = 0.5
    dtype: str = "float32"
    engine: str = "auto"     # auto | torch | cuda (K steps a launch)
    block_k: int = 16        # steps per kernel launch (cuda)

    def validate(self):
        self._require(self.nx > 0 and self.ny > 0, "grid dims must be positive")
        self._require(self.u0 != 0.0, "u0 must be nonzero")
        self._require(self.cfl > 0.0, "CFL must be > 0")
        self._require(self.visc_substeps >= 1, "visc_substeps must be >= 1")
        self._require(self.engine in ("auto", "torch", "cuda"),
                      "engine must be auto, torch or cuda")
        self._require(self.block_k >= 1, "block_k must be >= 1")
        if self.colehopf:
            self._require(abs(self.ca) < 1.0, "Cole-Hopf amplitude |ca| must be < 1")


class BurgersState(NamedTuple):
    phi_u: torch.Tensor  # asinh(u/u0), (ny, nx)
    phi_v: torch.Tensor
    t: torch.Tensor      # physical time (t0 * e^tau)
    tau: torch.Tensor    # log time


def _encode(cfg, u):
    return torch.asinh(div(u, cfg.u0))


def _decode(cfg, phi):
    return cfg.u0 * torch.sinh(phi)


def velocities(cfg: BurgersConfig, s: BurgersState):
    return _decode(cfg, s.phi_u), _decode(cfg, s.phi_v)


def cole_hopf_exact(cfg: BurgersConfig, t: float) -> np.ndarray:
    """Exact 1-D solution u(x,t) = 2 nu a k e^{-nu k^2 t} sin(kx) /
    (1 + a e^{-nu k^2 t} cos(kx)) (tau_burgers.cu:16-19)."""
    Lx = cfg.dx * cfg.nx
    k = 2.0 * math.pi * cfg.ck / Lx
    x = (np.arange(cfg.nx) + 0.5) * cfg.dx
    decay = math.exp(-cfg.nu * k * k * t)
    return (2.0 * cfg.nu * cfg.ca * k * decay * np.sin(k * x)) / (
        1.0 + cfg.ca * decay * np.cos(k * x)
    )


def cole_hopf_rel_l2(cfg: BurgersConfig, s: BurgersState) -> float:
    """Relative L2 error vs the exact solution (tau_burgers.cu:720-736)."""
    u = _decode(cfg, s.phi_u).detach().cpu().numpy()[0]
    u_ex = cole_hopf_exact(cfg, float(s.t))
    den = float((u_ex**2).sum())
    num = float(((u - u_ex) ** 2).sum())
    return math.sqrt(num / den) if den > 0 else math.sqrt(num)


def init(cfg: BurgersConfig, device=None) -> BurgersState:
    """The JAX module's initial field, drawn with the same numpy code.
    `device=None` means the GPU (raises where there is none)."""
    if device is None:
        device = resolve_device("cuda")
    nx, ny = cfg.nx, cfg.ny
    if cfg.colehopf:
        # 1-D exact-driven init on a ny-row strip (reference forces ny=1).
        u_row = cole_hopf_exact(cfg, 0.0)
        u = np.broadcast_to(u_row, (ny, nx)).astype(np.float64)
        v = np.zeros((ny, nx))
    else:
        cx = 0.5 * nx + cfg.offx
        cy = 0.5 * ny + cfg.offy
        i = np.arange(nx)[None, :]
        j = np.arange(ny)[:, None]
        dxc = i - cx
        dyc = j - cy
        r2 = (dxc * dxc + dyc * dyc) / max(cfg.bsig**2, 1e-6)
        theta = np.arctan2(dyc, dxc)
        mod = 1.0 + cfg.asym * np.cos(theta)

        rx = dxc * cfg.dx
        ry = dyc * cfg.dy
        r = np.sqrt(rx * rx + ry * ry)
        rc = cfg.rc * min(cfg.dx, cfg.dy)
        with np.errstate(invalid="ignore", divide="ignore"):
            u_theta = np.where(
                r > 0.0, cfg.swirl * r * np.exp(-0.5 * (r / rc) ** 2), 0.0
            )
            u = np.where(r > 0.0, -u_theta * ry / np.maximum(r, 1e-30), 0.0)
            v = np.where(r > 0.0, u_theta * rx / np.maximum(r, 1e-30), 0.0)
        g = cfg.amp * mod * np.exp(-0.5 * r2)
        u = u + 0.5 * g
        v = v - 0.5 * g

    phi_u = np.arcsinh(u / cfg.u0)
    phi_v = np.arcsinh(v / cfg.u0)
    dt = cfg.torch_dtype
    return BurgersState(
        phi_u=torch.tensor(phi_u, dtype=dt, device=device),
        phi_v=torch.tensor(phi_v, dtype=dt, device=device),
        t=torch.tensor(cfg.t0, dtype=dt, device=device),
        tau=torch.tensor(cfg.tau0, dtype=dt, device=device),
    )


def _muscl_faces(q, axis: int, shift=shift_wrapped):
    """Face states (left cell's right face, right cell's left face) with
    minmod slope limiting on phi (tau_burgers.cu:379-395)."""
    qp = shift(q, 0, 1) if axis == 0 else shift(q, 1, 0)
    qm = shift(q, 0, -1) if axis == 0 else shift(q, -1, 0)
    qpp = shift(q, 0, 2) if axis == 0 else shift(q, 2, 0)

    sL = 0.5 * minmod(q - qm, qp - q)
    sR = 0.5 * minmod(qpp - qp, qp - q)
    return q + sL, qp - sR


def _rusanov_faces(cfg, phi_u, phi_v, u, v, axis: int, shift=shift_wrapped):
    """Rusanov (LLF) face fluxes for both components along one axis.

    `u`/`v` are the step's decoded velocities: without MUSCL the faces
    reuse them (shift(sinh(phi)) == sinh(shift(phi)) bitwise); the MUSCL
    path reconstructs on phi and decodes the reconstructed faces
    (tau_burgers.cu:379-395)."""
    if cfg.muscl:
        pUL, pUR = _muscl_faces(phi_u, axis, shift)
        pVL, pVR = _muscl_faces(phi_v, axis, shift)
        uL, vL = _decode(cfg, pUL), _decode(cfg, pVL)
        uR, vR = _decode(cfg, pUR), _decode(cfg, pVR)
    else:
        uL, vL = u, v
        uR = shift(u, 0, 1) if axis == 0 else shift(u, 1, 0)
        vR = shift(v, 0, 1) if axis == 0 else shift(v, 1, 0)

    if axis == 0:
        FL_u, FL_v = 0.5 * uL * uL, uL * vL
        FR_u, FR_v = 0.5 * uR * uR, uR * vR
        a = torch.maximum(torch.abs(uL), torch.abs(uR))
        F_u = 0.5 * (FL_u + FR_u) - 0.5 * a * (uR - uL)
        F_v = 0.5 * (FL_v + FR_v) - 0.5 * a * (vR - vL)
    else:
        GL_u, GL_v = uL * vL, 0.5 * vL * vL
        GR_u, GR_v = uR * vR, 0.5 * vR * vR
        a = torch.maximum(torch.abs(vL), torch.abs(vR))
        F_u = 0.5 * (GL_u + GR_u) - 0.5 * a * (uR - uL)
        F_v = 0.5 * (GL_v + GR_v) - 0.5 * a * (vR - vL)
    return F_u, F_v


def step_fields(cfg: BurgersConfig, phi_u, phi_v, t, shift=shift_wrapped,
                wavespeed_reduce=None):
    """One τ-clock step on the raw (phi_u, phi_v) fields; returns
    (phi_u2, phi_v2) (tau_burgers.cu do_step :677-718).

    `shift` is the periodic 2-D shift primitive; `wavespeed_reduce` (an
    all-reduce MAX over ranks) extends the CFL max across devices for a
    sharded runner."""
    one_d = cfg.colehopf
    # the ONE decode of the step: faces reuse u0/v0 (see _rusanov_faces)
    u0 = _decode(cfg, phi_u)
    v0 = _decode(cfg, phi_v)
    u, v = u0, v0

    inv_dy = 0.0 if (one_d or cfg.ny <= 1) else 1.0 / cfg.dy
    smax = torch.max(div(torch.abs(u), cfg.dx) + torch.abs(v) * inv_dy)
    if wavespeed_reduce is not None:
        smax = wavespeed_reduce(smax)
    smax = torch.clamp_min(smax, 1e-12)
    dt = torch.minimum(t * cfg.dtau, rdiv(cfg.cfl, smax))

    Fu_x, Fv_x = _rusanov_faces(cfg, phi_u, phi_v, u0, v0, axis=0,
                                shift=shift)
    dFx_u = Fu_x - shift(Fu_x, 0, -1)
    dFx_v = Fv_x - shift(Fv_x, 0, -1)
    u = u - div(dt * dFx_u, cfg.dx)
    v = v - div(dt * dFx_v, cfg.dx)

    if not one_d:
        Gu_y, Gv_y = _rusanov_faces(cfg, phi_u, phi_v, u0, v0, axis=1,
                                    shift=shift)
        dGy_u = Gu_y - shift(Gu_y, -1, 0)
        dGy_v = Gv_y - shift(Gv_y, -1, 0)
        u = u - div(dt * dGy_u, cfg.dy)
        v = v - div(dt * dGy_v, cfg.dy)

    # Viscosity substeps (tau_burgers.cu:490-525, :711-717). The reference
    # re-encodes phi between substeps; sinh(asinh(x)) is the identity, so we
    # stay in real velocity across substeps and encode once at the end.
    inv_dx2 = 1.0 / (cfg.dx * cfg.dx)
    inv_dy2 = 0.0 if one_d else 1.0 / (cfg.dy * cfg.dy)
    sub = div(dt, cfg.visc_substeps)
    for _ in range(cfg.visc_substeps):
        lap_u = (
            (shift(u, 0, 1) - 2 * u + shift(u, 0, -1)) * inv_dx2
            + (shift(u, 1, 0) - 2 * u + shift(u, -1, 0)) * inv_dy2
        )
        lap_v = (
            (shift(v, 0, 1) - 2 * v + shift(v, 0, -1)) * inv_dx2
            + (shift(v, 1, 0) - 2 * v + shift(v, -1, 0)) * inv_dy2
        )
        u = u + cfg.nu * sub * lap_u
        v = v + cfg.nu * sub * lap_v

    return _encode(cfg, u), _encode(cfg, v)


def step(cfg: BurgersConfig, s: BurgersState,
         wavespeed_reduce=None) -> BurgersState:
    phi_u2, phi_v2 = step_fields(cfg, s.phi_u, s.phi_v, s.t,
                                 wavespeed_reduce=wavespeed_reduce)
    return BurgersState(
        phi_u=phi_u2,
        phi_v=phi_v2,
        t=s.t * torch.exp(torch.full((), cfg.dtau, dtype=s.t.dtype,
                                     device=s.t.device)),
        tau=s.tau + cfg.dtau,
    )


def resolve_engine(cfg: BurgersConfig, device) -> str:
    """The engine that steps `cfg` on `device`, by core.device.
    resolve_block_engine with the kernel's bound on block_k
    (kernels/burgers_cuda.py MAX_BLOCK_K)."""
    from ..kernels.burgers_cuda import MAX_BLOCK_K

    return resolve_block_engine(cfg.engine, device, cfg.block_k, MAX_BLOCK_K)


def run(cfg: BurgersConfig, s: BurgersState, n_steps: int) -> BurgersState:
    """`n_steps` steps on the engine `resolve_engine` picks for the state's
    device."""
    if resolve_engine(cfg, s.phi_u.device) == "cuda":
        from ..kernels.burgers_cuda import run_kernels

        return run_kernels(cfg, s, n_steps)
    return run_steps(lambda st: step(cfg, st), s, n_steps)
