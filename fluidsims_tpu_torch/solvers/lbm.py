"""D2Q9 BGK lattice Boltzmann with fused collide+stream and on-link
bounce-back (port of fluidsims_tpu.solvers.lbm).

Behavioral spec: tau_lbm.cu — lattice tables (:56-61), BGK equilibrium
(feq :68-72), channel walls + optional cylinder obstacle (init_kernel
:74-92), fused collide+stream with on-link bounce-back and a body-force-like
x drive (collide_stream_kernel :94-132), speed render (:134-155), MLUPS
metric (:291-294).

`step` is the JAX module's PULL formulation of the reference's push: each
fluid cell's slot q receives the post-collision q-packet of the upstream
cell (i - e_q), or its own opp(q) packet when the upstream link is a wall
or leaves the grid in y (on-link bounce-back); solid cells reflect all
packets in place.  x is periodic, y is bounded: rows outside [0, ny) are
out of bounds whatever the solid map says.

The moments are summed in one explicit order, the TPU kernels' (rho =
f0 + f1 + ... + f8; ux, uy from the nonzero lattice weights in q order):
the CUDA kernels (kernels/lbm_cuda.py) keep it, and so give the same bits.

Engines (`resolve_engine`): 'cuda' — `n // block_k` launches of the K-step
kernel (a tile stepped block_k times in shared memory), then `n % block_k`
of the one-step kernel; block_k=1: the one-step kernel every step.  The
default on a CUDA device.  'torch' — `step` below; the default on the CPU.
`drive` overrides reach the kernels as an argument, never a rebuild.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import BaseConfig
from ..core.device import resolve_block_engine, resolve_device
from ..core.stepper import run_steps
from ..ops.shift import shift_axis_wrapped

__all__ = ["LBMConfig", "LBMState", "EX", "EY", "OPP", "W", "feq",
           "build_solid", "init", "step", "run", "macroscopic", "speed_field",
           "resolve_engine"]

# D2Q9 lattice: rest, +x, +y, -x, -y, then diagonals (tau_lbm.cu:56-61).
EX = np.array([0, 1, 0, -1, 0, 1, -1, -1, 1])
EY = np.array([0, 0, 1, 0, -1, 1, 1, -1, -1])
OPP = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6])
W = np.array(
    [4 / 9, 1 / 9, 1 / 9, 1 / 9, 1 / 9, 1 / 36, 1 / 36, 1 / 36, 1 / 36],
    dtype=np.float64,
)


@dataclass(frozen=True)
class LBMConfig(BaseConfig):
    nx: int = 512
    ny: int = 256
    tau: float = 0.56         # viscosity = cs^2 (tau - 1/2)
    drive: float = 1.0e-6
    rho0: float = 1.0
    obstacle: bool = True
    obstacle_radius: float = 32.0
    dtype: str = "float32"
    engine: str = "auto"      # auto | torch | cuda (K-step temporal blocking)
    block_k: int = 8          # fused steps per round trip (cuda)

    def validate(self):
        self._require(self.nx >= 16 and self.ny >= 16, "grid must be >= 16^2")
        self._require(self.tau >= 0.501, "tau must be > 0.5 for stability")
        self._require(self.engine in ("auto", "torch", "cuda"),
                      "engine must be auto, torch or cuda")
        self._require(self.block_k >= 1, "block_k must be >= 1")


class LBMState(NamedTuple):
    f: torch.Tensor       # (9, ny, nx)
    solid: torch.Tensor   # bool (ny, nx)


def feq(q: int, rho, ux, uy):
    """BGK second-order equilibrium (tau_lbm.cu:68-72), on numpy arrays or
    tensors."""
    cu = 3.0 * (float(EX[q]) * ux + float(EY[q]) * uy)
    u2 = ux * ux + uy * uy
    return float(W[q]) * rho * (1.0 + cu + 0.5 * cu * cu - 1.5 * u2)


def build_solid(cfg: LBMConfig) -> np.ndarray:
    """Channel walls at j=0, ny-1 plus optional cylinder at (0.28 nx, ny/2)."""
    j = np.arange(cfg.ny)[:, None]
    i = np.arange(cfg.nx)[None, :]
    wall = (j == 0) | (j == cfg.ny - 1)
    cx, cy = 0.28 * cfg.nx, 0.5 * cfg.ny
    cyl = cfg.obstacle & (
        (i - cx) ** 2 + (j - cy) ** 2 < cfg.obstacle_radius**2
    )
    return np.broadcast_to(wall | cyl, (cfg.ny, cfg.nx)).copy()


def init(cfg: LBMConfig, device=None) -> LBMState:
    """Equilibrium init with a sinusoidal shear profile (tau_lbm.cu:88-92),
    formed in float64 numpy as the JAX module forms it.  `device=None`
    means the GPU (raises where there is none)."""
    if device is None:
        device = resolve_device("cuda")
    solid = build_solid(cfg)
    j = np.arange(cfg.ny)[:, None]
    shear = 0.015 * np.sin(
        2.0 * np.pi * j / (cfg.ny - 1 if cfg.ny > 1 else 1)
    )
    ux = np.broadcast_to(shear, (cfg.ny, cfg.nx))
    uy = np.zeros((cfg.ny, cfg.nx))
    f = np.stack([feq(q, cfg.rho0, ux, uy) for q in range(9)])
    return LBMState(f=torch.tensor(f, dtype=cfg.torch_dtype, device=device),
                    solid=torch.tensor(solid, device=device))


def macroscopic(f):
    """(rho, ux, uy) moments; rho floored at 1e-6 (tau_lbm.cu:113-119).
    Summed in the order of the TPU kernels (lbm_pallas.py:189-192), which
    the CUDA kernels keep."""
    rho = f[0] + f[1] + f[2] + f[3] + f[4] + f[5] + f[6] + f[7] + f[8]
    rho = torch.clamp(rho, min=1e-6)
    ux = f[1] - f[3] + f[5] - f[6] - f[7] + f[8]
    uy = f[2] - f[4] + f[5] + f[6] - f[7] - f[8]
    return rho, ux / rho, uy / rho


def _oob_rows(ny: int, eyq: int, device) -> torch.Tensor:
    """(ny, 1) bool: rows whose upstream row y - eyq lies outside [0, ny)."""
    y = torch.arange(ny, device=device)[:, None]
    return (y - eyq < 0) | (y - eyq >= ny)


def step(cfg: LBMConfig, s: LBMState, drive=None) -> LBMState:
    """Fused collide + stream, pull formulation (see module docstring).
    `drive` overrides cfg.drive: a Python number or a 0-d tensor."""
    f, solid = s.f, s.solid
    rho, ux, uy = macroscopic(f)
    ux = ux + (cfg.drive if drive is None else drive)
    omega = 1.0 / cfg.tau

    post = [f[q] - omega * (f[q] - feq(q, rho, ux, uy)) for q in range(9)]

    out = []
    for q in range(9):
        exq, eyq = int(EX[q]), int(EY[q])
        # upstream source cell: (i - ex, j - ey), x periodic, y bounded
        src_post = shift_axis_wrapped(post[q], -exq, axis=1)
        src_post = shift_axis_wrapped(src_post, -eyq, axis=0)
        src_solid = shift_axis_wrapped(solid, -eyq, axis=0)
        src_solid = shift_axis_wrapped(src_solid, -exq, axis=1)
        src_invalid = src_solid | _oob_rows(cfg.ny, eyq, f.device)

        streamed = torch.where(src_invalid, post[int(OPP[q])], src_post)
        # solid cells reflect every packet in place (tau_lbm.cu:108-111)
        out.append(torch.where(solid, f[int(OPP[q])], streamed))

    return LBMState(f=torch.stack(out), solid=solid)


def speed_field(cfg: LBMConfig, s: LBMState):
    """|u| per cell, -1 on solids (render_kernel, tau_lbm.cu:134-155)."""
    _, ux, uy = macroscopic(s.f)
    sp = torch.sqrt(ux * ux + uy * uy)
    return torch.where(s.solid, torch.full_like(sp, -1.0), sp)


def resolve_engine(cfg: LBMConfig, device) -> str:
    """The engine that steps `cfg` on `device`, by core.device.
    resolve_block_engine with the K-step kernel's bound on block_k
    (kernels/lbm_cuda.py MAX_BLOCK_K)."""
    from ..kernels.lbm_cuda import MAX_BLOCK_K

    return resolve_block_engine(cfg.engine, device, cfg.block_k, MAX_BLOCK_K)


def run(cfg: LBMConfig, s: LBMState, n_steps: int, drive=None) -> LBMState:
    """`n_steps` steps on the engine `resolve_engine` picks for the state's
    device."""
    if resolve_engine(cfg, s.f.device) == "cuda":
        from ..kernels.lbm_cuda import run_kernels

        return run_kernels(cfg, s, n_steps, drive=drive)
    return run_steps(lambda st: step(cfg, st, drive=drive), s, n_steps)
