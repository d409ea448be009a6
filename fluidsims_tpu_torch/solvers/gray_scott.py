"""Gray–Scott two-species reaction–diffusion (port of
fluidsims_tpu.solvers.gray_scott).

Behavioral spec: tau_gray_scott.cu — 5-point periodic Laplacian + reaction
(step_kernel, tau_gray_scott.cu:141-171), seeded center square + 64
xorshift32 random speckles (init_pattern, :173-204), defaults Du=0.2 Dv=0.1
F=0.03 k=0.06 dt=1 dx=1 seed=1337 (:43-61).

Engines (`resolve_engine`):

* 'cuda' — hand-written CUDA kernels (kernels/gray_scott_cuda.py):
  `n // block_k` launches of the K-step kernel, which steps a tile
  block_k times in shared memory per round trip to device memory, then
  `n % block_k` launches of the one-step kernel; with block_k=1 the
  one-step kernel every step.  The default on a CUDA device.
* 'torch' — `step` below, the XLA dataflow of the JAX module written in
  PyTorch.  The default on the CPU.

Both give the same bits: the kernels keep the per-cell operation order of
`step`.  `feed`/`kill` overrides reach the kernels as arguments, so a
nudge never rebuilds anything.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import BaseConfig
from ..core.device import resolve_block_engine, resolve_device
from ..core.stepper import run_steps
from ..ops.shift import shift_wrapped

__all__ = ["GrayScottConfig", "GrayScottState", "init", "step", "run",
           "resolve_engine"]


@dataclass(frozen=True)
class GrayScottConfig(BaseConfig):
    nx: int = 128
    ny: int = 128
    dx: float = 1.0
    dt: float = 1.0
    Du: float = 0.2
    Dv: float = 0.1
    feed: float = 0.03
    kill: float = 0.06
    seed: int = 1337
    dtype: str = "float32"
    engine: str = "auto"     # auto | torch | cuda (K-step temporal blocking)
    block_k: int = 16        # fused steps per round trip (cuda)

    def validate(self):
        self._require(self.nx > 0 and self.ny > 0, "grid dims must be positive")
        self._require(self.dx > 0 and self.dt > 0, "dx, dt must be positive")
        self._require(self.Du >= 0 and self.Dv >= 0, "diffusivities must be >= 0")
        self._require(self.engine in ("auto", "torch", "cuda"),
                      "engine must be auto, torch or cuda")
        self._require(self.block_k >= 1, "block_k must be >= 1")


class GrayScottState(NamedTuple):
    u: torch.Tensor  # (ny, nx)
    v: torch.Tensor


def init(cfg: GrayScottConfig, device=None) -> GrayScottState:
    """Uniform u=1, v=0 with a perturbed center square and 64 speckles,
    drawn in float32 numpy as the JAX module draws them.  `device=None`
    means the GPU (raises where there is none)."""
    if device is None:
        device = resolve_device("cuda")
    nx, ny = cfg.nx, cfg.ny
    u = np.ones((ny, nx), dtype=np.float32)
    v = np.zeros((ny, nx), dtype=np.float32)

    cx, cy = nx // 2, ny // 2
    r = min(nx, ny) // 12
    for j in range(-r, r + 1):
        for i in range(-r, r + 1):
            x = (cx + i + nx) % nx
            y = (cy + j + ny) % ny
            u[y, x] = 0.50
            v[y, x] = 0.25

    # The reference draws x then y from one xorshift32 stream per speckle.
    state = cfg.seed if cfg.seed else 1
    state &= 0xFFFFFFFF

    def rng():
        nonlocal state
        s = state
        s ^= (s << 13) & 0xFFFFFFFF
        s ^= s >> 17
        s ^= (s << 5) & 0xFFFFFFFF
        state = s
        return s

    for _ in range(64):
        x = rng() % nx
        y = rng() % ny
        u[y, x] = 0.35
        v[y, x] = 0.65

    dt = cfg.torch_dtype
    return GrayScottState(u=torch.tensor(u, dtype=dt, device=device),
                          v=torch.tensor(v, dtype=dt, device=device))


def _laplacian_periodic(f, inv_dx2):
    return (
        shift_wrapped(f, 0, 1)
        + shift_wrapped(f, 0, -1)
        + shift_wrapped(f, 1, 0)
        + shift_wrapped(f, -1, 0)
        - 4.0 * f
    ) * inv_dx2


def step(cfg: GrayScottConfig, s: GrayScottState,
         feed=None, kill=None) -> GrayScottState:
    """One forward-Euler reaction-diffusion update (tau_gray_scott.cu:141-171).
    `feed`/`kill` override cfg: Python numbers, whose sum `feed + kill` is
    formed in double, or 0-d tensors, summed in their own dtype."""
    feed = cfg.feed if feed is None else feed
    kill = cfg.kill if kill is None else kill
    inv_dx2 = 1.0 / (cfg.dx * cfg.dx)
    lap_u = _laplacian_periodic(s.u, inv_dx2)
    lap_v = _laplacian_periodic(s.v, inv_dx2)
    uvv = s.u * s.v * s.v
    du = cfg.Du * lap_u - uvv + feed * (1.0 - s.u)
    dv = cfg.Dv * lap_v + uvv - (feed + kill) * s.v
    return GrayScottState(u=s.u + cfg.dt * du, v=s.v + cfg.dt * dv)


def resolve_engine(cfg: GrayScottConfig, device) -> str:
    """The engine that steps `cfg` on `device`, by core.device.
    resolve_block_engine with the K-step kernel's bound on block_k
    (kernels/gray_scott_cuda.py MAX_BLOCK_K)."""
    from ..kernels.gray_scott_cuda import MAX_BLOCK_K

    return resolve_block_engine(cfg.engine, device, cfg.block_k, MAX_BLOCK_K)


def run(cfg: GrayScottConfig, s: GrayScottState, n_steps: int,
        feed=None, kill=None) -> GrayScottState:
    """`n_steps` steps on the engine `resolve_engine` picks for the state's
    device."""
    if resolve_engine(cfg, s.u.device) == "cuda":
        from ..kernels.gray_scott_cuda import run_kernels

        return run_kernels(cfg, s, n_steps, feed=feed, kill=kill)
    return run_steps(lambda st: step(cfg, st, feed=feed, kill=kill), s,
                     n_steps)
