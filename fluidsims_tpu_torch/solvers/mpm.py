"""2-D MLS-MPM elastoplastic solver with three materials, mud, snow and sand
(port of fluidsims_tpu.solvers.mpm).

Behavioral spec: tau_mpm.cu — quadratic B-spline weights (:138-147);
neo-Hookean-style stress P F^T = mu(Fe Fe^T - I) + lambda log(J) J I with
plastic hardening exp(h(1-Jp)) and per-material tweaks (k_p2g :123-183:
snow clamps the diagonal of Fe and decays shear, mud weakens shear 0.25x,
sand hardens shear 1.8x / softens lambda 0.75x); grid momentum normalize +
gravity + 3-cell sticky boundary bands (k_grid_update :185-198); G2P affine
C reconstruction, F update F <- (I + dt C) Fe, Jp volume-ratio tracking
clamped to [0.05, 20], position clamp to [2dx, (G-3)dx] (k_g2p :200-257);
jittered block init with shear velocity profile (reset_particles :304-320);
dx = boxX/(Gx-1) (step_mpm :327).

Engines (`resolve_engine`):

* 'cuda' — two hand-written CUDA kernels (kernels/mpm_cuda.py): the P2G,
  and the per-particle G2P that updates each node it gathers (the grid
  update and the G2P in one launch); the 'scatter' semantics, no cell
  capacity, no particle dropped.  The default on a CUDA device; on CPU
  tensors it raises.
* 'scatter' — JAX's exact scatter/gather formulation, split at JAX's own
  section lines into `_p2g` (`index_add_`; a target outside the grid is
  dropped, not clipped), `_grid_update` and `_g2p` (gathered at clipped
  indices, the weight of an out-of-grid target 0).  `_p2g` and
  `_grid_g2p` (`_g2p` of `_grid_update`'s node velocities) are the CUDA
  kernels' plain versions; `_step` composes them.
* 'dense' — `_step_dense`, JAX's cell-dense engine: particles binned into
  (Gy, Gx, K) slots, transfers as dense sums and static shifts; particles
  past a cell's K = `capacity` slots keep their state and are counted by
  `overflow_count`.  The default on the CPU, as JAX's 'auto' is.

JAX's TPU engine 'pallas' is the cell-dense engine in VMEM; its
counterpart here is 'cuda' (interop maps the name).  The 2x2 algebra is
written out component by component in JAX's order, so the G2P kernel can
match `_g2p` bitwise.  Constants that JAX forms from Python numbers
(inv_dx, the stress scale, gravity*dt, the clip bounds) are formed the
same way here and rounded once to the dtype.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import BaseConfig
from ..core.device import resolve_device
from ..core.stepper import run_steps
from ..ops import cell_dense as cd
from ..ops.scalar import div, scalar

__all__ = ["MPMConfig", "MPMState", "MATERIALS", "init", "step", "run",
           "overflow_count", "resolve_engine"]

MATERIALS = {"mud": 0, "snow": 1, "sand": 2}


@dataclass(frozen=True)
class MPMConfig(BaseConfig):
    n: int = 1 << 15
    gx: int = 96
    gy: int = 96
    box_x: float = 1.0
    box_y: float = 1.0
    dt: float = 8.0e-5
    gravity: float = 9.81
    particle_mass: float = 1.0
    volume: float = 1.0
    hardening: float = 10.0
    mu0: float = 18.0
    lambda0: float = 40.0
    critical_compression: float = 2.5e-2
    critical_stretch: float = 7.5e-3
    material: str = "snow"
    seed: int = 2026
    engine: str = "auto"   # auto | cuda | dense | scatter
    bin_capacity: int = 0   # 0 = auto (~16x mean occupancy); dense only
    dtype: str = "float32"

    def validate(self):
        self._require(self.n > 0, "n must be positive")
        self._require(self.gx >= 8 and self.gy >= 8, "grid too small")
        self._require(self.material in MATERIALS, f"material {self.material}")
        self._require(self.engine in ("auto", "cuda", "dense", "scatter"),
                      "engine must be auto, cuda, dense or scatter")

    @property
    def capacity(self) -> int:
        if self.bin_capacity > 0:
            return self.bin_capacity
        mean = self.n / (self.gx * self.gy)
        return max(32, int(np.ceil(16.0 * mean / 8.0)) * 8)

    @property
    def dx(self):
        return self.box_x / (self.gx - 1)


class MPMState(NamedTuple):
    pos: torch.Tensor  # (n, 2)
    vel: torch.Tensor  # (n, 2)
    F: torch.Tensor    # (n, 2, 2) elastic deformation gradient
    Jp: torch.Tensor   # (n,) plastic volume ratio


def init(cfg: MPMConfig, device=None) -> MPMState:
    """Jittered block at [0.22,0.64]x[0.28,0.73] with shear velocity
    (reset_particles, tau_mpm.cu:304-320), drawn in float64 numpy as the
    JAX module draws it.  F is a contiguous identity per particle.
    `device=None` means the GPU (raises where there is none)."""
    if device is None:
        device = resolve_device("cuda")
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n
    nx = int(np.sqrt(n))
    ny = (n + nx - 1) // nx
    i = np.arange(n)
    ix = i % nx
    iy = i // nx
    x = 0.22 + 0.42 * (ix + 0.5) / nx
    y = 0.28 + 0.45 * (iy + 0.5) / ny
    x = x + (rng.random(n) - 0.5) * 0.12 / nx
    y = y + (rng.random(n) - 0.5) * 0.12 / ny
    vel = np.stack([1.0 * (0.5 - y), np.zeros(n)], -1)

    dt = cfg.torch_dtype
    return MPMState(
        pos=torch.tensor(np.stack([x, y], -1), dtype=dt, device=device),
        vel=torch.tensor(vel, dtype=dt, device=device),
        F=torch.eye(2, dtype=dt, device=device).repeat(n, 1, 1),
        Jp=torch.ones(n, dtype=dt, device=device),
    )


def _bspline_w(f):
    """Quadratic B-spline weights for offsets 0,1,2 given fractional f
    (tau_mpm.cu:138-147); each square is one product, as JAX's `** 2`."""
    a, b, c = 1.5 - f, f - 1.0, f - 0.5
    return 0.5 * (a * a), 0.75 - b * b, 0.5 * (c * c)


def _det2(F):
    return F[:, 0, 0] * F[:, 1, 1] - F[:, 0, 1] * F[:, 1, 0]


def _base_frac(cfg, pos):
    """Scaled coordinates' base node (int64, (n, 2)) and fraction ((n, 2)):
    base = floor(pos / dx - 0.5), frac = pos / dx - base, with pos / dx a
    product by inv_dx in the dtype, as JAX forms it."""
    Xp = pos * (1.0 / cfg.dx)
    base = torch.floor(Xp - 0.5)
    return base.to(torch.int64), Xp - base


def _elastic(cfg, F):
    """The elastic part Fe of F (k_p2g :146-156): snow clamps the diagonal
    to [1 - critical_compression, 1 + critical_stretch] and decays the
    shear entries by 0.98; mud and sand keep F."""
    if MATERIALS[cfg.material] != 1:
        return F
    lo = scalar(F, 1.0 - cfg.critical_compression)
    hi = scalar(F, 1.0 + cfg.critical_stretch)
    f00, f01 = F[:, 0, 0], F[:, 0, 1]
    f10, f11 = F[:, 1, 0], F[:, 1, 1]
    return torch.stack([
        torch.stack([torch.clamp(f00, lo, hi), f01 * 0.98], -1),
        torch.stack([f10 * 0.98, torch.clamp(f11, lo, hi)], -1)], 1)


def _plastic_and_stress(cfg, s):
    """Per-particle plasticity clamp + stress (k_p2g :146-165): (Fe,
    stress), each (n, 2, 2), stress = P Fe^T * (-4 inv_dx^2 dt volume)."""
    mat = MATERIALS[cfg.material]
    inv_dx = 1.0 / cfg.dx
    Fe = _elastic(cfg, s.F)
    J = torch.maximum(_det2(Fe), scalar(Fe, 0.2))
    e = torch.exp(cfg.hardening * (1.0 - s.Jp))
    mu = cfg.mu0 * e
    lam = cfg.lambda0 * e
    if mat == 0:
        mu = mu * 0.25
    elif mat == 2:
        mu = mu * 1.8
        lam = lam * 0.75
    f00, f01 = Fe[:, 0, 0], Fe[:, 0, 1]
    f10, f11 = Fe[:, 1, 0], Fe[:, 1, 1]
    llj = lam * torch.log(J) * J
    s01 = mu * (f00 * f10 + f01 * f11)
    c = -4.0 * inv_dx * inv_dx * cfg.dt * cfg.volume
    stress = torch.stack([
        torch.stack([mu * (f00 * f00 + f01 * f01 - 1.0) + llj, s01], -1),
        torch.stack([s01, mu * (f10 * f10 + f11 * f11 - 1.0) + llj], -1)],
        1) * c
    return Fe, stress


def _p2g(cfg, pos, vel, F, Jp):
    """P2G of mass and of momentum plus the stress force (k_p2g :167-182):
    9 `index_add_` scatters into one spare-slot flat grid per field; a
    target outside the grid goes to the spare slot (JAX's mode="drop").
    Returns (mass, mom_x, mom_y), each (Gy, Gx)."""
    Gx, Gy = cfg.gx, cfg.gy
    dx = cfg.dx
    pm = cfg.particle_mass
    base, frac = _base_frac(cfg, pos)
    wx = _bspline_w(frac[:, 0])
    wy = _bspline_w(frac[:, 1])
    _, stress = _plastic_and_stress(cfg, MPMState(pos, vel, F, Jp))
    s00, s01 = stress[:, 0, 0], stress[:, 0, 1]
    s10, s11 = stress[:, 1, 0], stress[:, 1, 1]
    mvx, mvy = pm * vel[:, 0], pm * vel[:, 1]

    mass = torch.zeros(Gx * Gy + 1, dtype=pos.dtype, device=pos.device)
    mom_x = torch.zeros_like(mass)
    mom_y = torch.zeros_like(mass)
    for ox in range(3):
        ix = base[:, 0] + ox
        okx = (ix >= 0) & (ix < Gx)
        dposx = (ox - frac[:, 0]) * dx
        for oy in range(3):
            iy = base[:, 1] + oy
            ok = okx & (iy >= 0) & (iy < Gy)
            w = wx[ox] * wy[oy]
            dposy = (oy - frac[:, 1]) * dx
            fx = s00 * dposx + s01 * dposy
            fy = s10 * dposx + s11 * dposy
            flat = torch.where(ok, iy * Gx + ix, Gx * Gy)
            mass.index_add_(0, flat, w * pm)
            mom_x.index_add_(0, flat, w * (mvx + fx))
            mom_y.index_add_(0, flat, w * (mvy + fy))
    return tuple(g[:Gx * Gy].reshape(Gy, Gx) for g in (mass, mom_x, mom_y))


def _grid_update(cfg, mass, mom_x, mom_y):
    """k_grid_update (:185-198): momentum over mass where mass > 0, gravity
    on v, the 3-node sticky bands (an outward component at a wall band is
    zeroed), 0 where there is no mass.  Returns (gu, gv), each (Gy, Gx)."""
    Gx, Gy = cfg.gx, cfg.gy
    has = mass > 0.0
    floor_mass = torch.maximum(mass, scalar(mass, 1e-30))
    gu = torch.where(has, mom_x / floor_mass, mom_x)
    gv = torch.where(has, mom_y / floor_mass - cfg.gravity * cfg.dt, mom_y)
    xsi = torch.arange(Gx, device=mass.device)[None, :]
    ysi = torch.arange(Gy, device=mass.device)[:, None]
    zero = torch.zeros((), dtype=mass.dtype, device=mass.device)
    gu = torch.where(has & (((xsi < 3) & (gu < 0)) | ((xsi > Gx - 4)
                                                      & (gu > 0))), zero, gu)
    gv = torch.where(has & (((ysi < 3) & (gv < 0)) | ((ysi > Gy - 4)
                                                      & (gv > 0))), zero, gv)
    return torch.where(has, gu, zero), torch.where(has, gv, zero)


def _g2p(cfg, pos, F, Jp, gu, gv):
    """G2P (k_g2p :200-257): velocity and the affine C from the 3x3 nodes
    (an out-of-grid node weighs 0), F <- (I + dt C) Fe with Fe the elastic
    part of F, mud's shear x 0.96, Jp <- clip(Jp oldJ / newJ, 0.05, 20),
    x <- clip(x + dt v, 2dx, (G - 3)dx).  Returns (pos, vel, F, Jp)."""
    Gx, Gy = cfg.gx, cfg.gy
    dx = cfg.dx
    dt = cfg.dt
    c4 = 4.0 * (1.0 / dx)
    base, frac = _base_frac(cfg, pos)
    wx = _bspline_w(frac[:, 0])
    wy = _bspline_w(frac[:, 1])
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    flat_u, flat_v = gu.reshape(-1), gv.reshape(-1)

    nvx = torch.zeros_like(frac[:, 0])
    nvy = torch.zeros_like(nvx)
    C00, C01, C10, C11 = (torch.zeros_like(nvx) for _ in range(4))
    for ox in range(3):
        ix = base[:, 0] + ox
        okx = (ix >= 0) & (ix < Gx)
        dposx = (ox - frac[:, 0]) * dx
        for oy in range(3):
            iy = base[:, 1] + oy
            ok = okx & (iy >= 0) & (iy < Gy)
            w = torch.where(ok, wx[ox] * wy[oy], zero)
            flat = iy.clamp(0, Gy - 1) * Gx + ix.clamp(0, Gx - 1)
            gvx = torch.where(ok, flat_u.index_select(0, flat), zero)
            gvy = torch.where(ok, flat_v.index_select(0, flat), zero)
            dposy = (oy - frac[:, 1]) * dx
            wgx, wgy = w * gvx, w * gvy
            nvx = nvx + wgx
            nvy = nvy + wgy
            C00 = C00 + c4 * (wgx * dposx)
            C01 = C01 + c4 * (wgx * dposy)
            C10 = C10 + c4 * (wgy * dposx)
            C11 = C11 + c4 * (wgy * dposy)

    Fe = _elastic(cfg, F)
    f00, f01 = Fe[:, 0, 0], Fe[:, 0, 1]
    f10, f11 = Fe[:, 1, 0], Fe[:, 1, 1]
    a00, a01 = 1.0 + dt * C00, dt * C01
    a10, a11 = dt * C10, 1.0 + dt * C11
    n00 = a00 * f00 + a01 * f10
    n01 = a00 * f01 + a01 * f11
    n10 = a10 * f00 + a11 * f10
    n11 = a10 * f01 + a11 * f11
    eps = scalar(pos, 1.0e-6)
    oldJ = torch.maximum(f00 * f11 - f01 * f10, eps)
    newJ = torch.maximum(n00 * n11 - n01 * n10, eps)
    if MATERIALS[cfg.material] == 0:  # mud relaxes shear
        n01 = n01 * 0.96
        n10 = n10 * 0.96
    Jp = torch.clamp(Jp * oldJ / newJ, scalar(pos, 0.05), scalar(pos, 20.0))
    lo = scalar(pos, 2.0 * dx)
    x = torch.clamp(pos[:, 0] + dt * nvx, lo, scalar(pos, (Gx - 3.0) * dx))
    y = torch.clamp(pos[:, 1] + dt * nvy, lo, scalar(pos, (Gy - 3.0) * dx))
    newF = torch.stack([torch.stack([n00, n01], -1),
                        torch.stack([n10, n11], -1)], 1)
    return (torch.stack([x, y], -1), torch.stack([nvx, nvy], -1), newF, Jp)


def _grid_g2p(cfg, pos, F, Jp, mass, mom_x, mom_y):
    """The grid update and G2P from the P2G grids: `_g2p` on
    `_grid_update`'s node velocities.  Returns (pos, vel, F, Jp)."""
    return _g2p(cfg, pos, F, Jp, *_grid_update(cfg, mass, mom_x, mom_y))


def _step(cfg, s, p2g, g2p, grid_reduce=None) -> MPMState:
    """One step on the given transfers: `p2g(pos, vel, F, Jp)` and
    `g2p(pos, F, Jp, mass, mom_x, mom_y)`, the grid update and G2P from
    the P2G grids.  `grid_reduce` merges partial P2G grids (the
    multi-device hook) before the G2P reads them.  The state's tensors are
    not written."""
    grids = p2g(s.pos, s.vel, s.F, s.Jp)
    if grid_reduce is not None:
        grids = grid_reduce(grids)
    return MPMState(*g2p(s.pos, s.F, s.Jp, *grids))


def _step_scatter(cfg: MPMConfig, s: MPMState, grid_reduce=None) -> MPMState:
    """The exact engine (JAX's `_step_scatter`, :122-251)."""
    return _step(cfg, s, functools.partial(_p2g, cfg),
                 functools.partial(_grid_g2p, cfg), grid_reduce)


def _cell_index(cfg, base):
    """Flat cell id (int64) of each particle's base node, clipped."""
    bx = torch.clamp(base[:, 0], 0, cfg.gx - 1)
    by = torch.clamp(base[:, 1], 0, cfg.gy - 1)
    return by * cfg.gx + bx


def _dense_grid(cfg) -> cd.DenseGrid:
    return cd.DenseGrid(Gx=cfg.gx, Gy=cfg.gy, cell=cfg.dx, K=cfg.capacity)


def _step_dense(cfg: MPMConfig, s: MPMState, grid_reduce=None) -> MPMState:
    """Cell-dense engine (JAX's `_step_dense`, :288-425): one binning a
    step; P2G = 9 dense sums + grid shifts, G2P = 9 grid broadcasts.  The
    zero-filled shifts drop out-of-grid targets as the reference's bounds
    skip does.  Particles past their cell's K slots keep their previous
    state and stay out of the P2G."""
    n_p = s.pos.shape[0]
    Gx, Gy = cfg.gx, cfg.gy
    dx = cfg.dx
    dt = cfg.dt
    dtype, dev = s.pos.dtype, s.pos.device
    K = cfg.capacity
    M = Gx * Gy

    base, frac = _base_frac(cfg, s.pos)
    Fe, stress = _plastic_and_stress(cfg, s)
    m_v = cfg.particle_mass * s.vel
    cid = _cell_index(cfg, base)
    rank, ok, _ = cd.bin_rank(_dense_grid(cfg), s.pos, cid=cid)
    iota = torch.arange(n_p, dtype=torch.int64, device=dev)
    didx = torch.where(ok, cid * K + rank, M * K + iota)

    # one value scatter for all channels, with a ones channel that becomes
    # the occupancy mask; dropped particles land past the M * K slots
    packed = torch.cat([
        frac,                                    # 0: fx, 1: fy
        m_v,                                     # 2, 3
        stress.reshape(n_p, 4),                  # 4..7 (s00, s01, s10, s11)
        Fe.reshape(n_p, 4),                      # 8..11
        s.Jp[:, None],                           # 12
        s.pos,                                   # 13, 14
        torch.ones((n_p, 1), dtype=dtype, device=dev),   # 15: occupancy
    ], -1)
    d = torch.zeros((M * K + n_p, 16), dtype=dtype, device=dev)
    d.index_copy_(0, didx, packed)
    d = d[:M * K].reshape(Gy, Gx, K, 16)
    occf = d[..., 15]
    dfx, dfy = d[..., 0], d[..., 1]
    wxs = _bspline_w(dfx)
    wys = _bspline_w(dfy)

    # ---- P2G ----
    mass2 = torch.zeros((Gy, Gx), dtype=dtype, device=dev)
    gu = torch.zeros_like(mass2)
    gv = torch.zeros_like(mass2)
    for ox in range(3):
        dposx = (ox - dfx) * dx
        for oy in range(3):
            dposy = (oy - dfy) * dx
            w = wxs[ox] * wys[oy] * occf
            fx = d[..., 4] * dposx + d[..., 5] * dposy
            fy = d[..., 6] * dposx + d[..., 7] * dposy
            mass2 = mass2 + cd.grid_shift(
                torch.sum(w * cfg.particle_mass, -1), -oy, -ox)
            gu = gu + cd.grid_shift(torch.sum(w * (d[..., 2] + fx), -1),
                                    -oy, -ox)
            gv = gv + cd.grid_shift(torch.sum(w * (d[..., 3] + fy), -1),
                                    -oy, -ox)

    if grid_reduce is not None:
        mass2, gu, gv = grid_reduce((mass2, gu, gv))
    gu, gv = _grid_update(cfg, mass2, gu, gv)

    # ---- G2P ----
    c4 = 4.0 * (1.0 / dx)
    nvx = torch.zeros_like(dfx)
    nvy = torch.zeros_like(dfx)
    C00, C01, C10, C11 = (torch.zeros_like(dfx) for _ in range(4))
    for ox in range(3):
        dposx = (ox - dfx) * dx
        for oy in range(3):
            dposy = (oy - dfy) * dx
            w = wxs[ox] * wys[oy] * occf
            gvx = cd.grid_shift(gu, oy, ox)[:, :, None]
            gvy = cd.grid_shift(gv, oy, ox)[:, :, None]
            nvx = nvx + w * gvx
            nvy = nvy + w * gvy
            C00 = C00 + c4 * w * gvx * dposx
            C01 = C01 + c4 * w * gvx * dposy
            C10 = C10 + c4 * w * gvy * dposx
            C11 = C11 + c4 * w * gvy * dposy

    f00, f01, f10, f11 = d[..., 8], d[..., 9], d[..., 10], d[..., 11]
    n00 = (1.0 + dt * C00) * f00 + dt * C01 * f10
    n01 = (1.0 + dt * C00) * f01 + dt * C01 * f11
    n10 = dt * C10 * f00 + (1.0 + dt * C11) * f10
    n11 = dt * C10 * f01 + (1.0 + dt * C11) * f11
    eps = scalar(dfx, 1.0e-6)
    oldJ = torch.maximum(f00 * f11 - f01 * f10, eps)
    newJ = torch.maximum(n00 * n11 - n01 * n10, eps)
    if MATERIALS[cfg.material] == 0:  # mud relaxes shear
        n01 = n01 * 0.96
        n10 = n10 * 0.96
    Jp2 = torch.clamp(d[..., 12] * oldJ / newJ, scalar(dfx, 0.05),
                      scalar(dfx, 20.0))
    lo = scalar(dfx, 2.0 * dx)
    nx_ = torch.clamp(d[..., 13] + dt * nvx, lo, scalar(dfx, (Gx - 3.0) * dx))
    ny_ = torch.clamp(d[..., 14] + dt * nvy, lo, scalar(dfx, (Gy - 3.0) * dx))

    dense_out = torch.stack([nx_, ny_, nvx, nvy, n00, n01, n10, n11, Jp2], -1)
    got = dense_out.reshape(M * K, 9)[torch.clamp(didx, 0, M * K - 1)]
    old = torch.cat([s.pos, s.vel, s.F.reshape(n_p, 4), s.Jp[:, None]], -1)
    out = torch.where(ok[:, None], got, old)
    return MPMState(pos=out[:, 0:2].contiguous(),
                    vel=out[:, 2:4].contiguous(),
                    F=out[:, 4:8].reshape(n_p, 2, 2).contiguous(),
                    Jp=out[:, 8].contiguous())


def resolve_engine(cfg: MPMConfig, device) -> str:
    """The engine that steps `cfg` on `device`: 'auto' gives 'cuda' on a
    CUDA device and 'dense' on the CPU (JAX's 'auto'); 'cuda' on the CPU
    raises; 'dense' and 'scatter' are taken as asked.  Any grid and both
    dtypes run on every engine."""
    if cfg.engine in ("dense", "scatter"):
        return cfg.engine
    if torch.device(device).type != "cuda":
        if cfg.engine == "cuda":
            raise ValueError("engine='cuda' runs the CUDA kernels and needs "
                             f"CUDA tensors, got {device}; use engine="
                             "'scatter' or 'dense'")
        return "dense"
    return "cuda"


@functools.lru_cache(maxsize=None)
def _cuda_step(cfg: MPMConfig):
    from ..kernels.mpm_cuda import make_step_cuda

    return make_step_cuda(cfg)


def step(cfg: MPMConfig, s: MPMState, grid_reduce=None) -> MPMState:
    """One step on the engine `resolve_engine` picks for the state's
    device."""
    eng = resolve_engine(cfg, s.pos.device)
    if eng == "cuda":
        return _cuda_step(cfg)(s, grid_reduce)
    if eng == "dense":
        return _step_dense(cfg, s, grid_reduce)
    return _step_scatter(cfg, s, grid_reduce)


def overflow_count(cfg: MPMConfig, s: MPMState) -> torch.Tensor:
    """Particles beyond their cell's K capacity under the engine that steps
    `s` (a 0-d int64 tensor): the 'dense' engine's binning drops them;
    'cuda' and 'scatter' drop nothing and read 0.  JAX's counts only when
    the config names 'dense' literally, though its 'auto' runs 'dense'."""
    if resolve_engine(cfg, s.pos.device) != "dense":
        return torch.zeros((), dtype=torch.int64, device=s.pos.device)
    base = torch.floor(div(s.pos, cfg.dx) - 0.5).to(torch.int64)
    return cd.bin_rank(_dense_grid(cfg), s.pos,
                       cid=_cell_index(cfg, base))[2]


def run(cfg: MPMConfig, s: MPMState, n_steps: int) -> MPMState:
    return run_steps(lambda st: step(cfg, st), s, n_steps)
