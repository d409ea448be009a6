"""2-D hybrid FLIP/APIC incompressible fluid on a collocated grid (port of
fluidsims_tpu.solvers.flip_apic).

Behavioral spec: tau_flip_apic.cu — jittered block seed with initial swirl
(k_seed :72-93); linear-hat P2G with blendable APIC affine term (k_p2g
:105-131); grid normalize + gravity + edge clamps (k_normalize_forces
:133-150); central divergence, 48 Jacobi pressure iterations, gradient
projection (k_divergence/k_jacobi/k_project :152-184); bilinear G2P with
FLIP/PIC blend, affine matrix from central differences of the projected
field, advection with restitution -0.35 walls at [0.01, 0.99], and density
rasterization (sample_grid/k_g2p :186-241).

Engines (`resolve_engine`):

* 'cuda' — three hand-written CUDA kernels (kernels/flip_cuda.py): the
  atomic P2G, the whole grid phase in one cooperative launch and the
  per-particle G2P with the density raster; the 'scatter' semantics, no
  cell capacity, no particle dropped.  The default on a CUDA device; on
  CPU tensors it raises.
* 'scatter' — `_step_scatter`, JAX's exact scatter/gather formulation:
  `index_add_` P2G, gathered bilinear G2P.  Its three parts are the CUDA
  kernels' plain versions.
* 'dense' — `_step_dense`, JAX's cell-dense engine: particles binned into
  (n, n, K) slots, transfers as dense sums and static shifts; particles
  past a cell's K = `capacity` slots keep their state and are counted by
  `overflow_count`.  The default on the CPU, as JAX's 'auto' is off the
  TPU.

JAX's TPU engine 'pallas' is the cell-dense engine in VMEM; its
counterpart here is 'cuda' (interop maps the name).  The blend factors
`flip` and `apic` may be overridden per call on every engine: the CUDA
kernels take them as launch arguments, so nothing reroutes.
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
from ..ops.gather import gather2d
from ..ops.scalar import div, scalar

__all__ = ["FlipApicConfig", "FlipApicState", "init", "step", "run",
           "density_grid", "overflow_count", "resolve_engine"]


@dataclass(frozen=True)
class FlipApicConfig(BaseConfig):
    particles: int = 1 << 16
    grid: int = 128
    jacobi: int = 48
    dt: float = 0.004
    gravity: float = 7.5
    flip: float = 0.97
    apic: float = 0.85
    jitter: float = 0.22
    seed: int = 1337
    engine: str = "auto"    # auto | cuda | dense | scatter
    bin_capacity: int = 0   # 0 = auto (~16x mean occupancy); dense only
    dtype: str = "float32"

    def validate(self):
        self._require(self.particles > 0, "particles must be positive")
        self._require(self.grid >= 16, "grid must be >= 16")
        self._require(0.0 <= self.flip <= 1.0, "flip in [0,1]")
        self._require(0.0 <= self.apic <= 1.0, "apic in [0,1]")
        self._require(self.engine in ("auto", "cuda", "dense", "scatter"),
                      "engine must be auto, cuda, dense or scatter")

    @property
    def capacity(self) -> int:
        if self.bin_capacity > 0:
            return self.bin_capacity
        mean = self.particles / ((self.grid - 1) ** 2)
        return max(32, int(np.ceil(16.0 * mean / 8.0)) * 8)


class FlipApicState(NamedTuple):
    pos: torch.Tensor       # (np, 2) in [0,1]^2
    vel: torch.Tensor       # (np, 2)
    affine_x: torch.Tensor  # (np, 2) APIC d(vel)/dx
    affine_y: torch.Tensor  # (np, 2) APIC d(vel)/dy
    density: torch.Tensor   # (n, n) int32 particle counts (render state)


def init(cfg: FlipApicConfig, device=None) -> FlipApicState:
    """Jittered block with a swirl velocity field (k_seed, :72-93), using
    the reference's integer hash for the jitter, in float64 numpy as the
    JAX module draws it.  `device=None` means the GPU (raises where there
    is none)."""
    if device is None:
        device = resolve_device("cuda")
    n_p = cfg.particles
    side = int(np.ceil(np.sqrt(n_p)))
    idx = np.arange(n_p, dtype=np.uint64)
    ix = idx % side
    iy = idx // side
    h = (idx * np.uint64(747796405) + np.uint64(cfg.seed * 2891336453)) \
        & np.uint64(0xFFFFFFFF)
    h = ((h ^ (h >> np.uint64(16))) * np.uint64(2246822519)) \
        & np.uint64(0xFFFFFFFF)
    rx = ((h & np.uint64(1023)).astype(np.float64) / 1023.0 - 0.5) * cfg.jitter
    ry = (((h >> np.uint64(10)) & np.uint64(1023)).astype(np.float64) / 1023.0
          - 0.5) * cfg.jitter
    x = 0.12 + 0.45 * ((ix + 0.5 + rx) / side)
    y = 0.12 + 0.74 * ((iy + 0.5 + ry) / side)
    x = np.clip(x, 0.02, 0.98)
    y = np.clip(y, 0.02, 0.98)
    cx, cy = x - 0.38, y - 0.55
    vel = np.stack([-1.8 * cy, 1.8 * cx], -1)

    dt = cfg.torch_dtype
    return FlipApicState(
        pos=torch.tensor(np.stack([x, y], -1), dtype=dt, device=device),
        vel=torch.tensor(vel, dtype=dt, device=device),
        affine_x=torch.zeros((n_p, 2), dtype=dt, device=device),
        affine_y=torch.zeros((n_p, 2), dtype=dt, device=device),
        density=torch.zeros((cfg.grid, cfg.grid), dtype=torch.int32,
                            device=device),
    )


def _w1(x):
    """Linear hat weight (w1, :67-70)."""
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 1.0 - ax, torch.zeros_like(ax))


def _gshift(a, oy: int, ox: int):
    """(rows, cols) grid view at offset: out[j, i] = a[j + oy, i + ox],
    zeros outside the grid (JAX's `_gshift`; parallel/flip_spatial.py
    shifts its slabs with it)."""
    return cd.grid_shift(a, oy, ox)


def _p2g(cfg, pos, vel, ax, ay, apic=None):
    """Particle-to-grid mass/momentum transfer (k_p2g, :105-131): the CUDA
    atomicAdd as 9 masked `index_add_` scatters.  The target index is
    clipped, so at a wall the out-of-grid offset folds onto the wall cell.
    Returns (mass, mom_u, mom_v), each (n, n)."""
    n = cfg.grid
    apic = cfg.apic if apic is None else apic
    gx = pos[:, 0] * (n - 1)
    gy = pos[:, 1] * (n - 1)
    base_x = torch.floor(gx).to(torch.int64)
    base_y = torch.floor(gy).to(torch.int64)

    # one spare slot at n*n takes the masked entries (JAX's mode="drop")
    mass = torch.zeros(n * n + 1, dtype=pos.dtype, device=pos.device)
    mom_u = torch.zeros_like(mass)
    mom_v = torch.zeros_like(mass)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)

    for oy in (-1, 0, 1):
        j = torch.clamp(base_y + oy, 0, n - 1)
        wy = _w1(gy - j)
        for ox in (-1, 0, 1):
            i = torch.clamp(base_x + ox, 0, n - 1)
            wx = _w1(gx - i)
            wt = wx * wy
            rx = div(i - gx, n - 1)
            ry = div(j - gy, n - 1)
            vvx = vel[:, 0] + apic * (ax[:, 0] * rx + ay[:, 0] * ry)
            vvy = vel[:, 1] + apic * (ax[:, 1] * rx + ay[:, 1] * ry)
            ok = wt > 0.0
            flat = torch.where(ok, j * n + i, n * n)
            mass.index_add_(0, flat, torch.where(ok, wt, zero))
            mom_u.index_add_(0, flat, torch.where(ok, wt * vvx, zero))
            mom_v.index_add_(0, flat, torch.where(ok, wt * vvy, zero))
    return tuple(g[:n * n].reshape(n, n) for g in (mass, mom_u, mom_v))


def _sample(u, v, px, py, n):
    """Bilinear velocity sample (sample_grid, :186-200). Arrays are (n, n)
    with [j, i] = [y, x]; the clip bounds are constants of the dtype."""
    lo, hi = scalar(px, 0.0), scalar(px, n - 1.001)
    gx = torch.clamp(px * (n - 1), lo, hi)
    gy = torch.clamp(py * (n - 1), lo, hi)
    i0 = torch.floor(gx).to(torch.int64)
    j0 = torch.floor(gy).to(torch.int64)
    i1 = torch.clamp_max(i0 + 1, n - 1)
    j1 = torch.clamp_max(j0 + 1, n - 1)
    tx = gx - i0
    ty = gy - j0

    def bil(f):
        f00 = gather2d(f, j0, i0)
        f10 = gather2d(f, j0, i1)
        f01 = gather2d(f, j1, i0)
        f11 = gather2d(f, j1, i1)
        return (1 - tx) * ((1 - ty) * f00 + ty * f01) \
            + tx * ((1 - ty) * f10 + ty * f11)

    return bil(u), bil(v)


def _interior(a):
    return a[1:-1, 1:-1]


def _grid_phase(cfg, mass, u, v):
    """normalize + gravity + clamps -> divergence -> Jacobi -> projection
    (k_normalize_forces..k_project, :133-184).  Shared by every engine.
    Returns (u_prev, v_prev, u_proj, v_proj)."""
    n = cfg.grid
    dt = cfg.dt

    has_mass = mass > 1e-8
    floor_mass = torch.clamp_min(mass, 1e-8)
    u = torch.where(has_mass, u / floor_mass, u)
    v = torch.where(has_mass, v / floor_mass - cfg.gravity * dt, v)
    col = torch.arange(n, device=mass.device)
    edge_x = (col == 0) | (col == n - 1)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    u = torch.where(edge_x[None, :], zero, u)
    v = torch.where(edge_x[:, None], zero, v)   # v is clamped on rows
    u_prev, v_prev = u, v

    # divergence on the interior (k_divergence, :152-161)
    dv = torch.zeros_like(u)
    _interior(dv)[...] = -0.5 * (n - 1) * (
        u[1:-1, 2:] - u[1:-1, :-2] + v[2:, 1:-1] - v[:-2, 1:-1])

    # Jacobi pressure (k_jacobi, :162-172) from p = 0; the ring stays 0
    p = torch.zeros_like(u)
    for _ in range(cfg.jacobi):
        nxt = torch.zeros_like(p)
        _interior(nxt)[...] = 0.25 * (
            _interior(dv)
            + p[1:-1, :-2] + p[1:-1, 2:] + p[:-2, 1:-1] + p[2:, 1:-1])
        p = nxt

    # projection on the interior (k_project, :173-184); the ring is 0.
    # The quotient by (n - 1) is a true division, as in JAX's XLA path.
    u_proj = torch.zeros_like(u)
    v_proj = torch.zeros_like(v)
    _interior(u_proj)[...] = _interior(u) - div(
        0.5 * (p[1:-1, 2:] - p[1:-1, :-2]), n - 1)
    _interior(v_proj)[...] = _interior(v) - div(
        0.5 * (p[2:, 1:-1] - p[:-2, 1:-1]), n - 1)
    return u_prev, v_prev, u_proj, v_proj


def _g2p(cfg, pos, vel, u_prev, v_prev, u_proj, v_proj, flip=None):
    """Grid-to-particle (k_g2p, :202-241): FLIP/PIC blend of the bilinear
    samples, the APIC affine matrix from +-h samples of the projected
    field, advection with restitution walls, and the density raster.
    Returns (pos, vel, affine_x, affine_y, density)."""
    n = cfg.grid
    dt = cfg.dt
    flip = cfg.flip if flip is None else flip

    px, py = pos[:, 0], pos[:, 1]
    new_u, new_v = _sample(u_proj, v_proj, px, py, n)
    old_u, old_v = _sample(u_prev, v_prev, px, py, n)
    flip_u = vel[:, 0] + new_u - old_u
    flip_v = vel[:, 1] + new_v - old_v
    vel_x = (1 - flip) * new_u + flip * flip_u
    vel_y = (1 - flip) * new_v + flip * flip_v

    h = 1.0 / (n - 1)
    ux1, vx1 = _sample(u_proj, v_proj, px + h, py, n)
    ux0, vx0 = _sample(u_proj, v_proj, px - h, py, n)
    uy1, vy1 = _sample(u_proj, v_proj, px, py + h, n)
    uy0, vy0 = _sample(u_proj, v_proj, px, py - h, n)
    affine_x = torch.stack([div(0.5 * (ux1 - ux0), h),
                            div(0.5 * (vx1 - vx0), h)], -1)
    affine_y = torch.stack([div(0.5 * (uy1 - uy0), h),
                            div(0.5 * (vy1 - vy0), h)], -1)

    nx = px + vel_x * dt
    ny_ = py + vel_y * dt
    hit_x = (nx < 0.01) | (nx > 0.99)
    hit_y = (ny_ < 0.01) | (ny_ > 0.99)
    vel_x = torch.where(hit_x, vel_x * -0.35, vel_x)
    vel_y = torch.where(hit_y, vel_y * -0.35, vel_y)
    lo, hi = scalar(nx, 0.01), scalar(nx, 0.99)
    nx = torch.clamp(nx, lo, hi)
    ny_ = torch.clamp(ny_, lo, hi)

    return (torch.stack([nx, ny_], -1), torch.stack([vel_x, vel_y], -1),
            affine_x, affine_y, _raster(n, nx, ny_))


def _raster(n, px, py):
    """(n, n) int32 particle counts at cells (x*n, y*n), truncated and
    clipped."""
    rx = torch.clamp((px * n).to(torch.int32), 0, n - 1)
    ry = torch.clamp((py * n).to(torch.int32), 0, n - 1)
    density = torch.zeros(n * n, dtype=torch.int32, device=px.device)
    density.index_add_(0, (ry * n + rx).long(),
                       torch.ones_like(rx, dtype=torch.int32))
    return density.reshape(n, n)


def _step(cfg, s, p2g, grid_phase, g2p, grid_reduce=None, flip=None,
          apic=None) -> FlipApicState:
    """One step on the given transfers: `p2g(pos, vel, ax, ay, apic)`,
    `grid_phase(mass, u, v)` and `g2p(pos, vel, u_prev, v_prev, u_proj,
    v_proj, flip)`.  `grid_reduce` merges partial P2G grids and density
    rasters (the multi-device hook).  The state's tensors are not
    written."""
    mass, u, v = p2g(s.pos, s.vel, s.affine_x, s.affine_y, apic)
    if grid_reduce is not None:
        mass, u, v = grid_reduce((mass, u, v))
    u_prev, v_prev, u_proj, v_proj = grid_phase(mass, u, v)
    pos, vel, ax, ay, density = g2p(s.pos, s.vel, u_prev, v_prev, u_proj,
                                    v_proj, flip)
    if grid_reduce is not None:
        density = grid_reduce(density)
    return FlipApicState(pos=pos, vel=vel, affine_x=ax, affine_y=ay,
                         density=density)


def _step_scatter(cfg: FlipApicConfig, s: FlipApicState, grid_reduce=None,
                  flip=None, apic=None) -> FlipApicState:
    """The exact engine (JAX's `_step_scatter`, :227-276)."""
    return _step(cfg, s, functools.partial(_p2g, cfg),
                 functools.partial(_grid_phase, cfg),
                 functools.partial(_g2p, cfg), grid_reduce, flip, apic)


def _cell_index(cfg, pos):
    """Flat cell id (int64) of each particle's base node, clipped."""
    n = cfg.grid
    bx = torch.clamp(torch.floor(pos[:, 0] * (n - 1)).to(torch.int64), 0,
                     n - 1)
    by = torch.clamp(torch.floor(pos[:, 1] * (n - 1)).to(torch.int64), 0,
                     n - 1)
    return by * n + bx


def _dense_grid(cfg) -> cd.DenseGrid:
    return cd.DenseGrid(Gx=cfg.grid, Gy=cfg.grid, cell=1.0, K=cfg.capacity)


def _dense_transfers(cfg, dgx, dgy, dvx, dvy, dax, day, dpx, dpy,
                     cxp, cxm, cyp, cym, occf, grid_reduce=None,
                     flip=None, apic=None):
    """P2G -> grid phase -> G2P -> advection on the cell-dense (n, n, K)
    layout (JAX's `_dense_transfers`, :290-389).  All inputs are per-slot
    (n, n, K) channels (dax/day are (n, n, K, 2)); empty slots hold zeros
    with occf = 0.  Returns (n, n, K, 8) = [px, py, vx, vy, ax0, ax1, ay0,
    ay1]."""
    n = cfg.grid
    dt = cfg.dt
    dtype = dgx.dtype
    dev = dgx.device
    h = 1.0 / (n - 1)
    flip = cfg.flip if flip is None else flip
    apic = cfg.apic if apic is None else apic

    line = torch.arange(n, dtype=dtype, device=dev)
    ix = line[None, :, None]
    iy = line[:, None, None]
    # per-axis clip multiplicity: at the walls the reference's index clip
    # folds the out-of-grid offset onto the wall cell, doubling its weight
    mx0 = 1.0 + (ix == 0).to(dtype) + (ix == n - 1).to(dtype)
    my0 = 1.0 + (iy == 0).to(dtype) + (iy == n - 1).to(dtype)

    # ---- P2G (k_p2g semantics; 9 dense sums + shifts) ----
    mass = torch.zeros((n, n), dtype=dtype, device=dev)
    mom_u = torch.zeros_like(mass)
    mom_v = torch.zeros_like(mass)
    for oy in (-1, 0, 1):
        jt = iy + oy
        wy = _w1(dgy - jt) * (my0 if oy == 0 else 1.0)
        ry = div(jt - dgy, n - 1)
        for ox in (-1, 0, 1):
            it = ix + ox
            wt = _w1(dgx - it) * (mx0 if ox == 0 else 1.0) * wy * occf
            rx = div(it - dgx, n - 1)
            vvx = dvx + apic * (dax[..., 0] * rx + day[..., 0] * ry)
            vvy = dvy + apic * (dax[..., 1] * rx + day[..., 1] * ry)
            mass = mass + cd.grid_shift(torch.sum(wt, -1), -oy, -ox)
            mom_u = mom_u + cd.grid_shift(torch.sum(wt * vvx, -1), -oy, -ox)
            mom_v = mom_v + cd.grid_shift(torch.sum(wt * vvy, -1), -oy, -ox)

    if grid_reduce is not None:
        mass, mom_u, mom_v = grid_reduce((mass, mom_u, mom_v))
    u_prev, v_prev, u_proj, v_proj = _grid_phase(cfg, mass, mom_u, mom_v)

    # ---- G2P (sample_grid/k_g2p semantics; hat-window broadcasts) ----
    def sample(gu, gv, sx, sy, wxs, wys):
        """Per-slot bilinear sample of grids at clipped per-slot coords:
        the hat weight selects exactly the two active corners per axis
        inside the static offset window."""
        su = torch.zeros_like(sx)
        sv = torch.zeros_like(sx)
        for oy in wys:
            wy = _w1(sy - (iy + oy))
            for ox in wxs:
                w = _w1(sx - (ix + ox)) * wy
                su = su + w * cd.grid_shift(gu, oy, ox)[:, :, None]
                sv = sv + w * cd.grid_shift(gv, oy, ox)[:, :, None]
        return su, sv

    lo, hi = scalar(dgx, 0.0), scalar(dgx, n - 1.001)
    cgx, cgy, cxp, cxm, cyp, cym = (torch.clamp(a, lo, hi)
                                    for a in (dgx, dgy, cxp, cxm, cyp, cym))

    C = (0, 1)             # central window per axis
    W = (-2, -1, 0, 1, 2)  # wide window for the +-h samples (covers clips)
    new_u, new_v = sample(u_proj, v_proj, cgx, cgy, C, C)
    old_u, old_v = sample(u_prev, v_prev, cgx, cgy, C, C)
    flip_u = dvx + new_u - old_u
    flip_v = dvy + new_v - old_v
    vel_x = (1 - flip) * new_u + flip * flip_u
    vel_y = (1 - flip) * new_v + flip * flip_v

    ux1, vx1 = sample(u_proj, v_proj, cxp, cgy, W, C)
    ux0, vx0 = sample(u_proj, v_proj, cxm, cgy, W, C)
    uy1, vy1 = sample(u_proj, v_proj, cgx, cyp, C, W)
    uy0, vy0 = sample(u_proj, v_proj, cgx, cym, C, W)
    nax_x = div(0.5 * (ux1 - ux0), h)
    nax_y = div(0.5 * (vx1 - vx0), h)
    nay_x = div(0.5 * (uy1 - uy0), h)
    nay_y = div(0.5 * (vy1 - vy0), h)

    # advect + restitution walls, per slot
    nx_ = dpx + vel_x * dt
    ny_ = dpy + vel_y * dt
    hit_x = (nx_ < 0.01) | (nx_ > 0.99)
    hit_y = (ny_ < 0.01) | (ny_ > 0.99)
    vel_x = torch.where(hit_x, vel_x * -0.35, vel_x)
    vel_y = torch.where(hit_y, vel_y * -0.35, vel_y)
    lo, hi = scalar(nx_, 0.01), scalar(nx_, 0.99)
    nx_ = torch.clamp(nx_, lo, hi)
    ny_ = torch.clamp(ny_, lo, hi)

    return torch.stack(
        [nx_, ny_, vel_x, vel_y, nax_x, nax_y, nay_x, nay_y], -1)


def _step_dense(cfg: FlipApicConfig, s: FlipApicState, grid_reduce=None,
                flip=None, apic=None) -> FlipApicState:
    """Cell-dense engine (JAX's `_step_dense`, :392-458): bin once,
    transfers via dense sums + static shifts.  Particles past their cell's
    K slots keep their previous state and stay out of the P2G."""
    n = cfg.grid
    dtype = s.pos.dtype
    px, py = s.pos[:, 0], s.pos[:, 1]
    grid = _dense_grid(cfg)
    cells = cd.bin_particles(grid, s.pos, cid=_cell_index(cfg, s.pos))

    h = 1.0 / (n - 1)
    packed = torch.stack([
        px * (n - 1), py * (n - 1), s.vel[:, 0], s.vel[:, 1],
        s.affine_x[:, 0], s.affine_x[:, 1],
        s.affine_y[:, 0], s.affine_y[:, 1],
        px, py,
        (px + h) * (n - 1), (px - h) * (n - 1),
        (py + h) * (n - 1), (py - h) * (n - 1),
    ], -1)
    dall = cd.scatter_field(grid, cells, packed)      # (n, n, K, 14)
    occf = cells.occ.to(dtype)

    dense_out = _dense_transfers(
        cfg, dall[..., 0], dall[..., 1], dall[..., 2], dall[..., 3],
        dall[..., 4:6], dall[..., 6:8], dall[..., 8], dall[..., 9],
        dall[..., 10], dall[..., 11], dall[..., 12], dall[..., 13],
        occf, grid_reduce, flip=flip, apic=apic)

    # back to particle order (dropped particles keep their previous state)
    got = cd.gather_result(grid, cells, dense_out)    # (np, 8)
    old = torch.cat([s.pos, s.vel, s.affine_x, s.affine_y], -1)
    out = torch.where(cells.ok[:, None], got, old)

    density = _raster(n, out[:, 0], out[:, 1])
    if grid_reduce is not None:
        density = grid_reduce(density)
    pos, vel, ax, ay = (out[:, k:k + 2].contiguous() for k in (0, 2, 4, 6))
    return FlipApicState(pos=pos, vel=vel, affine_x=ax, affine_y=ay,
                         density=density)


def resolve_engine(cfg: FlipApicConfig, device) -> str:
    """The engine that steps `cfg` on `device`: 'auto' gives 'cuda' on a
    CUDA device and 'dense' on the CPU (JAX's 'auto' off the TPU); 'cuda'
    on the CPU raises; 'dense' and 'scatter' are taken as asked.  Any grid
    and both dtypes run on every engine."""
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
def _cuda_step(cfg: FlipApicConfig):
    from ..kernels.flip_cuda import make_step_cuda

    return make_step_cuda(cfg)


def step(cfg: FlipApicConfig, s: FlipApicState, grid_reduce=None,
         flip=None, apic=None) -> FlipApicState:
    """One step on the engine `resolve_engine` picks for the state's
    device.  `flip`/`apic` override the config's blend factors for this
    call (the reference's interactive keys) on every engine."""
    eng = resolve_engine(cfg, s.pos.device)
    if eng == "cuda":
        return _cuda_step(cfg)(s, grid_reduce, flip, apic)
    if eng == "dense":
        return _step_dense(cfg, s, grid_reduce, flip=flip, apic=apic)
    return _step_scatter(cfg, s, grid_reduce, flip=flip, apic=apic)


def density_grid(s: FlipApicState) -> torch.Tensor:
    return s.density


def overflow_count(cfg: FlipApicConfig, s: FlipApicState) -> torch.Tensor:
    """Particles beyond their cell's K capacity under the engine that steps
    `s` (a 0-d int64 tensor): the 'dense' engine's binning drops them;
    'cuda' and 'scatter' drop nothing and read 0.  JAX's counts only when
    the config names 'dense' literally, though its 'auto' runs 'dense' off
    the TPU."""
    if resolve_engine(cfg, s.pos.device) != "dense":
        return torch.zeros((), dtype=torch.int64, device=s.pos.device)
    return cd.bin_particles(_dense_grid(cfg), s.pos,
                            cid=_cell_index(cfg, s.pos)).overflow


def run(cfg: FlipApicConfig, s: FlipApicState, n_steps: int, flip=None,
        apic=None) -> FlipApicState:
    return run_steps(lambda st: step(cfg, st, flip=flip, apic=apic), s,
                     n_steps)
