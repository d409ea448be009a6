"""2-D weakly-compressible SPH on the τ clock (port of
fluidsims_tpu.solvers.sph).

Behavioral spec: tau_sph.cu — cubic-spline kernel (W_cubic :105-116,
gradW_cubic :118-133); Tait EOS on log-density s = ln rho (:207-213);
pressure-gradient + Monaghan artificial viscosity forces (:215-266);
optional XSPH velocity smoothing (:274-313); symplectic Euler with
restitution-0.2 box walls (:324-355); rain emitter with an LCG hash
overwriting particle slots (:377-391, accumulator :706-716); jittered
lattice init (:493-510); dt = min(t*dτ, CFL*h/(c0(1+2α))) with τ
bookkeeping per substep (:666-668, :718-721).

Engines (`resolve_engine`):

* 'cuda' — three hand-written CUDA kernels per substep (binning by
  rank-in-cell, density + EOS, forces + integrate; kernels/sph_cuda.py).
  They walk every member of the 3x3 cells around a particle, with no cell
  capacity, so they keep every pair, as the reference's linked lists do
  (tau_sph.cu:165-176).  The default on a CUDA device when XSPH is off.
  On CPU tensors the same engine runs the kernels' plain PyTorch versions.
* 'torch' — the cell-dense dataflow below, written as the JAX module's XLA
  engine writes it: particles binned into a (Gy, Gx, K) array of cells,
  the 3x3 neighbour passes as shifted (Gy, Gx, K, K) pair blocks.  The
  default on the CPU and wherever XSPH is on.
* 'exact' — chunked all pairs, O(n^2) but correct at any occupancy.

'cuda' and 'exact' keep every pair.  'torch' stores at most K particles per
cell (`cfg.cell_capacity`, which only it reads); particles beyond it are
left out of every pair sum and counted by `overflow_count`.  At the
reference defaults (c0=1, gamma_eos=1, g=9.81) the pool compresses under
gravity to hundreds of particles per cell, past the auto K, so long runs
of 'torch' drop pairs there.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import BaseConfig
from ..core.device import resolve_device
from ..core.stepper import run_steps
from ..ops import cell_dense as cd

__all__ = ["SPHConfig", "SPHState", "init", "step", "run", "density",
           "forces", "xsph", "resolve_engine", "overflow_count",
           "rasterize_counts", "raster_density", "w_cubic", "grad_w_cubic",
           "tait_pressure"]


@dataclass(frozen=True)
class SPHConfig(BaseConfig):
    n: int = 1 << 16
    box_x: float = 1.0
    box_y: float = 1.0
    dtau: float = 1.0
    t0: float = 1.0
    cfl: float = 1.0
    rho0: float = 1.0
    c0: float = 1.0
    gamma_eos: float = 1.0
    h_mul: float = 2.0
    visc_alpha: float = 0.25
    gravity: float = 9.81
    use_visc: bool = True
    use_grav: bool = True
    visc_substeps: int = 1
    use_xsph: bool = False
    xsph_eps: float = 0.25
    rain: bool = True
    seed: int = 69420
    cell_capacity: int = 0   # 0 = auto (3x mean occupancy, min 16)
    engine: str = "auto"     # auto | cuda | torch | exact
    dtype: str = "float32"

    def validate(self):
        self._require(self.n > 0, "n must be positive")
        self._require(self.box_x > 0 and self.box_y > 0, "box must be positive")
        self._require(self.c0 > 0, "c0 must be positive")
        self._require(self.visc_substeps >= 1, "visc_substeps >= 1")
        self._require(self.engine in ("auto", "cuda", "torch", "exact"),
                      "engine must be auto, cuda, torch or exact")

    @property
    def area(self):
        return self.box_x * self.box_y

    @property
    def mass(self):
        return self.rho0 * self.area / self.n

    @property
    def spacing(self):
        return math.sqrt(self.area / self.n)

    @property
    def h(self):
        return self.h_mul * self.spacing

    def grid(self) -> cd.DenseGrid:
        return cd.make_dense_grid(self.box_x, self.box_y, self.h, self.n,
                                  capacity=self.cell_capacity)


class SPHState(NamedTuple):
    pos: torch.Tensor         # (n, 2)
    vel: torch.Tensor         # (n, 2)
    t: torch.Tensor           # 0-d
    tau: torch.Tensor         # 0-d
    rain_carry: torch.Tensor  # 0-d
    step_idx: torch.Tensor    # 0-d int32


def _full(like: torch.Tensor, v) -> torch.Tensor:
    return torch.full((), v, dtype=like.dtype, device=like.device)


# ------------------------------ kernels ------------------------------------


def w_cubic(r, h):
    """2-D cubic spline kernel (tau_sph.cu:105-116)."""
    q = r / h
    alpha = 10.0 / (7.0 * math.pi * h * h)
    q2 = q * q
    inner = alpha * (1.0 - 1.5 * q2 + 0.75 * q2 * q)
    t = 2.0 - q
    outer = alpha * 0.25 * t * t * t
    zero = _full(r, 0.0)
    return torch.where(q < 1.0, inner, torch.where(q < 2.0, outer, zero))


def grad_w_cubic(rij, r, h):
    """Gradient of the cubic kernel w.r.t. x_i (tau_sph.cu:118-133).
    rij: (..., 2), r: (...)."""
    q = r / h
    alpha = 10.0 / (7.0 * math.pi * h * h)
    dWdq = torch.where(q < 1.0, alpha * (-3.0 * q + 2.25 * q * q),
                       alpha * (-0.75 * (2.0 - q) ** 2))
    ok = (r > 1e-8) & (r < 2.0 * h)
    scale = torch.where(ok, dWdq / (h * torch.clamp(r, min=1e-8)), _full(r, 0.0))
    return rij * scale[..., None]


def tait_pressure(cfg, rho):
    ratio = rho / cfg.rho0
    p = (cfg.c0**2) * cfg.rho0 * (ratio**cfg.gamma_eos - 1.0) / cfg.gamma_eos
    return torch.clamp(p, min=0.0)


# ------------------------------- init --------------------------------------


def init(cfg: SPHConfig, device=None) -> SPHState:
    """Jittered lattice filling the lower 60% of the box
    (reset_particles, tau_sph.cu:493-510), from the same numpy draws as the
    JAX module.  `device=None` means the GPU (raises where there is none)."""
    if device is None:
        device = resolve_device("cuda")
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n
    n_side = int(math.sqrt(n))
    nx = n_side
    ny = (n + n_side - 1) // n_side
    pad_x, pad_y = 0.05 * cfg.box_x, 0.05 * cfg.box_y
    width = cfg.box_x - 2 * pad_x
    height = 0.6 * cfg.box_y - pad_y

    i = np.arange(n)
    ix = i % nx
    iy = i // nx
    x = pad_x + (ix + 0.5) / nx * width
    y = pad_y + (iy + 0.5) / ny * height
    x = x + (rng.random(n) - 0.5) * 0.2 * width / nx
    y = y + (rng.random(n) - 0.5) * 0.2 * height / ny

    dt = cfg.torch_dtype
    return SPHState(
        pos=torch.tensor(np.stack([x, y], -1), dtype=dt, device=device),
        vel=torch.zeros((n, 2), dtype=dt, device=device),
        t=torch.tensor(cfg.t0, dtype=dt, device=device),
        tau=torch.zeros((), dtype=dt, device=device),
        rain_carry=torch.zeros((), dtype=dt, device=device),
        step_idx=torch.zeros((), dtype=torch.int32, device=device),
    )


# ------------------------ cell-dense neighbor passes -----------------------


def _pair_geometry(cfg, dpos, occ, oy, ox):
    """rij, r2 and validity for center-slot x neighbor-slot pairs of one
    3x3 cell offset. Shapes (Gy, Gx, K, K[, 2])."""
    npos = cd.shift_cells(dpos, oy, ox)
    nocc = cd.shift_cells(occ, oy, ox)
    rij = dpos[..., :, None, :] - npos[..., None, :, :]
    r2 = torch.sum(rij * rij, dim=-1)
    valid = nocc[..., None, :] & (r2 < (2.0 * cfg.h) ** 2)
    return npos, nocc, rij, r2, valid


def density(cfg: SPHConfig, pos, grid=None, cells=None):
    """SPH density + Tait pressure on log-density
    (k_density_pressure_cell, tau_sph.cu:178-213)."""
    grid = grid or cfg.grid()
    cells = cells or cd.bin_particles(grid, pos)
    dpos = cd.scatter_field(grid, cells, pos)
    occ = cells.occ
    h = cfg.h
    zero = _full(pos, 0.0)

    rho_d = torch.zeros(occ.shape, dtype=pos.dtype, device=pos.device)
    for ox, oy in cd.NEIGHBOR_OFFSETS_2D:
        _, _, _, r2, valid = _pair_geometry(cfg, dpos, occ, oy, ox)
        w = torch.where(valid, w_cubic(torch.sqrt(torch.clamp(r2, min=0.0)), h),
                        zero)
        rho_d = rho_d + cfg.mass * torch.sum(w, dim=-1)

    rho = cd.gather_result(grid, cells, rho_d)
    s = torch.log(torch.clamp(rho, min=1e-6))
    rho = torch.exp(s)
    return s, rho, tait_pressure(cfg, rho), cells, grid


def forces(cfg: SPHConfig, pos, vel, s, press, grid, cells):
    """Pressure gradient + Monaghan viscosity + gravity
    (k_forces_cell, tau_sph.cu:215-266)."""
    h = cfg.h
    K = grid.K
    rho = torch.exp(s)
    dpos = cd.scatter_field(grid, cells, pos)
    dvel = cd.scatter_field(grid, cells, vel)
    drho = cd.scatter_field(grid, cells, rho)
    dpress = cd.scatter_field(grid, cells, press)
    occ = cells.occ
    zero = _full(pos, 0.0)

    acc_d = torch.zeros(dpos.shape, dtype=pos.dtype, device=pos.device)
    not_self = ~torch.eye(K, dtype=torch.bool, device=pos.device)
    for ox, oy in cd.NEIGHBOR_OFFSETS_2D:
        npos, nocc, rij, r2, valid = _pair_geometry(cfg, dpos, occ, oy, ox)
        if ox == 0 and oy == 0:
            valid = valid & not_self
        valid = valid & (r2 > 1e-16)

        r = torch.sqrt(torch.clamp(r2, min=1e-30))
        gw = grad_w_cubic(rij, r, h)

        nrho = cd.shift_cells(drho, oy, ox)
        npress = cd.shift_cells(dpress, oy, ox)
        rho_i = torch.clamp(drho[..., :, None], min=1e-30)
        rho_j = torch.clamp(nrho[..., None, :], min=1e-30)
        p_i = dpress[..., :, None]
        p_j = npress[..., None, :]
        common = -cfg.mass * (p_i / (rho_i**2) + p_j / (rho_j**2))
        a = common[..., None] * gw

        if cfg.use_visc:
            nvel = cd.shift_cells(dvel, oy, ox)
            vij = dvel[..., :, None, :] - nvel[..., None, :, :]
            dot = torch.sum(vij * rij, dim=-1)
            mu = (h * dot) / (r2 + 0.01 * h * h)
            rho_bar = 0.5 * (rho_i + rho_j)
            pi_ij = torch.where(dot < 0.0,
                                (-cfg.visc_alpha * cfg.c0 * mu) / rho_bar, zero)
            a = a + (-cfg.mass * pi_ij)[..., None] * gw

        a = torch.where(valid[..., None], a, zero)
        acc_d = acc_d + torch.sum(a, dim=-2)

    acc = cd.gather_result(grid, cells, acc_d)
    if cfg.use_grav:
        acc = acc + torch.tensor([0.0, -cfg.gravity], dtype=pos.dtype,
                                 device=pos.device)
    return acc


def xsph(cfg: SPHConfig, pos, vel, s, grid, cells):
    """XSPH velocity smoothing (k_xsph_cell, tau_sph.cu:274-313).

    Like the reference, this runs with the PRE-integrate cell binning and
    densities but post-integrate positions/velocities."""
    h = cfg.h
    K = grid.K
    rho = torch.exp(s)
    dpos = cd.scatter_field(grid, cells, pos)
    dvel = cd.scatter_field(grid, cells, vel)
    drho = cd.scatter_field(grid, cells, rho)
    occ = cells.occ
    zero = _full(pos, 0.0)

    dv_d = torch.zeros(dpos.shape, dtype=pos.dtype, device=pos.device)
    not_self = ~torch.eye(K, dtype=torch.bool, device=pos.device)
    for ox, oy in cd.NEIGHBOR_OFFSETS_2D:
        npos, nocc, rij, r2, valid = _pair_geometry(cfg, dpos, occ, oy, ox)
        if ox == 0 and oy == 0:
            valid = valid & not_self
        w = torch.where(valid, w_cubic(torch.sqrt(torch.clamp(r2, min=0.0)), h),
                        zero)
        nrho = cd.shift_cells(drho, oy, ox)
        rho_bar = 0.5 * (torch.clamp(drho[..., :, None], min=1e-30)
                         + torch.clamp(nrho[..., None, :], min=1e-30))
        nvel = cd.shift_cells(dvel, oy, ox)
        vij = nvel[..., None, :, :] - dvel[..., :, None, :]
        dv_d = dv_d + torch.sum(((cfg.mass / rho_bar) * w)[..., None] * vij,
                                dim=-2)

    dv = cd.gather_result(grid, cells, dv_d)
    return cfg.xsph_eps * dv


def _integrate(cfg, pos, vel, acc, dt):
    """Symplectic Euler + restitution walls (k_integrate, tau_sph.cu:324-355)."""
    e = 0.2
    v = vel + acc * dt
    x = pos + v * dt
    lo_x = x[:, 0] < 0.0
    hi_x = x[:, 0] > cfg.box_x
    lo_y = x[:, 1] < 0.0
    hi_y = x[:, 1] > cfg.box_y
    x0 = torch.where(lo_x, _full(x, 0.0),
                     torch.where(hi_x, _full(x, cfg.box_x), x[:, 0]))
    y0 = torch.where(lo_y, _full(x, 0.0),
                     torch.where(hi_y, _full(x, cfg.box_y), x[:, 1]))
    vx = torch.where(lo_x | hi_x, -e * v[:, 0], v[:, 0])
    vy = torch.where(lo_y | hi_y, -e * v[:, 1], v[:, 1])
    return torch.stack([x0, y0], -1), torch.stack([vx, vy], -1)


_RAIN_MAX = 64  # static spawn-slot bound per substep
_U32 = 0xFFFFFFFF


def _rain(cfg, pos, vel, nspawn, seed):
    """Rain emitter with the reference's LCG hash (k_rain, tau_sph.cu:377-391):
    spawns up to _RAIN_MAX particles by overwriting hashed slots.

    `nspawn` is the (float) spawn count and `seed` an integer tensor; both
    stay on the device.  The uint32 LCG runs in int64 masked to 32 bits.
    Where several spawns hash to one slot the highest k wins, as the JAX
    module's scatter leaves it; every write to a slot carries that winner's
    value (or the slot's old value where no active spawn hits it), so the
    duplicate indices of the one index_put are harmless on any device."""
    dev = pos.device
    k = torch.arange(_RAIN_MAX, dtype=torch.int64, device=dev)
    A, C = 1664525, 1013904223
    s = (seed.long() & _U32) ^ ((k * A + C) & _U32)
    s = (s * A + C) & _U32
    rx = (s & 0x00FFFFFF).to(pos.dtype) / 16777216.0
    x = rx * (cfg.box_x * 0.8) + 0.1 * cfg.box_x
    s = (s * A + C) & _U32
    ry = (s & 0x00FFFFFF).to(pos.dtype) / 16777216.0
    y = cfg.box_y * (0.9 + 0.08 * ry)
    slots = s % cfg.n

    active = k < nspawn.long()
    hits = (slots[:, None] == slots[None, :]) & active[None, :]
    winner = torch.where(hits, k[None, :], -1).amax(dim=1)
    has = (winner >= 0)[:, None]
    w = winner.clamp(min=0)
    new_p = torch.stack([x, y], -1)
    new_v = torch.stack([torch.zeros_like(x), torch.full_like(x, -0.5 * cfg.c0)],
                        -1)
    pos = pos.index_put((slots,), torch.where(has, new_p[w], pos[slots]))
    vel = vel.index_put((slots,), torch.where(has, new_v[w], vel[slots]))
    return pos, vel


def _frame_dt(cfg, st, dtau):
    """Substep dt on the device: min(t*dτ, dt_cfl) / visc_substeps."""
    dt_try = st.t * (cfg.dtau if dtau is None else dtau)
    dt_cfl = cfg.cfl * cfg.h / (cfg.c0 * (1.0 + 2.0 * cfg.visc_alpha))
    dt_eff = torch.minimum(dt_try, _full(dt_try, dt_cfl))
    return dt_eff / _full(dt_eff, float(cfg.visc_substeps))


def _advance(cfg, st, dtau, substep):
    """The frame loop shared by every engine: visc_substeps times
    `substep(pos, vel, dt_sub) -> (pos, vel)`, then rain and the τ
    bookkeeping (main loop, tau_sph.cu:659-722).  Nothing is read back to
    the host."""
    dt_sub = _frame_dt(cfg, st, dtau)
    pos, vel = st.pos, st.vel
    rain_carry = st.rain_carry
    t = st.t
    dtau_accum = torch.zeros_like(st.t)
    for _ in range(cfg.visc_substeps):
        pos, vel = substep(pos, vel, dt_sub)
        if cfg.rain:
            rain_carry = rain_carry + 0.02 * cfg.n * dt_sub
            nspawn = torch.clamp(torch.floor(rain_carry), max=float(_RAIN_MAX))
            rain_carry = rain_carry - nspawn
            pos, vel = _rain(cfg, pos, vel, nspawn, st.step_idx + cfg.seed)
        dtau_accum = dtau_accum + dt_sub / torch.clamp(t, min=1e-9)
        t = cfg.t0 * torch.exp(st.tau + dtau_accum)
    return SPHState(pos=pos, vel=vel, t=t, tau=st.tau + dtau_accum,
                    rain_carry=rain_carry, step_idx=st.step_idx + 1)


def resolve_engine(cfg: SPHConfig, device) -> str:
    """The engine that steps `cfg` on `device`.  'torch' and 'exact' are
    taken as asked.  The CUDA kernels do not implement XSPH, so 'cuda'
    with XSPH raises; 'auto' gives 'cuda' on a CUDA device without XSPH
    and 'torch' otherwise, as the JAX module's 'auto' gives 'xla' where
    its Pallas kernels are not eligible.  'cuda' and 'exact' keep every
    pair; 'torch' drops the particles past a cell's K slots."""
    if cfg.engine in ("torch", "exact"):
        return cfg.engine
    if cfg.engine == "cuda":
        if cfg.use_xsph:
            raise ValueError("engine='cuda' does not implement XSPH; use "
                             "engine='torch' or 'exact'")
        return "cuda"
    on_cuda = torch.device(device).type == "cuda"
    return "cuda" if on_cuda and not cfg.use_xsph else "torch"


@functools.lru_cache(maxsize=None)
def _cuda_step(cfg: SPHConfig):
    from ..kernels.sph_cuda import make_step_cuda

    return make_step_cuda(cfg)


def step(cfg: SPHConfig, st: SPHState, dtau=None) -> SPHState:
    """One frame step, on the engine `resolve_engine` picks for the
    state's device.

    `dtau` optionally overrides cfg.dtau (a float or a 0-d tensor); it only
    enters the frame-level clock math."""
    engine = resolve_engine(cfg, st.pos.device)
    if engine == "exact":
        return _step_exact(cfg, st, dtau=dtau)
    if engine == "cuda":
        return _cuda_step(cfg)(st, dtau=dtau)
    return _step_torch(cfg, st, dtau=dtau)


def _step_torch(cfg: SPHConfig, st: SPHState, dtau=None) -> SPHState:
    """K substeps of build-cells -> density -> forces -> integrate ->
    (xsph) -> (rain), on the cell-dense layout (JAX: _step_xla)."""
    grid = cfg.grid()

    def substep(pos, vel, dt_sub):
        s, rho, press, cl, _ = density(cfg, pos, grid)
        acc = forces(cfg, pos, vel, s, press, grid, cl)
        pos, vel = _integrate(cfg, pos, vel, acc, dt_sub)
        if cfg.use_xsph and cfg.xsph_eps > 0.0:
            # The reference runs XSPH on post-integrate positions but with
            # the PRE-integrate cell list and densities (tau_sph.cu:698-704).
            vel = vel + xsph(cfg, pos, vel, s, grid, cl)
        return pos, vel

    return _advance(cfg, st, dtau, substep)


# ------------------------------ exact engine --------------------------------

_EXACT_FAR = 1.0e4   # pad particles parked far outside the box


def _chunks(cols, n_pad, CH):
    """(n_pad,) columns -> list of per-chunk tuples of (CH,) slices."""
    return [tuple(c[i:i + CH] for c in cols) for i in range(0, n_pad, CH)]


def _pad(a, n_pad, v):
    out = torch.full((n_pad,), v, dtype=a.dtype, device=a.device)
    out[:a.shape[0]] = a
    return out


def _exact_pairs(pos, chunk):
    """Pad to a chunk multiple: (px, py, CH, n_pad); pad particles sit far
    away so every real-vs-pad pair fails the r < 2h test."""
    n = pos.shape[0]
    CH = min(chunk, n)
    n_pad = -(-n // CH) * CH
    return (_pad(pos[:, 0], n_pad, _EXACT_FAR),
            _pad(pos[:, 1], n_pad, _EXACT_FAR), CH, n_pad)


def _exact_density(cfg, pos, chunk=1024):
    """All-pairs density + Tait pressure (k_density_pressure_cell semantics,
    tau_sph.cu:178-213, with the neighbour enumeration exact)."""
    h = cfg.h
    px, py, CH, n_pad = _exact_pairs(pos, chunk)
    zero = _full(pos, 0.0)
    out = []
    for cx, cy in _chunks((px, py), n_pad, CH):
        dx = cx[:, None] - px[None, :]
        dy = cy[:, None] - py[None, :]
        r2 = dx * dx + dy * dy
        w = torch.where(r2 < (2.0 * h) ** 2,
                        w_cubic(torch.sqrt(torch.clamp(r2, min=0.0)), h), zero)
        out.append(cfg.mass * torch.sum(w, dim=1))
    rho = torch.cat(out)[:pos.shape[0]]
    s = torch.log(torch.clamp(rho, min=1e-6))
    rho = torch.exp(s)
    return s, rho, tait_pressure(cfg, rho)


def _exact_forces(cfg, pos, vel, rho, press, chunk=1024):
    """All-pairs pressure-gradient + Monaghan viscosity (k_forces_cell,
    tau_sph.cu:215-266), the per-pair math of forces()."""
    h = cfg.h
    px, py, CH, n_pad = _exact_pairs(pos, chunk)
    vx, vy = _pad(vel[:, 0], n_pad, 0.0), _pad(vel[:, 1], n_pad, 0.0)
    rhop, prp = _pad(rho, n_pad, 1.0), _pad(press, n_pad, 0.0)
    zero = _full(pos, 0.0)
    alpha = 10.0 / (7.0 * math.pi * h * h)
    out = []
    for cx, cy, cvx, cvy, crho, cpr in _chunks((px, py, vx, vy, rhop, prp),
                                              n_pad, CH):
        dx = cx[:, None] - px[None, :]
        dy = cy[:, None] - py[None, :]
        r2 = dx * dx + dy * dy
        valid = (r2 < (2.0 * h) ** 2) & (r2 > 1e-16)
        r = torch.sqrt(torch.clamp(r2, min=1e-30))
        q = r / h
        dWdq = torch.where(q < 1.0, alpha * (-3.0 * q + 2.25 * q * q),
                           alpha * (-0.75 * (2.0 - q) ** 2))
        okg = (r > 1e-8) & (r < 2.0 * h)
        scale = torch.where(okg, dWdq / (h * torch.clamp(r, min=1e-8)), zero)

        rho_i = torch.clamp(crho[:, None], min=1e-30)
        rho_j = torch.clamp(rhop[None, :], min=1e-30)
        common = -cfg.mass * (cpr[:, None] / (rho_i ** 2)
                              + prp[None, :] / (rho_j ** 2))
        if cfg.use_visc:
            vijx = cvx[:, None] - vx[None, :]
            vijy = cvy[:, None] - vy[None, :]
            dot = vijx * dx + vijy * dy
            mu = (h * dot) / (r2 + 0.01 * h * h)
            rho_bar = 0.5 * (rho_i + rho_j)
            pi_ij = torch.where(dot < 0.0,
                                (-cfg.visc_alpha * cfg.c0 * mu) / rho_bar, zero)
            common = common - cfg.mass * pi_ij
        c = torch.where(valid, common * scale, zero)
        out.append(torch.stack([torch.sum(c * dx, dim=1),
                                torch.sum(c * dy, dim=1)], -1))
    acc = torch.cat(out)[:pos.shape[0]]
    if cfg.use_grav:
        acc = acc + torch.tensor([0.0, -cfg.gravity], dtype=pos.dtype,
                                 device=pos.device)
    return acc


def _exact_xsph(cfg, pos, vel, rho, chunk=1024):
    """All-pairs XSPH smoothing (k_xsph_cell, tau_sph.cu:274-313)."""
    h = cfg.h
    px, py, CH, n_pad = _exact_pairs(pos, chunk)
    vx, vy = _pad(vel[:, 0], n_pad, 0.0), _pad(vel[:, 1], n_pad, 0.0)
    rhop = _pad(rho, n_pad, 1.0)
    zero = _full(pos, 0.0)
    out = []
    for cx, cy, cvx, cvy, crho in _chunks((px, py, vx, vy, rhop), n_pad, CH):
        dx = cx[:, None] - px[None, :]
        dy = cy[:, None] - py[None, :]
        r2 = dx * dx + dy * dy
        valid = (r2 < (2.0 * h) ** 2) & (r2 > 1e-16)
        w = torch.where(valid, w_cubic(torch.sqrt(torch.clamp(r2, min=0.0)), h),
                        zero)
        rho_bar = 0.5 * (torch.clamp(crho[:, None], min=1e-30)
                         + torch.clamp(rhop[None, :], min=1e-30))
        f = (cfg.mass / rho_bar) * w
        out.append(torch.stack([torch.sum(f * (vx[None, :] - cvx[:, None]), 1),
                                torch.sum(f * (vy[None, :] - cvy[:, None]), 1)],
                               -1))
    return cfg.xsph_eps * torch.cat(out)[:pos.shape[0]]


def _step_exact(cfg: SPHConfig, st: SPHState, dtau=None) -> SPHState:
    """_step_torch with the neighbour sums exact (all pairs, no capacity)."""

    def substep(pos, vel, dt_sub):
        s, rho, press = _exact_density(cfg, pos)
        acc = _exact_forces(cfg, pos, vel, rho, press)
        pos, vel = _integrate(cfg, pos, vel, acc, dt_sub)
        if cfg.use_xsph and cfg.xsph_eps > 0.0:
            vel = vel + _exact_xsph(cfg, pos, vel, rho)
        return pos, vel

    return _advance(cfg, st, dtau, substep)


def run(cfg: SPHConfig, st: SPHState, n_steps: int, dtau=None) -> SPHState:
    return run_steps(lambda s: step(cfg, s, dtau=dtau), st, n_steps)


def overflow_count(cfg: SPHConfig, st: SPHState) -> torch.Tensor:
    """Particles currently beyond their cell's K capacity (left out of the
    pair sums by the 'torch' engine), as a 0-d tensor on the state's
    device; 0 for 'cuda' and 'exact', which keep every pair.  Diagnostic
    only: reading it syncs."""
    if resolve_engine(cfg, st.pos.device) in ("cuda", "exact"):
        return torch.zeros((), dtype=torch.int64, device=st.pos.device)
    return cd.bin_rank(cfg.grid(), st.pos)[2]


def raster_density(cfg: SPHConfig, pos, W: int = 64, H: int = 64,
                   chunk: int = 4096):
    """Exact (all-pairs) SPH density rho(x) = sum_j m W(|x - x_j|) at the
    W x H raster cell centres, shape (H, W)."""
    dt, dev = pos.dtype, pos.device
    gx = (torch.arange(W, dtype=dt, device=dev) + 0.5) / W * cfg.box_x
    gy = (torch.arange(H, dtype=dt, device=dev) + 0.5) / H * cfg.box_y
    Y, X = torch.meshgrid(gy, gx, indexing="ij")
    pts = torch.stack([X.reshape(-1), Y.reshape(-1)], -1)
    px, py = pos[:, 0], pos[:, 1]
    h = cfg.h
    zero = _full(pos, 0.0)
    out = []
    for i in range(0, pts.shape[0], chunk):
        pc = pts[i:i + chunk]
        dx = pc[:, 0][:, None] - px[None, :]
        dy = pc[:, 1][:, None] - py[None, :]
        r2 = dx * dx + dy * dy
        w = torch.where(r2 < (2.0 * h) ** 2,
                        w_cubic(torch.sqrt(torch.clamp(r2, min=0.0)), h), zero)
        out.append(cfg.mass * torch.sum(w, dim=1))
    return torch.cat(out).reshape(H, W)


def rasterize_counts(cfg: SPHConfig, pos, W: int, H: int):
    """Particle counts on a 2x-vertical terminal grid
    (k_rasterize, tau_sph.cu:363-374), shape (2H, W) int32."""
    cx = (pos[:, 0] / cfg.box_x * (W - 1)).to(torch.int32)
    sy = ((cfg.box_y - pos[:, 1]) / cfg.box_y * (2 * H - 1)).to(torch.int32)
    ok = (cx >= 0) & (cx < W) & (sy >= 0) & (sy < 2 * H)
    flat = torch.where(ok, sy * W + cx, 2 * H * W).long()
    counts = torch.bincount(flat, minlength=2 * H * W + 1)[:2 * H * W]
    return counts.to(torch.int32).reshape(2 * H, W)
