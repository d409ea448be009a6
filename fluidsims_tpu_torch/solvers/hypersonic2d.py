"""Flagship 2-D hypersonic compressible Euler solver (MUSCL-Hancock + HLLC).

Port of fluidsims_tpu.solvers.hypersonic2d.  Behavioral spec:
tau_hypersonic_cuda.cu — flow past a sphere-cone capsule with explicit
4th-order-stencil diffusion:
  * config + validation      tau_hypersonic_cuda.cu:37-50, 1394-1409, 1482-1639
  * geometry mask            :740-770 (SDF rasterized, rounded by Rb)
  * inflow left column       :772-784
  * CFL dt from max wavespeed:786-847, 1852-1869
  * MUSCL predict face states:849-962
  * HLLC face fluxes         :964-1030
  * update + diffusion + fix :1032-1176

The functions here are the plain PyTorch version of the step: whole-grid
tensor expressions, written as the JAX module writes them.  On the GPU the
step runs through two hand-written CUDA kernels instead
(kernels/hypersonic2d_cuda.py): one for the inflow column + wavespeed
reduction, one for `pad_bc` + `step_core_padded`.  `step` picks them by
default; their wrappers fall back to the functions below only for CPU
tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..core.clock import cfl_dt
from ..core.config import BaseConfig
from ..core.device import resolve_device
from ..core.metrics import span
from ..core.stepper import run_steps
from ..ops import euler2d as e2
from ..ops.euler2d import Cons, Prim
from ..ops.riemann import hllc
from ..ops.sdf import sd_sphere_cone_capsule, spherecone_xb
from ..ops.shift import shift_clamped

__all__ = [
    "Hypersonic2DConfig",
    "Hypersonic2DState",
    "default_config",
    "build_mask",
    "init",
    "pad_bc",
    "step_core_padded",
    "apply_inflow_",
    "step",
    "run",
    "max_wavespeed",
    "compute_dt",
]


@dataclass(frozen=True)
class Hypersonic2DConfig(BaseConfig):
    nx: int = 8192
    ny: int = 1024
    gamma: float = 1.1
    cfl: float = 0.25
    visc_nu: float = 5e-2
    visc_rho: float = 5e-2
    visc_e: float = 2e-2
    inflow_mach: float = 25.0
    geom_x0: float = 125.0
    geom_cy: float = 512.0
    geom_Rb: float = 1024.0 / 12.0
    geom_Rn: float = 1024.0 / 24.0
    geom_theta: float = math.pi / 4.0
    steps_per_frame: int = 2
    dtype: str = "float32"

    def validate(self):
        # Two-stage validation mirroring tau_hypersonic_cuda.cu:1538-1639.
        self._require(self.nx > 0 and self.ny > 0, "grid dims must be positive")
        self._require(self.gamma > 1.0, f"gamma {self.gamma} must be > 1")
        self._require(self.cfl > 0.0, "cfl must be > 0")
        self._require(self.visc_nu >= 0.0, "visc_nu must be >= 0")
        self._require(self.visc_rho >= 0.0, "visc_rho must be >= 0")
        self._require(self.visc_e >= 0.0, "visc_e must be >= 0")
        self._require(self.inflow_mach > 0.0, "inflow_mach must be > 0")
        self._require(
            0 < self.steps_per_frame <= 1024, "steps_per_frame must be in [1,1024]"
        )
        self._require(math.isfinite(self.geom_x0), "geom_x0 must be finite")
        self._require(math.isfinite(self.geom_cy), "geom_cy must be finite")
        self._require(self.geom_Rb > 0.0, "geom_Rb must be > 0")
        self._require(self.geom_Rn > 0.0, "geom_Rn must be > 0")
        self._require(
            0.0 < self.geom_theta < 0.5 * math.pi, "geom_theta must be in (0, pi/2)"
        )
        # Geometry tangency: base radius must reach past the sphere tangent.
        rt = self.geom_Rn * math.cos(self.geom_theta)
        self._require(
            self.geom_Rb >= rt,
            f"geom_Rb {self.geom_Rb} below tangent radius {rt}; "
            "require Rb >= Rn*cos(theta)",
        )
        tt = math.tan(self.geom_theta)
        self._require(math.isfinite(tt) and tt > 0.0, "tan(theta) must be positive")
        xb = spherecone_xb(self.geom_Rb, self.geom_Rn, self.geom_theta)
        xt = self.geom_Rn * (1.0 - math.sin(self.geom_theta))
        self._require(math.isfinite(xb) and xb >= xt, "cone base behind tangent point")

    @property
    def nu_max(self) -> float:
        return max(self.visc_nu, self.visc_rho, self.visc_e)


def default_config(nx: int = 8192, ny: int = 1024, **kw) -> Hypersonic2DConfig:
    """Defaults scaled to the grid as in tau_hypersonic_cuda.cu:1394-1409
    (cy = ny/2, Rb = ny/12, Rn = ny/24)."""
    base = dict(
        nx=nx,
        ny=ny,
        geom_x0=125.0 * nx / 8192.0 if nx != 8192 else 125.0,
        geom_cy=ny / 2.0,
        geom_Rb=ny / 12.0,
        geom_Rn=ny / 24.0,
    )
    base.update(kw)
    return Hypersonic2DConfig(**base)


class Hypersonic2DState(NamedTuple):
    U: Cons                  # conserved fields, each (ny, nx)
    mask: torch.Tensor       # bool (ny, nx), True = solid
    t: torch.Tensor          # sim time (0-d)


def _inflow(cfg: Hypersonic2DConfig, device=None) -> Prim:
    return e2.inflow_prim(cfg.gamma, cfg.inflow_mach, cfg.torch_dtype, device)


def inflow_cons(cfg: Hypersonic2DConfig, device=None) -> Cons:
    """The inflow state in conserved variables, as 0-d tensors."""
    return e2.prim_to_cons(_inflow(cfg, device), cfg.gamma)


def build_mask(cfg: Hypersonic2DConfig, device=None) -> torch.Tensor:
    """Rasterize the rounded sphere-cone SDF to a solid mask
    (tau_hypersonic_cuda.cu:740-765): sd = capsule_sd - Rb, clipped behind
    the base plane."""
    dt = cfg.torch_dtype
    x = torch.arange(cfg.nx, dtype=dt, device=device) - cfg.geom_x0
    y = torch.arange(cfg.ny, dtype=dt, device=device) - cfg.geom_cy
    Y, X = torch.meshgrid(y, x, indexing="ij")  # (ny, nx)
    xb = spherecone_xb(cfg.geom_Rb, cfg.geom_Rn, cfg.geom_theta)
    sd = sd_sphere_cone_capsule(X, Y, cfg.geom_Rb, cfg.geom_Rn, cfg.geom_theta)
    sd = sd - cfg.geom_Rb
    sd = torch.maximum(sd, X - xb)
    return sd < 0.0


def init(cfg: Hypersonic2DConfig, device=None) -> Hypersonic2DState:
    """Fill the domain with inflow; solid cells hold the stagnant state
    (rho, 0, 0, p) (tau_hypersonic_cuda.cu:767-769).  `device=None` means
    the GPU (raises where there is none)."""
    if device is None:
        device = resolve_device("cuda")
    mask = build_mask(cfg, device)
    infl = _inflow(cfg, device)
    shape = (cfg.ny, cfg.nx)

    def full(v):
        return v.expand(shape).contiguous()

    zero = torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
    fluid = e2.prim_to_cons(
        Prim(full(infl.rho), full(infl.u), full(infl.v), full(infl.p)), cfg.gamma
    )
    solid = e2.prim_to_cons(Prim(full(infl.rho), zero, zero, full(infl.p)),
                            cfg.gamma)
    U = e2.c_where(mask, solid, fluid)
    return Hypersonic2DState(
        U=U, mask=mask, t=torch.zeros((), dtype=cfg.torch_dtype, device=device))


# ---------------------------------------------------------------------------
# Branch-free neighbor access with boundary conditions (the views' sampler)
# ---------------------------------------------------------------------------


def _neighbor(cfg, U: Cons, mask, center_prim: Prim, dy: int, dx: int) -> Cons:
    """Whole-grid neighbor_or_wall (tau_hypersonic_cuda.cu:266-290):
    y edge-clamped; x<0 -> inflow; x>=nx -> last column (edge clamp);
    in-bounds solid neighbor -> no-slip ghost of the center cell.  Runs on
    the state's device."""
    Un = Cons(*(shift_clamped(f, dy, dx) for f in U))
    mn = shift_clamped(mask, dy, dx)

    ghost = e2.prim_to_cons(e2.wall_ghost(center_prim), cfg.gamma)

    col = torch.arange(cfg.nx, device=mask.device) + dx
    if dx != 0:
        # The wall-ghost substitution only applies where the x-neighbor was
        # in-bounds (the reference checks x bounds before the mask).
        sel = mn & ((col >= 0) & (col < cfg.nx))[None, :]
    else:
        sel = mn
    out = e2.c_where(sel, ghost, Un)

    if dx < 0:
        # First |dx| columns read past the inflow boundary.
        infl = inflow_cons(cfg, mask.device)
        out = e2.c_where((col < 0)[None, :], _bcast(infl, out.rho.shape), out)
    return out


def _bcast(c: Cons, shape) -> Cons:
    return Cons(*(f.expand(shape) for f in c))


# ---------------------------------------------------------------------------
# Padded-core formulation (as in the JAX module): (1) resolve all x/y
# boundary conditions into a halo-2 padded copy of the state (pad_bc), then
# (2) a purely local core (step_core_padded) in which every neighbor access
# is a slice and the only remaining BC logic is the wall-ghost mask select.
# The CUDA step kernel computes the same thing without the padded copy: its
# loads resolve the BCs by index arithmetic.
# ---------------------------------------------------------------------------

PAD = 2  # stencil reach: MUSCL(1) chained through faces + diffusion(2)


def pad_bc(cfg, U: Cons, mask):
    """Halo-2 padded state with BCs resolved: y edge-clamp, x<0 inflow,
    x>=nx outflow copy of the last column; padded mask is edge-clamped in y
    and False in the x pads (the reference never mask-checks x ghosts,
    tau_hypersonic_cuda.cu:277-283)."""
    H, W = mask.shape
    dev = mask.device
    infl = inflow_cons(cfg, dev)
    yi = torch.arange(-PAD, H + PAD, device=dev).clamp(0, H - 1)
    xi = torch.arange(0, W + PAD, device=dev).clamp(max=W - 1)

    def padf(f, left_val):
        f = f.index_select(0, yi).index_select(1, xi)
        left = left_val.expand(f.shape[0], PAD)
        return torch.cat([left, f], dim=1)

    Up = Cons(*(padf(f, v) for f, v in zip(U, infl)))
    mp = mask.index_select(0, yi)
    xpad = torch.zeros((H + 2 * PAD, PAD), dtype=torch.bool, device=dev)
    mp = torch.cat([xpad, mp, xpad], dim=1)
    return Up, mp


def _win(f, y0, x0, h, w):
    return f[y0:y0 + h, x0:x0 + w]


def _cwin(c, y0, x0, h, w):
    return type(c)(*(_win(f, y0, x0, h, w) for f in c))


def step_core_padded(cfg, Up: Cons, Mp, dt) -> Cons:
    """The local physics update on a halo-2 padded block: MUSCL predict ->
    HLLC face fluxes -> conservative update + diffusion -> positivity fix.
    Returns the new interior state (shape = padded minus 2*PAD each dim).
    The primitive decode runs once on the whole padded block; every window
    below is a slice of it."""
    hp, wp = Up.rho.shape
    H = hp - 2 * PAD
    W = wp - 2 * PAD
    g = cfg.gamma
    half_dt = 0.5 * dt

    Pp = e2.cons_to_prim(Up, g)

    def predict_axis(axis):
        # predicted (low, high) face states for the extended cell range:
        # x axis: cells [-1, W] x rows [0, H); y axis: cols [0, W) x rows
        # [-1, H]
        if axis == 0:
            h, w = H, W + 2
            y0, x0 = PAD, PAD - 1
            dy, dx = 0, 1
        else:
            h, w = H + 2, W
            y0, x0 = PAD - 1, PAD
            dy, dx = 1, 0

        qc = _cwin(Pp, y0, x0, h, w)
        ghost = e2.prim_to_cons(e2.wall_ghost(qc), g)

        def nbr(sgn):
            Un = _cwin(Up, y0 + sgn * dy, x0 + sgn * dx, h, w)
            mn = _win(Mp, y0 + sgn * dy, x0 + sgn * dx, h, w)
            return e2.c_where(mn, ghost, Un)

        qm = e2.cons_to_prim(nbr(-1), g)
        qp = e2.cons_to_prim(nbr(+1), g)
        qL, qR = e2.reconstruct_faces(qm, qc, qp)

        FL = e2.flux(e2.prim_to_cons(qL, g), g, axis)
        FR = e2.flux(e2.prim_to_cons(qR, g), g, axis)
        dF = e2.c_sub(FR, FL)
        pL = e2.clamp_prim(e2.half_step_predict(qL, dF, half_dt, g))
        pR = e2.clamp_prim(e2.half_step_predict(qR, dF, half_dt, g))
        return e2.prim_to_cons(pL, g), e2.prim_to_cons(pR, g)

    def zeros_like(c):
        return Cons(*(torch.zeros_like(f) for f in c))

    # ---- x faces: (H, W+1) ----
    xL, xR = predict_axis(0)
    fluidL = ~_win(Mp, PAD, PAD - 1, H, W + 1)   # cells -1..W-1
    fluidR = ~_win(Mp, PAD, PAD, H, W + 1)       # cells 0..W
    ghostL = e2.prim_to_cons(e2.wall_ghost(_cwin(Pp, PAD, PAD, H, W + 1)), g)
    ghostR = e2.prim_to_cons(e2.wall_ghost(_cwin(Pp, PAD, PAD - 1, H, W + 1)), g)
    UL = e2.c_where(fluidL, Cons(*(f[:, :-1] for f in xR)), ghostL)
    UR = e2.c_where(fluidR, Cons(*(f[:, 1:] for f in xL)), ghostR)
    Fx = hllc(UL, UR, g, axis=0)
    Fx = e2.c_where(fluidL | fluidR, Fx, zeros_like(Fx))

    # ---- y faces: (H+1, W) ----
    yL, yR = predict_axis(1)
    fluidB = ~_win(Mp, PAD - 1, PAD, H + 1, W)
    fluidT = ~_win(Mp, PAD, PAD, H + 1, W)
    ghostB = e2.prim_to_cons(e2.wall_ghost(_cwin(Pp, PAD, PAD, H + 1, W)), g)
    ghostT = e2.prim_to_cons(e2.wall_ghost(_cwin(Pp, PAD - 1, PAD, H + 1, W)), g)
    UB = e2.c_where(fluidB, Cons(*(f[:-1, :] for f in yR)), ghostB)
    UT = e2.c_where(fluidT, Cons(*(f[1:, :] for f in yL)), ghostT)
    Gy = hllc(UB, UT, g, axis=1)
    Gy = e2.c_where(fluidB | fluidT, Gy, zeros_like(Gy))

    # ---- conservative update ----
    Uc = _cwin(Up, PAD, PAD, H, W)
    maskc = _win(Mp, PAD, PAD, H, W)
    center = _cwin(Pp, PAD, PAD, H, W)

    Un = Cons(*(
        u - dt * (f[:, 1:] - f[:, :-1]) - dt * (gy[1:, :] - gy[:-1, :])
        for u, f, gy in zip(Uc, Fx, Gy)
    ))

    # ---- diffusion (4th-order 5-tap, halo 2) ----
    inv12 = 1.0 / 12.0
    ghost_c = e2.prim_to_cons(e2.wall_ghost(center), g)

    def dnbr(dy, dx):
        Unb = _cwin(Up, PAD + dy, PAD + dx, H, W)
        mnb = _win(Mp, PAD + dy, PAD + dx, H, W)
        return e2.c_where(mnb, ghost_c, Unb)

    def d2(axis):
        dy, dx = (0, 1) if axis == 0 else (1, 0)
        m2 = dnbr(-2 * dy, -2 * dx)
        m1 = dnbr(-dy, -dx)
        p1 = dnbr(dy, dx)
        p2 = dnbr(2 * dy, 2 * dx)
        return Cons(*(
            (-a + 16.0 * b - 30.0 * c + 16.0 * d - e) * inv12
            for a, b, c, d, e in zip(m2, m1, Uc, p1, p2)
        ))

    lap = e2.c_add(d2(0), d2(1))
    Un = Cons(
        rho=Un.rho + (cfg.visc_rho * dt) * lap.rho,
        mx=Un.mx + (cfg.visc_nu * dt) * lap.mx,
        my=Un.my + (cfg.visc_nu * dt) * lap.my,
        E=Un.E + (cfg.visc_e * dt) * lap.E,
    )

    # ---- positivity / finiteness repair ----
    Un = Un._replace(rho=torch.clamp_min(Un.rho, e2.EPS_RHO))
    pp = e2.cons_to_prim(Un, g)
    bad = (
        (pp.p <= e2.EPS_P)
        | ~torch.isfinite(pp.p) | ~torch.isfinite(pp.rho)
        | ~torch.isfinite(pp.u) | ~torch.isfinite(pp.v)
    )
    fixed = e2.prim_to_cons(e2.clamp_prim(pp), g)
    Un = e2.c_where(bad, fixed, Un)

    # solid cells keep their state
    return e2.c_where(maskc, Uc, Un)


# ---------------------------------------------------------------------------
# Step pipeline
# ---------------------------------------------------------------------------


def apply_inflow_(cfg, U: Cons, mask, col: int = 0) -> None:
    """Inflow left column (k_apply_inflow_left, :772-784), IN PLACE: the
    fluid cells of column `col` take the inflow state.  Idempotent.  A
    sharded run names the inflow column of its extended slab, or -1 where
    the slab holds none."""
    if col < 0:
        return
    fluid0 = ~mask[:, col]
    for f, v in zip(U, inflow_cons(cfg, mask.device)):
        f[:, col] = torch.where(fluid0, v, f[:, col])


def max_wavespeed(cfg, U: Cons, mask):
    """Max |u|+a, |v|+a over fluid cells, floored at 1e-12 (the reference's
    two-stage reduction, tau_hypersonic_cuda.cu:786-847)."""
    p = e2.cons_to_prim(U, cfg.gamma)
    a = e2.sound_speed(p, cfg.gamma)
    s = torch.maximum(torch.abs(p.u) + a, torch.abs(p.v) + a)
    s = torch.where(torch.isfinite(s), s, 1e-12)
    s = torch.where(mask, 1e-12, s)
    return torch.clamp_min(torch.amax(s), 1e-12)


def compute_dt(cfg, U: Cons, mask):
    return cfl_dt(max_wavespeed(cfg, U, mask), cfg.cfl, dx=1.0, nu_max=cfg.nu_max)


def step(
    cfg: Hypersonic2DConfig,
    s: Hypersonic2DState,
    core=None,
    wavespeed=None,
) -> Hypersonic2DState:
    """One full physics step — the reference's 5-kernel sequence
    (tau_hypersonic_cuda.cu:1833-1889): inflow column -> on-device CFL dt
    -> BC padding + cell update.

    `wavespeed(U, mask) -> 0-d tensor` applies the inflow column to `U` in
    place and returns the max wavespeed; `core(U, mask, dt) -> Cons` is the
    cell-update engine.  Both default to the CUDA kernels of
    kernels.hypersonic2d_cuda, whose wrappers run their plain versions
    (apply_inflow_ + max_wavespeed, pad_bc + step_core_padded) for CPU
    tensors.  Note that the input state's column 0 is updated in place;
    the inflow is idempotent, so stepping the same state twice gives the
    same result.  dt never leaves the device.  Under a profiler the two
    phases are the spans `fst.h2d.dt` and `fst.h2d.update`.
    """
    from ..kernels import hypersonic2d_cuda as hk

    U, mask = s.U, s.mask
    with span("fst.h2d.dt"):
        if wavespeed is None:
            maxs = hk.inflow_wavespeed(cfg, U, mask)
        else:
            maxs = wavespeed(U, mask)
        dt = cfl_dt(maxs, cfg.cfl, dx=1.0, nu_max=cfg.nu_max)
    with span("fst.h2d.update"):
        Un = hk.step_core(cfg, U, mask, dt) if core is None \
            else core(U, mask, dt)
        t = s.t + dt
    return Hypersonic2DState(U=Un, mask=mask, t=t)


def run(cfg: Hypersonic2DConfig, s: Hypersonic2DState, n_steps: int,
        core=None, wavespeed=None) -> Hypersonic2DState:
    return run_steps(lambda st: step(cfg, st, core, wavespeed), s, n_steps)
