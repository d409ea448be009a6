"""Jos Stam "Stable Fluids" on an exponentially stretched (log-eta) grid
(port of fluidsims_tpu.solvers.stam2d).

Behavioral spec: js_cuda.cu, a 512^2 double-precision solver with:
  * the log-eta metric x = X0*e^eta, eta in [-1.5, 1.5]; per-axis cell
    widths dx[i] = X0(e^{eta+deta/2} - e^{eta-deta/2}) (init_grid :196-214);
  * 40-iteration Jacobi solves for diffusion and pressure (k_lin :70-80,
    lin_solve :143-158);
  * semi-Lagrangian advection back-tracing in eta-space with the velocity
    converted by 1/x_p (k_adv :82-103), the sample clamped to [0.5, N+0.5];
  * projection: central divergence scaled by 1/dx, then the gradient
    subtraction scaled by dx (k_div :105-114, k_proj :116-124);
  * density decay and an orbiting animated swirl source (k_decay :49-54,
    k_add_source :126-140), the initial swirl seed (k_seed :56-68);
  * a zero halo ring (the (N+2)^2 padding is zeroed once, never written).

Fields are stored as interior (n, n) tensors; the zero ring is a pad at
the use sites, as in JAX.

Engines (`resolve_engine`):

* 'cuda' — hand-written CUDA kernels (kernels/stam2d_cuda.py): one launch
  is one whole Jacobi solve (all jacobi_iters sweeps, grid syncs between
  them), and the exact bilinear back-trace of one or two fields a launch;
  decay, source, divergence and gradient stay PyTorch ops.  The default on
  a CUDA device; on CPU tensors it raises.
* 'torch' — `_step_torch` below, JAX's exact XLA engine written in
  PyTorch.  The default on the CPU.

Neither engine clamps a back-trace, so a one-device run leaves
`state.ovf` at 0; the x-slab runner (parallel/stam2d_sharded.py) clamps
the back-traces that leave its exchanged columns and counts them there.
JAX's TPU engines 'pallas' (a row band of `advect_band` cells that clamps
past it) and 'hybrid' (the band with an exact repair window) exist only
for the TPU's missing gathers and are not ported; `advect_overflow_count`
still counts the back-traces the band would have clamped.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import BaseConfig
from ..core.device import resolve_device
from ..core.stepper import run_steps
from ..ops.gather import gather2d
from ..ops.scalar import div, rdiv

__all__ = ["Stam2DConfig", "Stam2DState", "init", "step", "run",
           "resolve_engine", "advect_overflow_count"]


@dataclass(frozen=True)
class Stam2DConfig(BaseConfig):
    n: int = 512
    dt: float = 1.0
    visc: float = 1e-6
    diff: float = 1e-7
    dens_decay: float = 1.0 - 1e-6
    x0: float = 1.0
    y0: float = 1.0
    eta_min: float = -1.5
    eta_max: float = 1.5
    jacobi_iters: int = 40
    # the row band of JAX's TPU advection kernel, in cells: read by
    # advect_overflow_count (no one-device engine of the port bands or
    # clamps) and, as the default of its exchanged columns (capped at
    # n / D), by the x-slab runner (parallel/stam2d_sharded.py)
    advect_band: int = 16
    engine: str = "auto"   # auto | cuda | torch
    dtype: str = "float32"

    def validate(self):
        self._require(self.n > 0, "n must be positive")
        self._require(self.jacobi_iters > 0, "jacobi_iters must be positive")
        self._require(self.eta_max > self.eta_min,
                      "eta range must be nonempty")
        self._require(1 <= self.advect_band <= 128,
                      "advect_band must be in [1, 128]")
        self._require(self.engine in ("auto", "cuda", "torch"),
                      "engine must be auto, cuda or torch")


class Stam2DState(NamedTuple):
    u: torch.Tensor    # (n, n) interior velocities
    v: torch.Tensor
    u0: torch.Tensor   # carried across steps: the Jacobi warm starts, as
    v0: torch.Tensor   # the reference reuses d_u0/d_v0/d_d0
    d: torch.Tensor
    d0: torch.Tensor
    step_idx: torch.Tensor   # 0-d int32: the orbiting source's phase
    ovf: torch.Tensor        # 0-d int32: clamped back-traces; only the
    #                          x-slab runner clamps and counts them


def _deta(cfg) -> float:
    return (cfg.eta_max - cfg.eta_min) / cfg.n


def _eta(cfg) -> np.ndarray:
    """eta of the cell centres 1..n along one axis, float64."""
    return cfg.eta_min + (np.arange(1, cfg.n + 1) - 0.5) * _deta(cfg)


def _cell_widths(cfg) -> np.ndarray:
    """Physical cell widths along one axis (init_grid, js_cuda.cu:196-207),
    float64."""
    deta = _deta(cfg)
    eta = _eta(cfg)
    return cfg.x0 * (np.exp(eta + deta / 2) - np.exp(eta - deta / 2))


class Metric(NamedTuple):
    """The grid's 1-D axes in the state's dtype: eta of the cell centres,
    the metric factors x0 e^eta and y0 e^eta, and the cell widths."""
    eta: torch.Tensor
    xp: torch.Tensor
    yp: torch.Tensor
    widths: torch.Tensor


@functools.lru_cache(maxsize=None)
def _metric_of(cfg, dtype, device) -> Metric:
    eta = torch.tensor(_eta(cfg), dtype=dtype, device=device)
    return Metric(eta=eta, xp=cfg.x0 * torch.exp(eta),
                  yp=cfg.y0 * torch.exp(eta),
                  widths=torch.tensor(_cell_widths(cfg), dtype=dtype,
                                      device=device))


def metric(cfg, like: torch.Tensor) -> Metric:
    """The Metric of cfg's grid in like's dtype and on its device, built
    once per (config, dtype, device): eta and the widths in float64 numpy,
    cast; xp and yp by torch.exp of the cast eta."""
    return _metric_of(cfg, like.dtype, like.device)


def init(cfg: Stam2DConfig, device=None) -> Stam2DState:
    """Initial swirl + Gaussian density blob (k_seed, js_cuda.cu:56-68),
    drawn in float64 numpy as the JAX module draws it.  `device=None`
    means the GPU (raises where there is none)."""
    if device is None:
        device = resolve_device("cuda")
    n = cfg.n
    dt = cfg.torch_dtype
    i = np.arange(1, n + 1)[None, :]
    j = np.arange(1, n + 1)[:, None]
    cx = cy = n // 2
    R = n / 2.5
    sw = 0.5
    dx = i - cx
    dy = j - cy
    r2 = dx * dx + dy * dy
    r = np.sqrt(r2) + 1e-6
    inside = r2 < R * R
    d = np.where(inside, 0.4 * np.exp(-r2 / (R * R)), 0.0)
    u = np.where(inside, -sw * dy / r, 0.0)
    v = np.where(inside, sw * dx / r, 0.0)

    def field(a):
        return torch.tensor(a, dtype=dt, device=device)

    def zeros():
        return torch.zeros((n, n), dtype=dt, device=device)

    def zero_int():
        return torch.zeros((), dtype=torch.int32, device=device)

    return Stam2DState(u=field(u), v=field(v), u0=zeros(), v0=zeros(),
                       d=field(d), d0=zeros(), step_idx=zero_int(),
                       ovf=zero_int())


def _sum4(x):
    """Sum of the 4 neighbours with the zero halo ring realized by padding,
    in JAX's order (rows j-1, j+1, then columns i-1, i+1)."""
    p = F.pad(x, (1, 1, 1, 1))
    return p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]


def _lin_solve(x, b, a: float, c: float, iters: int):
    """`iters` Jacobi sweeps x <- (b + a*sum4(x))/c (k_lin + lin_solve,
    js_cuda.cu:70-80,143-158), warm-started from x, which is not written.
    The division by c is a true division (ops/scalar.py)."""
    for _ in range(iters):
        x = div(b + a * _sum4(x), c)
    return x


def _backtrace_coords(cfg, uu, vv):
    """Exact semi-Lagrangian back-trace coordinates in eta-space (k_adv,
    js_cuda.cu:82-103): padded-space corner indices (i0, j0) in [0, n] and
    fractional weights (s1, t1)."""
    n = cfg.n
    deta = _deta(cfg)
    m = metric(cfg, uu)
    bx = m.eta[None, :] - cfg.dt * uu / m.xp[None, :]
    by = m.eta[:, None] - cfg.dt * vv / m.yp[:, None]
    sarr = torch.clamp(div(bx - cfg.eta_min, deta) + 0.5, 0.5, n + 0.5)
    tarr = torch.clamp(div(by - cfg.eta_min, deta) + 0.5, 0.5, n + 0.5)
    i0 = torch.floor(sarr).to(torch.int32)   # in [0, n]
    j0 = torch.floor(tarr).to(torch.int32)
    return i0, j0, sarr - i0, tarr - j0


def _bilinear(qp, i0, j0, s1, t1):
    """Exact 4-corner fetch + blend on the ring-padded array, in k_adv's
    association."""
    s0 = 1.0 - s1
    t0 = 1.0 - t1
    q00 = gather2d(qp, j0, i0)
    q01 = gather2d(qp, j0 + 1, i0)
    q10 = gather2d(qp, j0, i0 + 1)
    q11 = gather2d(qp, j0 + 1, i0 + 1)
    return s0 * (t0 * q00 + t1 * q01) + s1 * (t0 * q10 + t1 * q11)


def _advect_fields(cfg, qs, uu, vv) -> tuple:
    """Each field of qs advected by one back-trace of (uu, vv), computed
    once: the exact gather of JAX's XLA path for every field."""
    i0, j0, s1, t1 = _backtrace_coords(cfg, uu, vv)
    return tuple(_bilinear(F.pad(q, (1, 1, 1, 1)), i0, j0, s1, t1)
                 for q in qs)


def _advect(cfg, q0, uu, vv):
    """Semi-Lagrangian back-trace in eta-space (k_adv, js_cuda.cu:82-103)."""
    return _advect_fields(cfg, (q0,), uu, vv)[0]


def _project(cfg, uu, vv, widths, solve):
    """Divergence -> Jacobi Poisson (from p = 0) -> gradient subtract
    (k_div/k_proj + lin_solve, js_cuda.cu:105-124,170-181), multiplying by
    the reciprocal widths as JAX does.  `solve(x, b, a, c)` is the
    engine's Jacobi solve."""
    inv_w = rdiv(1.0, widths)
    pu = F.pad(uu, (1, 1, 1, 1))
    pv = F.pad(vv, (1, 1, 1, 1))
    dv = -0.5 * (
        (pu[1:-1, 2:] - pu[1:-1, :-2]) * inv_w[None, :]
        + (pv[2:, 1:-1] - pv[:-2, 1:-1]) * inv_w[:, None]
    )
    p = solve(torch.zeros_like(dv), dv, 1.0, 4.0)
    pp = F.pad(p, (1, 1, 1, 1))
    uu = uu - 0.5 * widths[None, :] * (pp[1:-1, 2:] - pp[1:-1, :-2])
    vv = vv - 0.5 * widths[:, None] * (pp[2:, 1:-1] - pp[:-2, 1:-1])
    return uu, vv


def _source_centre(cfg, step_idx, dtype):
    """(cx, cy, amp) of the orbiting source at step_idx (any shape of
    int tensor), on its device: C's (int) cast truncates toward zero
    (js_cuda.cu:130-131); cos and sin in `dtype`."""
    n = cfg.n
    t = step_idx.to(dtype)
    ang = t * 0.015
    cx = n // 2 + torch.trunc((n / 4) * torch.cos(ang)).to(torch.int32)
    cy = n // 2 + torch.trunc((n / 4) * torch.sin(ang)).to(torch.int32)
    amp = 0.5 + 0.4 * torch.sin(t * 0.02)
    return cx, cy, amp


def _add_source(cfg, u, v, d, step_idx):
    """Orbiting animated swirl source (k_add_source, js_cuda.cu:126-140),
    all on the device: no value is read back to the host."""
    n = cfg.n
    cx, cy, amp = _source_centre(cfg, step_idx, u.dtype)
    R = 3.0
    swirl = 0.6
    idx = torch.arange(1, n + 1, dtype=torch.int32, device=u.device)
    dx = (idx[None, :] - cx).to(u.dtype)
    dy = (idx[:, None] - cy).to(u.dtype)
    r2 = dx * dx + dy * dy
    r = torch.sqrt(r2) + 1e-6
    inside = r2 < R * R
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    d = d + torch.where(inside, amp * torch.exp(div(-r2, R * R)), zero)
    u = u + torch.where(inside, -swirl * dy / r, zero)
    v = v + torch.where(inside, swirl * dx / r, zero)
    return u, v, d


def resolve_engine(cfg: Stam2DConfig, device) -> str:
    """The engine that steps `cfg` on `device`: 'auto' gives 'cuda' on a
    CUDA device and 'torch' on the CPU; 'cuda' on the CPU raises.  Any n
    and both dtypes run on either engine."""
    if cfg.engine == "torch":
        return "torch"
    if torch.device(device).type != "cuda":
        if cfg.engine == "cuda":
            raise ValueError("engine='cuda' runs the CUDA kernels and needs "
                             f"CUDA tensors, got {device}; use engine='torch'")
        return "torch"
    return "cuda"


def advect_overflow_count(cfg: Stam2DConfig, s: Stam2DState) -> torch.Tensor:
    """Cells whose back-trace row displacement exceeds advect_band in the
    frame's two advections (the velocity advection traces with v0, the
    density advection with v): where JAX's banded TPU kernel (engine
    'pallas') would clamp on this state, whatever the engine that made
    it.  No engine of the port clamps.  A 0-d tensor; diagnostic only:
    reading it syncs."""
    n = cfg.n
    m = metric(cfg, s.v)
    idx = torch.arange(1, n + 1, dtype=s.v.dtype, device=s.v.device)
    over = torch.zeros((n, n), dtype=torch.bool, device=s.v.device)
    for vv in (s.v0, s.v):
        by = m.eta[:, None] - cfg.dt * vv / m.yp[:, None]
        tarr = torch.clamp(div(by - cfg.eta_min, _deta(cfg)) + 0.5, 0.5,
                           n + 0.5)
        disp = torch.floor(tarr) - idx[:, None]
        over = over | (torch.abs(disp) > cfg.advect_band)
    return over.sum()


def _step(cfg, s, solve, advect, advect_pair) -> Stam2DState:
    """One frame: decay -> source -> vel_step -> dens_step (main loop,
    js_cuda.cu:361-368), on the given Jacobi solve `solve(x, b, a, c)`,
    one-field `advect(q, uu, vv)` and two-field `advect_pair(qa, qb, uu,
    vv)`.  The state's tensors are not written."""
    widths = metric(cfg, s.u).widths

    def diffuse(x, x0, coeff):
        a = cfg.dt * coeff * cfg.n * cfg.n
        return solve(x, x0, a, 1.0 + 4.0 * a)

    d = s.d * cfg.dens_decay
    u, v, d = _add_source(cfg, s.u, s.v, d, s.step_idx)

    # vel_step (js_cuda.cu:165-182)
    u0 = diffuse(s.u0, u, cfg.visc)
    v0 = diffuse(s.v0, v, cfg.visc)
    u0, v0 = _project(cfg, u0, v0, widths, solve)
    u, v = advect_pair(u0, v0, u0, v0)
    u, v = _project(cfg, u, v, widths, solve)

    # dens_step (js_cuda.cu:184-191)
    d0 = diffuse(s.d0, d, cfg.diff)
    d = advect(d0, u, v)

    return Stam2DState(u=u, v=v, u0=u0, v0=v0, d=d, d0=d0,
                       step_idx=s.step_idx + 1, ovf=s.ovf)


def _step_torch(cfg: Stam2DConfig, s: Stam2DState) -> Stam2DState:
    """The 'torch' engine's frame step (JAX: engine 'xla')."""
    return _step(
        cfg, s,
        lambda x, b, a, c: _lin_solve(x, b, a, c, cfg.jacobi_iters),
        lambda q, uu, vv: _advect(cfg, q, uu, vv),
        lambda qa, qb, uu, vv: _advect_fields(cfg, (qa, qb), uu, vv))


@functools.lru_cache(maxsize=None)
def _cuda_step(cfg: Stam2DConfig):
    from ..kernels.stam2d_cuda import make_step_cuda

    return make_step_cuda(cfg)


def step(cfg: Stam2DConfig, s: Stam2DState) -> Stam2DState:
    """One frame step, on the engine `resolve_engine` picks for the
    state's device."""
    if resolve_engine(cfg, s.u.device) == "cuda":
        return _cuda_step(cfg)(s)
    return _step_torch(cfg, s)


def run(cfg: Stam2DConfig, s: Stam2DState, n_steps: int) -> Stam2DState:
    return run_steps(lambda st: step(cfg, st), s, n_steps)
