"""3-D Jos Stam stable fluids with reflective boundaries and isometric
splatting (port of fluidsims_tpu.solvers.stam3d).

Behavioral spec: js_cuda3d.cu — (N+2)^3 fields with an actively
maintained ghost ring via set_bnd reflections (k_set_bnd :119-157, applied
at the reference's exact points in vel_step/dens_step :333-363); 12-iter
Jacobi diffusion (a = dt*c*N^2, denom 1+6a) and pressure solves (:297-322);
trilinear semi-Lagrangian advection with backtrace clamped to [0.5, N+0.5]
(k_adv3d :192-237); density decay + orbiting 3-D source (k_decay :91-97,
k_add_source3d :99-117); ABC-flow + xorshift-noise turbulence seed
(k_seed_turbulence :365-420, seeded then projected :422-431); isometric
additive splatting with tone-map 1-exp(-gain*a) and gamma
(k_iso_accumulate :239-273, k_finalize_screen :275-295).

The state carries the full (N+2)^3 arrays, ghost rings included, so the
Jacobi solve's stale-ring semantics are those of the reference.

Engines (`resolve_engine`):

* 'cuda' — hand-written CUDA kernels (kernels/stam3d_cuda.py) for the
  Jacobi sweep, the advection and set_bnd; decay, source, divergence and
  gradient stay PyTorch ops, as they stay XLA ops in JAX's Pallas step.
  It advects by the exact trilinear gather at every `advect_k` (JAX's
  Pallas engine uses the dense-shift form, capped at K cells), and takes
  any `jacobi_iters`.  The default on a CUDA device; on CPU tensors it
  raises.
* 'torch' — `_step_torch` below, JAX's XLA engine written in PyTorch:
  the dense-shift advection for `advect_k >= 1` (exact while no backtrace
  passes K cells; `advect_capped_count` counts the cells that do), the
  exact gather at `advect_k = 0`.  The default on the CPU.
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
from ..ops.gather import gather3d
from ..ops.scalar import div

__all__ = ["Stam3DConfig", "Stam3DState", "init", "step", "run",
           "resolve_engine", "advect_capped_count", "iso_render", "set_bnd"]


@dataclass(frozen=True)
class Stam3DConfig(BaseConfig):
    n: int = 192
    dt: float = 1.0
    visc: float = 1e-5
    diff: float = 1e-6
    decay: float = 0.9
    src_gain: float = 0.25
    src_freq: float = 0.02
    seed_amp: float = 1.2
    seed_noise: float = 0.25
    seed_dens_amp: float = 0.8
    seed_sigma: float = 0.12
    jacobi_iters: int = 12
    seed: int = 1337
    # advection of the 'torch' engine: 0 = the exact per-cell gather
    # (k_adv3d); K >= 1 = the dense shift form, exact while backtrace
    # displacements stay within K cells.  The 'cuda' engine always gathers.
    advect_k: int = 2
    engine: str = "auto"   # auto | cuda | torch
    dtype: str = "float32"

    def validate(self):
        self._require(self.n >= 8, "n must be >= 8")
        self._require(self.jacobi_iters > 0, "jacobi_iters must be positive")
        self._require(0 <= self.advect_k <= 8, "advect_k must be in [0, 8]")
        self._require(self.engine in ("auto", "cuda", "torch"),
                      "engine must be auto, cuda or torch")


class Stam3DState(NamedTuple):
    # full (n+2)^3 arrays, ghost ring included; indexed [k, j, i] = (z, y, x)
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    u0: torch.Tensor
    v0: torch.Tensor
    w0: torch.Tensor
    d: torch.Tensor
    d0: torch.Tensor
    step_idx: torch.Tensor   # 0-d int32


def _interior(f):
    return f[1:-1, 1:-1, 1:-1]


def _set_interior(f, val):
    out = f.clone()
    out[1:-1, 1:-1, 1:-1] = val
    return out


def set_bnd(u, v, w, d):
    """Reflective velocity walls + copy density ghost (k_set_bnd,
    js_cuda3d.cu:119-157), as new tensors.  Index order is [z, y, x]; the
    reference's 'X faces' are the x-axis (last index).  Every face reads
    interior cells only; edges and corners are left as they are."""
    u, v, w, d = u.clone(), v.clone(), w.clone(), d.clone()
    # X faces: u reflects, others copy
    u[1:-1, 1:-1, 0] = -u[1:-1, 1:-1, 1]
    u[1:-1, 1:-1, -1] = -u[1:-1, 1:-1, -2]
    v[1:-1, 1:-1, 0] = v[1:-1, 1:-1, 1]
    v[1:-1, 1:-1, -1] = v[1:-1, 1:-1, -2]
    w[1:-1, 1:-1, 0] = w[1:-1, 1:-1, 1]
    w[1:-1, 1:-1, -1] = w[1:-1, 1:-1, -2]
    # Y faces: v reflects
    v[1:-1, 0, 1:-1] = -v[1:-1, 1, 1:-1]
    v[1:-1, -1, 1:-1] = -v[1:-1, -2, 1:-1]
    u[1:-1, 0, 1:-1] = u[1:-1, 1, 1:-1]
    u[1:-1, -1, 1:-1] = u[1:-1, -2, 1:-1]
    w[1:-1, 0, 1:-1] = w[1:-1, 1, 1:-1]
    w[1:-1, -1, 1:-1] = w[1:-1, -2, 1:-1]
    # Z faces: w reflects
    w[0, 1:-1, 1:-1] = -w[1, 1:-1, 1:-1]
    w[-1, 1:-1, 1:-1] = -w[-2, 1:-1, 1:-1]
    u[0, 1:-1, 1:-1] = u[1, 1:-1, 1:-1]
    u[-1, 1:-1, 1:-1] = u[-2, 1:-1, 1:-1]
    v[0, 1:-1, 1:-1] = v[1, 1:-1, 1:-1]
    v[-1, 1:-1, 1:-1] = v[-2, 1:-1, 1:-1]
    # density: copy on all faces
    d[1:-1, 1:-1, 0] = d[1:-1, 1:-1, 1]
    d[1:-1, 1:-1, -1] = d[1:-1, 1:-1, -2]
    d[1:-1, 0, 1:-1] = d[1:-1, 1, 1:-1]
    d[1:-1, -1, 1:-1] = d[1:-1, -2, 1:-1]
    d[0, 1:-1, 1:-1] = d[1, 1:-1, 1:-1]
    d[-1, 1:-1, 1:-1] = d[-2, 1:-1, 1:-1]
    return u, v, w, d


def _sum6(f):
    return (
        f[1:-1, 1:-1, :-2] + f[1:-1, 1:-1, 2:]
        + f[1:-1, :-2, 1:-1] + f[1:-1, 2:, 1:-1]
        + f[:-2, 1:-1, 1:-1] + f[2:, 1:-1, 1:-1]
    )


def _lin_solve(cfg, x, x0, a, c):
    """Jacobi ping-pong exactly as lin_solve (js_cuda3d.cu:297-313): only
    interiors are written, so reads alternate between the x buffer's ghost
    ring (even read iterations) and the zeroed scratch buffer's (odd).  An
    even iteration count lands in the x buffer (x's ghosts survive on the
    result); an odd one in the scratch (zero ghosts).  The division by c
    is a true division (ops/scalar.py), as in JAX."""
    x0i = _interior(x0)
    zeros = torch.zeros_like(x)
    out = x
    for it in range(cfg.jacobi_iters):
        interior = div(x0i + a * _sum6(out), c)
        # the buffer written at iteration `it` (and read at it+1):
        # even it -> the zeroed scratch, odd it -> the x buffer
        out = _set_interior(zeros if it % 2 == 0 else x, interior)
    return out


def _diffuse(cfg, x, x0, coeff, solve=_lin_solve):
    a = cfg.dt * coeff * cfg.n * cfg.n
    return solve(cfg, x, x0, a, 1.0 + 6.0 * a)


def _axes(cfg, like):
    """Cell indices 1..n as (1, 1, n), (1, n, 1), (n, 1, 1) tensors of
    like's dtype and device: x (i), y (j), z (k)."""
    idx = torch.arange(1, cfg.n + 1, dtype=like.dtype, device=like.device)
    return idx[None, None, :], idx[None, :, None], idx[:, None, None]


def _advect_dense(cfg, q0, u, v, w):
    """Dense-shift trilinear advection: with the backtrace displacement
    capped to +-K cells, the interpolation weight of source offset o is the
    hat function max(0, 1 - |x - (I+o)|), nonzero only for the two offsets
    trilinear uses, so the sum over the (2K+1)^3 shifted volumes equals the
    gather whenever |dt*u| <= K."""
    n = cfg.n
    K = cfg.advect_k
    dt_ = cfg.dt
    I, J, Kz = _axes(cfg, q0)

    def backtrace(base, vel):
        x = torch.clamp(base - dt_ * _interior(vel), 0.5, n + 0.5)
        return base + torch.clamp(x - base, -K, K)

    x = backtrace(I, u)
    y = backtrace(J, v)
    z = backtrace(Kz, w)

    def hat(pos, base, o):
        return torch.clamp(1.0 - torch.abs(pos - (base + o)), min=0.0)

    offs = list(range(-K, K + 1))
    wx = [hat(x, I, o) for o in offs]
    wy = [hat(y, J, o) for o in offs]
    wz = [hat(z, Kz, o) for o in offs]

    # edge padding by K: values at the capped range, weight 0
    e = torch.arange(-K, n + 2 + K, device=q0.device).clamp(0, n + 1)
    qp = q0[e][:, e][:, :, e]
    acc = torch.zeros((n, n, n), dtype=q0.dtype, device=q0.device)
    for iz, oz in enumerate(offs):
        for iy, oy in enumerate(offs):
            wzy = wz[iz] * wy[iy]
            for ix, ox in enumerate(offs):
                sl = qp[1 + K + oz: 1 + K + oz + n,
                        1 + K + oy: 1 + K + oy + n,
                        1 + K + ox: 1 + K + ox + n]
                acc = acc + (wzy * wx[ix]) * sl
    return _set_interior(q0, acc)


def _advect_gather(cfg, q0, u, v, w):
    """Exact trilinear semi-Lagrangian backtrace (k_adv3d,
    js_cuda3d.cu:192-237): the full array with the interior replaced
    (ring preserved)."""
    n = cfg.n
    dt_ = cfg.dt
    I, J, K = _axes(cfg, q0)
    x = torch.clamp(I - dt_ * _interior(u), 0.5, n + 0.5)
    y = torch.clamp(J - dt_ * _interior(v), 0.5, n + 0.5)
    z = torch.clamp(K - dt_ * _interior(w), 0.5, n + 0.5)

    i0 = torch.floor(x).to(torch.int32)
    j0 = torch.floor(y).to(torch.int32)
    k0 = torch.floor(z).to(torch.int32)
    sx = x - i0
    sy = y - j0
    sz = z - k0

    def g(kk, jj, ii):
        return gather3d(q0, kk, jj, ii)

    c000 = g(k0, j0, i0)
    c100 = g(k0, j0, i0 + 1)
    c010 = g(k0, j0 + 1, i0)
    c110 = g(k0, j0 + 1, i0 + 1)
    c001 = g(k0 + 1, j0, i0)
    c101 = g(k0 + 1, j0, i0 + 1)
    c011 = g(k0 + 1, j0 + 1, i0)
    c111 = g(k0 + 1, j0 + 1, i0 + 1)

    c00 = (1 - sx) * c000 + sx * c100
    c10 = (1 - sx) * c010 + sx * c110
    c01 = (1 - sx) * c001 + sx * c101
    c11 = (1 - sx) * c011 + sx * c111
    c0 = (1 - sy) * c00 + sy * c10
    c1 = (1 - sy) * c01 + sy * c11
    return _set_interior(q0, (1 - sz) * c0 + sz * c1)


def _advect(cfg, q0, u, v, w):
    """The 'torch' engine's advection: dense shift for advect_k >= 1, the
    exact gather at advect_k = 0 (JAX's _advect)."""
    if cfg.advect_k > 0:
        return _advect_dense(cfg, q0, u, v, w)
    return _advect_gather(cfg, q0, u, v, w)


def _project(cfg, u, v, w, p_init, solve=_lin_solve):
    """div -> Jacobi Poisson -> gradient subtract (project,
    js_cuda3d.cu:316-322, k_div/k_proj :170-190).  p starts from p_init
    with its interior zeroed: its ring carries over."""
    div_ = torch.zeros_like(u)
    div_[1:-1, 1:-1, 1:-1] = -0.5 * (
        (u[1:-1, 1:-1, 2:] - u[1:-1, 1:-1, :-2])
        + (v[1:-1, 2:, 1:-1] - v[1:-1, :-2, 1:-1])
        + (w[2:, 1:-1, 1:-1] - w[:-2, 1:-1, 1:-1]))
    p = _set_interior(p_init, 0.0)
    p = solve(cfg, p, div_, 1.0, 6.0)
    u = _set_interior(
        u, _interior(u) - 0.5 * (p[1:-1, 1:-1, 2:] - p[1:-1, 1:-1, :-2]))
    v = _set_interior(
        v, _interior(v) - 0.5 * (p[1:-1, 2:, 1:-1] - p[1:-1, :-2, 1:-1]))
    w = _set_interior(
        w, _interior(w) - 0.5 * (p[2:, 1:-1, 1:-1] - p[:-2, 1:-1, 1:-1]))
    return u, v, w, p


def _rand01(s: np.ndarray) -> np.ndarray:
    """The reference's xorshift32 hash to [0, 1), in float64."""
    s = s.astype(np.uint32)
    s = s ^ (s << np.uint32(13))
    s = s ^ (s >> np.uint32(17))
    s = s ^ (s << np.uint32(5))
    return s.astype(np.float64) * 2.3283064365386963e-10


def init(cfg: Stam3DConfig, device=None) -> Stam3DState:
    """ABC-flow + noise turbulence seed, then set_bnd + projection
    (seed_initial_turbulence, js_cuda3d.cu:422-431); the fields drawn in
    float64 numpy as the JAX module draws them.  `device=None` means the
    GPU (raises where there is none)."""
    if device is None:
        device = resolve_device("cuda")
    n = cfg.n
    dt = cfg.torch_dtype
    shape = (n + 2, n + 2, n + 2)

    idx = np.arange(1, n + 1)
    i = idx[None, None, :]
    j = idx[None, :, None]
    k = idx[:, None, None]
    xn = (i - 0.5) / n
    yn = (j - 0.5) / n
    zn = (k - 0.5) / n
    X = 2 * np.pi * xn
    Y = 2 * np.pi * yn
    Z = 2 * np.pi * zn
    A = cfg.seed_amp
    uu = A * np.sin(Z) + A * np.cos(Y)
    vv = A * np.sin(X) + A * np.cos(Z)
    ww = A * np.sin(Y) + A * np.cos(X)

    base = (np.uint32(cfg.seed)
            ^ (i.astype(np.uint32) * np.uint32(73856093))
            ^ (j.astype(np.uint32) * np.uint32(19349663))
            ^ (k.astype(np.uint32) * np.uint32(83492791)))
    uu = uu + cfg.seed_noise * (_rand01(base + np.uint32(0)) - 0.5)
    vv = vv + cfg.seed_noise * (_rand01(base + np.uint32(1)) - 0.5)
    ww = ww + cfg.seed_noise * (_rand01(base + np.uint32(2)) - 0.5)

    dxn = xn - 0.5
    dyn = yn - 0.5
    dzn = zn - 0.5
    r2 = dxn**2 + dyn**2 + dzn**2
    g = np.exp(-r2 / (2.0 * cfg.seed_sigma**2))
    tex = 0.5 * (np.sin(2 * X) * np.sin(2 * Y) * np.sin(2 * Z) + 1.0)
    dens = cfg.seed_dens_amp * (g + 0.35 * tex)

    def field(a):
        f = torch.zeros(shape, dtype=dt, device=device)
        f[1:-1, 1:-1, 1:-1] = torch.tensor(
            np.ascontiguousarray(np.broadcast_to(a, (n, n, n))), dtype=dt,
            device=device)
        return f

    u, v, w, d = field(uu), field(vv), field(ww), field(dens)
    u, v, w, d = set_bnd(u, v, w, d)
    u, v, w, _ = _project(cfg, u, v, w, torch.zeros(shape, dtype=dt,
                                                    device=device))
    u, v, w, d = set_bnd(u, v, w, d)

    def zeros():
        return torch.zeros(shape, dtype=dt, device=device)

    return Stam3DState(u=u, v=v, w=w, u0=zeros(), v0=zeros(), w0=zeros(),
                       d=d, d0=zeros(),
                       step_idx=torch.zeros((), dtype=torch.int32,
                                            device=device))


def _add_source(cfg, u, v, w, d, step_idx):
    """Orbiting swirl source (k_add_source3d, js_cuda3d.cu:99-117), with
    the reference's crossed assignment: u += dz / r, w += dx / r."""
    n = cfg.n
    no4 = n / 4.0
    t = cfg.src_freq * step_idx.to(u.dtype)
    i, j, k = _axes(cfg, u)
    dx = i - no4 * (1.0 + torch.cos(t))
    dy = j - no4 * (1.0 + torch.sin(t))
    dz = k - no4 * (1.0 + torch.sin(t))
    r2 = dx * dx + dy * dy + dz * dz
    inside = r2 < n
    r = torch.sqrt(r2) + 1e-7
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    d = _set_interior(d, _interior(d) + torch.where(
        inside, cfg.src_gain * torch.exp(div(-r2, n)), zero))
    u = _set_interior(u, _interior(u) + torch.where(inside, dz / r, zero))
    v = _set_interior(v, _interior(v) + torch.where(inside, dy / r, zero))
    w = _set_interior(w, _interior(w) + torch.where(inside, dx / r, zero))
    return u, v, w, d


def resolve_engine(cfg: Stam3DConfig, device) -> str:
    """The engine that steps `cfg` on `device`: 'auto' gives 'cuda' on a
    CUDA device and 'torch' on the CPU; 'cuda' on the CPU raises."""
    if cfg.engine == "torch":
        return "torch"
    if torch.device(device).type != "cuda":
        if cfg.engine == "cuda":
            raise ValueError("engine='cuda' runs the CUDA kernels and needs "
                             f"CUDA tensors, got {device}; use engine='torch'")
        return "torch"
    return "cuda"


def advect_capped_count(cfg: Stam3DConfig, s: Stam3DState) -> torch.Tensor:
    """Cells whose backtrace displacement exceeds advect_k on any axis,
    i.e. where the 'torch' engine's dense advection deviates from the exact
    gather, as a 0-d tensor; 0 at advect_k = 0 and for the 'cuda' engine,
    which always gathers.  Diagnostic only: reading it syncs."""
    if cfg.advect_k < 1 or resolve_engine(cfg, s.u.device) == "cuda":
        return torch.zeros((), dtype=torch.int64, device=s.u.device)
    n = cfg.n
    K = float(cfg.advect_k)
    capped = torch.zeros((n, n, n), dtype=torch.bool, device=s.u.device)
    for base, vel in zip(_axes(cfg, s.u), (s.u, s.v, s.w)):
        x = torch.clamp(base - cfg.dt * _interior(vel), 0.5, n + 0.5)
        capped = capped | (torch.abs(x - base) > K)
    return capped.sum()


def _step(cfg, s, solve, advect, bnd) -> Stam3DState:
    """decay -> source -> vel_step -> dens_step with the reference's exact
    set_bnd placement (js_cuda3d.cu:333-363, main loop :629-700), on the
    given Jacobi solve, advection and set_bnd."""
    d = _set_interior(s.d, _interior(s.d) * cfg.decay)
    u, v, w, d = _add_source(cfg, s.u, s.v, s.w, d, s.step_idx)

    # vel_step
    u0 = _diffuse(cfg, s.u0, u, cfg.visc, solve)
    v0 = _diffuse(cfg, s.v0, v, cfg.visc, solve)
    w0 = _diffuse(cfg, s.w0, w, cfg.visc, solve)
    u0, v0, w0, d = bnd(u0, v0, w0, d)
    u0, v0, w0, p = _project(cfg, u0, v0, w0, torch.zeros_like(u0), solve)
    u0, v0, w0, d = bnd(u0, v0, w0, d)
    u = advect(cfg, u0, u0, v0, w0)
    v = advect(cfg, v0, u0, v0, w0)
    w = advect(cfg, w0, u0, v0, w0)
    u, v, w, d = bnd(u, v, w, d)
    u, v, w, p = _project(cfg, u, v, w, p, solve)
    u, v, w, d = bnd(u, v, w, d)

    # dens_step
    d0 = _diffuse(cfg, s.d0, d, cfg.diff, solve)
    u, v, w, d0 = bnd(u, v, w, d0)
    d = advect(cfg, d0, u, v, w)
    u, v, w, d = bnd(u, v, w, d)

    return Stam3DState(u=u, v=v, w=w, u0=u0, v0=v0, w0=w0, d=d, d0=d0,
                       step_idx=s.step_idx + 1)


def _step_torch(cfg: Stam3DConfig, s: Stam3DState) -> Stam3DState:
    """The 'torch' engine's frame step (JAX: _step_xla)."""
    return _step(cfg, s, _lin_solve, _advect, set_bnd)


@functools.lru_cache(maxsize=None)
def _cuda_step(cfg: Stam3DConfig):
    from ..kernels.stam3d_cuda import make_step_cuda

    return make_step_cuda(cfg)


def step(cfg: Stam3DConfig, s: Stam3DState) -> Stam3DState:
    """One frame step, on the engine `resolve_engine` picks for the
    state's device."""
    if resolve_engine(cfg, s.u.device) == "cuda":
        return _cuda_step(cfg)(s)
    return _step_torch(cfg, s)


def iso_render(cfg: Stam3DConfig, s: Stam3DState, W: int, H: int,
               gain: float = 0.2, gamma: float = 1.2, levels: int = 256):
    """Isometric additive splat + tone map (k_iso_accumulate /
    k_finalize_screen, js_cuda3d.cu:239-295): int band indices (H, W).
    The reference's atomicAdd is an `index_add_` over the 4 corners."""
    n = cfg.n
    sproj = min(W / (2.0 * n), H / (1.5 * n))
    cx = W * 0.5
    cy = H * 0.35

    i, j, k = _axes(cfg, s.d)
    val = torch.sqrt(torch.clamp(_interior(s.d), min=0.0))
    X = (i - j) * sproj + cx
    Y = ((i + j) * 0.5 - k) * sproj + cy
    X = torch.broadcast_to(X, val.shape).reshape(-1)
    Y = torch.broadcast_to(Y, val.shape).reshape(-1)
    val = val.reshape(-1)

    x0 = torch.floor(X).to(torch.int32)
    y0 = torch.floor(Y).to(torch.int32)
    fx = X - x0
    fy = Y - y0

    zero = torch.zeros((), dtype=val.dtype, device=val.device)
    acc = torch.zeros(W * H + 1, dtype=val.dtype, device=val.device)
    for ox, oy, wgt in (
        (0, 0, (1 - fx) * (1 - fy)),
        (1, 0, fx * (1 - fy)),
        (0, 1, (1 - fx) * fy),
        (1, 1, fx * fy),
    ):
        xs = x0 + ox
        ys = y0 + oy
        ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
        flat = torch.where(ok, ys * W + xs, W * H).long()
        acc.index_add_(0, flat, torch.where(ok, val * wgt, zero))
    acc = acc[:W * H]

    y = 1.0 - torch.exp(-gain * acc)
    y = torch.clamp(y ** gamma, 0.0, 1.0)
    q = torch.clamp(torch.floor(y * levels + 0.5).to(torch.int32), 0, levels)
    return q.reshape(H, W)


def run(cfg: Stam3DConfig, s: Stam3DState, n_steps: int) -> Stam3DState:
    return run_steps(lambda st: step(cfg, st), s, n_steps)
