"""x-slab domain decomposition for the 2-D stable fluids (port of
fluidsims_tpu.parallel.stam2d_sharded), on the kernels #9 and #10.

The solver's ghost ring is a zero halo that is never written
(js_cuda.cu:317-323), so the slab exchange needs no boundary case: a
non-wrapping `mesh.ppermute` leaves zeros past the domain edges, which
are the ring.  Each rank holds the n rows and n / D columns of every
field; the step is solvers/stam2d.py::_step on those slabs:

* the Jacobi solves (`_lin_solve_sharded`) exchange `halo_k` columns
  once and run `halo_k` sweeps on the extended slab before the next
  exchange, ceil(jacobi_iters / halo_k) rounds a solve.  A round is one
  call of `kernels/stam2d_cuda.lin_solve` (#9 on CUDA tensors, its plain
  version on CPU tensors) on this rank's slab extended by the round's
  sweeps on each side that has a neighbour, an (n, n / D + kb) or (n, n /
  D + 2 kb) field: a slab edge's error creeps one column a sweep, so
  after kb sweeps it has reached exactly the exchanged columns, which are
  cropped; on a domain edge the slab is not extended, and the kernel's
  implicit zero ring is the global ring (JAX extends there too and pins
  the columns past the edge to zero every sweep: the same bits);
* the advection (`_advect_sharded`) is `kernels/stam2d_cuda.advect` (#10)
  over a `Window` of this rank's columns on the fields' slabs extended
  by `advect_halo` exchanged columns: rows stay exact, a back-trace's
  column is clamped to the slab, and the kernel adds the clamped cells,
  once per field advected, to a device int32, all-reduced into
  `state.ovf` once a step;
* decay, source, divergence and gradient are torch ops on the slab, with
  the one-device step's expressions, and the metric's columns are slices
  of the one-device tensors (solvers/stam2d.py::metric).

So every cell of a step whose back-traces stay within `advect_halo`
columns has the one-device step's bits: the 'cuda' engine's on the card,
the 'torch' engine's on the CPU.  Collectives a step at the defaults
(halo_k = 8, 40 sweeps): 5 solves x (5 rounds + 1 exchange of the
right-hand side) x 2 ppermutes, 2 projections x 2 exchanges of one
column x 2 ppermutes, 3 advected fields x 2 ppermutes, and 1 all-reduce:
74 ppermutes and 1 all-reduce.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.stepper import run_steps
from ..kernels import stam2d_cuda as s2k
from ..ops.scalar import div, rdiv
from ..solvers import stam2d as s2
from .halo import exchange_halo_x
from .mesh import Mesh, gather, psum, shard

__all__ = ["shard_state", "gather_state", "make_sharded_step",
           "make_sharded_run"]

_FIELDS = 6   # u, v, u0, v0, d, d0; then step_idx and ovf, replicated


def _exchange_x(f: torch.Tensor, halo: int, mesh: Mesh,
                axis: str) -> torch.Tensor:
    """`f` with `halo` columns from each slab neighbour, zeros past the
    domain edges (the zero ring)."""
    left, right = exchange_halo_x(f, halo, mesh, axis)
    return torch.cat([left, f, right], dim=-1)


def _sides(mesh: Mesh, axis: str) -> tuple[bool, bool]:
    """(this rank has a left neighbour, it has a right one)."""
    i = mesh.axis_index(axis)
    return i > 0, i < mesh.axis_size(axis) - 1


def _extend(f: torch.Tensor, kb: int, mesh: Mesh, axis: str) -> torch.Tensor:
    """`f` with `kb` exchanged columns on each side that has a neighbour
    (a solve round's slab)."""
    left, right = exchange_halo_x(f, kb, mesh, axis)
    lo, hi = _sides(mesh, axis)
    parts = ([left] if lo else []) + [f] + ([right] if hi else [])
    return torch.cat(parts, dim=-1) if len(parts) > 1 else f


def _lin_solve_sharded(x, b, a: float, c: float, iters: int, halo_k: int,
                       mesh: Mesh, axis: str) -> torch.Tensor:
    """`iters` Jacobi sweeps x <- (b + a sum4(x)) / c of this rank's slab,
    bitwise the one-device solve, in rounds of up to `halo_k` sweeps, one
    #9 launch each.  b is exchanged once per distinct round width (at most
    two: halo_k and the remainder), as in JAX."""
    lo, hi = _sides(mesh, axis)
    rhs = {}
    done = 0
    while done < iters:
        kb = min(halo_k, iters - done)
        if kb not in rhs:
            rhs[kb] = _extend(b, kb, mesh, axis)
        xe = s2k.lin_solve(_extend(x, kb, mesh, axis), rhs[kb], a, c, kb)
        x = xe[:, (kb if lo else 0):xe.shape[-1] - (kb if hi else 0)]
        done += kb
    return x.contiguous()


def _advect_sharded(cfg, qs: tuple, uu, vv, halo: int, col_off: int,
                    mesh: Mesh, axis: str, ovf: torch.Tensor) -> tuple:
    """The fields of qs advected by (uu, vv) over this rank's columns (#10
    over a window of `halo` exchanged columns a side); the clamped cells
    are added to ovf once per field."""
    slabs = tuple(_exchange_x(q, halo, mesh, axis) for q in qs)
    return s2k.advect(cfg, slabs, uu, vv, s2k.Window(col_off, halo), ovf)


def _project_sharded(uu, vv, widths, cols: slice, lin_solve, mesh: Mesh,
                     axis: str) -> tuple:
    """Divergence -> Jacobi Poisson -> gradient subtract on the slab, as
    solvers/stam2d.py::_project: the column neighbours by exchanges of one
    column, the rows by zero padding."""
    inv_w = rdiv(1.0, widths)
    ue = _exchange_x(uu, 1, mesh, axis)
    pv = F.pad(vv, (0, 0, 1, 1))
    dv = -0.5 * (
        (ue[:, 2:] - ue[:, :-2]) * inv_w[None, cols]
        + (pv[2:, :] - pv[:-2, :]) * inv_w[:, None]
    )
    p = lin_solve(torch.zeros_like(dv), dv, 1.0, 4.0)
    pp = F.pad(_exchange_x(p, 1, mesh, axis), (0, 0, 1, 1))
    uu = uu - 0.5 * widths[None, cols] * (pp[1:-1, 2:] - pp[1:-1, :-2])
    vv = vv - 0.5 * widths[:, None] * (pp[2:, 1:-1] - pp[:-2, 1:-1])
    return uu, vv


def _add_source_sharded(cfg, u, v, d, step_idx, col_off: int) -> tuple:
    """The orbiting swirl source (solvers/stam2d.py::_add_source) with
    global column indices."""
    n, n_loc = cfg.n, u.shape[-1]
    cx, cy, amp = s2._source_centre(cfg, step_idx, u.dtype)
    R = 3.0
    swirl = 0.6
    rows = torch.arange(1, n + 1, dtype=torch.int32, device=u.device)
    gi = torch.arange(col_off + 1, col_off + n_loc + 1, dtype=torch.int32,
                      device=u.device)
    dx = (gi[None, :] - cx).to(u.dtype)
    dy = (rows[:, None] - cy).to(u.dtype)
    r2 = dx * dx + dy * dy
    r = torch.sqrt(r2) + 1e-6
    inside = r2 < R * R
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    d = d + torch.where(inside, amp * torch.exp(div(-r2, R * R)), zero)
    u = u + torch.where(inside, -swirl * dy / r, zero)
    v = v + torch.where(inside, swirl * dx / r, zero)
    return u, v, d


def shard_state(s: s2.Stam2DState, mesh: Mesh, axis: str = "x"):
    """This rank's x-slab (columns) of the six (n, n) fields; step_idx and
    ovf replicated."""
    return s2.Stam2DState(
        *(shard(f, mesh, {axis: 1}) for f in s[:_FIELDS]),
        *(f.to(mesh.device) for f in s[_FIELDS:]))


def gather_state(s: s2.Stam2DState, mesh: Mesh, axis: str = "x"):
    """The global state, on every rank, from each rank's slab."""
    return s2.Stam2DState(*(gather(f, mesh, {axis: 1}) for f in s[:_FIELDS]),
                          *s[_FIELDS:])


def make_sharded_step(cfg: s2.Stam2DConfig, mesh: Mesh, halo_k: int = 8,
                      advect_halo: int | None = None, axis: str = "x"):
    """step(local_state) -> local_state over x-slab states (`shard_state`).
    `halo_k`: Jacobi sweeps a halo exchange (<= n / D); `advect_halo`:
    exchanged columns of the back-trace (default min(advect_band, n / D)),
    past which it is clamped and counted in `ovf`.  Every rank calls it."""
    n_dev = mesh.axis_size(axis)
    if cfg.n % n_dev:
        raise ValueError(f"n={cfg.n} must divide over {n_dev} devices")
    n_loc = cfg.n // n_dev
    if advect_halo is None:
        advect_halo = min(cfg.advect_band, n_loc)
    if not (1 <= halo_k <= n_loc and 1 <= advect_halo <= n_loc):
        raise ValueError("halos must be in [1, n/n_devices]")
    col_off = mesh.axis_index(axis) * n_loc
    cols = slice(col_off, col_off + n_loc)

    def lin_solve(x, b, a, c):
        return _lin_solve_sharded(x, b, a, c, cfg.jacobi_iters, halo_k, mesh,
                                  axis)

    def diffuse(x, x0, coeff):
        a = cfg.dt * coeff * cfg.n * cfg.n
        return lin_solve(x, x0, a, 1.0 + 4.0 * a)

    def advect(qs, uu, vv, ovf):
        return _advect_sharded(cfg, qs, uu, vv, advect_halo, col_off, mesh,
                               axis, ovf)

    def step(s: s2.Stam2DState) -> s2.Stam2DState:
        widths = s2.metric(cfg, s.u).widths
        ovf = torch.zeros((), dtype=torch.int32, device=s.u.device)
        d = s.d * cfg.dens_decay
        u, v, d = _add_source_sharded(cfg, s.u, s.v, d, s.step_idx, col_off)

        # vel_step (js_cuda.cu:165-182)
        u0 = diffuse(s.u0, u, cfg.visc)
        v0 = diffuse(s.v0, v, cfg.visc)
        u0, v0 = _project_sharded(u0, v0, widths, cols, lin_solve, mesh,
                                  axis)
        u, v = advect((u0, v0), u0, v0, ovf)
        u, v = _project_sharded(u, v, widths, cols, lin_solve, mesh, axis)

        # dens_step (js_cuda.cu:184-191)
        d0 = diffuse(s.d0, d, cfg.diff)
        (d,) = advect((d0,), u, v, ovf)

        return s2.Stam2DState(u=u, v=v, u0=u0, v0=v0, d=d, d0=d0,
                              step_idx=s.step_idx + 1,
                              ovf=s.ovf + psum(ovf, mesh))

    return step


def make_sharded_run(cfg: s2.Stam2DConfig, mesh: Mesh, n_steps: int,
                     halo_k: int = 8, advect_halo: int | None = None,
                     axis: str = "x"):
    """run(local_state) -> local_state: `n_steps` sharded steps.  Every
    rank calls it."""
    step = make_sharded_step(cfg, mesh, halo_k, advect_halo, axis)
    return lambda s: run_steps(step, s, n_steps)
