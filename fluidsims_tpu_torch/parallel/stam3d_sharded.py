"""z-slab domain decomposition for the 3-D stable fluids (port of
fluidsims_tpu.parallel.stam3d_sharded), with the Jacobi sweeps on kernel
#11.

Unlike the 2-D solver's zero ring, the 3-D ghost ring is live: set_bnd
writes reflective ghosts (k_set_bnd, js_cuda3d.cu:119-157), and the
Jacobi ping-pong reads the ring of x before an even sweep and a zeroed
scratch's before an odd one (lin_solve, :297-313).  The (n+2)^3 fields
are padded along z to Zp = `padded_z(n, D)` slices and cut into D slabs
of B = Zp / D slices; the padded slices hold finite values that never
reach a real cell, since every z chain passes through the face gz = n + 1,
which the ring parity (Jacobi), the ring passthrough (advection) or
set_bnd rewrites first.

* `_lin_solve_sharded`: rounds of up to `halo_k` sweeps, each on a
  window of the slab and `kb` exchanged slices a side, with one #11
  launch a sweep (`kernels/stam3d_cuda.jacobi` on the window, from its
  global slice z_off - kb; its plain version on CPU tensors).  The sweeps
  ping-pong between two copies of the window whose global ring holds the
  entry buffer's ring (read by an even sweep of the solve) and zeros (an
  odd one), the parity of the global sweep index, so any `halo_k` is
  exact; the kernel writes only cells of the global interior, and a
  window end's error reaches exactly the kb cropped slices.
* The advection (the dense shift of the 'torch' engine at `advect_k`, as
  JAX's runner composes it), set_bnd, the projection and the source stay
  torch ops on the slab, with the one-device step's expressions: #12
  gathers exactly over whole volumes, with no cap, and #13 writes whole
  volumes' faces, whose z neighbour may sit on another rank.

So a step is bitwise the one-device 'torch' engine's at the same
`advect_k` wherever #11 is bitwise its plain version.  Collectives a step
at the defaults (12 sweeps, halo_k = 4): 6 solves x (3 rounds + 2
exchanges of the right-hand side and the ring) x 2 ppermutes, 2
projections x 2 exchanges of one slice x 2, 4 advections x 2, and one
ppermute of the top face's neighbour slice a set_bnd where that slice is
the first of its rank's slab (6 a step then): 76 or 82 ppermutes, no
all-reduce.
"""

from __future__ import annotations

import torch

from ..core.stepper import run_steps
from ..kernels import stam3d_cuda as s3k
from ..ops.scalar import div
from ..solvers import stam3d as s3
from .mesh import Mesh, gather, ppermute, shard

__all__ = ["padded_z", "shard_state", "unshard_state", "gather_state",
           "make_sharded_step", "make_sharded_run"]

_FIELDS = 8   # u, v, w, u0, v0, w0, d, d0; then step_idx, replicated


def padded_z(n: int, n_dev: int) -> int:
    """z extent after padding n + 2 up to a multiple of the ranks."""
    return -(-(n + 2) // n_dev) * n_dev


def _exchange_z(f: torch.Tensor, halo: int, mesh: Mesh,
                axis: str) -> torch.Tensor:
    """`f` with `halo` slices from each slab neighbour; zeros past the
    domain's ends (finite, and cut off by the ring)."""
    n = mesh.axis_size(axis)
    lower = ppermute(f[-halo:], mesh, axis,
                     [(i, i + 1) for i in range(n - 1)])
    upper = ppermute(f[:halo], mesh, axis,
                     [(i + 1, i) for i in range(n - 1)])
    return torch.cat([lower, f, upper], dim=0)


def _ring_mask(g0: int, w: int, Np: int, device) -> torch.Tensor:
    """The global ring of a window of w slices from global slice g0."""
    gz = torch.arange(g0, g0 + w, device=device)[:, None, None]
    g = torch.arange(Np, device=device)
    gy, gx = g[None, :, None], g[None, None, :]
    return ((gz == 0) | (gz == Np - 1) | (gy == 0) | (gy == Np - 1)
            | (gx == 0) | (gx == Np - 1))


def _inner(z_off: int, B: int, Np: int) -> slice:
    """The local slices of a slab of B from global slice z_off that lie in
    the global interior [1, Np - 2]."""
    return slice(max(0, 1 - z_off), max(0, min(B, Np - 1 - z_off)))


def _lin_solve_sharded(x, b, a: float, c: float, iters: int, halo_k: int,
                       Np: int, z_off: int, mesh: Mesh,
                       axis: str) -> torch.Tensor:
    """`iters` Jacobi sweeps of this rank's slab from x, bitwise
    solvers/stam3d.py::_lin_solve (even `iters`), in rounds of up to
    `halo_k` sweeps.  b and the entry buffer's ring are exchanged once per
    distinct round width (at most two), as in JAX."""
    if iters % 2:
        raise ValueError("sharded stam3d lin_solve requires even iters")
    B = x.shape[0]
    rounds = {}
    cur = x
    done = 0
    while done < iters:
        kb = min(halo_k, iters - done)
        if kb not in rounds:
            ring = _ring_mask(z_off - kb, B + 2 * kb, Np, x.device)
            rounds[kb] = (_exchange_z(b, kb, mesh, axis), ring,
                          _exchange_z(x, kb, mesh, axis))
        be, ring, xe = rounds[kb]
        ce = _exchange_z(cur, kb, mesh, axis)
        cur = _sweeps(ce, xe, be, ring, a, c, z_off - kb, done, kb)[kb:-kb]
        done += kb
    # an even total ends in the entry-ring window: x's ring on the result
    return cur.contiguous()


def _sweeps(ce, xe, be, ring, a: float, c: float, g0: int, done: int,
            kb: int, jacobi=s3k.jacobi) -> torch.Tensor:
    """Sweeps done .. done + kb - 1 of a solve on the window ce (global
    slices from g0) with right-hand side be: `jacobi` ping-pongs between a
    copy of ce whose ring (`ring`) holds the entry buffer xe's values,
    read by an even sweep, and one whose ring is zero, read by an odd one
    (the one-device ping-pong's two buffers).  Returns the buffer the last
    sweep wrote."""
    bufs = (torch.where(ring, xe, ce), torch.where(ring, 0.0, ce))
    for t in range(done, done + kb):
        jacobi(bufs[t % 2], be, bufs[1 - t % 2], a, c, g0)
    return bufs[(done + kb) % 2]


def _advect_sharded(cfg, q0, u, v, w, Np: int, z_off: int, mesh: Mesh,
                    axis: str) -> torch.Tensor:
    """solvers/stam3d.py::_advect_dense on the slab: the z window from
    `advect_k` exchanged slices a side, y and x edge-padded by K, the
    weights and the order of the sum as there.  Ring and padded slices
    pass q0 through."""
    n, K, dt_ = cfg.n, cfg.advect_k, cfg.dt
    L = _inner(z_off, q0.shape[0], Np)
    out = q0.clone()
    qe = _exchange_z(q0, K, mesh, axis)   # every rank takes part
    if L.stop <= L.start:
        return out
    e = torch.arange(-K, n + 2 + K, device=q0.device).clamp(0, n + 1)
    qp = qe[:, e][:, :, e]
    idx = torch.arange(1, n + 1, dtype=q0.dtype, device=q0.device)
    I, J = idx[None, None, :], idx[None, :, None]
    Kz = torch.arange(z_off + L.start, z_off + L.stop, dtype=q0.dtype,
                      device=q0.device)[:, None, None]

    def backtrace(base, vel):
        x = torch.clamp(base - dt_ * vel[L, 1:-1, 1:-1], 0.5, n + 0.5)
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
    m = L.stop - L.start
    acc = torch.zeros((m, n, n), dtype=q0.dtype, device=q0.device)
    for iz, oz in enumerate(offs):
        for iy, oy in enumerate(offs):
            wzy = wz[iz] * wy[iy]
            for ix, ox in enumerate(offs):
                # local slice l sits at window index l + K
                sl = qp[K + oz + L.start:K + oz + L.stop,
                        1 + K + oy:1 + K + oy + n,
                        1 + K + ox:1 + K + ox + n]
                acc = acc + (wzy * wx[ix]) * sl
    out[L, 1:-1, 1:-1] = acc
    return out


def _set_bnd_sharded(fields: tuple, Np: int, z_off: int, mesh: Mesh,
                     axis: str) -> tuple:
    """solvers/stam3d.py::set_bnd of (u, v, w, d) on the slab, as new
    tensors: every face cell from its interior neighbour, negated on a
    velocity component's own axis.  The top face's neighbour slice (global
    Np - 2) sits on the rank below when the face is a slab's first slice:
    one ppermute of the four fields' slices then."""
    B = fields[0].shape[0]
    out = [f.clone() for f in fields]
    L = _inner(z_off, B, Np)
    I = slice(1, -1)
    signs = ((-1, 1, 1), (1, -1, 1), (1, 1, -1), (1, 1, 1))
    for f, (sx, sy, _) in zip(out, signs):
        for dst, src, sign in (((L, I, 0), (L, I, 1), sx),
                               ((L, I, -1), (L, I, -2), sx),
                               ((L, 0, I), (L, 1, I), sy),
                               ((L, -1, I), (L, -2, I), sy)):
            f[dst] = -f[src] if sign < 0 else f[src]
    top_rank, top = divmod(Np - 1, B)
    below = None
    if top == 0:
        below = ppermute(torch.stack([f[-1, I, I] for f in fields]), mesh,
                         axis, [(top_rank - 1, top_rank)])
    for k, (f, (_, _, sz)) in enumerate(zip(out, signs)):
        if z_off == 0:
            f[0, I, I] = -f[1, I, I] if sz < 0 else f[1, I, I]
        if mesh.axis_index(axis) == top_rank:
            src = below[k] if top == 0 else f[top - 1, I, I]
            f[top, I, I] = -src if sz < 0 else src
    return tuple(out)


def _project_sharded(u, v, w, p_init, lin_solve, Np: int, z_off: int,
                     mesh: Mesh, axis: str) -> tuple:
    """solvers/stam3d.py::_project on the slab: the z neighbours of w and
    p by exchanges of one slice."""
    L = _inner(z_off, u.shape[0], Np)
    I = slice(1, -1)
    Lp = slice(L.start + 2, L.stop + 2)   # local slice l + 1, exchanged
    we = _exchange_z(w, 1, mesh, axis)
    div_ = torch.zeros_like(u)
    div_[L, I, I] = -0.5 * (
        (u[L, I, 2:] - u[L, I, :-2])
        + (v[L, 2:, I] - v[L, :-2, I])
        + (we[Lp, I, I] - we[L, I, I]))
    p = p_init.clone()
    p[L, I, I] = 0.0
    p = lin_solve(p, div_)
    pe = _exchange_z(p, 1, mesh, axis)
    u, v, w = u.clone(), v.clone(), w.clone()
    u[L, I, I] = u[L, I, I] - 0.5 * (p[L, I, 2:] - p[L, I, :-2])
    v[L, I, I] = v[L, I, I] - 0.5 * (p[L, 2:, I] - p[L, :-2, I])
    w[L, I, I] = w[L, I, I] - 0.5 * (pe[Lp, I, I] - pe[L, I, I])
    return u, v, w, p


def _add_source_sharded(cfg, u, v, w, d, step_idx, Np: int,
                        z_off: int) -> tuple:
    """Decay and the orbiting swirl source (solvers/stam3d.py::_step's
    decay, ::_add_source) with global z indices."""
    n = cfg.n
    L = _inner(z_off, u.shape[0], Np)
    I = slice(1, -1)
    d = d.clone()
    d[L, I, I] = d[L, I, I] * cfg.decay
    no4 = n / 4.0
    t = cfg.src_freq * step_idx.to(u.dtype)
    idx = torch.arange(1, n + 1, dtype=u.dtype, device=u.device)
    i, j = idx[None, None, :], idx[None, :, None]
    k = torch.arange(z_off + L.start, z_off + L.stop, dtype=u.dtype,
                     device=u.device)[:, None, None]
    dx = i - no4 * (1.0 + torch.cos(t))
    dy = j - no4 * (1.0 + torch.sin(t))
    dz = k - no4 * (1.0 + torch.sin(t))
    r2 = dx * dx + dy * dy + dz * dz
    inside = r2 < n
    r = torch.sqrt(r2) + 1e-7
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    u, v, w = u.clone(), v.clone(), w.clone()
    d[L, I, I] = d[L, I, I] + torch.where(
        inside, cfg.src_gain * torch.exp(div(-r2, n)), zero)
    u[L, I, I] = u[L, I, I] + torch.where(inside, dz / r, zero)
    v[L, I, I] = v[L, I, I] + torch.where(inside, dy / r, zero)
    w[L, I, I] = w[L, I, I] + torch.where(inside, dx / r, zero)
    return u, v, w, d


def shard_state(s: s3.Stam3DState, mesh: Mesh, axis: str = "x"):
    """Pad the (n+2)^3 fields along z to `padded_z` slices (zeros) and
    give this rank its z-slab; step_idx replicated."""
    zp = padded_z(s.u.shape[0] - 2, mesh.axis_size(axis))

    def place(f):
        pad = f.new_zeros((zp - f.shape[0],) + tuple(f.shape[1:]))
        return shard(torch.cat([f, pad]), mesh, {axis: 0})

    return s3.Stam3DState(*(place(f) for f in s[:_FIELDS]),
                          s.step_idx.to(mesh.device))


def unshard_state(s: s3.Stam3DState, n: int) -> s3.Stam3DState:
    """Crop the z padding back to n + 2 slices."""
    return s3.Stam3DState(*(f[:n + 2] for f in s[:_FIELDS]), s.step_idx)


def gather_state(s: s3.Stam3DState, mesh: Mesh, axis: str = "x"):
    """The global (n+2)^3 state, on every rank, from each rank's slab."""
    full = s3.Stam3DState(*(gather(f, mesh, {axis: 0}) for f in s[:_FIELDS]),
                          s.step_idx)
    return unshard_state(full, s.u.shape[1] - 2)


def make_sharded_step(cfg: s3.Stam3DConfig, mesh: Mesh, halo_k: int = 4,
                      axis: str = "x"):
    """step(local_state) -> local_state over z-slab states (`shard_state`):
    the sequence of solvers/stam3d.py::_step.  `halo_k`: Jacobi sweeps a
    halo exchange (<= Zp / D).  Every rank calls it."""
    n_dev = mesh.axis_size(axis)
    Np = cfg.n + 2
    B = padded_z(cfg.n, n_dev) // n_dev
    if cfg.jacobi_iters % 2:
        raise ValueError("sharded stam3d requires even jacobi_iters")
    if not 1 <= halo_k <= B:
        raise ValueError("halo_k must be in [1, Zp/n_devices]")
    if cfg.advect_k < 1:
        raise ValueError("sharded stam3d requires the dense advection "
                         "(advect_k >= 1)")
    if cfg.advect_k + 1 > B:
        raise ValueError("advect_k + 1 must be <= Zp/n_devices")
    z_off = mesh.axis_index(axis) * B

    def lin_solve(x, b, a, c):
        return _lin_solve_sharded(x, b, a, c, cfg.jacobi_iters, halo_k, Np,
                                  z_off, mesh, axis)

    def diffuse(x, x0, coeff):
        a = cfg.dt * coeff * cfg.n * cfg.n
        return lin_solve(x, x0, a, 1.0 + 6.0 * a)

    def advect(q0, u, v, w):
        return _advect_sharded(cfg, q0, u, v, w, Np, z_off, mesh, axis)

    def bnd(*fields):
        return _set_bnd_sharded(fields, Np, z_off, mesh, axis)

    def project(u, v, w, p_init):
        return _project_sharded(u, v, w, p_init,
                                lambda x, b: lin_solve(x, b, 1.0, 6.0), Np,
                                z_off, mesh, axis)

    def step(s: s3.Stam3DState) -> s3.Stam3DState:
        u, v, w, d = _add_source_sharded(cfg, s.u, s.v, s.w, s.d, s.step_idx,
                                         Np, z_off)

        # vel_step
        u0 = diffuse(s.u0, u, cfg.visc)
        v0 = diffuse(s.v0, v, cfg.visc)
        w0 = diffuse(s.w0, w, cfg.visc)
        u0, v0, w0, d = bnd(u0, v0, w0, d)
        u0, v0, w0, p = project(u0, v0, w0, torch.zeros_like(u0))
        u0, v0, w0, d = bnd(u0, v0, w0, d)
        u = advect(u0, u0, v0, w0)
        v = advect(v0, u0, v0, w0)
        w = advect(w0, u0, v0, w0)
        u, v, w, d = bnd(u, v, w, d)
        u, v, w, p = project(u, v, w, p)
        u, v, w, d = bnd(u, v, w, d)

        # dens_step
        d0 = diffuse(s.d0, d, cfg.diff)
        u, v, w, d0 = bnd(u, v, w, d0)
        d = advect(d0, u, v, w)
        u, v, w, d = bnd(u, v, w, d)

        return s3.Stam3DState(u=u, v=v, w=w, u0=u0, v0=v0, w0=w0, d=d, d0=d0,
                              step_idx=s.step_idx + 1)

    return step


def make_sharded_run(cfg: s3.Stam3DConfig, mesh: Mesh, n_steps: int,
                     halo_k: int = 4, axis: str = "x"):
    """run(local_state) -> local_state: `n_steps` sharded steps.  Every
    rank calls it."""
    step = make_sharded_step(cfg, mesh, halo_k, axis)
    return lambda s: run_steps(step, s, n_steps)
