"""Spatially sharded MLS-MPM: x-slabs of the grid, owner buffers and
migration (port of fluidsims_tpu.parallel.mpm_spatial).

parallel/mpm_sharded.py shards the particles but sums a replicated grid,
so a rank's memory stays O(n).  This runner cuts the domain, as
flip_spatial.py does for FLIP/APIC:

  * the grid's Gx columns are cut into D slabs of W = Gx / D columns; rank
    d owns the particles whose base column (floor(px / dx - 0.5), the
    B-spline stencil's origin in solvers/mpm._step_dense) lies in its
    slab, in a buffer of P_cap = slack * n / D rows (an empty row has id
    -1);
  * the particles bin into the rank's (Gy, W, K) slab of cells;
  * grid arrays live as (Gy, W + 2H) with H = 2 halo columns: the
    quadratic B-spline reaches [0, +2] nodes from its base (tau_mpm.cu:
    138-147), so H = 2 covers the P2G and the G2P.  The P2G partial sums
    in the halo columns are added into the neighbour that owns them
    (spatial_common halo_reduce), and the updated node velocities are
    filled back (halo_fill);
  * the grid update (momentum over mass, gravity, the 3-node sticky
    bands, tau_mpm.cu:185-198) is per node, its bands in global column
    coordinates;
  * after the advection, the particles whose base column left the slab
    migrate to the neighbour (spatial_common.migrate).

No CUDA kernel runs on this path: JAX composes its cell-dense XLA engine
here, not a Pallas kernel, and so does the port, with the torch ops of its
own dense engine (solvers/mpm._step_dense).  The MPM kernels #19-#21 have
no cell capacity, so composing them would change the dense engine's
semantics (particles past a cell's K slots sit out the transfers there).

Trajectories match the one-device dense engine to summation order (the
P2G sums at a slab edge merge in another order), compared by particle id.
Capacity overruns of the owner or migration buffers drop particles and
are counted in `lost`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops import cell_dense as cd
from ..ops.scalar import div, scalar
from ..solvers import mpm
from ..solvers.mpm import MATERIALS, _bspline_w, _plastic_and_stress
from .mesh import Mesh
from .spatial_common import (gather_by_id, make_halo_ops, migrate,
                             owner_buffers, owner_cap)

__all__ = ["SpatialMPMState", "shard_state", "gather_state",
           "make_sharded_run"]

_H = 2          # grid halo columns (the one-sided [0, +2] B-spline window)
_SENT = 2.0     # an empty row's position, outside the box


class SpatialMPMState(NamedTuple):
    pos: torch.Tensor   # (P_cap, 2) this rank's owner buffer
    vel: torch.Tensor   # (P_cap, 2)
    F: torch.Tensor     # (P_cap, 4) row-major elastic F
    Jp: torch.Tensor    # (P_cap,)
    ids: torch.Tensor   # (P_cap,) int32 particle id, -1 = empty row
    lost: torch.Tensor  # 0-d int32: particles dropped to capacity


def _slab_w(cfg, n_dev: int) -> int:
    if cfg.gx % n_dev:
        raise ValueError(f"gx={cfg.gx} not divisible by {n_dev} devices")
    W = cfg.gx // n_dev
    if W < _H + 1:
        raise ValueError(f"slab width {W} must exceed the halo {_H}")
    return W


def _base_col(cfg, px: torch.Tensor) -> torch.Tensor:
    """Each particle's stencil-origin column, the owner's key (int64)."""
    return torch.clamp(torch.floor(div(px, cfg.dx) - 0.5).to(torch.int64), 0,
                       cfg.gx - 1)


def shard_state(state: mpm.MPMState, cfg: mpm.MPMConfig, mesh: Mesh,
                axis: str = "x", slack: float = 4.0) -> SpatialMPMState:
    """This rank's owner buffer of a global MPMState (the same on every
    rank); an empty row holds the identity F and Jp = 1."""
    n_dev = mesh.axis_size(axis)
    (pos, vel, F4, Jp), ids, lost = owner_buffers(
        (state.pos, state.vel, state.F.reshape(-1, 4), state.Jp),
        (_SENT, 0.0, [1.0, 0.0, 0.0, 1.0], 1.0),
        _base_col(cfg, state.pos[:, 0]) // _slab_w(cfg, n_dev), mesh, axis,
        owner_cap(cfg.n, n_dev, slack), cfg.torch_dtype)
    return SpatialMPMState(pos=pos, vel=vel, F=F4, Jp=Jp, ids=ids,
                           lost=lost)


def gather_state(s: SpatialMPMState, n: int, mesh: Mesh) -> mpm.MPMState:
    """The global MPMState in particle order, on every rank (NaN where a
    particle was lost)."""
    pos, vel, F4, Jp = gather_by_id((s.pos, s.vel, s.F, s.Jp), s.ids, n,
                                    mesh)
    return mpm.MPMState(pos=pos, vel=vel, F=F4.reshape(n, 2, 2), Jp=Jp)


def make_sharded_run(cfg: mpm.MPMConfig, mesh: Mesh, n_steps: int,
                     axis: str = "x", slack: float = 4.0, mig_cap: int = 0):
    """run(SpatialMPMState) -> SpatialMPMState: `n_steps` steps over the
    mesh's slabs.  Every rank calls it."""
    if cfg.n >= (1 << 24):
        raise ValueError("particle ids ride the float migration payload; "
                         "n must stay below 2^24")
    n_dev, d = mesh.axis_size(axis), mesh.axis_index(axis)
    W = _slab_w(cfg, n_dev)
    p_cap = owner_cap(cfg.n, n_dev, slack)
    if mig_cap <= 0:
        mig_cap = max(8, p_cap // 8)
    Gx, Gy, H = cfg.gx, cfg.gy, _H
    Wp = W + 2 * H
    K = cfg.capacity
    dx, dt = cfg.dx, cfg.dt
    c4 = 4.0 * (1.0 / dx)
    dtype, dev = cfg.torch_dtype, mesh.device
    x0 = d * W                      # the first owned grid column
    M = Gy * W
    grid = cd.DenseGrid(Gx=W, Gy=Gy, cell=dx, K=K)
    gcol = (x0 - H + torch.arange(Wp, device=dev))[None, :]
    ysi = torch.arange(Gy, device=dev)[:, None]
    zero = torch.zeros((), dtype=dtype, device=dev)
    fill10 = torch.tensor([_SENT, _SENT, 0, 0, 1, 0, 0, 1, 1, -1],
                          dtype=dtype, device=dev)
    halo_fill, halo_reduce = make_halo_ops(mesh, axis, W, H)

    def gview(g, oy, ox):
        """(Gy, Wp) grid -> (Gy, W): the values at (row + oy, owned col +
        ox)."""
        rows = cd.grid_shift(g, oy, 0) if oy else g
        return rows[:, H + ox:H + ox + W]

    def substep(pos, vel, F4, Jp, alive):
        n_loc = pos.shape[0]
        base, frac = mpm._base_frac(cfg, pos)
        bx = torch.clamp(base[:, 0], 0, Gx - 1)
        by = torch.clamp(base[:, 1], 0, Gy - 1)
        in_slab = alive & (bx >= x0) & (bx < x0 + W)
        Fe, stress = _plastic_and_stress(
            cfg, mpm.MPMState(pos, vel, F4.reshape(n_loc, 2, 2), Jp))
        m_v = cfg.particle_mass * vel

        cid = torch.where(in_slab, by * W + (bx - x0), M)
        rank, ok, _ = cd.bin_rank(grid, pos, cid=cid)
        ok = ok & in_slab
        iota = torch.arange(n_loc, dtype=torch.int64, device=dev)
        didx = torch.where(ok, cid * K + rank, M * K + iota)

        packed = torch.cat([
            frac,                                    # 0: fx, 1: fy
            m_v,                                     # 2, 3
            stress.reshape(n_loc, 4),                # 4..7
            Fe.reshape(n_loc, 4),                    # 8..11
            Jp[:, None],                             # 12
            pos,                                     # 13, 14
            torch.ones((n_loc, 1), dtype=dtype, device=dev),   # 15
        ], -1)
        dd = torch.zeros((M * K + n_loc, 16), dtype=dtype, device=dev)
        dd.index_copy_(0, didx, packed)
        dd = dd[:M * K].reshape(Gy, W, K, 16)
        occf = dd[..., 15]
        dfx, dfy = dd[..., 0], dd[..., 1]
        wxs = _bspline_w(dfx)
        wys = _bspline_w(dfy)

        # P2G into the padded local grid: node (iy + oy, l + ox), the y
        # shift zero-filled, the x offset into the halo columns; then the
        # reverse halo exchange
        mass = torch.zeros((Gy, Wp), dtype=dtype, device=dev)
        gu = torch.zeros_like(mass)
        gv = torch.zeros_like(mass)
        for ox in range(3):
            dposx = (ox - dfx) * dx
            for oy in range(3):
                dposy = (oy - dfy) * dx
                w = wxs[ox] * wys[oy] * occf
                fx = dd[..., 4] * dposx + dd[..., 5] * dposy
                fy = dd[..., 6] * dposx + dd[..., 7] * dposy

                def sh(s, oy=oy, ox=ox):
                    return F.pad(cd.grid_shift(s, -oy, 0) if oy else s,
                                 (H + ox, H - ox))

                mass = mass + sh(torch.sum(w * cfg.particle_mass, -1))
                gu = gu + sh(torch.sum(w * (dd[..., 2] + fx), -1))
                gv = gv + sh(torch.sum(w * (dd[..., 3] + fy), -1))

        mass, gu, gv = halo_reduce(torch.stack([mass, gu, gv]))

        # the grid update, its sticky bands in global coordinates
        has = mass > 0.0
        floor_mass = torch.maximum(mass, scalar(mass, 1e-30))
        gu = torch.where(has, gu / floor_mass, gu)
        gv = torch.where(has, gv / floor_mass - cfg.gravity * dt, gv)
        gu = torch.where(has & (((gcol < 3) & (gu < 0))
                                | ((gcol > Gx - 4) & (gu > 0))), zero, gu)
        gv = torch.where(has & (((ysi < 3) & (gv < 0))
                                | ((ysi > Gy - 4) & (gv > 0))), zero, gv)
        gu, gv = halo_fill(torch.stack([torch.where(has, gu, zero),
                                        torch.where(has, gv, zero)]))

        # G2P from the halo-filled grid
        nvx = torch.zeros_like(dfx)
        nvy = torch.zeros_like(dfx)
        C00, C01, C10, C11 = (torch.zeros_like(dfx) for _ in range(4))
        for ox in range(3):
            dposx = (ox - dfx) * dx
            for oy in range(3):
                dposy = (oy - dfy) * dx
                w = wxs[ox] * wys[oy] * occf
                gvx = gview(gu, oy, ox)[:, :, None]
                gvy = gview(gv, oy, ox)[:, :, None]
                nvx = nvx + w * gvx
                nvy = nvy + w * gvy
                C00 = C00 + c4 * w * gvx * dposx
                C01 = C01 + c4 * w * gvx * dposy
                C10 = C10 + c4 * w * gvy * dposx
                C11 = C11 + c4 * w * gvy * dposy

        f00, f01, f10, f11 = dd[..., 8], dd[..., 9], dd[..., 10], dd[..., 11]
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
        Jp2 = torch.clamp(dd[..., 12] * oldJ / newJ, scalar(dfx, 0.05),
                          scalar(dfx, 20.0))
        lo = scalar(dfx, 2.0 * dx)
        nx_ = torch.clamp(dd[..., 13] + dt * nvx, lo,
                          scalar(dfx, (Gx - 3.0) * dx))
        ny_ = torch.clamp(dd[..., 14] + dt * nvy, lo,
                          scalar(dfx, (Gy - 3.0) * dx))

        dense_out = torch.stack([nx_, ny_, nvx, nvy, n00, n01, n10, n11,
                                 Jp2], -1)
        got = dense_out.reshape(M * K, 9)[torch.clamp(didx, 0, M * K - 1)]
        old = torch.cat([pos, vel, F4, Jp[:, None]], -1)
        return torch.where(ok[:, None], got, old)

    def one(s: SpatialMPMState) -> SpatialMPMState:
        alive = s.ids >= 0
        out = substep(s.pos, s.vel, s.F, s.Jp, alive)
        # migration across the slab boundaries, the stencil's base column
        # formed as the step forms it
        bx = torch.clamp(torch.floor(out[:, 0] * (1.0 / dx) - 0.5).to(
            torch.int64), 0, Gx - 1)
        payload = torch.cat([out, s.ids[:, None].to(dtype)], 1)
        final, ids, lost = migrate(
            payload, bx // W, alive, mesh=mesh, axis=axis, mig_cap=mig_cap,
            p_cap=p_cap, fill_row=fill10)
        return SpatialMPMState(
            pos=final[:, 0:2].contiguous(), vel=final[:, 2:4].contiguous(),
            F=final[:, 4:8].contiguous(), Jp=final[:, 8].contiguous(),
            ids=ids, lost=s.lost + lost)

    def run(s: SpatialMPMState) -> SpatialMPMState:
        for _ in range(n_steps):
            s = one(s)
        return s

    return run
