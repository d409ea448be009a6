"""Spatially sharded FLIP/APIC: x-slabs of the grid, owner buffers and
migration (port of fluidsims_tpu.parallel.flip_spatial).

parallel/flip_sharded.py shards the particles but sums a replicated grid,
so a rank's memory stays O(n) and every rank solves the whole pressure
field.  This runner cuts the domain, as sph_spatial.py does:

  * the grid's n columns are cut into D slabs of W = n / D columns; rank
    d owns the particles whose base column (floor(px (n - 1)), the
    binning cell of solvers/flip_apic._step_dense) lies in its slab, in a
    buffer of P_cap = slack * particles / D rows (an empty row has id -1),
    and the (n, W) columns of the grid;
  * the particles bin into the rank's (n, W, K) slab of cells;
  * every grid array lives as (n, W + 2H) with H = 3 halo columns: the P2G
    partial sums that fall in a halo column are added into the neighbour
    that owns it (spatial_common halo_reduce), then the mass and momentum
    halos are filled from the owners (halo_fill);
  * the Jacobi pressure solve exchanges an H-wide band of the pressure
    every H sweeps and recomputes the eroding halo in between
    (ceil(jacobi / 3) exchanges, 16 at 48 sweeps, not 48);
  * the G2P (its +-h affine samples reach +-2 columns) reads the filled
    halos;
  * after the advection, the particles whose base column left the slab
    migrate to the neighbour (spatial_common.migrate), and the density
    raster of the owned columns is summed across the slab edges.

No CUDA kernel runs on this path: JAX composes its cell-dense XLA engine
here, not a Pallas kernel, and so does the port, with the torch ops of its
own dense engine (solvers/flip_apic._step_dense).  The FLIP kernels #16-#18
have no cell capacity, so composing them would change the dense engine's
semantics (particles past a cell's K slots sit out the transfers there).

Trajectories match the one-device dense engine to summation order (a
cell's slots follow the buffer order, the P2G sums at a slab edge merge
in another order, the Jacobi adds its neighbours in JAX's spatial order),
compared by particle id.  Capacity overruns of the owner or migration
buffers drop particles and are counted in `lost`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops import cell_dense as cd
from ..ops.scalar import div, scalar
from ..solvers import flip_apic as fa
from ..solvers.flip_apic import _gshift, _w1
from .mesh import Mesh, all_gather
from .spatial_common import (gather_by_id, make_halo_ops, migrate,
                             owner_buffers, owner_cap)

__all__ = ["SpatialFlipState", "shard_state", "gather_state",
           "make_sharded_run"]

_H = 3          # grid halo columns (covers the +-2 G2P affine window)
_SENT = 2.0     # an empty row's position, outside the box


class SpatialFlipState(NamedTuple):
    pos: torch.Tensor       # (P_cap, 2) this rank's owner buffer
    vel: torch.Tensor       # (P_cap, 2)
    affine_x: torch.Tensor  # (P_cap, 2)
    affine_y: torch.Tensor  # (P_cap, 2)
    ids: torch.Tensor       # (P_cap,) int32 particle id, -1 = empty row
    density: torch.Tensor   # (n, W) int32, the raster's owned columns
    lost: torch.Tensor      # 0-d int32: particles dropped to capacity


def _slab_w(cfg, n_dev: int) -> int:
    n = cfg.grid
    if n % n_dev:
        raise ValueError(f"grid={n} not divisible by {n_dev} devices")
    W = n // n_dev
    if W < _H + 1:
        raise ValueError(f"slab width {W} must exceed the halo {_H}")
    return W


def _base_col(cfg, px: torch.Tensor) -> torch.Tensor:
    """Each particle's base grid column, the owner's key (int64)."""
    n = cfg.grid
    return torch.clamp(torch.floor(px * (n - 1)).to(torch.int64), 0, n - 1)


def shard_state(state: fa.FlipApicState, cfg: fa.FlipApicConfig, mesh: Mesh,
                axis: str = "x", slack: float = 4.0) -> SpatialFlipState:
    """This rank's owner buffer of a global FlipApicState (the same on
    every rank), and a zero raster of its columns."""
    n_dev = mesh.axis_size(axis)
    W = _slab_w(cfg, n_dev)
    (pos, vel, ax, ay), ids, lost = owner_buffers(
        state[:4], (_SENT, 0.0, 0.0, 0.0),
        _base_col(cfg, state.pos[:, 0]) // W, mesh, axis,
        owner_cap(cfg.particles, n_dev, slack), cfg.torch_dtype)
    return SpatialFlipState(
        pos=pos, vel=vel, affine_x=ax, affine_y=ay, ids=ids,
        density=torch.zeros((cfg.grid, W), dtype=torch.int32,
                            device=mesh.device), lost=lost)


def gather_state(s: SpatialFlipState, n: int, mesh: Mesh) -> fa.FlipApicState:
    """The global FlipApicState in particle order, on every rank: NaN where
    a particle was lost; the raster's slabs side by side."""
    pos, vel, ax, ay = gather_by_id((s.pos, s.vel, s.affine_x, s.affine_y),
                                    s.ids, n, mesh)
    return fa.FlipApicState(pos=pos, vel=vel, affine_x=ax, affine_y=ay,
                            density=torch.cat(all_gather(s.density, mesh),
                                              1))


def _bin_slab(grid: cd.DenseGrid, pos, cid, in_slab) -> cd.DenseCells:
    """cd.bin_particles over the slab's cells, the particles outside it
    (cid = M) left out."""
    n_p = pos.shape[0]
    M, K = grid.Gx * grid.Gy, grid.K
    order, sc, slot = cd.sort_by_cell(grid, pos, cid)
    ok_sorted = (slot < K) & (sc < M)
    # the dropped ones take spare slots past M * K, one each (one for all
    # would serialise their writes on the card)
    didx_sorted = torch.where(ok_sorted, sc * K + slot, M * K + order)
    didx = torch.empty_like(didx_sorted)
    didx[order] = didx_sorted
    ok = torch.empty_like(ok_sorted)
    ok[order] = ok_sorted
    inv = torch.full((M * K + n_p,), n_p, dtype=torch.int64,
                     device=pos.device)
    inv[didx_sorted] = order
    inv = inv[:M * K]
    occ = (inv < n_p).reshape(grid.Gy, grid.Gx, K)
    return cd.DenseCells(didx=didx, ok=ok & in_slab, occ=occ,
                         overflow=n_p - ok.sum(), inv=inv)


def make_sharded_run(cfg: fa.FlipApicConfig, mesh: Mesh, n_steps: int,
                     axis: str = "x", slack: float = 4.0, mig_cap: int = 0):
    """run(SpatialFlipState) -> SpatialFlipState: `n_steps` steps over the
    mesh's slabs.  Every rank calls it."""
    if cfg.particles >= (1 << 24):
        raise ValueError("particle ids ride the float migration payload; "
                         "particles must stay below 2^24")
    n_dev, d = mesh.axis_size(axis), mesh.axis_index(axis)
    W = _slab_w(cfg, n_dev)
    p_cap = owner_cap(cfg.particles, n_dev, slack)
    if mig_cap <= 0:
        mig_cap = max(8, p_cap // 8)
    n, H = cfg.grid, _H
    Wp = W + 2 * H
    K = cfg.capacity
    dt = cfg.dt
    dtype, dev = cfg.torch_dtype, mesh.device
    h = 1.0 / (n - 1)
    x0 = d * W                      # the first owned grid/cell column
    M = n * W
    grid = cd.DenseGrid(Gx=W, Gy=n, cell=1.0, K=K)

    # global coordinates of the local columns (pads included)
    gcol = x0 - H + torch.arange(Wp, device=dev)
    row = torch.arange(n, device=dev)
    edge_col = (gcol == 0) | (gcol == n - 1)
    edge_row = (row == 0) | (row == n - 1)
    ginterior = ((~edge_row[:, None]) & (~edge_col[None, :])
                 & (gcol >= 0)[None, :] & (gcol <= n - 1)[None, :])
    ix = (torch.arange(W, device=dev) + x0).to(dtype)[None, :, None]
    iy = row.to(dtype)[:, None, None]
    mx0 = 1.0 + (ix == 0).to(dtype) + (ix == n - 1).to(dtype)
    my0 = 1.0 + (iy == 0).to(dtype) + (iy == n - 1).to(dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)
    fill9 = torch.tensor([_SENT, _SENT] + [0.0] * 6 + [-1.0], dtype=dtype,
                         device=dev)

    halo_fill, halo_reduce = make_halo_ops(mesh, axis, W, H)

    def gview(g, oy, ox):
        """(n, Wp) grid -> (n, W): the values at (row + oy, owned col +
        ox)."""
        rows = _gshift(g, oy, 0) if oy else g
        return rows[:, H + ox:H + ox + W]

    def sum4(p):
        return (_gshift(p, 0, -1) + _gshift(p, 0, 1)
                + _gshift(p, -1, 0) + _gshift(p, 1, 0))

    def substep(pos, vel, ax, ay, alive):
        px, py = pos[:, 0], pos[:, 1]
        gxp = px * (n - 1)
        gyp = py * (n - 1)
        bxp = torch.clamp(torch.floor(gxp).to(torch.int64), 0, n - 1)
        byp = torch.clamp(torch.floor(gyp).to(torch.int64), 0, n - 1)
        in_slab = alive & (bxp >= x0) & (bxp < x0 + W)
        cid = torch.where(in_slab, byp * W + (bxp - x0), M)
        cells = _bin_slab(grid, pos, cid, in_slab)

        # one scatter of the 14 channels into the (n, W, K) slab
        packed = torch.stack([
            gxp, gyp, vel[:, 0], vel[:, 1], ax[:, 0], ax[:, 1],
            ay[:, 0], ay[:, 1], px, py,
            (px + h) * (n - 1), (px - h) * (n - 1),
            (py + h) * (n - 1), (py - h) * (n - 1)], -1)
        dall = cd.scatter_field(grid, cells, packed)
        dgx, dgy = dall[..., 0], dall[..., 1]
        dvx, dvy = dall[..., 2], dall[..., 3]
        dax, day = dall[..., 4:6], dall[..., 6:8]
        dpx, dpy = dall[..., 8], dall[..., 9]
        occf = cells.occ.to(dtype)

        # P2G into the padded local grid, then the reverse halo exchange
        mass = torch.zeros((n, Wp), dtype=dtype, device=dev)
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
                vvx = dvx + cfg.apic * (dax[..., 0] * rx + day[..., 0] * ry)
                vvy = dvy + cfg.apic * (dax[..., 1] * rx + day[..., 1] * ry)

                def sh(s, oy=oy, ox=ox):
                    return F.pad(_gshift(s, -oy, 0) if oy else s,
                                 (H + ox, H - ox))

                mass = mass + sh(torch.sum(wt, -1))
                mom_u = mom_u + sh(torch.sum(wt * vvx, -1))
                mom_v = mom_v + sh(torch.sum(wt * vvy, -1))

        mass, u, v = halo_fill(halo_reduce(torch.stack([mass, mom_u,
                                                        mom_v])))

        # the grid phase on (n, Wp), masks in global coordinates
        has_mass = mass > 1e-8
        floor_mass = torch.clamp_min(mass, 1e-8)
        u = torch.where(has_mass, u / floor_mass, u)
        v = torch.where(has_mass, v / floor_mass - cfg.gravity * dt, v)
        u = torch.where(edge_col[None, :], zero, u)
        v = torch.where(edge_row[:, None], zero, v)
        u_prev, v_prev = u, v

        dv = torch.where(
            ginterior,
            -0.5 * (n - 1) * (_gshift(u, 0, 1) - _gshift(u, 0, -1)
                              + _gshift(v, 1, 0) - _gshift(v, -1, 0)), zero)

        # banded Jacobi: H sweeps a pressure-halo exchange
        p = torch.zeros_like(u)
        left = cfg.jacobi
        while left > 0:
            p = halo_fill(p)
            for _ in range(min(H, left)):
                p = torch.where(ginterior, 0.25 * (dv + sum4(p)), zero)
            left -= H
        p = halo_fill(p)          # the whole width for the projection

        u_proj = torch.where(
            ginterior,
            u - div(0.5 * (_gshift(p, 0, 1) - _gshift(p, 0, -1)), n - 1),
            zero)
        v_proj = torch.where(
            ginterior,
            v - div(0.5 * (_gshift(p, 1, 0) - _gshift(p, -1, 0)), n - 1),
            zero)

        # G2P from the halo-filled grid
        def sample(gu, gv, sx, sy, wxs, wys):
            su = torch.zeros_like(sx)
            sv = torch.zeros_like(sx)
            for oy in wys:
                wy = _w1(sy - (iy + oy))
                for ox in wxs:
                    w = _w1(sx - (ix + ox)) * wy
                    su = su + w * gview(gu, oy, ox)[:, :, None]
                    sv = sv + w * gview(gv, oy, ox)[:, :, None]
            return su, sv

        lo, hi = scalar(dgx, 0.0), scalar(dgx, n - 1.001)
        cgx, cgy, cxp, cxm, cyp, cym = (
            torch.clamp(a, lo, hi) for a in (
                dgx, dgy, dall[..., 10], dall[..., 11], dall[..., 12],
                dall[..., 13]))

        C = (0, 1)
        W5 = (-2, -1, 0, 1, 2)
        new_u, new_v = sample(u_proj, v_proj, cgx, cgy, C, C)
        old_u, old_v = sample(u_prev, v_prev, cgx, cgy, C, C)
        flip_u = dvx + new_u - old_u
        flip_v = dvy + new_v - old_v
        vel_x = (1 - cfg.flip) * new_u + cfg.flip * flip_u
        vel_y = (1 - cfg.flip) * new_v + cfg.flip * flip_v

        ux1, vx1 = sample(u_proj, v_proj, cxp, cgy, W5, C)
        ux0, vx0 = sample(u_proj, v_proj, cxm, cgy, W5, C)
        uy1, vy1 = sample(u_proj, v_proj, cgx, cyp, C, W5)
        uy0, vy0 = sample(u_proj, v_proj, cgx, cym, C, W5)
        nax_x = div(0.5 * (ux1 - ux0), h)
        nax_y = div(0.5 * (vx1 - vx0), h)
        nay_x = div(0.5 * (uy1 - uy0), h)
        nay_y = div(0.5 * (vy1 - vy0), h)

        nx_ = dpx + vel_x * dt
        ny_ = dpy + vel_y * dt
        hit_x = (nx_ < 0.01) | (nx_ > 0.99)
        hit_y = (ny_ < 0.01) | (ny_ > 0.99)
        vel_x = torch.where(hit_x, vel_x * -0.35, vel_x)
        vel_y = torch.where(hit_y, vel_y * -0.35, vel_y)
        lo, hi = scalar(nx_, 0.01), scalar(nx_, 0.99)
        nx_ = torch.clamp(nx_, lo, hi)
        ny_ = torch.clamp(ny_, lo, hi)

        dense_out = torch.stack(
            [nx_, ny_, vel_x, vel_y, nax_x, nax_y, nay_x, nay_y], -1)
        got = dense_out.reshape(M * K, 8)[cells.didx.clamp(0, M * K - 1)]
        old = torch.cat([pos, vel, ax, ay], -1)
        return torch.where(cells.ok[:, None], got, old)

    def one(s: SpatialFlipState) -> SpatialFlipState:
        alive = s.ids >= 0
        out = substep(s.pos, s.vel, s.affine_x, s.affine_y, alive)

        # migration across the slab boundaries
        payload = torch.cat([out, s.ids[:, None].to(dtype)], 1)
        final, ids, lost = migrate(
            payload, _base_col(cfg, out[:, 0]) // W, alive, mesh=mesh,
            axis=axis, mig_cap=mig_cap, p_cap=p_cap, fill_row=fill9)
        pos = final[:, 0:2].contiguous()

        # the density raster of the owned columns (k_g2p's raster)
        rx = torch.clamp((pos[:, 0] * n).to(torch.int32), 0, n - 1).long()
        ry = torch.clamp((pos[:, 1] * n).to(torch.int32), 0, n - 1).long()
        cl = rx - x0 + H
        okr = (ids >= 0) & (cl >= 0) & (cl < Wp)
        spare = n * Wp + torch.arange(p_cap, device=dev)   # one a row
        flat = torch.where(okr, ry * Wp + cl, spare)
        dloc = torch.zeros(n * Wp + p_cap, dtype=torch.int32, device=dev)
        dloc.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
        dloc = halo_reduce(dloc[:n * Wp].reshape(n, Wp))
        return SpatialFlipState(
            pos=pos, vel=final[:, 2:4].contiguous(),
            affine_x=final[:, 4:6].contiguous(),
            affine_y=final[:, 6:8].contiguous(), ids=ids,
            density=dloc[:, H:H + W].contiguous(), lost=s.lost + lost)

    def run(s: SpatialFlipState) -> SpatialFlipState:
        for _ in range(n_steps):
            s = one(s)
        return s

    return run
