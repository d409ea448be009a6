"""Spatially sharded SPH: x-slabs of whole cell columns, owner buffers, a
halo of particles and migration (port of fluidsims_tpu.parallel.
sph_spatial).

parallel/sph_sharded.py splits the pair sums but keeps every particle on
every rank, so a rank's memory stays O(n).  This runner cuts the domain:
the grid's Gx cell columns are cut into D slabs of W = Gx / D columns,
and rank d owns the particles whose column lies in its slab, in a buffer
of P_cap = slack * n / D rows (spatial_common.owner_cap; an empty row has
id -1).  A substep on rank d:

  * its edge columns' particles go to the slab neighbours, and theirs come
    in: a halo of one cell column a side (a cell is 2h wide, so the 3x3
    cells of an owned particle lie in the slab and its halo).  The halo
    exchange is sized on the host, after one all-gather of the ranks'
    counts, so no particle of a halo is dropped;
  * the bin (kernel #22 on a CUDA device), the density (#14) and the
    forces and integrate (#15) run over a `Window` of cell columns, the
    slab and its halo, on the owned particles and the halo's (O(n / D)
    particles and O(G / D) cells a rank);
  * an owned particle's receivers lie among the halo's in the window's
    row-major sorted order, so the pair kernels run over the whole local
    range and the halo receivers' results are dropped; before the forces,
    the owners send back the (rho, p / rho^2) of their edge particles,
    which the halo's holders put in place of their own (a halo particle's
    3x3 cells leave the window), as JAX exchanges its rho/pressure band;
  * a particle that lies outside its rank's slab (a straggler that moved
    more than one slab a step) sits out the pair sums and integrates with
    gravity alone, as JAX's mask does;
  * then spatial_common.migrate moves the particles whose new column left
    the slab to the neighbour (a payload of (x, y, vx, vy, id)).

Trajectories match the one-device 'cuda' engine to summation order (a
cell's members keep their buffer order, the local set has its own lanes
and chunks), compared by particle id.  Rain is not supported (its
overwrite-oldest slots are global), nor XSPH (the kernels have none);
particle ids ride the float payload, so n stays below 2^24.  Capacity
overruns of the owner or migration buffers drop particles and are
counted in `lost`.

Sizing `slack`: an equal-column cut balances the volume, not the
particles; a rank's buffer needs slack >= 1 / (the share of the width
that the fluid spans); the default 4 holds a pool spanning a quarter of
the width.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import sph_cuda as sk
from ..solvers import sph as sph_mod
from .mesh import Mesh, all_gather, ppermute
from .spatial_common import gather_by_id, migrate, owner_buffers, owner_cap

__all__ = ["SpatialSPHState", "shard_state", "gather_state",
           "make_sharded_run"]

_SENT = -1.0e4   # an empty row's position, as JAX's pad position


class SpatialSPHState(NamedTuple):
    pos: torch.Tensor       # (P_cap, 2) this rank's owner buffer
    vel: torch.Tensor       # (P_cap, 2)
    ids: torch.Tensor       # (P_cap,) int32 particle id, -1 = empty row
    t: torch.Tensor         # 0-d, the same on every rank
    tau: torch.Tensor
    step_idx: torch.Tensor
    lost: torch.Tensor      # 0-d int32: particles dropped to capacity


def _slab_w(cfg, n_dev: int) -> int:
    Gx = cfg.grid().Gx
    if Gx % n_dev:
        raise ValueError(f"{Gx} cell columns not divisible by {n_dev} "
                         "devices")
    return Gx // n_dev


def _columns(cfg, pos: torch.Tensor) -> torch.Tensor:
    """Each particle's global cell column, clamped (int64)."""
    g = cfg.grid()
    cell = torch.full((), g.cell, dtype=pos.dtype, device=pos.device)
    return torch.floor(pos[:, 0] / cell).to(torch.int32).clamp(
        0, g.Gx - 1).long()


def shard_state(state: sph_mod.SPHState, cfg: sph_mod.SPHConfig, mesh: Mesh,
                axis: str = "c", slack: float = 4.0) -> SpatialSPHState:
    """This rank's owner buffer of a global SPHState (the same on every
    rank): the particles of its slab, in index order."""
    n_dev = mesh.axis_size(axis)
    (pos, vel), ids, lost = owner_buffers(
        state[:2], (_SENT, 0.0), _columns(cfg, state.pos) // _slab_w(
            cfg, n_dev), mesh, axis, owner_cap(cfg.n, n_dev, slack),
        cfg.torch_dtype)
    dev = mesh.device
    return SpatialSPHState(
        pos=pos, vel=vel, ids=ids, t=state.t.to(dev), tau=state.tau.to(dev),
        step_idx=state.step_idx.to(dev), lost=lost)


def gather_state(s: SpatialSPHState, n: int, mesh: Mesh) -> sph_mod.SPHState:
    """The global SPHState in particle order, on every rank (NaN where a
    particle was lost; rain_carry 0, as rain is off)."""
    pos, vel = gather_by_id((s.pos, s.vel), s.ids, n, mesh)
    return sph_mod.SPHState(pos=pos, vel=vel, t=s.t, tau=s.tau,
                            rain_carry=torch.zeros_like(s.t),
                            step_idx=s.step_idx)


def _first_rows(mask: torch.Tensor, count: int) -> torch.Tensor:
    """The indices of the `count` rows where `mask` holds, in order (count
    known on the host: no read back)."""
    rows = torch.arange(mask.numel(), device=mask.device)
    at = torch.cumsum(mask.to(torch.int64), 0) - 1
    dst = torch.where(mask, at, count + rows)   # the others: spare slots
    out = torch.empty(count + mask.numel(), dtype=torch.int64,
                      device=mask.device)
    out.index_copy_(0, dst, rows)
    return out[:count]


def _padded(rows: torch.Tensor, length: int) -> torch.Tensor:
    out = rows.new_zeros((length,) + rows.shape[1:])
    out[:rows.shape[0]] = rows
    return out


def make_sharded_run(cfg: sph_mod.SPHConfig, mesh: Mesh, n_steps: int,
                     axis: str = "c", slack: float = 4.0, mig_cap: int = 0):
    """run(SpatialSPHState) -> SpatialSPHState: `n_steps` steps over the
    mesh's slabs, the kernels on a CUDA device and their plain versions on
    the CPU.  Every rank calls it.  The returned function's `stats` counts
    the receivers the pair kernels took and those of the halo."""
    if cfg.rain:
        raise ValueError("spatial SPH sharding requires rain=False "
                         "(overwrite-oldest rain is global; see the module "
                         "docstring)")
    if cfg.use_xsph:
        raise ValueError("the cuda SPH engine does not implement XSPH")
    if cfg.n >= (1 << 24):
        raise ValueError("particle ids ride the float migration payload; "
                         "n must stay below 2^24")
    n_dev, d = mesh.axis_size(axis), mesh.axis_index(axis)
    W = _slab_w(cfg, n_dev)
    Gx = cfg.grid().Gx
    p_cap = owner_cap(cfg.n, n_dev, slack)
    if mig_cap <= 0:
        mig_cap = max(8, p_cap // 8)
    c0, c1 = d * W, (d + 1) * W                  # owned columns
    gx0, gx1 = max(c0 - 1, 0), min(c1 + 1, Gx)   # the window: slab + halo
    fwd = [(i, i + 1) for i in range(n_dev - 1)]
    bwd = [(i + 1, i) for i in range(n_dev - 1)]
    dtype, dev = cfg.torch_dtype, mesh.device
    fill5 = torch.tensor([_SENT, _SENT, 0.0, 0.0, -1.0], dtype=dtype,
                         device=dev)
    gravity = torch.tensor([0.0, -cfg.gravity if cfg.use_grav else 0.0],
                           dtype=dtype, device=dev)
    stats = {"receivers": 0, "halo": 0}

    def exchange(to_left, to_right):
        """(from the left neighbour, from the right one): each rank sends
        `to_left` down and `to_right` up the axis."""
        return (ppermute(to_right, mesh, axis, fwd),
                ppermute(to_left, mesh, axis, bwd))

    def substep(pos, vel, carry, dt_sub):
        ids = carry["ids"]
        alive = ids >= 0
        col = _columns(cfg, pos)
        own = alive & (col >= c0) & (col < c1)
        edge_l, edge_r = own & (col == c0), own & (col == c1 - 1)
        counts = torch.stack([own.sum(), edge_l.sum(), edge_r.sum()])
        every = torch.stack(all_gather(counts, mesh)).tolist()
        n_own, n_l, n_r = every[d]
        got_l = every[d - 1][2] if d > 0 else 0           # d-1's right edge
        got_r = every[d + 1][1] if d < n_dev - 1 else 0   # d+1's left edge
        width = max(1, max(max(r[1], r[2]) for r in every))

        # the halo: the neighbours' edge columns, (x, y, vx, vy)
        own_rows = _first_rows(own, n_own)
        rows_l, rows_r = _first_rows(edge_l, n_l), _first_rows(edge_r, n_r)
        f = torch.cat([pos, vel], 1)
        if n_dev > 1:
            from_l, from_r = exchange(_padded(f[rows_l], width),
                                      _padded(f[rows_r], width))
        else:
            from_l = from_r = f[:0]
        local = torch.cat([f[own_rows], from_l[:got_l], from_r[:got_r]])
        n_loc = n_own + got_l + got_r
        win = sk.Window(gx0, gx1 - gx0)
        stats["receivers"] += n_loc
        stats["halo"] += got_l + got_r

        if n_loc:
            b = sk.binning(cfg, local[:, :2].contiguous(),
                           local[:, 2:].contiguous(), win)
            rp = sk.density(cfg, b, win=win)
            at = torch.empty(n_loc, dtype=torch.int64, device=dev)
            at[b.order.long()] = torch.arange(n_loc, device=dev)
        else:   # nothing here; the exchanges below still take part
            rp = local.new_zeros((0, 2))
            at = torch.zeros(0, dtype=torch.int64, device=dev)
        if n_dev > 1:
            # the halo's (rho, p / rho^2) from its owners: a halo
            # particle's 3x3 cells leave the window
            slot = torch.cumsum(own.to(torch.int64), 0) - 1  # local row
            back_l, back_r = exchange(_padded(rp[at[slot[rows_l]]], width),
                                      _padded(rp[at[slot[rows_r]]], width))
            rp = rp.index_copy(0, at[n_own:],
                               torch.cat([back_l[:got_l], back_r[:got_r]]))
        if n_own:
            pos_k, vel_k = sk.forces(cfg, b, rp, dt_sub, win=win)
        else:
            pos_k = vel_k = local[:0, :2]

        # owned particles from the kernels; stragglers with gravity alone
        pos_g, vel_g = sph_mod._integrate(
            cfg, pos, vel, gravity.expand_as(pos), dt_sub)
        pos = pos_g.index_copy(0, own_rows, pos_k[:n_own])
        vel = vel_g.index_copy(0, own_rows, vel_k[:n_own])
        pos = torch.where(alive[:, None], pos, fill5[:2])
        vel = torch.where(alive[:, None], vel, fill5[2:4])

        payload = torch.cat([pos, vel, ids[:, None].to(dtype)], 1)
        final, ids, lost = migrate(
            payload, _columns(cfg, pos) // W, alive, mesh=mesh, axis=axis,
            mig_cap=mig_cap, p_cap=p_cap, fill_row=fill5)
        carry["ids"] = ids
        carry["lost"] = carry["lost"] + lost
        return final[:, :2].contiguous(), final[:, 2:4].contiguous()

    def run(s: SpatialSPHState) -> SpatialSPHState:
        for _ in range(n_steps):
            carry = {"ids": s.ids, "lost": s.lost}
            st = sph_mod._advance(
                cfg, sph_mod.SPHState(s.pos, s.vel, s.t, s.tau,
                                      torch.zeros_like(s.t), s.step_idx),
                None, lambda p, v, dt: substep(p, v, carry, dt))
            s = SpatialSPHState(pos=st.pos, vel=st.vel, ids=carry["ids"],
                                t=st.t, tau=st.tau, step_idx=st.step_idx,
                                lost=carry["lost"])
        return s

    run.stats = stats
    return run
