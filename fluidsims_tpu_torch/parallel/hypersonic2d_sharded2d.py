"""Multi-device 2-D hypersonic solver on a two-dimensional mesh (port of
fluidsims_tpu.parallel.hypersonic2d_sharded2d).

Generalises hypersonic2d_sharded (1-D x-slabs) to a (y, x) mesh of py x px
ranks: each rank owns an (ny/py, nx/px) block, takes HALO = 2 ghost
columns from its row neighbours and then, on the x-extended block (so the
corner ghosts come from the two exchanges in turn), HALO ghost rows from
its column neighbours, and runs the one-device step on the doubly
extended block.  Outward ghosts carry the physical boundaries: the inflow
state left of the x = 0 column of ranks, edge replication elsewhere (the
outflow clamp in x, and exactly pad_bc's edge clamp in y).  The CFL
wavespeed max is one all-reduce over every rank, which is the max over
both axes (JAX: lax.pmax over "x" then "y").
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..core.stepper import run_steps
from ..kernels import hypersonic2d_cuda as hk
from ..ops.euler2d import Cons
from ..solvers import hypersonic2d as h2
from .mesh import Mesh, gather, group_mesh, pmax, ppermute, shard

__all__ = ["HALO", "make_mesh_2d", "make_sharded_run", "shard_state",
           "gather_state"]

HALO = 2
_DIMS = {"y": 0, "x": 1}


def make_mesh_2d(px: int, py: int, device=None) -> Mesh:
    """A (y, x) mesh of py x px ranks over the initialised process group,
    ranks numbered row-major (rank = iy * px + ix)."""
    return group_mesh(("y", "x"), (py, px), device)


def shard_state(state: h2.Hypersonic2DState, mesh: Mesh):
    """This rank's (y, x) block of a global state; the time replicated."""
    return h2.Hypersonic2DState(
        U=Cons(*(shard(f, mesh, _DIMS) for f in state.U)),
        mask=shard(state.mask, mesh, _DIMS), t=state.t.to(mesh.device))


def gather_state(state: h2.Hypersonic2DState, mesh: Mesh):
    """The global state, on every rank, from each rank's block."""
    return h2.Hypersonic2DState(
        U=Cons(*(gather(f, mesh, _DIMS) for f in state.U)),
        mask=gather(state.mask, mesh, _DIMS), t=state.t)


def _extend2d(f: torch.Tensor, mesh: Mesh, left_fill: torch.Tensor):
    """A local (nyl, nxl) block with HALO ghosts on all four sides:
    neighbours' edges inside the mesh, physical fills outward."""
    px, py = mesh.axis_size("x"), mesh.axis_size("y")
    ix, iy = mesh.axis_index("x"), mesh.axis_index("y")

    lg = ppermute(f[:, -HALO:], mesh, "x", [(i, i + 1) for i in range(px - 1)])
    rg = ppermute(f[:, :HALO], mesh, "x", [(i + 1, i) for i in range(px - 1)])
    if ix == 0:
        lg = left_fill
    if ix == px - 1:
        rg = f[:, -1:].expand(f.shape[0], HALO)
    f = torch.cat([lg, f, rg], dim=1)

    # y ghosts of the x-extended block, so the corners are consistent
    bg = ppermute(f[-HALO:, :], mesh, "y", [(i, i + 1) for i in range(py - 1)])
    tg = ppermute(f[:HALO, :], mesh, "y", [(i + 1, i) for i in range(py - 1)])
    if iy == 0:
        bg = f[:1, :].expand(HALO, f.shape[1])
    if iy == py - 1:
        tg = f[-1:, :].expand(HALO, f.shape[1])
    return torch.cat([bg, f, tg], dim=0)


def make_sharded_run(cfg: h2.Hypersonic2DConfig, mesh: Mesh, n_steps: int):
    """run(local_state) -> local_state: `n_steps` steps of this rank's
    block (as `shard_state` gives it).  Every rank calls it."""
    px, py = mesh.axis_size("x"), mesh.axis_size("y")
    if cfg.nx % px or cfg.ny % py:
        raise ValueError(
            f"grid {cfg.ny}x{cfg.nx} not divisible by mesh {py}x{px}")
    nxl, nyl = cfg.nx // px, cfg.ny // py
    if nxl < HALO or nyl < HALO:
        raise ValueError("local block thinner than the halo")
    cfg_ext = replace(cfg, nx=nxl + 2 * HALO, ny=nyl + 2 * HALO)
    # the inflow reset applies at global column 0 == extended column HALO
    # on the x = 0 column of ranks
    inflow_col = HALO if mesh.axis_index("x") == 0 else -1

    def wavespeed(U, mask):
        return pmax(hk.inflow_wavespeed(cfg_ext, U, mask, inflow_col), mesh)

    def run(state: h2.Hypersonic2DState) -> h2.Hypersonic2DState:
        U, mask, t = state
        dev = mask.device
        infl = h2.inflow_cons(cfg, dev)
        mask_ext = _extend2d(
            mask, mesh, torch.zeros((nyl, HALO), dtype=torch.bool,
                                    device=dev))

        def one(carry):
            U, t = carry
            Ue = Cons(*(_extend2d(f, mesh, v.expand(nyl, HALO))
                        for f, v in zip(U, infl)))
            out = h2.step(cfg_ext, h2.Hypersonic2DState(Ue, mask_ext, t),
                          wavespeed=wavespeed)
            return (Cons(*(f[HALO:-HALO, HALO:-HALO].contiguous()
                           for f in out.U)), out.t)

        U, t = run_steps(one, (U, t), n_steps)
        return h2.Hypersonic2DState(U=U, mask=mask, t=t)

    return run
