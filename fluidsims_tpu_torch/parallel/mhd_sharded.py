"""Multi-device GLM-MHD: x-slab decomposition with clamped-edge halos
(port of fluidsims_tpu.parallel.mhd_sharded).

The MHD domain has fixed edges: the reference computes fluxes only on the
interior face band (tau_mhd.c:164-167), and its slope and shift reads
clamp at the walls.  Each rank extends its slab by HALO = 2 exchanged
columns; the first and last rank replicate their edge column outward,
which reproduces the one-device step's clamped reads exactly.  The
interior face band is given to the step in global columns (its
`face_masks` hook), `dxdy` keeps the global cell size, and the dt / ch
fast-speed max is an all-reduce MAX over the mesh, so the sharded run is
bitwise the one-device plain one.

The step is the plain one, on whatever device the mesh has: the
one-device CUDA engine is a cooperative K-step kernel (#8) that forms dt
inside the launch and cannot wait for a max over ranks (JAX's sharded
runner steps in XLA too).
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..core.stepper import run_steps
from ..solvers import mhd
from ..solvers.mhd import ConsM
from .halo import extend_with_halo_x
from .mesh import Mesh, gather, pmax, shard

__all__ = ["HALO", "make_sharded_run", "shard_state", "gather_state"]

HALO = 2  # MC slopes (1) chained through the face flux + pair update


def shard_state(state: mhd.MHDState, mesh: Mesh, axis: str = "x"):
    """This rank's x-slab of the conserved fields; t replicated."""
    return mhd.MHDState(U=ConsM(*(shard(f, mesh, {axis: 1})
                                  for f in state.U)),
                        t=state.t.to(mesh.device))


def gather_state(state: mhd.MHDState, mesh: Mesh, axis: str = "x"):
    """The global state, on every rank, from each rank's slab."""
    return mhd.MHDState(U=ConsM(*(gather(f, mesh, {axis: 1})
                                  for f in state.U)), t=state.t)


def _face_masks(cfg: mhd.MHDConfig, x0: int, nx_ext: int, device):
    """The interior face bands (mhd.default_face_masks) of an extended
    slab whose column 0 is global column x0 - HALO."""
    ny = cfg.ny
    gx = x0 + torch.arange(nx_ext, device=device) - HALO
    y = torch.arange(ny, device=device)[:, None]
    mx_face = ((y >= 1) & (y < ny - 1)) & ((gx >= 1) & (gx < cfg.nx - 2))
    my_face = ((y >= 1) & (y < ny - 2)) & ((gx >= 1) & (gx < cfg.nx - 1))
    return mx_face, my_face


def make_sharded_run(cfg: mhd.MHDConfig, mesh: Mesh, n_steps: int,
                     axis: str = "x"):
    """run(local_state) -> local_state: `n_steps` plain steps of this
    rank's slab.  Every rank calls it."""
    n_dev = mesh.axis_size(axis)
    if cfg.nx % n_dev:
        raise ValueError(f"nx={cfg.nx} not divisible by {n_dev} devices")
    nxl = cfg.nx // n_dev
    if nxl < HALO:
        raise ValueError(f"local slab thinner than halo {HALO}")
    cfg_ext = replace(cfg, nx=nxl + 2 * HALO)
    dxdy = (1.0 / cfg.nx, 1.0 / cfg.ny)
    x0 = mesh.axis_index(axis) * nxl

    def reduce(v):
        return pmax(v, mesh)

    def run(state: mhd.MHDState) -> mhd.MHDState:
        faces = _face_masks(cfg, x0, cfg_ext.nx, state.t.device)

        def one(s: mhd.MHDState) -> mhd.MHDState:
            Ue = ConsM(*(extend_with_halo_x(f, HALO, mesh, axis)
                         for f in s.U))
            out = mhd.step(cfg_ext, mhd.MHDState(U=Ue, t=s.t),
                           wavespeed_reduce=reduce, face_masks=faces,
                           dxdy=dxdy)
            return mhd.MHDState(
                U=ConsM(*(f[:, HALO:-HALO].contiguous() for f in out.U)),
                t=out.t)

        return run_steps(one, state, n_steps)

    return run
