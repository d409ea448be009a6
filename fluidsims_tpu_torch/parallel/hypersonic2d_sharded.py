"""Multi-device 2-D hypersonic solver: x-slab decomposition with halo
exchange (port of fluidsims_tpu.parallel.hypersonic2d_sharded).

The (ny, nx) grid is cut along x over a 1-D mesh.  Each step every rank
extends its slab by HALO = 2 exchanged columns of rho, mx, my, E (the
stencil's reach: MUSCL(1) chained through the face fluxes, and the 5-tap
diffusion), fills the outward ghosts with the physical boundaries (the
inflow state on rank 0, a constant region in which the reconstruction
gives the inflow state itself; edge replication on the last rank, which
is the outflow clamp of tau_hypersonic_cuda.cu:281-282), runs the port's
one-device step on the extended slab and crops it.

The step's two hooks carry the decomposition: `core` is the step
kernel (#1, kernels/hypersonic2d_cuda.step_core; its plain version on the
CPU) on the extended slab, and `wavespeed` the inflow + wavespeed kernel
(p1) with the inflow at global column 0, which is column HALO of rank 0's
extended slab and lies on no other rank (`inflow_col` -1), followed by an
all-reduce MAX over the mesh (JAX's `lax.pmax`).  The extended slab is a
new tensor every step, so p1's in-place inflow write never reaches the
caller's state.  The mask is static: it is exchanged once a run.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..core.stepper import run_steps
from ..kernels import hypersonic2d_cuda as hk
from ..ops.euler2d import Cons
from ..solvers import hypersonic2d as h2
from .halo import extend_with_halo_x
from .mesh import Mesh, gather, pmax, shard

__all__ = ["HALO", "make_sharded_run", "shard_state", "gather_state"]

HALO = 2  # stencil reach: MUSCL(1) through the face flux chain + diffusion(2)


def shard_state(state: h2.Hypersonic2DState, mesh: Mesh, axis: str = "x"):
    """This rank's x-slab of a global state (every rank holds the same
    one); the time is replicated."""
    dims = {axis: 1}
    return h2.Hypersonic2DState(
        U=Cons(*(shard(f, mesh, dims) for f in state.U)),
        mask=shard(state.mask, mesh, dims), t=state.t.to(mesh.device))


def gather_state(state: h2.Hypersonic2DState, mesh: Mesh, axis: str = "x"):
    """The global state, on every rank, from each rank's slab."""
    dims = {axis: 1}
    return h2.Hypersonic2DState(
        U=Cons(*(gather(f, mesh, dims) for f in state.U)),
        mask=gather(state.mask, mesh, dims), t=state.t)


def make_sharded_run(cfg: h2.Hypersonic2DConfig, mesh: Mesh, n_steps: int,
                     axis: str = "x"):
    """run(local_state) -> local_state: `n_steps` sharded steps of this
    rank's slab (as `shard_state` gives it).  Every rank calls it."""
    n_dev = mesh.axis_size(axis)
    if cfg.nx % n_dev:
        raise ValueError(f"nx={cfg.nx} not divisible by {n_dev} devices")
    nxl = cfg.nx // n_dev
    if nxl < HALO:
        raise ValueError(f"local slab {nxl} thinner than the halo {HALO}")
    cfg_ext = replace(cfg, nx=nxl + 2 * HALO)
    inflow_col = HALO if mesh.axis_index(axis) == 0 else -1

    def wavespeed(U, mask):
        return pmax(hk.inflow_wavespeed(cfg_ext, U, mask, inflow_col), mesh)

    def run(state: h2.Hypersonic2DState) -> h2.Hypersonic2DState:
        U, mask, t = state
        dev = mask.device
        infl = h2.inflow_cons(cfg, dev)
        mask_ext = extend_with_halo_x(
            mask, HALO, mesh, axis,
            torch.zeros((cfg.ny, HALO), dtype=torch.bool, device=dev))

        def one(carry):
            U, t = carry
            Ue = Cons(*(extend_with_halo_x(f, HALO, mesh, axis,
                                           v.expand(cfg.ny, HALO))
                        for f, v in zip(U, infl)))
            out = h2.step(cfg_ext, h2.Hypersonic2DState(Ue, mask_ext, t),
                          wavespeed=wavespeed)
            return (Cons(*(f[:, HALO:-HALO].contiguous() for f in out.U)),
                    out.t)

        U, t = run_steps(one, (U, t), n_steps)
        return h2.Hypersonic2DState(U=U, mask=mask, t=t)

    return run
