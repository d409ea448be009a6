"""Multi-device 3-D hypersonic solver: z-slab decomposition with halo
exchange (port of fluidsims_tpu.parallel.hypersonic3d_sharded).

The 3-D domain is periodic in y and z (tau_hypersonic_3d_cuda.cu:729-730);
cut along z, the ring of ranks is the periodic wrap: each step every rank
takes HALO = 3 (WENO5's reach) z-slices from each ring neighbour, runs
the one-device step on the extended slab and crops it.  The solid mask is
exchanged like the fields, and the step's halo-3 padded mask is built
from a ring exchange of 2 * HALO slices, the y wrap and False x pads
(the geometry must not touch the x boundaries, as for the JAX runner).
The mask is static, so both are built once a run.

Through the port's step hooks: `core` is the step kernel (#2) on the
extended slab; `wavespeed` the masked max-wavespeed kernel (p2) on this
rank's own slices of the step's result (the cropped slab, so the halo
cells, which the step computes from the extended slab's wrap, take no
part), and `wavespeed_reduce` an all-reduce MAX over the mesh (the
cross-device analog of the reference's atomicMax, :523-532), so every
rank feeds the same max to the τ-clock's dτ controller.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..core.stepper import run_steps
from ..kernels import hypersonic3d_cuda as hk3
from ..solvers import hypersonic3d as h3
from ..solvers.hypersonic3d import HALO, PrimT
from .mesh import Mesh, gather, pmax, ppermute, shard

__all__ = ["shard_state", "gather_state", "make_sharded_run"]

_FIELDS = ("xi", "phix", "phiy", "phiz", "lam", "zet")


def shard_state(state: h3.Hypersonic3DState, mesh: Mesh, axis: str = "z"):
    """This rank's z-slab (first axis) of a global state; t and dtau
    replicated."""
    dims = {axis: 0}
    kw = {k: shard(getattr(state, k), mesh, dims) for k in _FIELDS}
    return h3.Hypersonic3DState(
        **kw, solid=shard(state.solid, mesh, dims),
        t=state.t.to(mesh.device), dtau=state.dtau.to(mesh.device))


def gather_state(state: h3.Hypersonic3DState, mesh: Mesh, axis: str = "z"):
    """The global state, on every rank, from each rank's slab."""
    dims = {axis: 0}
    kw = {k: gather(getattr(state, k), mesh, dims) for k in _FIELDS}
    return h3.Hypersonic3DState(**kw, solid=gather(state.solid, mesh, dims),
                                t=state.t, dtau=state.dtau)


def _exchange_z(f: torch.Tensor, mesh: Mesh, axis: str, halo: int = HALO):
    """`f` with `halo` slices from each ring neighbour along z."""
    n = mesh.axis_size(axis)
    top = ppermute(f[-halo:], mesh, axis,
                   [(i, (i + 1) % n) for i in range(n)])
    bot = ppermute(f[:halo], mesh, axis,
                   [(i, (i - 1) % n) for i in range(n)])
    return torch.cat([top, f, bot], dim=0)


def _solid_pad(solid: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The halo-3 padded mask of the extended slab, z in [-2H, nzl + 2H):
    a 2 * HALO ring exchange, then y wrapped and x padded with False."""
    sp = _exchange_z(solid, mesh, axis, 2 * HALO)
    sp = torch.cat([sp[:, -HALO:, :], sp, sp[:, :HALO, :]], dim=1)
    zf = torch.zeros((sp.shape[0], sp.shape[1], HALO), dtype=torch.bool,
                     device=sp.device)
    return torch.cat([zf, sp, zf], dim=2)


def make_sharded_run(cfg: h3.Hypersonic3DConfig, mesh: Mesh, n_steps: int,
                     axis: str = "z"):
    """run(local_state) -> local_state: `n_steps` steps of this rank's
    slab (as `shard_state` gives it).  Every rank calls it."""
    n_dev = mesh.axis_size(axis)
    if cfg.nz % n_dev:
        raise ValueError(f"nz={cfg.nz} not divisible by {n_dev} devices")
    nzl = cfg.nz // n_dev
    if nzl < 2 * HALO:
        raise ValueError(
            f"slab ({nzl}) thinner than 2*WENO halo ({2 * HALO})")
    cfg_ext = replace(cfg, nz=nzl + 2 * HALO)
    cfg_local = replace(cfg, nz=nzl)

    def wavespeed(q1: PrimT, solid: torch.Tensor) -> torch.Tensor:
        return hk3.wavespeed(cfg_local, PrimT(*(f[HALO:-HALO] for f in q1)),
                             solid[HALO:-HALO])

    def reduce(v):
        return pmax(v, mesh)

    def run(state: h3.Hypersonic3DState) -> h3.Hypersonic3DState:
        solid, t, dtau = state.solid, state.t, state.dtau
        solid_ext = _exchange_z(solid, mesh, axis)
        solid_pad = _solid_pad(solid, mesh, axis)

        def one(carry):
            fields, t, dtau = carry
            ext = [_exchange_z(f, mesh, axis) for f in fields]
            out = h3.step(cfg_ext, h3.Hypersonic3DState(
                *ext, solid=solid_ext, t=t, dtau=dtau), solid_pad=solid_pad,
                wavespeed_reduce=reduce, wavespeed=wavespeed)
            return (tuple(getattr(out, k)[HALO:-HALO] for k in _FIELDS),
                    out.t, out.dtau)

        fields, t, dtau = run_steps(
            one, (tuple(getattr(state, k) for k in _FIELDS), t, dtau),
            n_steps)
        return h3.Hypersonic3DState(*fields, solid=solid, t=t, dtau=dtau)

    return run
