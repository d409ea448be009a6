"""Multi-device FLIP/APIC: data-parallel particles and a replicated grid
(port of fluidsims_tpu.parallel.flip_sharded).

The scale axis of the particle solvers is the particle count, while the
grid stays small (128^2), so the particles are sharded over the mesh and
the grid is replicated:

  * each rank runs the P2G on its particles into a whole grid (kernel #16
    on a CUDA device),
  * one all-reduce SUM merges the partial mass and momentum grids (the
    solver's `grid_reduce` hook, JAX's `lax.psum`),
  * the grid phase (#17) runs redundantly on every rank: the same inputs
    give the same bits, so the replicas agree with no communication,
  * the G2P with the density raster (#18) is per-particle work on the
    shard; a second all-reduce SUM merges the rasters.

Particles are sharded by strided index: rank d owns original indices
d::world, put into one contiguous block by `interleave_perm`, so each
shard samples the whole domain and every cell's occupancy drops by about
the rank count.  A run's state and output keep that interleaved order.

The per-rank config has `particles = n / world`, which sizes the 'dense'
engine's cell capacity and picks the CUDA P2G's design from the rank's
own count (atomic below 2^18, tiled from there).  Equivalence with one
device is to summation order: the partial grids and their sum reassociate
the one-device P2G's sums, whose atomic adds land in no fixed order on
the card anyway.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..core.stepper import run_steps
from ..solvers import flip_apic as fa
from .mesh import Mesh, gather, psum, shard

__all__ = ["interleave_perm", "shard_state", "gather_state",
           "make_sharded_run", "particle_shard", "particle_gather"]


def interleave_perm(n: int, n_dev: int) -> np.ndarray:
    """Permutation putting original indices d::n_dev into contiguous
    block d (so an index-sharded array is spatially well-mixed)."""
    return np.arange(n).reshape(n_dev, -1, order="F").reshape(-1)


def particle_shard(arrays: tuple, mesh: Mesh, axis: str) -> tuple:
    """This rank's block of each global per-particle array, after the
    interleave permutation."""
    n_dev = mesh.axis_size(axis)
    n = arrays[0].shape[0]
    if n % n_dev:
        raise ValueError(f"particles={n} not divisible by {n_dev} devices")
    perm = torch.from_numpy(interleave_perm(n, n_dev))
    return tuple(shard(a[perm.to(a.device)], mesh, {axis: 0})
                 for a in arrays)


def particle_gather(arrays: tuple, mesh: Mesh, axis: str) -> tuple:
    """The global per-particle arrays in interleaved order, on every
    rank."""
    return tuple(gather(a, mesh, {axis: 0}) for a in arrays)


def shard_state(state: fa.FlipApicState, mesh: Mesh, axis: str = "p"):
    """Interleave the particles and take this rank's block; the density
    raster is replicated."""
    pos, vel, ax, ay = particle_shard(tuple(state[:4]), mesh, axis)
    return fa.FlipApicState(pos=pos, vel=vel, affine_x=ax, affine_y=ay,
                            density=state.density.to(mesh.device))


def gather_state(state: fa.FlipApicState, mesh: Mesh, axis: str = "p"):
    """The global state (particles in interleaved order) on every rank."""
    pos, vel, ax, ay = particle_gather(tuple(state[:4]), mesh, axis)
    return fa.FlipApicState(pos=pos, vel=vel, affine_x=ax, affine_y=ay,
                            density=state.density)


def make_sharded_run(cfg: fa.FlipApicConfig, mesh: Mesh, n_steps: int,
                     axis: str = "p"):
    """run(local_state) -> local_state: `n_steps` particle-sharded steps
    on the engine `fa.resolve_engine` picks for the mesh's device.  Every
    rank calls it."""
    n_dev = mesh.axis_size(axis)
    if cfg.particles % n_dev:
        raise ValueError(
            f"particles={cfg.particles} not divisible by {n_dev} devices")
    cfg_local = replace(cfg, particles=cfg.particles // n_dev)

    def reduce(grids):
        return psum(grids, mesh)

    def run(state: fa.FlipApicState) -> fa.FlipApicState:
        return run_steps(lambda s: fa.step(cfg_local, s, grid_reduce=reduce),
                         state, n_steps)

    return run
