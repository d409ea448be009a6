"""Multi-device MLS-MPM: data-parallel particles and a replicated grid
(port of fluidsims_tpu.parallel.mpm_sharded).

The decomposition of parallel/flip_sharded.py (see its docstring): the
particles are sharded by the strided interleave, each rank runs the P2G
(kernel #19 on a CUDA device) on its particles into a whole grid, one
all-reduce SUM a step merges the partial mass and momentum grids (the
solver's `grid_reduce` hook), and the grid update with the G2P and the
plastic F update (#20 + #21, one launch) runs on the reduced grid for the
rank's own particles.  Equivalence with one device is to summation order.
"""

from __future__ import annotations

from dataclasses import replace

from ..core.stepper import run_steps
from ..solvers import mpm
from .flip_sharded import particle_gather, particle_shard
from .mesh import Mesh, psum

__all__ = ["shard_state", "gather_state", "make_sharded_run"]


def shard_state(state: mpm.MPMState, mesh: Mesh, axis: str = "p"):
    """Interleave the particles and take this rank's block."""
    return mpm.MPMState(*particle_shard(tuple(state), mesh, axis))


def gather_state(state: mpm.MPMState, mesh: Mesh, axis: str = "p"):
    """The global state (particles in interleaved order) on every rank."""
    return mpm.MPMState(*particle_gather(tuple(state), mesh, axis))


def make_sharded_run(cfg: mpm.MPMConfig, mesh: Mesh, n_steps: int,
                     axis: str = "p"):
    """run(local_state) -> local_state: `n_steps` particle-sharded steps
    on the engine `mpm.resolve_engine` picks for the mesh's device.  Every
    rank calls it."""
    n_dev = mesh.axis_size(axis)
    if cfg.n % n_dev:
        raise ValueError(f"n={cfg.n} not divisible by {n_dev} devices")
    cfg_local = replace(cfg, n=cfg.n // n_dev)

    def reduce(grids):
        return psum(tuple(grids), mesh)

    def run(state: mpm.MPMState) -> mpm.MPMState:
        return run_steps(lambda s: mpm.step(cfg_local, s, grid_reduce=reduce),
                         state, n_steps)

    return run
