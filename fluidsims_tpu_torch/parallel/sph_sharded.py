"""Multi-device SPH: the pair sums split by ranges of sorted positions
(port of fluidsims_tpu.parallel.sph_sharded).

SPH's cost is its pair sums, so the decomposition splits them and keeps
the state replicated: every rank holds every particle.  A substep on
every rank:

  * the bin (kernel #22 on a CUDA device) of all n particles, the same on
    every rank;
  * the density (#14) of the rank's receivers: the sorted positions cut
    into D consecutive ranges [k n // D, (k + 1) n // D), rank k's the
    k-th;
  * one all-gather of the ranges' (rho, p / rho^2), which every rank's
    forces read for the neighbours;
  * the forces and the integrate (#15) of the same receivers, and one
    all-gather of their positions and velocities, merged into the whole
    state on every rank.

The kernels keep the blocks of the whole range over a part of it
(kernels/sph_cuda.py), and the lanes a particle follow the particle count,
so every receiver's sums have the same bits as on one device: at every
world size the run is bitwise the one-device 'cuda' run, as JAX's equals
its single-chip run (every output block computed by one program).  Rain
and the τ clock are the one-device code (`solvers/sph._advance`), on the
replicated state.

JAX cuts the flat row-major cell axis into D ranges of whole 128-cell
blocks (its TPU kernels' block width), so it asks that D divide the block
count, and a rank's share of the work is that of the particles in its
cells.  The port's kernels take any range of sorted positions (which lie
in row-major cell order) with the same bits, so it cuts the particles
themselves: every rank gets n / D receivers, however the pool lies, the
ranges are known before the run (no read-back to the host), and any D
will do.
"""

from __future__ import annotations

import torch

from ..core.stepper import run_steps
from ..kernels import sph_cuda as sk
from ..solvers import sph as sph_mod
from .mesh import Mesh, all_gather

__all__ = ["shard_state", "gather_state", "make_sharded_run"]


def shard_state(state: sph_mod.SPHState, mesh: Mesh) -> sph_mod.SPHState:
    """The state is replicated (the cells, not the particles, split): each
    rank takes the whole of it onto its device."""
    return sph_mod.SPHState(*(t.to(mesh.device) for t in state))


def gather_state(state: sph_mod.SPHState, mesh: Mesh) -> sph_mod.SPHState:
    """The replicated state, as every rank holds it."""
    return state


def _merge(part: torch.Tensor, bounds: list, mesh: Mesh) -> torch.Tensor:
    """The ranks' consecutive parts (rank r's the rows bounds[r] to
    bounds[r + 1]) as one tensor on every rank: one all-gather of the parts
    padded to the longest."""
    lens = [b - a for a, b in zip(bounds, bounds[1:])]
    if len(lens) == 1:
        return part
    pad = part.new_zeros((max(lens),) + part.shape[1:])
    pad[:part.shape[0]] = part
    return torch.cat([p[:k] for p, k in zip(all_gather(pad, mesh), lens)])


def make_sharded_run(cfg: sph_mod.SPHConfig, mesh: Mesh, n_steps: int,
                     axis: str = "c"):
    """run(state) -> state: `n_steps` steps of the 'cuda' engine's
    substep with the pair sums split over the ranks (the kernels on a
    CUDA device, their plain versions on the CPU).  Every rank calls it
    with the same replicated state.  The returned function's `stats`
    counts the receivers of the rank's pair kernels (`halo` 0: none)."""
    if cfg.use_xsph:
        raise ValueError("the cuda SPH engine does not implement XSPH")
    n_dev = mesh.axis_size(axis)
    d = mesh.axis_index(axis)
    bounds = [k * cfg.n // n_dev for k in range(n_dev + 1)]
    lo, hi = bounds[d], bounds[d + 1]
    stats = {"receivers": 0, "halo": 0}

    def substep(pos, vel, dt_sub):
        b = sk.binning(cfg, pos, vel)
        stats["receivers"] += hi - lo
        rp = _merge(sk.density(cfg, b, lo, hi), bounds, mesh)
        pos_k, vel_k = sk.forces(cfg, b, rp, dt_sub, lo, hi)
        if n_dev == 1:
            return pos_k, vel_k
        # the rank's receivers' rows in sorted order, merged and put back
        # in particle order
        order = b.order.long()
        mine = torch.cat([pos_k, vel_k], 1)[order[lo:hi]]
        merged = _merge(mine, bounds, mesh)
        out = torch.empty_like(merged)
        out[order] = merged
        return out[:, :2].contiguous(), out[:, 2:].contiguous()

    def run(state: sph_mod.SPHState) -> sph_mod.SPHState:
        return run_steps(lambda s: sph_mod._advance(cfg, s, None, substep),
                         state, n_steps)

    run.stats = stats
    return run
