"""Multi-device n-body graph layout: body-sharded exact all-pairs forces
(port of fluidsims_tpu.parallel.nbody_sharded).

The exact engine's O(n^2) repulsion splits by target rows: rank d takes
its n / world rows against every body (the repulsion kernel p3 with
`rows`, kernels/nbody_cuda.repulsion_exact), so each rank's pair work is
n^2 / world.  The springs split the same way: rank d sums the entries of
the static incidence (solvers/nbody_graph._sorted_incidence, sorted by
target) whose target is one of its rows, in the one-device order.  Each
rank adds its rows' springs and repulsion, and one all-gather a step
assembles the forces of every body on every rank; the integration is
replicated (elementwise on (n, dims)), so the state stays identical on
every rank.

JAX's runner splits the springs by edge instead, each device
accumulating its slice of the edge list into every body and a `psum`
merging the slices, which reassociates each body's spring sum.  Splitting
by target keeps every body's sums whole on one rank, so the sharded
trajectory is bitwise the one-device one wherever the one-device run is
itself deterministic, and a step needs one all-gather of n x dims values
in place of an all-reduce of as many plus the gather.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.stepper import run_steps
from ..kernels import nbody_cuda as nk
from ..solvers import nbody_graph as ng
from .mesh import Mesh, all_gather

__all__ = ["shard_state", "gather_state", "make_sharded_run"]


def shard_state(state: ng.GraphLayoutState, mesh: Mesh, axis: str = "b"):
    """Positions, velocities, edges and the step count replicated, on the
    mesh's device."""
    return ng.GraphLayoutState(*(f.to(mesh.device).clone() for f in state))


def gather_state(state: ng.GraphLayoutState, mesh: Mesh, axis: str = "b"):
    """The state is replicated: every rank's is the global one."""
    return state


def _incidence_rows(cfg, row0: int, n_rows: int, device):
    """(target - row0, other endpoint) of the incidence entries whose
    target lies in [row0, row0 + n_rows), in the one-device order, as
    int64 tensors on `device`."""
    tgt, oth = ng._sorted_incidence(cfg.max_number)
    a, b = np.searchsorted(tgt, [row0, row0 + n_rows])
    return (torch.from_numpy((tgt[a:b] - row0).astype(np.int64)).to(device),
            torch.from_numpy(oth[a:b].astype(np.int64)).to(device))


def make_sharded_run(cfg: ng.GraphLayoutConfig, mesh: Mesh, n_steps: int,
                     axis: str = "b"):
    """run(state) -> state: `n_steps` body-sharded exact steps of the
    replicated state.  Every rank calls it."""
    if cfg.engine != "exact":
        raise ValueError(f"engine={cfg.engine!r}: the sharded runner splits "
                         "the exact all-pairs repulsion; use 'exact'")
    n, n_dev = cfg.n_bodies, mesh.axis_size(axis)
    if n % n_dev:
        raise ValueError(f"bodies={n} not divisible by {n_dev} devices")
    n_rows = n // n_dev
    row0 = mesh.axis_index(axis) * n_rows

    def run(state: ng.GraphLayoutState) -> ng.GraphLayoutState:
        tgt, oth = _incidence_rows(cfg, row0, n_rows, state.pos.device)

        def forces(pos):
            rows = pos[row0:row0 + n_rows]
            spring = torch.zeros_like(rows).index_add_(
                0, tgt, ng._spring_law(cfg, pos[oth] - rows[tgt]))
            rep = nk.repulsion_exact(cfg, pos, rows)
            return torch.cat(all_gather(spring + rep, mesh))

        return run_steps(lambda s: ng.step(cfg, s, forces=forces), state,
                         n_steps)

    return run
