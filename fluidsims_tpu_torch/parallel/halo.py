"""Halo exchange for slab-decomposed grids (port of
fluidsims_tpu.parallel.halo).

Each rank holds an x-slab (x the last axis) and receives `halo` ghost
columns from each neighbour along the mesh axis by `mesh.ppermute`.  The
outward ghost of the first and last rank is the physical boundary: the
caller's fill, or edge replication (the outflow clamp of
tau_hypersonic_cuda.cu:281-282).
"""

from __future__ import annotations

import torch

from .mesh import Mesh, ppermute

__all__ = ["exchange_halo_x", "extend_with_halo_x"]


def exchange_halo_x(f: torch.Tensor, halo: int, mesh: Mesh, axis: str = "x"):
    """(left_ghost, right_ghost): the `halo` edge columns of this rank's
    neighbours along `axis`, each of shape (..., halo).  The first rank's
    left ghost and the last rank's right ghost are zeros (no neighbour
    sends them)."""
    n = mesh.axis_size(axis)
    # left ghost = right edge of the left neighbour: data moves rightward
    left = ppermute(f[..., -halo:], mesh, axis,
                    [(i, i + 1) for i in range(n - 1)])
    # right ghost = left edge of the right neighbour: data moves leftward
    right = ppermute(f[..., :halo], mesh, axis,
                     [(i + 1, i) for i in range(n - 1)])
    return left, right


def _edge(f: torch.Tensor, col: slice, halo: int) -> torch.Tensor:
    return f[..., col].expand(*f.shape[:-1], halo)


def extend_with_halo_x(f: torch.Tensor, halo: int, mesh: Mesh,
                       axis: str = "x", left_fill=None, right_fill=None):
    """`f` with `halo` exchanged ghost columns on each side along x.
    `left_fill` / `right_fill` (shape (..., halo)) are the outward ghosts
    of the first / last rank; None replicates the edge column there."""
    left, right = exchange_halo_x(f, halo, mesh, axis)
    i, n = mesh.axis_index(axis), mesh.axis_size(axis)
    if i == 0:
        left = _edge(f, slice(0, 1), halo) if left_fill is None else left_fill
    if i == n - 1:
        right = (_edge(f, slice(-1, None), halo) if right_fill is None
                 else right_fill)
    return torch.cat([left, f, right], dim=-1)
