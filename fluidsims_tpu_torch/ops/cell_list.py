"""Fixed-capacity cell lists for neighbour search, sort-based (port of
fluidsims_tpu.ops.cell_list).

1. the clamped cell id of each particle,
2. a stable argsort of the ids,
3. each particle's rank within its cell from the sorted order,
4. the sorted indices scattered into a dense (n_cells, capacity) table
   (a particle past `capacity` is dropped and counted by
   `overflow_count`),
5. a neighbour cell's residents are one gather of (N, capacity) indices,
   masked where a slot is empty.

The sort is stable and the search takes the left side, so the tables equal
the JAX module's bit for bit.  Used by the grid-monopole engine of
solvers/nbody_graph.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .scalar import div

__all__ = ["CellGrid", "CellList", "make_grid", "build_cell_list",
           "cell_of", "overflow_count", "NEIGHBOR_OFFSETS",
           "neighbor_indices"]


class CellGrid(NamedTuple):
    Gx: int
    Gy: int
    cell: float       # cell edge length
    capacity: int     # max particles stored per cell


class CellList(NamedTuple):
    table: torch.Tensor  # (Gx*Gy, capacity) int32 particle indices, N = empty
    cid: torch.Tensor    # (N,) cell id per particle
    n: int               # particle count (sentinel value)


def make_grid(box_x: float, box_y: float, h: float, capacity: int,
              cell_mul: float = 2.0) -> CellGrid:
    """Grid with cell size cell_mul * h, so the 3x3 neighbourhood covers a
    kernel support of 2h."""
    cell = cell_mul * h
    Gx = max(1, math.ceil(box_x / cell))
    Gy = max(1, math.ceil(box_y / cell))
    return CellGrid(Gx=Gx, Gy=Gy, cell=cell, capacity=capacity)


def cell_of(grid: CellGrid, pos: torch.Tensor) -> torch.Tensor:
    """Clamped int32 cell id gy * Gx + gx of each particle."""
    gx = torch.clamp(torch.floor(div(pos[:, 0], grid.cell)).to(torch.int32),
                     0, grid.Gx - 1)
    gy = torch.clamp(torch.floor(div(pos[:, 1], grid.cell)).to(torch.int32),
                     0, grid.Gy - 1)
    return gy * grid.Gx + gx


def build_cell_list(grid: CellGrid, pos: torch.Tensor) -> CellList:
    n = pos.shape[0]
    M = grid.Gx * grid.Gy
    K = grid.capacity

    cid = cell_of(grid, pos)
    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]

    # rank within cell = position among equal cids
    first_same = torch.searchsorted(sorted_cid, sorted_cid, side="left")
    slot = (torch.arange(n, dtype=torch.int64, device=pos.device)
            - first_same)

    flat = sorted_cid.to(torch.int64) * K + slot
    keep = slot < K                                  # overflow -> dropped
    table = torch.full((M * K,), n, dtype=torch.int32, device=pos.device)
    table[flat[keep]] = order[keep].to(torch.int32)
    return CellList(table=table.reshape(M, K), cid=cid, n=n)


def overflow_count(grid: CellGrid, cl: CellList) -> torch.Tensor:
    """Number of particles that exceeded a cell's capacity (diagnostic)."""
    stored = torch.sum(cl.table < cl.n)
    return cl.cid.shape[0] - stored


NEIGHBOR_OFFSETS = [(-1, -1), (0, -1), (1, -1),
                    (-1, 0), (0, 0), (1, 0),
                    (-1, 1), (0, 1), (1, 1)]


def neighbor_indices(grid: CellGrid, cl: CellList, ox: int, oy: int):
    """Per-particle neighbour-slot indices for one 3x3 cell offset:
    (idx (N, K) int32, valid (N, K) bool).  Out-of-grid cells yield no
    neighbours."""
    cidx = cl.cid % grid.Gx
    cidy = torch.div(cl.cid, grid.Gx, rounding_mode="floor")
    nx = cidx + ox
    ny = cidy + oy
    in_grid = (nx >= 0) & (nx < grid.Gx) & (ny >= 0) & (ny < grid.Gy)
    ncell = torch.where(in_grid, ny * grid.Gx + nx, 0)
    idx = cl.table[ncell.to(torch.int64)]            # (N, K)
    valid = in_grid[:, None] & (idx < cl.n)
    return idx, valid
