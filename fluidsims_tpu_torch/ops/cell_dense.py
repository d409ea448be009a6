"""Cell-dense particle layout (port of fluidsims_tpu.ops.cell_dense).

Particles are binned into a dense (Gy, Gx, K) array-of-cells: sort by cell
id, take each particle's rank in its cell, and store the first K of every
cell.  A neighbour cell's residents are then a shift of the dense array and
pair interactions are dense (Gy, Gx, K, K) blocks; per-particle results
come back with one gather.  Particles beyond a cell's K slots are dropped
from the interaction set and counted in `overflow`.

The rank is the stable rank: particle-index order inside a cell.  The sort
key packs (cell id, particle index) into one int64, which never overflows
for the sizes a device holds, so the JAX module's int32 fallback to a
stable argsort has no counterpart here; the ranks are the same.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["DenseCells", "DenseGrid", "make_dense_grid", "bin_particles",
           "bin_rank", "sort_by_cell", "scatter_field", "gather_result",
           "shift_cells", "grid_shift", "NEIGHBOR_OFFSETS_2D"]

NEIGHBOR_OFFSETS_2D = [(ox, oy) for oy in (-1, 0, 1) for ox in (-1, 0, 1)]


class DenseGrid(NamedTuple):
    Gx: int
    Gy: int
    cell: float
    K: int


class DenseCells(NamedTuple):
    didx: torch.Tensor      # (n,) int64 dense slot per particle (M*K = dropped)
    ok: torch.Tensor        # (n,) bool: particle stored
    occ: torch.Tensor       # (Gy, Gx, K) bool: slot occupied
    overflow: torch.Tensor  # 0-d int64: dropped particles
    inv: torch.Tensor       # (M*K,) int64: particle index per slot (n = empty)


def make_dense_grid(box_x: float, box_y: float, h: float, n: int,
                    capacity: int = 0, cell_mul: float = 2.0) -> DenseGrid:
    cell = cell_mul * h
    Gx = max(1, math.ceil(box_x / cell))
    Gy = max(1, math.ceil(box_y / cell))
    if capacity <= 0:
        mean_occ = n * cell * cell / (box_x * box_y)
        capacity = max(16, int(math.ceil(3.0 * mean_occ / 8.0)) * 8)
    return DenseGrid(Gx=Gx, Gy=Gy, cell=cell, K=capacity)


def _cid(grid: DenseGrid, pos: torch.Tensor) -> torch.Tensor:
    """Flat cell id gy * Gx + gx (int64) of each particle, clamped to the
    grid.  The divisor is a tensor on pos' device: on a CUDA device PyTorch
    multiplies by the reciprocal of a Python-scalar divisor, which is not
    the correctly rounded quotient that the JAX module and the bin kernel
    compute."""
    cell = torch.full((), grid.cell, dtype=pos.dtype, device=pos.device)
    gx = torch.floor(pos[:, 0] / cell).to(torch.int32).clamp(0, grid.Gx - 1)
    gy = torch.floor(pos[:, 1] / cell).to(torch.int32).clamp(0, grid.Gy - 1)
    return gy.long() * grid.Gx + gx.long()


def sort_by_cell(grid: DenseGrid, pos, cid=None):
    """One packed-key sort by (cell id, particle index): the particle index
    at each sorted position, the cell id there and the rank in the cell
    there (int64, all three)."""
    n = pos.shape[0]
    if cid is None:
        cid = _cid(grid, pos)
    idx = torch.arange(n, dtype=torch.int64, device=pos.device)
    bits = max(1, (n - 1).bit_length())
    skey = torch.sort((cid.long() << bits) | idx).values
    order = skey & ((1 << bits) - 1)
    sc = skey >> bits
    newseg = torch.ones(n, dtype=torch.bool, device=pos.device)
    newseg[1:] = sc[1:] != sc[:-1]
    first = torch.cummax(torch.where(newseg, idx, 0), 0).values
    return order, sc, idx - first


def bin_particles(grid: DenseGrid, pos, cid=None) -> DenseCells:
    """Bin by position (default) or by a caller-computed flat cell id."""
    n = pos.shape[0]
    M = grid.Gx * grid.Gy
    K = grid.K
    order, sc, slot = sort_by_cell(grid, pos, cid)
    ok_sorted = slot < K
    didx_sorted = torch.where(ok_sorted, sc * K + slot, M * K)

    didx = torch.empty_like(didx_sorted)
    didx[order] = didx_sorted
    ok = torch.empty_like(ok_sorted)
    ok[order] = ok_sorted
    # slot -> particle; dropped particles land in the one spare slot M*K
    inv = torch.full((M * K + 1,), n, dtype=torch.int64, device=pos.device)
    inv[didx_sorted] = order
    inv = inv[:M * K]
    occ = (inv < n).reshape(grid.Gy, grid.Gx, K)
    return DenseCells(didx=didx, ok=ok, occ=occ, overflow=n - ok.sum(),
                      inv=inv)


def bin_rank(grid: DenseGrid, pos, cid=None):
    """Per-particle rank within its cell, in particle order:
    (rank int64, ok = rank < K, overflow)."""
    order, _, slot = sort_by_cell(grid, pos, cid)
    rank = torch.empty_like(slot)
    rank[order] = slot
    ok = rank < grid.K
    return rank, ok, pos.shape[0] - ok.sum()


def scatter_field(grid: DenseGrid, cells: DenseCells, f):
    """(n,) or (n, c) particle field -> (Gy, Gx, K[, c]) dense array (empty
    slots hold zero)."""
    n = f.shape[0]
    occ = (cells.inv < n).reshape(-1, *([1] * (f.ndim - 1)))
    vals = f[cells.inv.clamp(max=n - 1)]
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    return torch.where(occ, vals, zero).reshape(grid.Gy, grid.Gx, grid.K,
                                                *f.shape[1:])


def gather_result(grid: DenseGrid, cells: DenseCells, dense, fill=0.0):
    """(Gy, Gx, K[, c]) dense result -> (n[, c]) per particle (dropped
    particles get `fill`)."""
    M = grid.Gx * grid.Gy
    flat = dense.reshape(M * grid.K, *dense.shape[3:])
    vals = flat[cells.didx.clamp(0, M * grid.K - 1)]
    fill_t = torch.full((), fill, dtype=dense.dtype, device=dense.device)
    if dense.ndim == 3:
        return torch.where(cells.ok, vals, fill_t)
    return torch.where(cells.ok[:, None], vals, fill_t)


def shift_cells(dense, oy: int, ox: int):
    """out[j, i] = dense[j + oy, i + ox] over the two leading (cell) axes,
    zeros outside the grid (callers also mask with the shifted `occ`)."""
    Gy, Gx = dense.shape[:2]
    out = torch.zeros_like(dense)
    ys, xs = max(-oy, 0), max(-ox, 0)
    ye, xe = Gy - max(oy, 0), Gx - max(ox, 0)
    if ye > ys and xe > xs:
        out[ys:ye, xs:xe] = dense[ys + oy:ye + oy, xs + ox:xe + ox]
    return out


def grid_shift(a, oy: int, ox: int):
    """(Gy, Gx) grid view at offset: out[j, i] = a[j + oy, i + ox], zeros
    outside the grid."""
    return shift_cells(a, oy, ox)
