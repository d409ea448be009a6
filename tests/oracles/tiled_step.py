"""A plain torch model of the tiling of the port's K-step tile kernels
(fluidsims_tpu_torch/csrc/burgers_multistep.cu and
shallow_water_multistep.cu, through csrc/tiles.cuh), for CPU tests that
hold a kernel's halo, ring and wrap against the plain step while the
kernel itself cannot run."""

import torch

# The kernels' tile, kTileX x kTileY of csrc/tiles.cuh (clipped to the
# grid; on the card the grid query reports it).
KERNEL_TILE = (32, 32)


def kernel_tile(nx: int, ny: int) -> tuple[int, int]:
    """KERNEL_TILE clipped to an ny x nx grid, as the kernels clip it."""
    return min(KERNEL_TILE[0], nx), min(KERNEL_TILE[1], ny)


def tiled_step_fields(step_fields, cfg, fields, t, tile, halo):
    """One step of `step_fields` (a solver's plain step on its state
    fields) as the tiled kernels take it: the grid cut into tiles of
    tile = (tile_x, tile_y); each tile's window (the tile and a halo of
    `halo` cells, wrapped periodically) stepped by the plain
    `step_fields`, whose own periodic shifts then wrap around the window
    and spoil only cells within the stencil's reach of its edge; the
    step's wavespeed max taken over the whole grid, as the kernel's
    grid-wide max; the tile of the stepped window is the step's result
    there."""
    seen = []
    step_fields(cfg, *fields, t,
                wavespeed_reduce=lambda m: seen.append(m) or m)
    ny, nx = fields[0].shape
    tx, ty = tile
    outs = [torch.empty_like(f) for f in fields]
    for y0 in range(0, ny, ty):
        for x0 in range(0, nx, tx):
            ys = torch.arange(y0 - halo, y0 + ty + halo) % ny
            xs = torch.arange(x0 - halo, x0 + tx + halo) % nx
            win = [f[ys][:, xs] for f in fields]
            res = step_fields(cfg, *win, t,
                              wavespeed_reduce=lambda m: seen[0])
            hy, hx = min(ty, ny - y0), min(tx, nx - x0)
            for o, r in zip(outs, res):
                o[y0:y0 + hy, x0:x0 + hx] = r[halo:halo + hy, halo:halo + hx]
    return outs
