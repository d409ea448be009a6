"""A plain torch model of the tiling of the port's GLM-MHD K-step kernel
(fluidsims_tpu_torch/csrc/mhd_multistep.cu, through csrc/tiles.cuh), for
CPU tests that hold the kernel's tiles, clamped halo and global face bands
against the plain step while the kernel itself cannot run.

As tests/oracles/tiled_step.py models the periodic tile kernels, but with
edge-copy boundaries: the grid is cut into the kernel's tiles (read from
the source's tile macros, so that the model cannot drift from them); each
tile's window (the tile and a halo of 2, indices clamped to the grid) is
stepped by the plain step_core, with default_face_masks' bands in global
coordinates and the global dx, dy; the step's wavespeed max is the whole
grid's, taken from the bits the step before wrote; the tile's cells inside
the grid are the step's result there."""

import re
from pathlib import Path

import torch

from fluidsims_tpu_torch.solvers import mhd

SRC = (Path(__file__).resolve().parents[2] / "fluidsims_tpu_torch" / "csrc"
       / "mhd_multistep.cu").read_text()


def _macro(name: str) -> int:
    return int(re.search(rf"#define {name} (\d+)", SRC).group(1))


# the kernel's tile of each dtype (clipped to the grid) and its halo
TILE = {"float32": (_macro("FST_MHD_TILE_X"), _macro("FST_MHD_TILE_Y")),
        "float64": (_macro("FST_MHD_F64_TILE_X"),
                    _macro("FST_MHD_F64_TILE_Y"))}
HALO = int(re.search(r"constexpr int kHalo = (\d+);", SRC).group(1))


def kernel_tile(cfg) -> tuple[int, int]:
    """TILE of cfg's dtype clipped to its grid, as the kernel clips it."""
    tx, ty = TILE[cfg.dtype]
    return min(tx, cfg.nx), min(ty, cfg.ny)


def global_bands(nx: int, ny: int, ys, xs):
    """default_face_masks' bands at global rows ys and columns xs (which
    may lie past the grid: no face there is in a band)."""
    y, x = ys.view(-1, 1), xs.view(1, -1)
    mx = (y >= 1) & (y <= ny - 2) & (x >= 1) & (x <= nx - 3)
    my = (y >= 1) & (y <= ny - 3) & (x >= 1) & (x <= nx - 2)
    return mx, my


def grid_max(cfg, U) -> torch.Tensor:
    """The step's wavespeed max over the whole grid, as step_core forms it
    from the state (the bits the step before wrote)."""
    seen = []
    mhd.step_core(cfg, U, wavespeed_reduce=lambda m: seen.append(m) or m)
    return seen[0]


def tiled_step(cfg, s: mhd.MHDState, tile=None, halo: int = HALO):
    """One step of the tiled kernel's model: tile = (tile_x, tile_y),
    default the kernel's."""
    ny, nx = cfg.ny, cfg.nx
    tx, ty = tile or kernel_tile(cfg)
    m = grid_max(cfg, s.U)
    out = [torch.empty_like(f) for f in s.U]
    dt = None
    for y0 in range(0, ny, ty):
        for x0 in range(0, nx, tx):
            ys = torch.arange(y0 - halo, y0 + ty + halo)
            xs = torch.arange(x0 - halo, x0 + tx + halo)
            yc, xc = ys.clamp(0, ny - 1), xs.clamp(0, nx - 1)
            win = mhd.ConsM(*(f[yc][:, xc] for f in s.U))
            Un, dt = mhd.step_core(cfg, win,
                                   face_masks=global_bands(nx, ny, ys, xs),
                                   dxdy=(1.0 / nx, 1.0 / ny),
                                   wavespeed_reduce=lambda _: m)
            hy, hx = min(ty, ny - y0), min(tx, nx - x0)
            for o, r in zip(out, Un):
                o[y0:y0 + hy, x0:x0 + hx] = r[halo:halo + hy, halo:halo + hx]
    return mhd.MHDState(U=mhd.ConsM(*out), t=s.t + dt)


def tiled_run(cfg, s: mhd.MHDState, k: int, tile=None, halo: int = HALO):
    """k steps of tiled_step: what one launch of k steps computes."""
    for _ in range(k):
        s = tiled_step(cfg, s, tile, halo)
    return s
