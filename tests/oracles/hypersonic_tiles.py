"""A plain torch model of the tiling of the port's hypersonic step kernels
(fluidsims_tpu_torch/csrc/hypersonic2d_step.cu and hypersonic3d_step.cu),
for CPU tests that hold a kernel's tile and halo against the plain step
while the kernel itself cannot run.

The grid is cut into the kernel's tiles, read from the sources' tile
macros so that the model cannot drift from them; each tile's window (the
tile and a halo, with the boundary conditions resolved as the kernel
resolves them) is stepped by the plain core, and the tile's cells inside
the grid are the step's result there.  A window with less halo than the
stencil reaches is filled out to the core's padding by repeating its
edge cells, as a kernel that staged too little would have to."""

import re
from pathlib import Path

import torch

from fluidsims_tpu_torch.ops.euler2d import Cons
from fluidsims_tpu_torch.solvers import hypersonic2d as h2
from fluidsims_tpu_torch.solvers import hypersonic3d as h3

CSRC = Path(__file__).resolve().parents[2] / "fluidsims_tpu_torch" / "csrc"


def _source_ints(src: str, pattern: str) -> tuple:
    text = (CSRC / src).read_text()
    return tuple(int(v) for v in re.findall(pattern, text))


def source_tile(src: str, macro: str, axes: str) -> tuple:
    """The default of each tile macro `{macro}_TILE_{axis}` of `src`."""
    return tuple(_source_ints(src, rf"#define {macro}_TILE_{a} (\d+)")[0]
                 for a in axes)


# the 2-D kernel's tile of each dtype, the 3-D kernel's of both
TILE_2D = {"float32": source_tile("hypersonic2d_step.cu", "FST_HYP2D", "XY"),
           "float64": source_tile("hypersonic2d_step.cu", "FST_HYP2D_F64",
                                  "XY")}
TILE_3D = source_tile("hypersonic3d_step.cu", "FST_HYP3D", "XYZ")
HALO_2D = _source_ints("hypersonic2d_step.cu", r"constexpr int kHalo = (\d+);")[0]
HALO_3D = _source_ints("hypersonic3d_step.cu", r"constexpr int kHalo = (\d+);")[0]


def _edge_pad(f: torch.Tensor, extra: int) -> torch.Tensor:
    """f with `extra` more cells on each side of every axis, repeating the
    edge cells."""
    for d in range(f.dim()):
        n = f.shape[d]
        idx = torch.arange(-extra, n + extra).clamp(0, n - 1)
        f = f.index_select(d, idx)
    return f


def window_2d(cfg, U: Cons, mask, y0: int, x0: int, tile, halo: int):
    """The window of the 2-D tile at (y0, x0): its cells and `halo` more
    on each side, with load_bc's boundary conditions (y clamped; x < 0
    the inflow state, x >= nx the last column, also past the grid in a
    ragged tile; the mask False at x < 0 and x >= nx)."""
    ny, nx = mask.shape
    tx, ty = tile
    ys = torch.arange(y0 - halo, y0 + ty + halo).clamp(0, ny - 1)
    xs = torch.arange(x0 - halo, x0 + tx + halo)
    left, right = xs < 0, xs >= nx
    xc = xs.clamp(0, nx - 1)
    infl = h2.inflow_cons(cfg, mask.device)
    fields = []
    for f, v in zip(U, infl):
        w = f.index_select(0, ys).index_select(1, xc)
        fields.append(torch.where(left.view(1, -1), v, w))
    m = mask.index_select(0, ys).index_select(1, xc)
    m = m & ~(left | right).view(1, -1)
    return Cons(*fields), m


def tiled_step_2d(cfg, U: Cons, mask, dt, halo=HALO_2D):
    """pad_bc + step_core_padded as the tiled 2-D kernel takes it, on the
    kernel's tile of cfg's dtype."""
    ny, nx = mask.shape
    tile = TILE_2D[cfg.dtype]
    tx, ty = tile
    out = [torch.empty_like(f) for f in U]
    for y0 in range(0, ny, ty):
        for x0 in range(0, nx, tx):
            Uw, Mw = window_2d(cfg, U, mask, y0, x0, tile, halo)
            if halo < h2.PAD:
                Uw = Cons(*(_edge_pad(f, h2.PAD - halo) for f in Uw))
                Mw = _edge_pad(Mw, h2.PAD - halo)
            res = h2.step_core_padded(cfg, Uw, Mw, dt)
            hy, hx = min(ty, ny - y0), min(tx, nx - x0)
            for o, r in zip(out, res):
                o[y0:y0 + hy, x0:x0 + hx] = r[:hy, :hx]
    return Cons(*out)


def tiled_step_3d(cfg, qp, solid_pad, dt, gain, x0: int = 0, tile=TILE_3D,
                  halo=HALO_3D):
    """step_core_padded (slab sponges) on halo-3 padded prims as the tiled
    3-D kernel takes it: each tile's window of the padded prims, its
    coordinates clamped to the padded grid as the kernel's staging clamps
    them, stepped with the tile's first global x."""
    nz, ny, nx = (s - 2 * h3.HALO for s in solid_pad.shape)
    tx, ty, tz = tile
    out = [torch.empty((nz, ny, nx), dtype=qp.r.dtype) for _ in qp]
    for z0 in range(0, nz, tz):
        for y0 in range(0, ny, ty):
            for xt in range(0, nx, tx):
                # padded coordinates of the window: the tile's cells and
                # `halo` more each side (interior o - halo .. o + t + halo)
                idx = [torch.arange(o + h3.HALO - halo,
                                    o + t + h3.HALO + halo).clamp(max=n + 5)
                       for o, t, n in ((z0, tz, nz), (y0, ty, ny),
                                       (xt, tx, nx))]

                def win(f):
                    w = f.index_select(0, idx[0]).index_select(1, idx[1])
                    w = w.index_select(2, idx[2])
                    return _edge_pad(w, h3.HALO - halo)

                res = h3.step_core_padded(
                    cfg, h3.PrimT(*(win(f) for f in qp)), win(solid_pad), dt,
                    gain, x0=x0 + xt, solid_box="dense", sponge_mode="slab")
                hz, hy, hx = min(tz, nz - z0), min(ty, ny - y0), \
                    min(tx, nx - xt)
                for o, r in zip(out, res):
                    o[z0:z0 + hz, y0:y0 + hy, xt:xt + hx] = r[:hz, :hy, :hx]
    return h3.PrimT(*out)
