"""A plain torch model of the tiling of the port's LBM K-step kernel
(fluidsims_tpu_torch/csrc/lbm_multistep.cu), for CPU tests that hold its
windows, link masks and in-place moving frame against K plain steps while
the kernel itself cannot run.

Each tile's window (the tile and a halo of K, x wrapped, rows outside
[0, ny) out of bounds) holds ONE copy of the 9 packet planes, NaN where
nothing was written.  After the collision of step s (s = 0 .. K-1) the
post-collision packet q of window cell c sits at P[q][c - s e_q]; step s's
pull reads packet q of cell c at P[q][c - s e_q], or, where the link
bounces (the upstream cell solid or out of bounds: the cell's 9-bit mask,
formed once from the global solid map), the cell's own post of step s - 1
at P[OPP[q]][c + (s - 1) e_q].  Step s runs on the window less a ring of s
cells; cells that are solid or out of bounds never run.  The last pull
(step K) gives the tile; a solid cell's output is its packets reflected K
times.  The collision is the plain step's own arithmetic
(solvers/lbm.py: macroscopic, feq).

The model also checks the kernel's claim that a step needs one barrier:
no place that a cell of step s reads is written in step s by another
cell (`check_places`).  The tile rule and the shared memory a block are
read from the source's macros, so that the model cannot drift from them."""

import re
from pathlib import Path

import torch

from fluidsims_tpu_torch.solvers import lbm

SRC = (Path(__file__).resolve().parents[2] / "fluidsims_tpu_torch" / "csrc"
       / "lbm_multistep.cu").read_text()


def _macro(name: str) -> int:
    return int(re.search(rf"#define {name} (\d+)", SRC).group(1))


SMEM = _macro("FST_LBM_SMEM")
THREADS = _macro("FST_LBM_THREADS")
MAX_K = int(re.search(r"constexpr int kLbmMaxK = (\d+);", SRC).group(1))
EX, EY, OPP = (tuple(int(v) for v in a) for a in (lbm.EX, lbm.EY, lbm.OPP))


def cell_bytes(itemsize: int) -> int:
    """Shared memory a window cell: 9 packets and a 16-bit link mask."""
    return 9 * itemsize + 2


def _even(n: int, most: int) -> int:
    tiles = -(-n // most)
    return -(-n // tiles)


def kernel_tile(ny: int, nx: int, k: int, itemsize: int) -> tuple:
    """(tile_x, tile_y) of a launch of k steps: the largest square tile
    whose window (a halo of k) fits SMEM, clipped to the grid and evened
    out over the tiles of each axis."""
    side = 1
    while (side + 1) ** 2 * cell_bytes(itemsize) <= SMEM:
        side += 1
    tile = side - 2 * k
    if tile < 1:
        raise ValueError(f"k={k}: no tile fits {SMEM} bytes")
    return _even(nx, min(tile, nx)), _even(ny, min(tile, ny))


def _collide(cfg, f, drive):
    """The plain step's collision of stacked packets f (9, h, w)."""
    rho, ux, uy = lbm.macroscopic(f)
    ux = ux + (cfg.drive if drive is None else drive)
    omega = 1.0 / cfg.tau
    return torch.stack([f[q] - omega * (f[q] - lbm.feq(q, rho, ux, uy))
                        for q in range(9)])


def _region(s: int, sy: int, sx: int, dy: int = 0, dx: int = 0):
    """The window less a ring of s cells, moved by (dy, dx)."""
    return slice(s + dy, sy - s + dy), slice(s + dx, sx - s + dx)


def check_places(s: int, k: int, idle, bounce, sy: int, sx: int) -> None:
    """Within step s (1 <= s <= k), the places a running cell reads by a
    bounced link are written by no cell: the writer of P[OPP[q]][c + (s -
    1) e_q] in step s would be the upstream cell c - e_q, which is idle
    (solid or out of bounds) or outside the region of step s."""
    if s == k:
        return  # the last pull writes device memory, not the window
    ry, rx = _region(s, sy, sx)
    writes = torch.zeros((9, sy, sx), dtype=torch.bool)
    for q in range(9):
        ys, xs = _region(s, sy, sx, -s * EY[q], -s * EX[q])
        writes[q, ys, xs] = ~idle[ry, rx]
    for q in range(1, 9):
        ys, xs = _region(s, sy, sx, (s - 1) * EY[q], (s - 1) * EX[q])
        reads = bounce[q][ry, rx] & ~idle[ry, rx]
        assert not bool((reads & writes[OPP[q], ys, xs]).any()), (s, q)


def tiled_run(cfg, s: lbm.LBMState, k: int, tile=None, drive=None,
              loaded=None) -> lbm.LBMState:
    """k steps of the tiled kernel's model: tile = (tile_x, tile_y),
    default the kernel's; `loaded` (default k) the halo cells loaded from
    the state (the window's outer k - loaded rings hold NaN)."""
    ny, nx = cfg.ny, cfg.nx
    f, solid = s.f, s.solid
    itemsize = f.element_size()
    tx, ty = tile or kernel_tile(ny, nx, k, itemsize)
    gap = k - (k if loaded is None else loaded)
    out = torch.empty_like(f)
    nan = float("nan")
    for y0 in range(0, ny, ty):
        for x0 in range(0, nx, tx):
            gy = torch.arange(y0 - k, y0 + ty + k)
            gx = torch.arange(x0 - k, x0 + tx + k) % nx
            sy, sx = len(gy), len(gx)
            rows = (gy >= 0) & (gy < ny)
            gyc = gy.clamp(0, ny - 1)
            idle = solid[gyc][:, gx] | ~rows.view(-1, 1)
            # link masks from the global map: upstream solid or out of rows
            bounce = [None]
            for q in range(1, 9):
                uy = gy - EY[q]
                ux = (gx - EX[q]) % nx
                up = solid[uy.clamp(0, ny - 1)][:, ux]
                bounce.append(up | ((uy < 0) | (uy >= ny)).view(-1, 1))
            fw = f[:, gyc][:, :, gx]
            if gap:
                held = torch.zeros((sy, sx), dtype=torch.bool)
                held[gap:sy - gap, gap:sx - gap] = True
                fw = torch.where(held, fw, torch.full_like(fw, nan))
            # step 0: collide the loaded packets, post q at P[q][c]
            P = torch.where(idle, torch.full_like(fw, nan),
                            _collide(cfg, fw, drive))
            for st in range(1, k + 1):
                check_places(st, k, idle, bounce, sy, sx)
                ry, rx = _region(st, sy, sx)
                fl = [P[0, ry, rx]]
                for q in range(1, 9):
                    norm = P[(q,) + _region(st, sy, sx, -st * EY[q],
                                            -st * EX[q])]
                    back = P[(OPP[q],) + _region(st, sy, sx,
                                                 (st - 1) * EY[q],
                                                 (st - 1) * EX[q])]
                    fl.append(torch.where(bounce[q][ry, rx], back, norm))
                fl = torch.stack(fl)
                if st == k:
                    break
                post = _collide(cfg, fl, drive)
                keep = idle[ry, rx]
                for q in range(9):
                    place = (q,) + _region(st, sy, sx, -st * EY[q],
                                           -st * EX[q])
                    P[place] = torch.where(keep, P[place], post[q])
            # the tile's cells inside the grid; solid cells reflected k times
            hy, hx = min(ty, ny - y0), min(tx, nx - x0)
            tile_f = fl[:, :hy, :hx]
            refl = f[[OPP[q] if k % 2 else q for q in range(9)]]
            g = (slice(None), slice(y0, y0 + hy), slice(x0, x0 + hx))
            out[g] = torch.where(solid[g[1:]], refl[g], tile_f)
    return lbm.LBMState(f=out, solid=solid)
