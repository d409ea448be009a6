"""A plain torch model of the tiling of the port's FLIP grid-phase kernel
(fluidsims_tpu_torch/csrc/flip_grid.cu), for CPU tests that hold its
phases, halos and zero ring against the plain grid phase while the kernel
itself cannot run.

The kernel runs the `jacobi` sweeps in phases of h (the last takes the
rest, also when jacobi < h), one grid sync between two phases, each phase
on every tile's window (the tile and a halo of the phase's sweeps, one
more in the last phase) in shared memory.  The model does the same tile
by tile with torch ops on the window, in the plain version's operations
and order (solvers/flip_apic.py::_grid_phase):

* the first phase forms u and v on its window from mass and momentum (the
  wall clamps on global coordinates, 0 past the grid), writes u_prev and
  v_prev of the tile, forms div on the window less its ring (and writes
  the tile's div when later phases need it) and starts from p = 0;
* a later phase starts from the phase before's p and the div of its
  window (0 outside the interior);
* sweep k is formed on the window less a ring of k cells only; the rest
  of the window holds NaN, so that a halo too short for its sweeps shows;
* a phase that is not the last writes p of the tile's interior; the last
  projects the tile.

The tile, h and the small-grid bound are read from the source's macros,
so that the model cannot drift from them."""

import re
from pathlib import Path

import torch

from fluidsims_tpu_torch.ops.scalar import div

SRC = (Path(__file__).resolve().parents[2] / "fluidsims_tpu_torch" / "csrc"
       / "flip_grid.cu").read_text()


def _macro(name: str) -> int:
    return int(re.search(rf"#define {name} (\d+)", SRC).group(1))


# The kernel's sweeps a phase, its (tile_x, tile_y, threads) for grids of
# n > SMALL_N and n <= SMALL_N, and its shared-memory windows a block.
SWEEPS = _macro("FST_FLIP_SWEEPS")
LARGE = tuple(_macro(f"FST_FLIP_{k}") for k in ("TILE_X", "TILE_Y", "THREADS"))
SMALL = tuple(_macro(f"FST_FLIP_SMALL_{k}") for k in
              ("TILE_X", "TILE_Y", "THREADS"))
SMALL_N = _macro("FST_FLIP_SMALL_N")
WINDOWS = int(re.search(r"constexpr int kFlipWindows = (\d+);",
                        SRC).group(1))


def kernel_shape(n: int) -> tuple[int, int, int]:
    """(tile_x, tile_y, h) of the kernel on an (n, n) grid: the size
    class's tile clipped to the grid, and its sweeps a phase."""
    tx, ty, _ = SMALL if n <= SMALL_N else LARGE
    return min(tx, n), min(ty, n), SWEEPS


def smem_bytes(n: int, itemsize: int) -> int:
    """The kernel's dynamic shared memory a block on an (n, n) grid: its
    windows of the tile and a halo of h + 1."""
    tx, ty, h = kernel_shape(n)
    return WINDOWS * (tx + 2 * (h + 1)) * (ty + 2 * (h + 1)) * itemsize


def phases(jacobi: int, h: int) -> int:
    """Phases of `jacobi` sweeps at h a phase: max(ceil(jacobi / h), 1);
    the kernel makes one grid sync fewer."""
    return max(-(-jacobi // h), 1)


def grid_phase_tiled(cfg, mass, mom_u, mom_v, shape=None, short: int = 0):
    """(u_prev, v_prev, u_proj, v_proj) of the tiled kernel's model: shape
    = (tile_x, tile_y, h), default the kernel's for cfg.grid; `short`
    takes that many cells off every phase's halo."""
    n = cfg.grid
    tx, ty, h = shape or kernel_shape(n)
    dt = mass.dtype
    nan = float("nan")
    zero = torch.zeros((), dtype=dt)
    u_prev, v_prev = torch.empty_like(mass), torch.empty_like(mass)
    u_proj, v_proj = torch.empty_like(mass), torch.empty_like(mass)
    dv = torch.full_like(mass, nan)
    p_glob = [torch.full_like(mass, nan), torch.full_like(mass, nan)]
    gdt = cfg.gravity * cfg.dt
    n_ph = phases(cfg.jacobi, h)
    src = None
    for ph in range(n_ph):
        last = ph + 1 == n_ph
        count = cfg.jacobi - ph * h if last else h
        halo = count + (1 if last else 0) - short
        dst = p_glob[ph % 2]
        for y0 in range(0, n, ty):
            for x0 in range(0, n, tx):
                ys = torch.arange(y0 - halo, y0 + ty + halo)
                xs = torch.arange(x0 - halo, x0 + tx + halo)
                wy, wx = len(ys), len(xs)
                yc, xc = ys.clamp(0, n - 1), xs.clamp(0, n - 1)
                Y, X = ys.view(-1, 1), xs.view(1, -1)
                in_grid = (Y >= 0) & (Y < n) & (X >= 0) & (X < n)
                inner = (Y >= 1) & (Y <= n - 2) & (X >= 1) & (X <= n - 2)
                # the tile's cells inside the grid, in window and grid
                # coordinates
                ty1, tx1 = min(y0 + ty, n), min(x0 + tx, n)
                tile = (slice(halo, halo + ty1 - y0),
                        slice(halo, halo + tx1 - x0))
                g_tile = (slice(y0, ty1), slice(x0, tx1))
                if ph == 0:
                    m = mass[yc][:, xc]
                    mu, mv = mom_u[yc][:, xc], mom_v[yc][:, xc]
                    has = m > 1e-8
                    mm = torch.clamp_min(m, 1e-8)
                    u = torch.where(has, mu / mm, mu)
                    v = torch.where(has, mv / mm - gdt, mv)
                    u = torch.where((X == 0) | (X == n - 1), zero, u)
                    v = torch.where((Y == 0) | (Y == n - 1), zero, v)
                    u = torch.where(in_grid, u, zero)
                    v = torch.where(in_grid, v, zero)
                    u_prev[g_tile] = u[tile]
                    v_prev[g_tile] = v[tile]
                    d = torch.full((wy, wx), nan, dtype=dt)
                    if count > 0:
                        d[1:-1, 1:-1] = torch.where(
                            inner[1:-1, 1:-1],
                            -0.5 * (n - 1) * (u[1:-1, 2:] - u[1:-1, :-2]
                                              + v[2:, 1:-1] - v[:-2, 1:-1]),
                            zero)
                        if not last:
                            sel = inner[tile]
                            dv[g_tile][sel] = d[tile][sel]
                    p = torch.zeros((wy, wx), dtype=dt)
                else:
                    u = v = None
                    p = torch.where(inner, src[yc][:, xc], zero)
                    d = torch.where(inner, dv[yc][:, xc], zero)
                for k in range(1, count + 1):
                    nxt = torch.full((wy, wx), nan, dtype=dt)
                    r = (slice(k, wy - k), slice(k, wx - k))
                    nxt[r] = torch.where(
                        inner[r],
                        0.25 * (d[r] + p[k:wy - k, k - 1:wx - k - 1]
                                + p[k:wy - k, k + 1:wx - k + 1]
                                + p[k - 1:wy - k - 1, k:wx - k]
                                + p[k + 1:wy - k + 1, k:wx - k]),
                        zero)
                    p = nxt
                if not last:
                    sel = inner[tile]
                    dst[g_tile][sel] = p[tile][sel]
                    continue
                # projection of the tile; the grid's ring is 0
                if u is None:
                    u = torch.full((wy, wx), nan, dtype=dt)
                    v = torch.full((wy, wx), nan, dtype=dt)
                    u[tile] = u_prev[g_tile]
                    v[tile] = v_prev[g_tile]
                t0, t1 = tile
                pe = p[t0, t1.start + 1:t1.stop + 1]
                pw = p[t0, t1.start - 1:t1.stop - 1]
                pn = p[t0.start + 1:t0.stop + 1, t1]
                ps = p[t0.start - 1:t0.stop - 1, t1]
                u_proj[g_tile] = torch.where(
                    inner[tile], u[tile] - div(0.5 * (pe - pw), n - 1), zero)
                v_proj[g_tile] = torch.where(
                    inner[tile], v[tile] - div(0.5 * (pn - ps), n - 1), zero)
        src = dst
    return u_prev, v_prev, u_proj, v_proj
