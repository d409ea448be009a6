"""A torch model of csrc/mpm_g2p.cu's order of work: the MLS-MPM G2P that
reads the P2G grids and forms the velocities of the nodes it gathers.

Per particle, as the kernel does it (vectorised over particles): the base
node clamped to [-3, G] as mpm.cuh's mpm_base clamps it, the fraction and
weights.  Per block of `threads` particles: the box of the in-grid nodes
its particles gather; where the box holds at most `window` nodes, each of
its nodes' velocity is formed once into the block's window and the
particles read it there, else each gathered node's velocity is formed
where it is gathered.  A node's velocity comes from its three P2G sums at
its own index by mpm.cuh's mpm_node_velocity (where the mass is > 0: the
momenta over max(mass, 1e-30), gravity dt off v, the outward component
zeroed in the 3-node band of each wall by the node's own (x, y); else 0).
The 9 nodes, ox outer and oy inner; a node outside the grid weighs 0 and
reads 0.  Then the sums of v and C and the F, Jp and position updates in
the kernel's order.  Nothing here reads a node velocity grid: the model
never forms one.
"""

from __future__ import annotations

import re
from pathlib import Path

import torch

from fluidsims_tpu_torch.ops.scalar import scalar
from fluidsims_tpu_torch.solvers import mpm


def node_velocity(cfg, m, mx, my, x, y):
    """mpm_node_velocity at nodes (x, y) with P2G sums (m, mx, my)."""
    zero = torch.zeros((), dtype=m.dtype)
    has = m > 0.0
    fm = torch.maximum(m, scalar(m, 1e-30))
    u = torch.where(has, mx / fm, zero)
    v = torch.where(has, my / fm - cfg.gravity * cfg.dt, zero)
    u = torch.where(((x < 3) & (u < 0)) | ((x > cfg.gx - 4) & (u > 0)),
                    zero, u)
    v = torch.where(((y < 3) & (v < 0)) | ((y > cfg.gy - 4) & (v > 0)),
                    zero, v)
    return u, v


def source_shape() -> tuple[int, int]:
    """(threads a block, nodes a block's window) of csrc/mpm_g2p.cu's
    macros."""
    src = (Path(mpm.__file__).parents[1] / "csrc" / "mpm_g2p.cu").read_text()
    return tuple(int(re.search(rf"#define {name} (\d+)", src).group(1))
                 for name in ("FST_MPM_G2P_THREADS", "FST_MPM_G2P_WINDOW"))


def block_boxes(cfg, base, threads: int):
    """Each block's box (x0, x1, y0, y1) of the in-grid nodes that its
    particles gather (x0 > x1 where they gather none), from the clamped
    base nodes."""
    lim = torch.tensor([cfg.gx - 1, cfg.gy - 1])
    lo, hi = base.clamp(min=0), torch.minimum(base + 2, lim)
    empty = (lo > hi).any(1, keepdim=True)
    big = 1 << 30
    lo = torch.where(empty, big, lo)
    hi = torch.where(empty, -big, hi)
    pad = -base.shape[0] % threads
    lo = torch.cat([lo, lo.new_full((pad, 2), big)]).view(-1, threads, 2)
    hi = torch.cat([hi, hi.new_full((pad, 2), -big)]).view(-1, threads, 2)
    lo, hi = lo.amin(1), hi.amax(1)
    return lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]


def fused_g2p(cfg, pos, F, Jp, mass, mom_x, mom_y, threads=None,
              window=None):
    """(pos, vel, F, Jp) after the G2P, in the kernel's order of work, with
    `threads` particles a block and windows of up to `window` nodes (the
    source's by default).  Also returns the (n, 9, 2) node velocities each
    particle gathered, and whether each block formed a window."""
    shipped = source_shape()
    threads = shipped[0] if threads is None else threads
    window = shipped[1] if window is None else window
    gx, gy = cfg.gx, cfg.gy
    dx, dt = cfg.dx, cfg.dt
    c4 = 4.0 * (1.0 / dx)
    xp = pos * (1.0 / dx)
    fb = torch.floor(xp - 0.5)
    frac = xp - fb
    lim = torch.tensor([gx, gy], dtype=fb.dtype)
    base = torch.minimum(torch.maximum(fb, scalar(fb, -3.0)), lim).long()
    wx = mpm._bspline_w(frac[:, 0])
    wy = mpm._bspline_w(frac[:, 1])
    flat = [g.reshape(-1) for g in (mass, mom_x, mom_y)]
    zero = torch.zeros((), dtype=pos.dtype)

    # each block's window: the velocities of its box's nodes, formed once,
    # the windows laid end to end
    x0, x1, y0, y1 = block_boxes(cfg, base, threads)
    width = (x1 - x0 + 1).clamp(min=0)
    nodes = width * (y1 - y0 + 1).clamp(min=0)
    windowed = (nodes > 0) & (nodes <= window)
    nodes = torch.where(windowed, nodes, 0)
    start = torch.cumsum(nodes, 0) - nodes
    win = [torch.zeros(int(nodes.sum()), dtype=pos.dtype) for _ in range(2)]
    for b in torch.nonzero(windowed).flatten().tolist():
        xs = torch.arange(int(x0[b]), int(x1[b]) + 1)
        ys = torch.arange(int(y0[b]), int(y1[b]) + 1)
        y, x = (t.reshape(-1) for t in torch.meshgrid(ys, xs, indexing="ij"))
        vel = node_velocity(cfg, *(g[y * gx + x] for g in flat), x, y)
        for w, v in zip(win, vel):
            w[int(start[b]):int(start[b] + nodes[b])] = v
    block = torch.arange(pos.shape[0]) // threads
    in_window = windowed[block]

    nvx = torch.zeros_like(frac[:, 0])
    nvy = torch.zeros_like(nvx)
    C00, C01, C10, C11 = (torch.zeros_like(nvx) for _ in range(4))
    seen = []
    for ox in range(3):
        ix = base[:, 0] + ox
        okx = (ix >= 0) & (ix < gx)
        dposx = (ox - frac[:, 0]) * dx
        for oy in range(3):
            iy = base[:, 1] + oy
            ok = okx & (iy >= 0) & (iy < gy)
            w = torch.where(ok, wx[ox] * wy[oy], zero)
            # a windowed block reads its window, another forms the node
            # where it is gathered
            i = (start[block] + (iy - y0[block]) * width[block]
                 + (ix - x0[block]))
            i = torch.where(ok & in_window, i, 0)
            node = torch.where(ok & ~in_window, iy * gx + ix, 0)
            m, mx, my = (g.index_select(0, node) for g in flat)
            u, v = node_velocity(cfg, m, mx, my, ix, iy)
            if win[0].numel():
                u = torch.where(in_window, win[0][i], u)
                v = torch.where(in_window, win[1][i], v)
            gvx, gvy = torch.where(ok, u, zero), torch.where(ok, v, zero)
            seen.append(torch.stack([gvx, gvy], -1))
            dposy = (oy - frac[:, 1]) * dx
            wgx, wgy = w * gvx, w * gvy
            nvx = nvx + wgx
            nvy = nvy + wgy
            C00 = C00 + c4 * (wgx * dposx)
            C01 = C01 + c4 * (wgx * dposy)
            C10 = C10 + c4 * (wgy * dposx)
            C11 = C11 + c4 * (wgy * dposy)

    Fe = mpm._elastic(cfg, F)
    f00, f01 = Fe[:, 0, 0], Fe[:, 0, 1]
    f10, f11 = Fe[:, 1, 0], Fe[:, 1, 1]
    a00, a01 = 1.0 + dt * C00, dt * C01
    a10, a11 = dt * C10, 1.0 + dt * C11
    n00 = a00 * f00 + a01 * f10
    n01 = a00 * f01 + a01 * f11
    n10 = a10 * f00 + a11 * f10
    n11 = a10 * f01 + a11 * f11
    eps = scalar(pos, 1.0e-6)
    oldJ = torch.maximum(f00 * f11 - f01 * f10, eps)
    newJ = torch.maximum(n00 * n11 - n01 * n10, eps)
    if mpm.MATERIALS[cfg.material] == 0:
        n01 = n01 * 0.96
        n10 = n10 * 0.96
    Jp = torch.clamp(Jp * oldJ / newJ, scalar(pos, 0.05), scalar(pos, 20.0))
    lo = scalar(pos, 2.0 * dx)
    x = torch.clamp(pos[:, 0] + dt * nvx, lo, scalar(pos, (gx - 3.0) * dx))
    y = torch.clamp(pos[:, 1] + dt * nvy, lo, scalar(pos, (gy - 3.0) * dx))
    newF = torch.stack([torch.stack([n00, n01], -1),
                        torch.stack([n10, n11], -1)], 1)
    out = (torch.stack([x, y], -1), torch.stack([nvx, nvy], -1), newF, Jp)
    return out, torch.stack(seen, 1), windowed
