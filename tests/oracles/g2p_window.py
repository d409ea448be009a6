"""A plain torch model of where the port's FLIP G2P kernel
(fluidsims_tpu_torch/csrc/flip_g2p.cu) takes each node value from, and of
its grouped raster adds, for CPU tests that hold both against the plain
version while the kernel itself cannot run.

The kernel loads, about the centre sample's base node (j0, i0), a
plus-shaped window of 12 nodes of each projected field where the window
is centred (1 <= i0 <= n - 3, so that its columns lie in the grid): rows
j0 and j1 over columns i0 - 1 .. i0 + 2 (slots 0..3) and columns i0 and
i0 + 1 over rows j0 - 1 and j0 + 2 (clamped to the grid).  There the
centre sample reads the window; a sample shifted by one node along x
(px +- h) keeps the centre's rows and takes its nodes from fixed slots
(SLOTS) where its base node is the centre's +- 1 and its far node the
next, all four from memory otherwise; along y likewise with the centre's
columns.  Where the window is not centred, every sample reads memory.
Every sample computes its own coordinate, floor, far node and fraction
(flip.cuh flip_axis), so only where a value comes from changes.  The
model records, for every node of every sample, the index it reads,
whether the window or memory gave it, and the index the window slot was
loaded from, and blends the values so taken in the plain version's order.

The raster: the lanes of a warp (32 consecutive particles, since a block
is whole warps) that land in one cell form a group, whose lowest lane
adds the group's count once.  Block sizes are read
from the source, so that the model cannot drift from them."""

import re
from pathlib import Path

import torch

from fluidsims_tpu_torch.ops.scalar import div, scalar

SRC = (Path(__file__).resolve().parents[2] / "fluidsims_tpu_torch" / "csrc"
       / "flip_g2p.cu").read_text()
WARP = 32


def _macro(name: str) -> int:
    return int(re.search(rf"#define {name} (\d+)", SRC).group(1))


THREADS = _macro("FST_G2P_THREADS")
F64_THREADS = _macro("FST_G2P_F64_THREADS")


def axis(p: torch.Tensor, n: int):
    """flip_axis: (i0, i1, t, o) of coordinate p; a NaN coordinate's floor
    converts to 0 on the card, and the index clamp keeps it in the grid."""
    g = torch.clamp(p * (n - 1), scalar(p, 0.0), scalar(p, n - 1.001))
    fl = torch.floor(g)
    i0 = torch.where(torch.isnan(fl), torch.zeros_like(fl), fl)
    i0 = torch.clamp(i0.to(torch.int64), 0, n - 1)
    i1 = torch.clamp_max(i0 + 1, n - 1)
    t = g - i0
    return i0, i1, t, 1 - t


def blend(x, y, f00, f01, f10, f11):
    """flip_blend: f<x><y> at (y.i<y>, x.i<x>)."""
    return x[3] * (y[3] * f00 + y[2] * f01) + x[2] * (y[3] * f10 + y[2] * f11)


class Window:
    """One projected field's window about the centre (cx, cy): x0, x1 (4
    slots each, rows cy.i0 and cy.i1), ya, yb (2 slots each, rows cy.i0 - 1
    and cy.i0 + 2 at columns cx.i0 and cx.i1), as values and as the
    (row, col) each slot was loaded from."""

    def __init__(self, f: torch.Tensor, cx, cy, n: int):
        self.f, self.n = f, n
        cols = [torch.clamp(cx[0] - 1 + k, 0, n - 1) for k in range(4)]
        ra = torch.clamp(cy[0] - 1, 0, n - 1)
        rb = torch.clamp(cy[0] + 2, 0, n - 1)
        self.where = {
            "x0": [(cy[0], c) for c in cols], "x1": [(cy[1], c) for c in cols],
            "ya": [(ra, cx[0]), (ra, cx[1])], "yb": [(rb, cx[0]), (rb, cx[1])]}
        self.val = {k: [f[r, c] for r, c in v] for k, v in self.where.items()}

    def slot(self, part: str, s: torch.Tensor):
        """(value, (row, col) loaded) of slot s (a tensor of 0..3, clipped
        where out of range) of `part`."""
        k = torch.clamp(s, 0, len(self.val[part]) - 1)
        pick = lambda seq: torch.stack(seq, -1).gather(  # noqa: E731
            -1, k[:, None])[:, 0]
        return (pick(self.val[part]),
                tuple(pick([w[i] for w in self.where[part]]) for i in (0, 1)))


class Node:
    """A node a sample reads: the index it asks for, whether the window
    gave it, the index the window slot holds, and the value taken."""

    def __init__(self, r, c, in_window, slot_rc, slot_val, f):
        self.r, self.c, self.in_window = r, c, in_window
        self.slot_r = torch.where(in_window, slot_rc[0], r)
        self.slot_c = torch.where(in_window, slot_rc[1], c)
        self.value = torch.where(in_window, slot_val, f[r, c])


# The window slots of a shifted sample's nodes f00, f01, f10, f11 where
# it takes them from the window (flip_g2p.cu shifted_x, shifted_y).
SLOTS = {"x+": (("x0", 2), ("x1", 2), ("x0", 3), ("x1", 3)),
         "x-": (("x0", 0), ("x1", 0), ("x0", 1), ("x1", 1)),
         "y+": (("x1", 1), ("yb", 0), ("x1", 2), ("yb", 1)),
         "y-": (("ya", 0), ("x0", 1), ("ya", 1), ("x0", 2))}


def _nodes(f, x, y):
    """The (row, col) of a sample's nodes f00, f01, f10, f11."""
    return ((y[0], x[0]), (y[1], x[0]), (y[0], x[1]), (y[1], x[1]))


def samples(u_proj, v_proj, u_prev, v_prev, px, py, n: int):
    """The kernel's six samples of one particle set: {name: (su, sv,
    nodes)} for 'new', 'old', 'x+', 'x-', 'y+', 'y-', the nodes a list of
    Node in the order f00, f01, f10, f11 of each field (u, then v).  'old'
    reads memory; where the window is centred, 'new' reads its slots 1
    and 2 and a shifted sample its SLOTS where its base node is the
    centre's +- 1 and its far node the next; the rest read memory."""
    h = torch.tensor(1.0 / (n - 1), dtype=px.dtype)
    cx, cy = axis(px, n), axis(py, n)
    wins = [Window(f, cx, cy, n) for f in (u_proj, v_proj)]
    centred = (cx[0] >= 1) & (cx[0] <= n - 3)
    out = {}
    nodes = [Node(r, c, torch.zeros_like(centred), (r, c), f[r, c], f)
             for f in (u_prev, v_prev) for r, c in _nodes(f, cx, cy)]
    out["old"] = (blend(cx, cy, *[q.value for q in nodes[:4]]),
                  blend(cx, cy, *[q.value for q in nodes[4:]]), nodes)
    nodes = []
    for w in wins:
        for (r, c), (part, k) in zip(_nodes(w.f, cx, cy),
                                     (("x0", 1), ("x1", 1), ("x0", 2),
                                      ("x1", 2))):
            nodes.append(Node(r, c, centred,
                              *w.slot(part, torch.full_like(r, k))[::-1],
                              w.f))
    out["new"] = (blend(cx, cy, *[q.value for q in nodes[:4]]),
                  blend(cx, cy, *[q.value for q in nodes[4:]]), nodes)
    for name, d in (("x+", 1), ("x-", -1), ("y+", 1), ("y-", -1)):
        along_x = name[0] == "x"
        a = axis((px if along_x else py) + d * h, n)
        c = cx if along_x else cy
        inw = centred & (a[0] == c[0] + d) & (a[1] == a[0] + 1)
        x, y = (a, cy) if along_x else (cx, a)
        nodes = []
        for w in wins:
            for (r, col), (part, k) in zip(_nodes(w.f, x, y), SLOTS[name]):
                nodes.append(Node(r, col, inw,
                                  *w.slot(part, torch.full_like(r, k))[::-1],
                                  w.f))
        out[name] = (blend(x, y, *[q.value for q in nodes[:4]]),
                     blend(x, y, *[q.value for q in nodes[4:]]), nodes)
    return out


def raster_groups(n: int, nx: torch.Tensor, ny: torch.Tensor):
    """(density, adds): the raster as the kernel's grouped adds make it
    (one add of a group's count a (warp, cell)), and the number of adds."""
    rx = torch.clamp((nx * n).to(torch.int32), 0, n - 1).long()
    ry = torch.clamp((ny * n).to(torch.int32), 0, n - 1).long()
    cell = ry * n + rx
    warp = torch.arange(cell.numel()) // WARP
    keys, counts = torch.unique(warp * (n * n) + cell, return_counts=True)
    density = torch.zeros(n * n, dtype=torch.int32)
    density.index_add_(0, keys % (n * n), counts.to(torch.int32))
    return density.reshape(n, n), int(keys.numel())


def g2p(cfg, pos, vel, u_prev, v_prev, u_proj, v_proj, flip=None):
    """(pos, vel, affine_x, affine_y, density, samples): the kernel's
    outputs with each value taken as the model says, in the plain
    version's order of operations, and the samples with their nodes."""
    n, dt = cfg.grid, cfg.dt
    flip = cfg.flip if flip is None else flip
    px, py = pos[:, 0], pos[:, 1]
    s = samples(u_proj, v_proj, u_prev, v_prev, px, py, n)
    new_u, new_v, _ = s["new"]
    old_u, old_v, _ = s["old"]
    vel_x = (1 - flip) * new_u + flip * (vel[:, 0] + new_u - old_u)
    vel_y = (1 - flip) * new_v + flip * (vel[:, 1] + new_v - old_v)
    h = 1.0 / (n - 1)
    ax = torch.stack([div(0.5 * (s["x+"][0] - s["x-"][0]), h),
                      div(0.5 * (s["x+"][1] - s["x-"][1]), h)], -1)
    ay = torch.stack([div(0.5 * (s["y+"][0] - s["y-"][0]), h),
                      div(0.5 * (s["y+"][1] - s["y-"][1]), h)], -1)
    nx = px + vel_x * dt
    ny = py + vel_y * dt
    vel_x = torch.where((nx < 0.01) | (nx > 0.99), vel_x * -0.35, vel_x)
    vel_y = torch.where((ny < 0.01) | (ny > 0.99), vel_y * -0.35, vel_y)
    lo, hi = scalar(nx, 0.01), scalar(nx, 0.99)
    nx, ny = torch.clamp(nx, lo, hi), torch.clamp(ny, lo, hi)
    density, _ = raster_groups(n, nx, ny)
    return (torch.stack([nx, ny], -1), torch.stack([vel_x, vel_y], -1), ax,
            ay, density, s)
