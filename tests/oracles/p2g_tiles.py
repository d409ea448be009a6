"""A plain torch model of the port's tiled particle-to-grid kernels
(fluidsims_tpu_torch/csrc/p2g_tiles.cuh, with csrc/mpm_p2g.cu and
csrc/flip_p2g.cu), for CPU tests that hold its binning, chunks, sort and
runs against the plain P2Gs while the kernels themselves cannot run.

The kernel bins the particles by tile of shifted base nodes (MPM: the base
node clamped to [-3, g] as mpm_base clamps it, plus 2, a particle without a
target inside the grid joining no tile; FLIP: the base clamped to [-1, n],
plus 1), cuts each tile's particles into chunks of `chunk`, sorts a chunk
by its particles' cell in the tile, takes the sorted particles 32 at a
time (a warp), and within a warp sums each run of one cell's particles
target by target (the targets some lane of the run adds to), then adds the
run's sums to the grids, one add a target and field.  The model does the
same with torch ops, the particles of a tile in index order (the kernel's
order comes from atomics, any order), each particle's targets and values
in the plain version's operations (solvers/mpm.py::_p2g, solvers/
flip_apic.py::_p2g), and asserts the two premises the kernel rests on:
every particle's cell lies in its tile, and the particles of a run share
their 9 targets.

The tile, chunk and threads, the size from which the wrappers take the
tiled design, and the tile counts a block keeps in shared memory are read
from the sources' macros and constants, so that the model cannot drift
from them."""

import re
from pathlib import Path
from typing import NamedTuple

import torch

from fluidsims_tpu_torch.ops.scalar import div
from fluidsims_tpu_torch.solvers import flip_apic, mpm

CSRC = Path(__file__).resolve().parents[2] / "fluidsims_tpu_torch" / "csrc"
WARP = 32
TARGETS = 9
# the H100's shared memory a block (227 KB)
SMEM_MAX = 232448


def _source(name: str) -> str:
    return (CSRC / name).read_text()


def _macro(src: str, name: str) -> int:
    return int(re.search(rf"#define {name} (\d+)", src).group(1))


def _constexpr(src: str, name: str) -> int:
    return int(re.search(rf"constexpr (?:int|long long) {name} = (\d+);",
                         src).group(1))


class Shape(NamedTuple):
    tile_x: int
    tile_y: int
    chunk: int
    threads: int
    fields: int   # values a particle staged


def _shape(src: str, prefix: str, kind: str) -> Shape:
    return Shape(*(_macro(src, f"FST_{prefix}_P2G_{k}")
                   for k in ("TILE_X", "TILE_Y", "CHUNK", "THREADS")),
                 int(re.search(rf"struct {kind} {{\s*static constexpr int "
                               r"kFields = (\d+);", src).group(1)))


HEADER = _source("p2g_tiles.cuh")
MPM = _shape(_source("mpm_p2g.cu"), "MPM", "MPMParticles")
FLIP = _shape(_source("flip_p2g.cu"), "FLIP", "FlipParticles")
TILED_FROM = _macro(HEADER, "FST_P2G_TILED_FROM")
SHARED_TILES = _constexpr(HEADER, "kP2GSharedTiles")
ATOMIC_THREADS = _constexpr(HEADER, "kP2GAtomicThreads")


def design(n_p: int) -> str:
    """The design the wrappers take for n_p particles."""
    return "tiled" if n_p >= TILED_FROM else "atomic"


def tiles(shape: Shape, gx: int, gy: int) -> tuple[int, int]:
    """(tiles along x, tiles) of a (gy, gx) grid: shifted bases span
    [0, g + 2) along each axis."""
    tx = -(-(gx + 2) // shape.tile_x)
    return tx, tx * -(-(gy + 2) // shape.tile_y)


def smem_bytes(shape: Shape, itemsize: int, gx: int, gy: int) -> int:
    """A tiled launch's dynamic shared memory a block (p2g_shape): the
    staged chunk and its sort's int arrays, or the tile counts of phases
    1-2 where larger."""
    sort = (shape.fields * shape.chunk * itemsize
            + (shape.tile_x * shape.tile_y + 4 * shape.chunk) * 4)
    n = tiles(shape, gx, gy)[1]
    return max(sort, 4 * n if n <= SHARED_TILES else 0)


def layout(n_p: int, n_tiles: int, chunk: int) -> dict:
    """The int32 scratch's parts, in words (p2g_layout)."""
    counts = 4
    offsets = counts + n_tiles
    first_chunk = offsets + n_tiles + 1
    keys = (first_chunk + n_tiles + 1) & ~1
    idx = keys + 2 * n_p
    chunks = (idx + n_p + 3) & ~3
    return {"counts": counts, "offsets": offsets, "first_chunk": first_chunk,
            "keys": keys, "idx": idx, "chunks": chunks,
            "total": chunks + 4 * (n_tiles + -(-n_p // chunk))}


class Targets(NamedTuple):
    shifted: torch.Tensor   # (n, 2) shifted base node
    joins: torch.Tensor     # (n,) the particle joins a tile
    node: torch.Tensor      # (n, 9) target node, row-major
    inside: torch.Tensor    # (n, 9) the target lies inside the grid
    use: torch.Tensor       # (n, 9) the particle adds there
    values: torch.Tensor    # (n, 9, 3) mass and the two momenta


def mpm_targets(cfg, pos, vel, F, Jp, shift: int = 2) -> Targets:
    """Each particle's 9 targets (ox outer, oy inner) and values in the
    plain version's operations; the shifted base clamps as mpm_base."""
    base, frac = mpm._base_frac(cfg, pos)
    wx, wy = mpm._bspline_w(frac[:, 0]), mpm._bspline_w(frac[:, 1])
    _, stress = mpm._plastic_and_stress(cfg, mpm.MPMState(pos, vel, F, Jp))
    s00, s01 = stress[:, 0, 0], stress[:, 0, 1]
    s10, s11 = stress[:, 1, 0], stress[:, 1, 1]
    pm, dx = cfg.particle_mass, cfg.dx
    mvx, mvy = pm * vel[:, 0], pm * vel[:, 1]
    g = torch.tensor([cfg.gx, cfg.gy])
    shifted = torch.minimum(torch.maximum(base, torch.tensor(-3)), g) + shift
    joins = ((shifted >= 0) & (shifted < g + 2)).all(1)
    node, inside, values = [], [], []
    for ox in range(3):
        ix = base[:, 0] + ox
        dposx = (ox - frac[:, 0]) * dx
        for oy in range(3):
            iy = base[:, 1] + oy
            w = wx[ox] * wy[oy]
            dposy = (oy - frac[:, 1]) * dx
            fx = s00 * dposx + s01 * dposy
            fy = s10 * dposx + s11 * dposy
            inside.append((ix >= 0) & (ix < cfg.gx) & (iy >= 0)
                          & (iy < cfg.gy))
            node.append(iy * cfg.gx + ix)
            values.append(torch.stack([w * pm, w * (mvx + fx),
                                       w * (mvy + fy)], -1))
    inside = torch.stack(inside, 1)
    return Targets(shifted, joins, torch.stack(node, 1), inside,
                   torch.ones_like(inside), torch.stack(values, 1))


def flip_targets(cfg, pos, vel, ax, ay, apic=None, shift: int = 1) -> Targets:
    """Each particle's 9 targets (oy outer, ox inner) and values in the
    plain version's operations, the clipped node, added where wt > 0; the
    shifted base is the base clamped to [-1, n], plus `shift`."""
    n = cfg.grid
    apic = cfg.apic if apic is None else apic
    gx, gy = pos[:, 0] * (n - 1), pos[:, 1] * (n - 1)
    base = torch.stack([torch.floor(gx), torch.floor(gy)], 1).to(torch.int64)
    shifted = base.clamp(-1, n) + shift
    node, use, values = [], [], []
    for oy in (-1, 0, 1):
        j = torch.clamp(base[:, 1] + oy, 0, n - 1)
        wy = flip_apic._w1(gy - j)
        ry = div(j - gy, n - 1)
        for ox in (-1, 0, 1):
            i = torch.clamp(base[:, 0] + ox, 0, n - 1)
            wt = flip_apic._w1(gx - i) * wy
            rx = div(i - gx, n - 1)
            vvx = vel[:, 0] + apic * (ax[:, 0] * rx + ay[:, 0] * ry)
            vvy = vel[:, 1] + apic * (ax[:, 1] * rx + ay[:, 1] * ry)
            node.append(j * n + i)
            use.append(wt > 0.0)
            values.append(torch.stack([wt, wt * vvx, wt * vvy], -1))
    use = torch.stack(use, 1)
    joins = torch.ones(pos.shape[0], dtype=torch.bool)
    return Targets(shifted, joins, torch.stack(node, 1),
                   torch.ones_like(use), use, torch.stack(values, 1))


def p2g_tiled(q: Targets, shape: Shape, gx: int, gy: int,
              stats: dict | None = None):
    """(mass, x momentum, y momentum), each (gy, gx), of the tiled kernel's
    model on the targets `q`; `stats` (if given) gets the chunks, the most
    particles in a tile, the runs and the global adds."""
    dt = q.values.dtype
    n_tx, n_tiles = tiles(shape, gx, gy)
    tx, ty, C = shape.tile_x, shape.tile_y, shape.chunk
    cells = tx * ty
    k = torch.nonzero(q.joins).flatten()      # particles with a tile
    sx, sy = q.shifted[k, 0], q.shifted[k, 1]
    assert bool(((sx >= 0) & (sy >= 0)).all()), "a shifted base below 0"
    tile = (sy // ty) * n_tx + sx // tx
    assert bool((tile < n_tiles).all()), "a tile past the last"
    # the tile's particles in index order, cut into chunks of C
    by_tile = torch.argsort(tile, stable=True)
    k, sx, sy, tile = k[by_tile], sx[by_tile], sy[by_tile], tile[by_tile]
    counts = torch.bincount(tile, minlength=n_tiles)
    first = torch.cumsum(counts, 0) - counts
    chunk = (torch.arange(len(k)) - first[tile]) // C
    # each chunk sorted by the particle's cell in its tile
    cell = (sy - (tile // n_tx) * ty) * tx + (sx - (tile % n_tx) * tx)
    assert bool(((cell >= 0) & (cell < cells)).all()), "a cell past its tile"
    group = tile * (len(k) // C + 1) + chunk
    s = torch.argsort(group * cells + cell, stable=True)
    k, cell, group = k[s], cell[s], group[s]
    g_first = torch.zeros_like(group)
    new = torch.ones_like(group, dtype=torch.bool)
    new[1:] = group[1:] != group[:-1]
    g_first[new] = torch.nonzero(new).flatten()
    g_first = torch.cummax(g_first, 0).values
    warp = (torch.arange(len(k)) - g_first) // WARP
    # runs: one cell in one warp of one chunk
    head = torch.ones_like(new)
    head[1:] = ((group[1:] != group[:-1]) | (warp[1:] != warp[:-1])
                | (cell[1:] != cell[:-1]))
    run = torch.cumsum(head.long(), 0) - 1
    n_runs = int(run[-1]) + 1 if len(run) else 0
    lead = k[head]
    node, inside = q.node[k], q.inside[k]
    assert bool((node == q.node[lead][run]).all()), "a run's targets differ"
    assert bool((inside == q.inside[lead][run]).all()), "a run's walls differ"
    u = inside & q.use[k]
    vals = torch.where(u[..., None], q.values[k], torch.zeros((), dtype=dt))
    sums = torch.zeros((n_runs, TARGETS, 3), dtype=dt).index_add_(0, run,
                                                                   vals)
    adds = torch.zeros((n_runs, TARGETS), dtype=torch.long).index_add_(
        0, run, u.long()) > 0
    grids = torch.zeros((3, gx * gy), dtype=dt)
    at = q.node[lead][adds]
    for f in range(3):
        grids[f].index_add_(0, at, sums[..., f][adds])
    if stats is not None:
        stats.update(chunks=int(new.sum()), most_in_tile=int(counts.max()),
                     runs=n_runs, global_adds=3 * int(adds.sum()),
                     particle_adds=3 * int(u.sum()))
    return tuple(g.reshape(gy, gx) for g in grids)


def mpm_p2g_tiled(cfg, pos, vel, F, Jp, shape=None, shift: int = 2,
                  stats=None):
    """The tiled MPM P2G's model: (mass, mom_x, mom_y)."""
    return p2g_tiled(mpm_targets(cfg, pos, vel, F, Jp, shift),
                     shape or MPM, cfg.gx, cfg.gy, stats)


def flip_p2g_tiled(cfg, pos, vel, ax, ay, apic=None, shape=None,
                   shift: int = 1, stats=None):
    """The tiled FLIP P2G's model: (mass, mom_u, mom_v)."""
    return p2g_tiled(flip_targets(cfg, pos, vel, ax, ay, apic, shift),
                     shape or FLIP, cfg.grid, cfg.grid, stats)
