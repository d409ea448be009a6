"""Force-directed layout of the prime/divisor graph, 2-D and 3-D (port of
fluidsims_tpu.solvers.nbody_graph).

Behavioral spec: number_fluid2d.c / number_fluid3d.c, which despite their
names are Barnes–Hut force-directed layouts of the graph whose edges join
a root to every prime and every number to its multiples (generate_edges,
number_fluid2d.c:209-242); spring forces k=0.0125 toward link length 20
with softening 4 (:493-511); repulsion 180/d^2 (:386-438); damped (0.86)
velocity integration with speed clamp 80 and dt=0.5, root pinned at the
origin (:515-539, :469-476); circle / Fibonacci-sphere inits of radius
20*sqrt(n) (:356-368, number_fluid3d.c:384-404).

Repulsion engines:

* 'exact' (default) — the all-pairs sum.  `step` calls the CUDA kernel
  kernels/nbody_cuda.repulsion_exact (one launch a step on CUDA tensors;
  its plain version, `_repulsion_exact`, on CPU tensors).
  `_repulsion_exact` takes the targets in chunks of `cfg.chunk` to bound
  the memory of its (chunk, n) blocks.
* 'grid' — the uniform-grid monopole approximation (`_repulsion_grid`),
  plain PyTorch on every device: cell centres of mass for the far field,
  and in 2-D up to `near_field_max` bodies the exact pairs of the 3x3
  neighbour cells in place of their monopoles.

The springs are one `index_add_` over the graph's incidence sorted by
target (`_spring_forces_static`); `_spring_forces` takes an edge list as
data.  The speed clamp's quotient is taken tensor by tensor
(ops/scalar.py), as JAX takes it.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import BaseConfig
from ..core.device import resolve_device
from ..core.stepper import run_steps
from ..ops import cell_list as cl_ops
from ..ops.scalar import div, rdiv

__all__ = ["GraphLayoutConfig", "GraphLayoutState", "generate_edges", "init",
           "init_arrays", "step", "run"]


def generate_edges(max_number: int) -> np.ndarray:
    """Sieve of Eratosthenes edge list: root(0) -> primes, n -> multiples
    (generate_edges, number_fluid2d.c:209-242).  Node i represents number
    i+1."""
    prime = np.ones(max_number + 1, bool)
    prime[:2] = False
    for p in range(2, int(max_number**0.5) + 1):
        if prime[p]:
            prime[p * p:: p] = False

    edges = []
    ns = np.arange(2, max_number + 1)
    pr = ns[prime[2:]]
    edges.append(np.stack([np.zeros_like(pr), pr - 1], -1))
    for frm in range(2, max_number + 1):
        tos = np.arange(2 * frm, max_number + 1, frm)
        if tos.size:
            edges.append(
                np.stack([np.full_like(tos, frm - 1), tos - 1], -1)
            )
    return np.concatenate(edges, 0).astype(np.int32)


@dataclass(frozen=True)
class GraphLayoutConfig(BaseConfig):
    max_number: int = 1 << 17
    dims: int = 2                  # 2 or 3
    link_length: float = 20.0
    spring_k: float = 0.0125
    softening: float = 4.0
    repulsion: float = 180.0
    damping: float = 0.86
    dt: float = 0.5
    max_speed: float = 80.0
    grid_res: int = 32             # monopole mesh resolution per axis
    near_field_max: int = 1 << 15  # grid mode: above this, monopole-only
    # repulsion engine: "exact" = all-pairs, "grid" = grid monopoles
    engine: str = "exact"
    chunk: int = 1024              # targets per block of the plain all-pairs
    dtype: str = "float32"

    def validate(self):
        self._require(self.max_number >= 2, "max_number >= 2")
        self._require(self.dims in (2, 3), "dims must be 2 or 3")
        self._require(self.grid_res >= 4, "grid_res >= 4")
        self._require(self.engine in ("exact", "grid"),
                      "engine must be exact or grid")

    @property
    def n_bodies(self):
        return self.max_number


class GraphLayoutState(NamedTuple):
    pos: torch.Tensor    # (n, dims)
    vel: torch.Tensor
    edges: torch.Tensor  # (m, 2) int32, the static graph
    steps: torch.Tensor  # 0-d int32


def init_arrays(cfg: GraphLayoutConfig):
    """NumPy (pos, vel, edges) of the initial layout, shared by `init` and
    the native engine."""
    n = cfg.n_bodies
    radius = math.sqrt(n) * 20.0
    if cfg.dims == 2:
        a = 2.0 * np.pi * (np.arange(1, n) - 1) / max(n - 1, 1)
        pos = np.zeros((n, 2))
        pos[1:, 0] = np.cos(a) * radius
        pos[1:, 1] = np.sin(a) * radius
    else:
        # Fibonacci sphere (init_bodies_sphere, number_fluid3d.c:384-404)
        golden = np.pi * (3.0 - math.sqrt(5.0))
        k = np.arange(n - 1)
        m = n - 1
        t = k / max(m - 1, 1)
        yy = 1.0 - 2.0 * t
        r = np.sqrt(np.maximum(0.0, 1.0 - yy * yy))
        phi = golden * k
        pos = np.zeros((n, 3))
        pos[1:, 0] = np.cos(phi) * r * radius
        pos[1:, 1] = yy * radius
        pos[1:, 2] = np.sin(phi) * r * radius

    return pos, np.zeros((n, cfg.dims)), generate_edges(cfg.max_number)


def init(cfg: GraphLayoutConfig, device="cuda") -> GraphLayoutState:
    """The initial layout on `device` (the GPU unless asked for the CPU;
    raises where there is none)."""
    device = resolve_device(device)
    pos, vel, edges = init_arrays(cfg)
    dt = cfg.torch_dtype
    return GraphLayoutState(
        pos=torch.tensor(pos, dtype=dt, device=device),
        vel=torch.tensor(vel, dtype=dt, device=device),
        edges=torch.tensor(edges, device=device),
        steps=torch.zeros((), dtype=torch.int32, device=device),
    )


def _spring_law(cfg, d: torch.Tensor) -> torch.Tensor:
    """Spring force k (|d| - L) / |d| * d with softened |d| (worker_step,
    number_fluid2d.c:493-511), per row of d."""
    d2 = torch.sum(d * d, dim=-1) + cfg.softening
    inv_d = rdiv(1.0, torch.sqrt(d2))
    dist = d2 * inv_d
    return (cfg.spring_k * (dist - cfg.link_length) * inv_d)[:, None] * d


def _spring_forces(cfg, pos, edges):
    """Edge springs accumulated by two `index_add_`s over an edge list
    given as data (the sharded runner passes its shard); the root (node 0)
    receives no spring force."""
    src = edges[:, 0].to(torch.int64)
    dst = edges[:, 1].to(torch.int64)
    f = _spring_law(cfg, pos[dst] - pos[src])
    f_src = torch.where((src != 0)[:, None], f, 0.0)
    f_dst = torch.where((dst != 0)[:, None], -f, 0.0)
    out = torch.zeros_like(pos)
    out.index_add_(0, src, f_src)
    out.index_add_(0, dst, f_dst)
    return out


@functools.lru_cache(maxsize=8)
def _sorted_incidence(max_number: int):
    """Static (target, other-endpoint) incidence of the prime/divisor
    graph, root entries dropped (node 0 receives no spring force), sorted
    by target node.  NumPy int32, computed once per max_number."""
    e = generate_edges(max_number)
    tgt = np.concatenate([e[:, 0], e[:, 1]])
    oth = np.concatenate([e[:, 1], e[:, 0]])
    keep = tgt != 0
    tgt, oth = tgt[keep], oth[keep]
    order = np.argsort(tgt, kind="stable")
    return tgt[order], oth[order]


@functools.lru_cache(maxsize=8)
def _incidence_on(max_number: int, device: torch.device):
    """`_sorted_incidence` as int64 tensors on `device`, once per
    device."""
    tgt, oth = _sorted_incidence(max_number)
    return (torch.from_numpy(tgt.astype(np.int64)).to(device),
            torch.from_numpy(oth.astype(np.int64)).to(device))


def _spring_forces_static(cfg, pos):
    """Spring forces over the sorted incidence: the spring law is
    antisymmetric in the endpoints, so each (target, other) entry gives
    the signed contribution to its target, and one `index_add_` over the
    sorted targets sums them (JAX: a sorted segment_sum)."""
    tgt, oth = _incidence_on(cfg.max_number, pos.device)
    f = _spring_law(cfg, pos[oth] - pos[tgt])
    return torch.zeros_like(pos).index_add_(0, tgt, f)


def _repulsion_exact(cfg, pos, rows=None):
    """Exact all-pairs 1/d^2 repulsion, the plain version of the CUDA
    kernel: for each target t_i,
    sum_j repulsion * (|t_i - p_j|^2 + softening)^(-3/2) * (t_i - p_j),
    from the explicit differences (not the |a|^2 + |b|^2 - 2ab identity,
    which cancels catastrophically in f32 at 7e3-scale coordinates).  The
    self pair contributes exactly zero (d = 0).

    `rows` (a subset of positions) restricts the TARGETS while the sum
    still runs over all of `pos` (the sharded runner's slice).  The
    targets go in chunks of `cfg.chunk`, which bounds the (chunk, n)
    blocks in memory and changes no sum."""
    targets = pos if rows is None else rows
    nt, dims = targets.shape
    CH = max(1, min(cfg.chunk, nt))
    comps = [pos[:, k] for k in range(dims)]
    out = torch.empty_like(targets)
    for a in range(0, nt, CH):
        pc = targets[a:a + CH]
        d = [pc[:, k][:, None] - comps[k][None, :] for k in range(dims)]
        d2 = d[0] * d[0] + d[1] * d[1]
        if dims == 3:
            d2 = d2 + d[2] * d[2]
        d2 = d2 + cfg.softening
        inv = torch.rsqrt(d2)
        # w = repulsion * d2^(-3/2) via inv^3: no division a pair
        w = cfg.repulsion * (inv * inv * inv)
        out[a:a + CH] = torch.stack([torch.sum(w * dk, dim=1) for dk in d],
                                    -1)
    return out


def _repulsion_grid(cfg, pos):
    """Grid-monopole repulsion: the cell centres of mass of a grid_res^dims
    grid over the bounding box for the far field; in 2-D with n <=
    near_field_max, the exact pairs of the 3x3 neighbour cells in place of
    their monopoles (apply_repulsion_from_tree, number_fluid2d.c:386-438,
    as uniform cells)."""
    n, dims = pos.shape
    G = cfg.grid_res
    dev = pos.device

    lo = torch.amin(pos, dim=0)
    hi = torch.amax(pos, dim=0)
    span = torch.clamp_min(torch.amax(hi - lo), 1e-3)
    cell = div(span, G)
    ij = torch.clamp(((pos - lo) / cell).to(torch.int32), 0, G - 1)

    if dims == 2:
        cid = ij[:, 1] * G + ij[:, 0]
        M = G * G
    else:
        cid = (ij[:, 2] * G + ij[:, 1]) * G + ij[:, 0]
        M = G * G * G
    cid64 = cid.to(torch.int64)

    # cell monopoles
    mass = torch.zeros(M, dtype=pos.dtype, device=dev).index_add_(
        0, cid64, torch.ones(n, dtype=pos.dtype, device=dev))
    mpos = torch.zeros((M, dims), dtype=pos.dtype, device=dev).index_add_(
        0, cid64, pos)
    com = mpos / torch.clamp_min(mass, 1.0)[:, None]

    # far field: the monopole of every cell, over chunks of bodies so the
    # (chunk, M, dims) blocks stay bounded
    CH = min(n, 4096)
    far = torch.empty_like(pos)
    for a in range(0, n, CH):
        d = pos[a:a + CH, None, :] - com[None, :, :]      # (CH, M, dims)
        d2 = torch.sum(d * d, dim=-1) + cfg.softening
        inv_d = rdiv(1.0, torch.sqrt(d2))
        fmag = cfg.repulsion * mass[None, :] / d2
        far[a:a + CH] = torch.sum((fmag * inv_d)[..., None] * d, dim=1)

    if dims == 3 or n > cfg.near_field_max:
        # near field left to the monopoles (the far field holds every cell)
        return far

    # near field: take out the monopoles of this body's cell and its
    # neighbours and add the exact pairs of those cells' bodies
    cap = max(16, int(8 * n / M) + 8)
    grid2 = cl_ops.CellGrid(Gx=G, Gy=G, cell=1.0, capacity=cap)
    slot = cid64 * cap + _rank_in_cell(cid, n).to(torch.int64)
    keep = slot < M * cap                              # JAX's mode="drop"
    table = torch.full((M * cap,), n, dtype=torch.int32, device=dev)
    table[slot[keep]] = torch.arange(n, dtype=torch.int32, device=dev)[keep]
    cl = cl_ops.CellList(table=table.reshape(M, cap), cid=cid, n=n)

    near = torch.zeros_like(pos)
    self_idx = torch.arange(n, dtype=torch.int32, device=dev)
    for ox, oy in cl_ops.NEIGHBOR_OFFSETS:
        idx, valid = cl_ops.neighbor_indices(grid2, cl, ox, oy)
        j = torch.clamp(idx, 0, n - 1).to(torch.int64)
        dd = pos[:, None, :] - pos[j]
        dd2 = torch.sum(dd * dd, dim=-1) + cfg.softening
        ok = valid & (idx != self_idx[:, None])
        inv = rdiv(1.0, torch.sqrt(dd2))
        fm = torch.where(ok, rdiv(cfg.repulsion, dd2), 0.0)
        near = near + torch.sum((fm * inv)[..., None] * dd, dim=1)

        # take out this neighbour cell's monopole (in the far field)
        cx = cl.cid % G + ox
        cy = torch.div(cl.cid, G, rounding_mode="floor") + oy
        in_grid = (cx >= 0) & (cx < G) & (cy >= 0) & (cy < G)
        nc = torch.where(in_grid, cy * G + cx, 0).to(torch.int64)
        dcm = pos - com[nc]
        dcm2 = torch.sum(dcm * dcm, dim=-1) + cfg.softening
        invc = rdiv(1.0, torch.sqrt(dcm2))
        fmc = torch.where(in_grid, cfg.repulsion * mass[nc] / dcm2, 0.0)
        near = near - (fmc * invc)[:, None] * dcm

    return far + near


def _rank_in_cell(cid, n):
    """Each body's rank among the bodies of its cell, in index order
    (int32)."""
    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    first = torch.searchsorted(sorted_cid, sorted_cid, side="left")
    rank_sorted = (torch.arange(n, dtype=torch.int64, device=cid.device)
                   - first).to(torch.int32)
    rank = torch.zeros(n, dtype=torch.int32, device=cid.device)
    rank[order] = rank_sorted
    return rank


def step(cfg: GraphLayoutConfig, s: GraphLayoutState,
         repulsion=None, forces=None) -> GraphLayoutState:
    """One layout step.  `repulsion(pos) -> forces`, where given, replaces
    the engine's repulsion.  Without it the exact engine calls the CUDA
    kernel's wrapper (kernels/nbody_cuda.repulsion_exact: one launch on
    CUDA tensors, the plain `_repulsion_exact` on CPU tensors) and the
    grid engine `_repulsion_grid`.  `forces(pos)`, where given, replaces
    the whole sum of springs and repulsion (the sharded runner's hook)."""
    pos = s.pos.clone()
    pos[0] = 0.0                 # root pinned (worker_step :469-476)
    vel = s.vel.clone()
    vel[0] = 0.0

    if forces is not None:
        f = forces(pos)
    else:
        if repulsion is not None:
            rep = repulsion(pos)
        elif cfg.engine == "exact":
            from ..kernels import nbody_cuda as nk

            rep = nk.repulsion_exact(cfg, pos)
        else:
            rep = _repulsion_grid(cfg, pos)
        f = _spring_forces_static(cfg, pos) + rep

    v = (vel + f * cfg.dt) * cfg.damping
    speed2 = torch.sum(v * v, dim=-1, keepdim=True)
    scale = torch.where(
        speed2 > cfg.max_speed**2,
        rdiv(cfg.max_speed, torch.sqrt(torch.clamp_min(speed2, 1e-30))),
        1.0,
    )
    v = v * scale
    v[0] = 0.0
    new_pos = pos + v * cfg.dt
    new_pos[0] = 0.0
    return GraphLayoutState(pos=new_pos, vel=v, edges=s.edges,
                            steps=s.steps + 1)


def run(cfg: GraphLayoutConfig, s: GraphLayoutState, n_steps: int,
        repulsion=None) -> GraphLayoutState:
    return run_steps(lambda st: step(cfg, st, repulsion), s, n_steps)
