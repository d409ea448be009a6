"""A plain torch model of the order of work of the port's n-body repulsion
kernel (fluidsims_tpu_torch/csrc/nbody_repulsion.cu), for CPU tests that
hold the kernel's split of the all-pairs sums against the plain version
while the kernel itself cannot run.

The kernel gives each thread `targets` targets (block b, thread t, slot k
takes target b * threads * targets + k * threads + t, and writes it only
if it is below nt), walks the sources a tile of `threads` at a time (the
last tile ragged where n is not a multiple), adds each tile's sources one
after another into a partial sum a target, with fused multiply-adds:

    d = t - p,  d2 = fma(dx, dx, fma(dy, dy, softening)) (dz innermost),
    inv = rsqrt(d2),  w = (inv * inv) * inv,  part = fma(w, d, part),

adds each tile's partial to the running total, and multiplies the total
by the repulsion once.  The model does the same, vectorized over the
targets: an f32 fused multiply-add is modelled by taking a * b + c in
f64 (the f32 product is exact there) and rounding it to f32; in f64 it
is a * b + c in f64 (one more rounding than the card's, far below the f64
bar).  w is torch.rsqrt cubed in the working dtype (the card's f32 rsqrt
is within 2 ulp; its f64 w, rsqrt.approx.ftz.f64 cubed and corrected by a
series, within a few ulp).  The block shape defaults to the source's
constants, read from the source so that the model cannot drift from
them.
"""

import re
from pathlib import Path

import torch

SRC = (Path(__file__).resolve().parents[2] / "fluidsims_tpu_torch" / "csrc"
       / "nbody_repulsion.cu").read_text()


def _macro(name: str) -> int:
    return int(re.search(rf"#define {name} (\d+)", SRC).group(1))


THREADS = {torch.float32: _macro("FST_NBODY_THREADS"),
           torch.float64: _macro("FST_NBODY_F64_THREADS")}
TARGETS = {torch.float32: _macro("FST_NBODY_TARGETS"),
           torch.float64: _macro("FST_NBODY_F64_TARGETS")}
UNROLL = _macro("FST_NBODY_UNROLL")


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c as a fused multiply-add in a's dtype (see the module
    docstring for f64)."""
    if a.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    return a * b + c


def slots(nt: int, threads: int, targets: int) -> torch.Tensor:
    """(blocks, threads, targets) of the target each slot of each thread
    takes, -1 past nt."""
    per_block = threads * targets
    blocks = -(-nt // per_block)
    b = torch.arange(blocks)[:, None, None]
    t = torch.arange(threads)[None, :, None]
    k = torch.arange(targets)[None, None, :]
    i = b * per_block + k * threads + t
    return torch.where(i < nt, i, torch.full_like(i, -1))


def repulsion_tiles(cfg, pos: torch.Tensor, rows: torch.Tensor | None = None,
                    threads: int | None = None,
                    targets: int | None = None) -> tuple[torch.Tensor, dict]:
    """(forces, info): the kernel's forces on each target of `rows` (or
    `pos`) from every body of `pos`, in the kernel's order of work with
    `threads` a block (= sources a tile) and `targets` a thread (default
    the source's for pos' dtype); info counts the blocks, the tiles and
    the sources of the last tile."""
    dt = pos.dtype
    threads = threads or THREADS[dt]
    targets = targets or TARGETS[dt]
    tg = pos if rows is None else rows
    nt, dims = tg.shape
    n = pos.shape[0]
    soft = torch.tensor(cfg.softening, dtype=dt)
    acc = torch.zeros((nt, dims), dtype=dt)
    tiles = 0
    for base in range(0, n, threads):
        src = pos[base:base + threads]
        m = src.shape[0]
        tiles += 1
        # every pair of the tile as the kernel forms them, (source, target)
        d = [tg[None, :, c] - src[:, None, c] for c in range(dims)]
        d2 = fma(d[-1], d[-1], soft.expand_as(d[-1]))
        for c in range(dims - 2, -1, -1):
            d2 = fma(d[c], d[c], d2)
        inv = torch.rsqrt(d2)
        w = (inv * inv) * inv
        # the tile's partial, one source after another
        part = [torch.zeros(nt, dtype=dt) for _ in range(dims)]
        for j in range(m):
            for c in range(dims):
                part[c] = fma(w[j], d[c][j], part[c])
        acc = acc + torch.stack(part, -1)
    res = torch.tensor(cfg.repulsion, dtype=dt) * acc

    idx = slots(nt, threads, targets).reshape(-1)
    live = idx[idx >= 0]
    writes = torch.zeros(nt, dtype=torch.long).index_add_(
        0, live, torch.ones_like(live))
    assert bool((writes == 1).all()), "a target written other than once"
    out = torch.full_like(res, float("nan"))
    out[live] = res[live]
    return out, {"blocks": -(-nt // (threads * targets)), "tiles": tiles,
                 "last_tile": n - (tiles - 1) * threads}
