"""A plain torch model of the tiling of the port's Gray–Scott K-step kernel
(fluidsims_tpu_torch/csrc/gray_scott_multistep.cu), for CPU tests that
hold its windows, its copies of the window and its shrinking region
against K plain steps while the kernel itself cannot run.

Each tile's window (the tile and a halo of K, wrapped periodically in
both axes, so a window may hold several copies of a narrow grid) sits in
a buffer a field, one guard vector of columns on either side of each row,
NaN where nothing was loaded.  Step s (1 <= s <= K) covers the region
[s, S - s) of each axis with items: bands of `rows` rows times vectors of
VEC columns (4 floats, 2 doubles), the columns rounded out to whole
vectors.  Every item forms the new values of its cells from the old
values of the cells and their four neighbours (the plain step's
arithmetic: solvers/gray_scott.py step on the buffer, whose periodic wrap
touches only the buffer's edge cells, which no item computes) and stores
the rows of the region.  With one copy (the kernel's f64 design) the
buffer is stepped in place, one item a thread: the compute phase reads,
a barrier, the store phase writes, a barrier.  With two copies (its f32
design) the items read one buffer and store into the other, which the
next step reads.  The tile's cells inside the grid are the output.

The model checks what the kernel rests on: `check_places` — every place a
step's items read holds the value step s - 1 left when it is read (in
place, the step's stores come after the barrier, though the step writes
places that it reads, so the barrier is what keeps one copy exact); in
place, the items of a step never outnumber the threads; and the
trapezoid — an age carried beside each buffer's values (the step whose
value a place holds: 0 for the loaded cells, none for the guards, step s
for a cell formed in step s from five places of step s - 1, none
otherwise) is K at every output cell, so no garbage that the rounded-out
vectors, the guards or a copy's older values put in the window reaches
the output.

Each dtype's design (threads, blocks an SM of __launch_bounds__, rows,
copies) and the shared memory a block are read from the source's macros,
so that the model cannot drift from them; the blocks an SM are those the
shared memory, the threads and __launch_bounds__ allow (the card's
occupancy query also counts registers)."""

import re
from pathlib import Path

import torch

from fluidsims_tpu_torch.solvers import gray_scott as gs

SRC = (Path(__file__).resolve().parents[2] / "fluidsims_tpu_torch" / "csrc"
       / "gray_scott_multistep.cu").read_text()


def _macro(name: str) -> int:
    return int(re.search(rf"#define {name} (\d+)", SRC).group(1))


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


SMEM = _macro("FST_GS_SMEM")
MAX_K = _const("kGsMaxK")
MAX_TILE = _const("kGsMaxTile")
# An H100 SXM: SMs, shared memory an SM (less 1 KB reserved a block) and
# threads an SM.
SMS, SM_SMEM, SM_THREADS = 132, 233472, 2048


def design(itemsize: int) -> dict:
    """The kernel's design for floats (4) or doubles (8): threads a block,
    blocks an SM of __launch_bounds__, rows a strip, copies of the
    window."""
    pre = "FST_GS_" if itemsize == 4 else "FST_GS_F64_"
    return {name: _macro(pre + name.upper())
            for name in ("threads", "min_blocks", "rows", "copies")}


def vec(itemsize: int) -> int:
    """Columns an item: one 16-byte vector."""
    return 16 // itemsize


def pitch(sx: int, itemsize: int) -> int:
    """A window row in the buffer: a guard vector, the sx cells rounded up
    to whole vectors, a guard vector."""
    c = vec(itemsize)
    return c + -(-sx // c) * c + c


def smem(sx: int, sy: int, itemsize: int, copies: int | None = None) -> int:
    copies = copies or design(itemsize)["copies"]
    return copies * 2 * sy * pitch(sx, itemsize) * itemsize


def groups(sx: int, s: int, itemsize: int) -> tuple[int, int]:
    """(first, count) of the column vectors of step s's items."""
    c = vec(itemsize)
    g0 = s // c
    return g0, (sx - s - 1) // c + 1 - g0


def items(sx: int, sy: int, s: int, itemsize: int,
          rows: int | None = None) -> int:
    rows = rows or design(itemsize)["rows"]
    if sy - 2 * s <= 0 or sx - 2 * s <= 0:
        return 0
    return -(-(sy - 2 * s) // rows) * groups(sx, s, itemsize)[1]


def fits(sx: int, sy: int, k: int, itemsize: int) -> bool:
    """The window's two fields (each copy) fit SMEM, and in place, no step
    has more items than the block has threads."""
    d = design(itemsize)
    if smem(sx, sy, itemsize) > SMEM:
        return False
    return d["copies"] == 2 or all(
        items(sx, sy, s, itemsize) <= d["threads"] for s in range(1, k + 1))


def _even(n: int, most: int) -> tuple[int, int]:
    tiles = -(-n // most)
    return -(-n // tiles), tiles


def blocks_per_sm(smem_bytes: int, itemsize: int) -> int:
    """Blocks an SM that shared memory, threads and __launch_bounds__'s
    register cap allow (the model's stand-in for the occupancy query)."""
    d = design(itemsize)
    return min(SM_SMEM // (smem_bytes + 1024), SM_THREADS // d["threads"],
               d["min_blocks"])


def kernel_tile(ny: int, nx: int, k: int, itemsize: int,
                sms: int = SMS) -> dict:
    """The tile rule: every square side whose window fits, evened out over
    each axis, the one of least waves x blocks an SM x work of a tile (the
    cells its items compute over the k steps, its window's load and its
    tile's store) kept, the larger on a tie."""
    best, last = None, None
    for side in range(MAX_TILE, 0, -1):
        tx, nt_x = _even(nx, min(side, nx))
        ty, nt_y = _even(ny, min(side, ny))
        if (tx, ty) == last:
            continue
        last = (tx, ty)
        sx, sy = tx + 2 * k, ty + 2 * k
        if not fits(sx, sy, k, itemsize):
            continue
        sm = smem(sx, sy, itemsize)
        bps = blocks_per_sm(sm, itemsize)
        waves = -(-(nt_x * nt_y) // (sms * bps))
        rows = design(itemsize)["rows"]
        work = sum(items(sx, sy, s, itemsize) * rows * vec(itemsize)
                   for s in range(1, k + 1)) + 2.0 * sx * sy + tx * ty
        cost = waves * bps * work
        if best is None or cost < best["cost"]:
            best = {"tile_x": tx, "tile_y": ty, "tiles": nt_x * nt_y,
                    "smem": sm, "blocks_per_sm": bps, "waves": waves,
                    "cost": cost}
    if best is None:
        raise ValueError(f"k={k}: no tile fits")
    return best


def check_places(reads: torch.Tensor, writes: torch.Tensor,
                 seen: torch.Tensor, before: torch.Tensor) -> int:
    """One step's places: `reads`, the cells its items compute and their
    four neighbours; `writes`, the cells its items store; `seen`, the
    values the compute phase read; `before`, the values step s - 1 left.
    Asserts that every place read held step s - 1's value when it was read
    (no store of the step landed before the barrier); returns the places
    both read and written in the step, which only the barrier keeps
    apart."""
    same = (seen == before) | (seen.isnan() & before.isnan())
    assert bool(same[reads].all())
    return int((reads & writes).sum())


def _stencil_ok(age: torch.Tensor, step: int) -> torch.Tensor:
    """A cell formed in `step` is right when it and its four neighbours
    hold the values of step - 1 (`age`: the step whose value a place
    holds, -1 for none)."""
    ok = age == step - 1
    return (ok & ok.roll(1, 0) & ok.roll(-1, 0) & ok.roll(1, 1)
            & ok.roll(-1, 1))


def tiled_run(cfg, s: gs.GrayScottState, k: int, tile=None, feed=None,
              kill=None, loaded=None, copies: int | None = None,
              shared=None) -> gs.GrayScottState:
    """k steps of the tiled kernel's model: tile = (tile_x, tile_y),
    default the kernel's (kernel_tile); `loaded` (default k) the halo
    cells loaded from the state (the window's outer k - loaded rings hold
    NaN, and the trapezoid check is left out); `copies`, default the
    dtype's design; `shared`, a list that gets each step's count of places
    both read and written (check_places)."""
    ny, nx = cfg.ny, cfg.nx
    itemsize = s.u.element_size()
    c = vec(itemsize)
    d = design(itemsize)
    copies = copies or d["copies"]
    if tile is None:
        t = kernel_tile(ny, nx, k, itemsize)
        tile = (t["tile_x"], t["tile_y"])
    tx, ty = tile
    gap = k - (k if loaded is None else loaded)
    out_u, out_v = torch.empty_like(s.u), torch.empty_like(s.v)
    nan = float("nan")
    for y0 in range(0, ny, ty):
        for x0 in range(0, nx, tx):
            sx, sy = tx + 2 * k, ty + 2 * k
            p = pitch(sx, itemsize)
            gy = torch.arange(y0 - k, y0 + ty + k) % ny
            gx = torch.arange(x0 - k, x0 + tx + k) % nx
            # [values u, values v, age] of each copy: the step whose value
            # a place holds, -1 for none or a wrong one
            bufs = [[torch.full((sy, p), nan, dtype=s.u.dtype),
                     torch.full((sy, p), nan, dtype=s.v.dtype),
                     torch.full((sy, p), -1, dtype=torch.int32)]
                    for _ in range(copies)]
            inner = (slice(gap, sy - gap), slice(c + gap, c + sx - gap))
            bufs[0][0][inner] = s.u[gy][:, gx][gap:sy - gap, gap:sx - gap]
            bufs[0][1][inner] = s.v[gy][:, gx][gap:sy - gap, gap:sx - gap]
            bufs[0][2][inner] = 0
            wcfg = cfg.replace(nx=p, ny=sy)
            for st in range(1, k + 1):
                if copies == 1:
                    assert items(sx, sy, st, itemsize) <= d["threads"], st
                cur, nxt = bufs[0], bufs[-1]
                g0, ng = groups(sx, st, itemsize)
                # the items' cells: rows [st, sy - st), whole vectors
                ry = slice(st, sy - st)
                rx = slice(c + g0 * c, c + (g0 + ng) * c)
                writes = torch.zeros((sy, p), dtype=torch.bool)
                writes[ry, rx] = True
                reads = (writes | writes.roll(1, 0) | writes.roll(-1, 0)
                         | writes.roll(1, 1) | writes.roll(-1, 1))
                before = (cur[0].clone(), cur[1].clone())
                # compute phase: every item reads, nothing is stored
                new = gs.step(wcfg, gs.GrayScottState(cur[0], cur[1]),
                              feed=feed, kill=kill)
                ok = _stencil_ok(cur[2], st)
                both = [check_places(reads, writes if copies == 1
                                     else torch.zeros_like(writes), a, b)
                        for a, b in zip(cur[:2], before)]
                if shared is not None:
                    shared.append(both[0])
                # store phase (in place: after the barrier)
                nxt[0], nxt[1] = nxt[0].clone(), nxt[1].clone()
                nxt[0][ry, rx] = new.u[ry, rx]
                nxt[1][ry, rx] = new.v[ry, rx]
                nxt[2] = torch.where(writes, torch.where(ok, st, -1),
                                     nxt[2])
                bufs.reverse()  # two copies: the next step reads this one
            cur = bufs[0]
            hy, hx = min(ty, ny - y0), min(tx, nx - x0)
            cells = (slice(k, k + hy), slice(c + k, c + k + hx))
            if loaded is None:
                assert bool((cur[2][cells] == k).all()), (y0, x0)
            out_u[y0:y0 + hy, x0:x0 + hx] = cur[0][cells]
            out_v[y0:y0 + hy, x0:x0 + hx] = cur[1][cells]
    return gs.GrayScottState(out_u, out_v)
