"""A plain torch model of the order of work of the port's SPH forces kernel
(fluidsims_tpu_torch/csrc/sph_forces.cu), for CPU tests that hold the
kernel's split of the pair sums against the plain version while the kernel
itself cannot run.

The kernel's blocks take kThreads / kLanes consecutive sorted positions
each and walk them a run of one grid row's cells at a time; a run's 3x3
cells together are three contiguous ranges of the sorted order, staged in
chunks of a fixed number of candidates; a particle's own 3x3 cells are a
contiguous part of each range, which its kLanes lanes walk, lane l the
entries l, l + kLanes, ... of each part, chunk by chunk, skipping its own
entry; the lanes' sums are combined by an xor butterfly.  The lanes a
particle are chosen at launch from the particle count.  Over a range [lo,
hi) of receivers the blocks stay those of the whole range: the first is
the block that holds lo, a run with no receiver in the range is skipped,
and only the receivers in the range are live; over a window of cell
columns the cells are the window's (kernels/sph_cuda.py Window).  The model
builds each lane's sequence of neighbours in that order, adds the plain
version's pair terms (kernels/sph_cuda.py pair_forces) one position of the
sequences at a time, combines the lanes the kernel's way, and integrates
as the plain version does.  The block shape defaults to the sources'
constants, read from the source so that the model cannot drift from
them."""

import re
from pathlib import Path

import torch

from fluidsims_tpu_torch.kernels import sph_cuda as sk
from fluidsims_tpu_torch.solvers import sph as sph_mod

SRC = (Path(__file__).resolve().parents[2] / "fluidsims_tpu_torch" / "csrc"
       / "sph_forces.cu").read_text()


def _macro(name: str) -> int:
    return int(re.search(rf"#define {name} (\d+)", SRC).group(1))


THREADS = _macro("FST_SPH_FORCES_THREADS")
STAGE_BYTES = _macro("FST_SPH_STAGE_BYTES")
MIN_LANES = _macro("FST_SPH_MIN_LANES")
MAX_LANES = _macro("FST_SPH_MAX_LANES")
LANE_THREADS = _macro("FST_SPH_LANE_THREADS")


def kernel_lanes(n: int) -> int:
    """The lanes a particle the kernel takes for n particles (lanes_for):
    the largest power of two in [MIN_LANES, MAX_LANES] with n x lanes
    within LANE_THREADS."""
    lanes = 1
    while lanes < MIN_LANES:
        lanes *= 2
    while lanes * 2 <= MAX_LANES and n * lanes * 2 <= LANE_THREADS:
        lanes *= 2
    return lanes


def kernel_chunk(dtype: torch.dtype, stage_bytes: int = STAGE_BYTES) -> int:
    """Candidates a staged chunk holds: the stage's bytes over a
    candidate's (x, y, vx, vy) and (rho, p / rho^2)."""
    return stage_bytes // (6 * torch.finfo(dtype).bits // 8)


def lane_sequences(cfg, b: sk.Binned, threads: int, lanes: int, chunk: int,
                   skip_self: bool = True, r0: int = 0, r1: int | None = None,
                   win: sk.Window | None = None):
    """(seqs, skips, chunks): seqs[s][l], the sorted positions whose pair
    terms lane l of sorted position s adds, in the kernel's order; skips[s],
    the entries its own-index test skipped (none without `skip_self`: the
    density kernel sums the self pair); chunks[s], the chunks its run
    staged; for the receivers s in [r0, r1) (default every one; the others
    get none) of the window's cells (default the whole grid)."""
    n, gx_n = b.fields.shape[0], (win or sk.full_window(cfg)).gw
    gy_n = cfg.grid().Gy
    r1 = n if r1 is None else r1
    starts = b.starts.tolist()
    sc = b.cid.long()[b.order.long()].tolist()  # the cell of each position
    group = threads // lanes
    seqs = [[[] for _ in range(lanes)] for _ in range(n)]
    skips, chunks = [0] * n, [0] * n
    for first in range(r0 // group * group, r1, group):
        hi, lo = min(first + group, n), first
        while lo < hi:
            gy, gxa = divmod(sc[lo], gx_n)
            e = max(min(starts[(gy + 1) * gx_n], hi), lo + 1)
            if e <= r0 or lo >= r1:  # no receiver of the range in this run
                lo = e
                continue
            gxb = min(max(sc[e - 1] - gy * gx_n, gxa), gx_n - 1)
            x0, x1 = max(gxa - 1, 0), min(gxb + 1, gx_n - 1)
            base, length = [0, 0, 0], [0, 0, 0]
            for o in range(3):
                row = gy - 1 + o
                if 0 <= row < gy_n:
                    base[o] = starts[row * gx_n + x0]
                    length[o] = starts[row * gx_n + x1 + 1] - base[o]
            off = [0, length[0], length[0] + length[1]]
            total = sum(length)

            def at(k):
                for o in range(3):
                    if k < off[o] + length[o]:
                        return base[o] + k - off[o]
                raise IndexError(k)

            for s in range(max(lo, r0), min(e, r1)):
                gx = sc[s] - gy * gx_n
                self_ = off[1] + s - base[1]
                parts = []
                for o in range(3):
                    row = gy - 1 + o
                    if not 0 <= row < gy_n:
                        parts.append((0, 0))
                        continue
                    shift = off[o] - base[o]
                    parts.append((shift + starts[row * gx_n + max(gx - 1, 0)],
                                  shift + starts[row * gx_n
                                                 + min(gx + 1, gx_n - 1) + 1]))
                for k0 in range(0, total, chunk):
                    count = min(chunk, total - k0)
                    chunks[s] += 1
                    for pa, pe in parts:
                        jb, je = max(pa, k0), min(pe, k0 + count)
                        for lane in range(lanes):
                            for j in range(jb + lane, je, lanes):
                                if skip_self and j == self_:
                                    skips[s] += 1
                                    continue
                                seqs[s][lane].append(at(j))
            lo = e
    return seqs, skips, chunks


def forces_split(cfg, b: sk.Binned, rp, dt, threads: int = THREADS,
                 lanes: int | None = None, chunk: int | None = None,
                 r0: int = 0, r1: int | None = None,
                 win: sk.Window | None = None):
    """(pos, vel, skips, chunks): the forces + integrate kernel's result in
    particle order (NaN where a particle is not a receiver of [r0, r1)),
    the pair sums split and combined in the kernel's order (lanes, chunk:
    lanes a particle and candidates a staged chunk, default the kernel's
    for the count and dtype), with lane_sequences' skip and chunk
    counts."""
    f = b.fields
    n = f.shape[0]
    r1 = n if r1 is None else r1
    lanes = lanes or kernel_lanes(n)
    chunk = chunk or kernel_chunk(f.dtype)
    seqs, skips, chunks = lane_sequences(cfg, b, threads, lanes, chunk,
                                         r0=r0, r1=r1, win=win)
    longest = max((len(q) for per in seqs for q in per), default=0)
    nbr = torch.full((n, lanes, max(longest, 1)), -1, dtype=torch.long)
    for s, per in enumerate(seqs):
        for lane, q in enumerate(per):
            nbr[s, lane, :len(q)] = torch.tensor(q, dtype=torch.long)
    recv = torch.arange(n).repeat_interleave(lanes)
    nbr = nbr.reshape(n * lanes, -1)
    acc = torch.zeros((n * lanes, 2), dtype=f.dtype)
    zero = torch.zeros((), dtype=f.dtype)
    for t in range(longest):
        j = nbr[:, t]
        live = j >= 0
        cx, cy = sk.pair_forces(cfg, f, rp, recv, torch.where(live, j, recv))
        acc += torch.stack([torch.where(live, cx, zero),
                            torch.where(live, cy, zero)], -1)
    acc = acc.reshape(n, lanes, 2)
    o = lanes // 2
    while o > 0:  # the xor butterfly: lane l adds lane l ^ o's sum
        acc = acc + acc[:, torch.arange(lanes) ^ o]
        o //= 2
    acc = acc[:, 0]
    p = sk._params(cfg)
    if p.use_grav:
        acc = acc - torch.tensor([0.0, p.gravity], dtype=acc.dtype)
    pos_s, vel_s = sph_mod._integrate(cfg, f[:, :2], f[:, 2:], acc, dt)
    order = b.order.long()[r0:r1]
    pos = torch.full_like(pos_s, float("nan"))
    vel = torch.full_like(vel_s, float("nan"))
    pos[order] = pos_s[r0:r1]
    vel[order] = vel_s[r0:r1]
    return pos, vel, skips, chunks
