"""A plain torch model of the order of work of the port's SPH density
kernel (fluidsims_tpu_torch/csrc/sph_density.cu), for CPU tests that hold
the kernel's split of the density sums against the plain version while the
kernel itself cannot run.

The kernel takes the forces kernel's blocks (tests/oracles/
sph_forces_split.py): kThreads / kLanes consecutive sorted positions a
block, walked a run of one grid row's cells at a time; a run's 3x3 cells
are three contiguous ranges of the sorted order, staged in chunks of
positions alone (STAGE_BYTES / (2 x itemsize) candidates); a particle's
own 3x3 cells are a contiguous part of each range, which its kLanes lanes
walk, lane l the entries l, l + kLanes, ... of each part, chunk by chunk,
its own entry included (the self pair is part of the density); the lanes'
sums are combined by an xor butterfly, and lane 0 forms the EOS.  The
lanes a particle are chosen at launch from the particle count by
density's own constants.  The model builds each lane's sequence of
neighbours in that order (sph_forces_split.lane_sequences without the
own-index skip), adds the plain version's pair term (kernels/sph_cuda.py
pair_density) one position of the sequences at a time, combines the lanes
the kernel's way and applies the plain version's EOS (density_eos); over
a range of receivers and a window of cell columns as the forces model
does.  The
block shape defaults to the source's constants, read from the source so
that the model cannot drift from them."""

import re
from pathlib import Path

import torch

from fluidsims_tpu_torch.kernels import sph_cuda as sk
from tests.oracles import sph_forces_split

SRC = (Path(__file__).resolve().parents[2] / "fluidsims_tpu_torch" / "csrc"
       / "sph_density.cu").read_text()


def _macro(name: str) -> int:
    return int(re.search(rf"#define {name} (\d+)", SRC).group(1))


THREADS = _macro("FST_SPH_DENSITY_THREADS")
STAGE_BYTES = _macro("FST_SPH_DENSITY_STAGE_BYTES")
MIN_LANES = _macro("FST_SPH_DENSITY_MIN_LANES")
MAX_LANES = _macro("FST_SPH_DENSITY_MAX_LANES")
LANE_THREADS = _macro("FST_SPH_DENSITY_LANE_THREADS")


def kernel_lanes(n: int) -> int:
    """The lanes a particle the kernel takes for n particles (sph.cuh
    lanes_for with the density constants): the largest power of two in
    [MIN_LANES, MAX_LANES] with n x lanes within LANE_THREADS."""
    lanes = 1
    while lanes < MIN_LANES:
        lanes *= 2
    while lanes * 2 <= MAX_LANES and n * lanes * 2 <= LANE_THREADS:
        lanes *= 2
    return lanes


def kernel_chunk(dtype: torch.dtype, stage_bytes: int = STAGE_BYTES) -> int:
    """Candidates a staged chunk holds: the stage's bytes over a
    candidate's (x, y)."""
    return stage_bytes // (2 * torch.finfo(dtype).bits // 8)


def density_split(cfg, b: sk.Binned, threads: int = THREADS,
                  lanes: int | None = None, chunk: int | None = None,
                  r0: int = 0, r1: int | None = None,
                  win: sk.Window | None = None):
    """(rp, chunks): the density kernel's (rho, p / rho^2) of the sorted
    positions [r0, r1) (default every one), (r1 - r0, 2), the sums split
    and combined in the kernel's order (lanes, chunk: lanes a particle and
    candidates a staged chunk, default the kernel's for the count and
    dtype), with the chunks each position's run staged."""
    f = b.fields
    n = f.shape[0]
    r1 = n if r1 is None else r1
    lanes = lanes or kernel_lanes(n)
    chunk = chunk or kernel_chunk(f.dtype)
    seqs, skips, chunks = sph_forces_split.lane_sequences(
        cfg, b, threads, lanes, chunk, skip_self=False, r0=r0, r1=r1,
        win=win)
    assert skips == [0] * n
    longest = max((len(q) for per in seqs for q in per), default=0)
    nbr = torch.full((n, lanes, max(longest, 1)), -1, dtype=torch.long)
    for s, per in enumerate(seqs):
        for lane, q in enumerate(per):
            nbr[s, lane, :len(q)] = torch.tensor(q, dtype=torch.long)
    recv = torch.arange(n).repeat_interleave(lanes)
    nbr = nbr.reshape(n * lanes, -1)
    acc = torch.zeros(n * lanes, dtype=f.dtype)
    zero = torch.zeros((), dtype=f.dtype)
    for t in range(longest):
        j = nbr[:, t]
        live = j >= 0
        w = sk.pair_density(cfg, f, recv, torch.where(live, j, recv))
        acc += torch.where(live, w, zero)
    acc = acc.reshape(n, lanes)
    o = lanes // 2
    while o > 0:  # the xor butterfly: lane l adds lane l ^ o's sum
        acc = acc + acc[:, torch.arange(lanes) ^ o]
        o //= 2
    return sk.density_eos(cfg, acc[r0:r1, 0]), chunks
