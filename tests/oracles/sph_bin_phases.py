"""A numpy model of the SPH bin kernel's four phases
(fluidsims_tpu_torch/csrc/sph_bin.cu), with its constants read from the
source, for the CPU tests: the kernel runs only on the card.

`bin_model(cid, M, grid)` walks the launches as the kernels do, the
cooperative one on `grid` blocks of the source's threads: the
warp-aggregated counts (one add for each distinct cell of an aligned
group of 32 particles), the starts by slices of the cells with the sums
of the slices before each block, the fill of the bucket in a random order
of the warps' adds (the order the atomics land in on the card varies);
then the ranks: a cell of at most kBinCountCap members counted in its
slots' blocks, each staging its slots' cells whole, a listed one by a
block's bitonic sort of chunks of kBinBlockCap and a binary search in the
other chunks.  `bitonic_sort` runs the kernel's
loops and pair index arithmetic.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

SRC = (Path(__file__).resolve().parents[2] / "fluidsims_tpu_torch" / "csrc"
       / "sph_bin.cu").read_text()


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\w+);", SRC)
    v = m.group(1)
    if v.isdigit():
        return int(v)
    return int(re.search(rf"#define {v} (\d+)", SRC).group(1))


THREADS = _const("kBinThreads")
COUNT_CAP = _const("kBinCountCap")
BLOCK_CAP = _const("kBinBlockCap")
SYNCS = _const("kBinSyncs")


def layout(n: int, M: int, grid: int) -> dict:
    """csrc/sph_bin.cu bin_layout: the scratch's parts, in int32 words."""
    lay = {"counts": 0, "sums": M}
    lay["listed"] = lay["sums"] + grid
    lay["list"] = lay["listed"] + 1
    lay["bucket"] = (lay["list"] + n // (COUNT_CAP + 1) + 2) & ~1
    lay["total"] = lay["bucket"] + 2 * n
    return lay


def pow2_at_least(m: int) -> int:
    return 1 if m <= 1 else 1 << (m - 1).bit_length()


def bitonic_sort(s: np.ndarray) -> np.ndarray:
    """The kernel's bitonic_sort of s (a power-of-two length): every step's
    pairs lo = 2 i - (i & (j - 1)), hi = lo + j, swapped where they are out
    of the step's direction."""
    s = s.copy()
    P = s.size
    i = np.arange(P // 2)
    k = 2
    while k <= P:
        j = k >> 1
        while j > 0:
            lo = 2 * i - (i & (j - 1))
            hi = lo + j
            x, y = s[lo], s[hi]
            swap = (x > y) == ((lo & k) == 0)
            s[lo[swap]], s[hi[swap]] = y[swap], x[swap]
            j >>= 1
        k <<= 1
    return s


def _sorted_by_sort(members: np.ndarray) -> np.ndarray:
    """The members padded to a power of two with INT_MAX and put through
    bitonic_sort, the padding dropped."""
    P = pow2_at_least(members.size)
    s = np.full(P, np.iinfo(np.int32).max, np.int64)
    s[:members.size] = members
    return bitonic_sort(s)[:members.size]


def bin_model(cid: np.ndarray, M: int, grid: int, seed: int = 0) -> dict:
    """starts, order and rank of the launch on `grid` blocks, and what each
    phase did: the counting adds, the slices, the three tiers' cells."""
    cid = np.asarray(cid, np.int64)
    n = cid.size
    rng = np.random.default_rng(seed)
    groups = [cid[w0:w0 + 32] for w0 in range(0, n, 32)]

    # 1. the counts: one add for each distinct cell of a warp's 32 particles
    counts = np.zeros(M, np.int64)
    adds = 0
    for g in groups:
        cells, per = np.unique(g, return_counts=True)
        counts[cells] += per
        adds += cells.size

    # 2. the starts: block b scans cells [b slice, (b + 1) slice), each
    # thread a strip, and adds the sums of the slices before it
    slice_ = -(-M // grid)
    sums = np.zeros(grid, np.int64)
    local = np.zeros(M, np.int64)
    for b in range(grid):
        c0, c1 = min(M, slice_ * b), min(M, slice_ * b + slice_)
        per = -(-(c1 - c0) // THREADS)
        strips = [counts[min(c1, c0 + per * t):min(c1, c0 + per * t + per)]
                  for t in range(THREADS)]
        before = np.cumsum([0] + [s.sum() for s in strips])
        for t, s in enumerate(strips):
            s0 = min(c1, c0 + per * t)
            local[s0:s0 + s.size] = before[t] + np.cumsum(s) - s
        sums[b] = before[-1]
    starts = np.zeros(M + 1, np.int64)
    for b in range(grid):
        c0, c1 = min(M, slice_ * b), min(M, slice_ * b + slice_)
        starts[c0:c1] = sums[:b].sum() + local[c0:c1]
    starts[M] = sums.sum()
    listed = np.flatnonzero(counts > COUNT_CAP)

    # 3. the fill: the warps' adds land in a random order; a warp's lanes of
    # one cell take consecutive slots in lane order
    cursor = starts[:M].copy()
    bucket = np.full(n, -1, np.int64)
    for w in rng.permutation(len(groups)):
        g = groups[w]
        for c in np.unique(g):
            lanes = np.flatnonzero(g == c)
            bucket[cursor[c]:cursor[c] + lanes.size] = 32 * w + lanes
            cursor[c] += lanes.size
    assert (cursor == starts[1:]).all() and (bucket >= 0).all()

    # 4. the ranks: each block's slots' cells of at most COUNT_CAP members
    # staged whole, in at most THREADS + 2 (COUNT_CAP - 1) slots
    slot_cell = np.repeat(np.arange(M), counts)
    for q0 in range(0, n, THREADS):
        cells = np.unique(slot_cell[q0:q0 + THREADS])
        cells = cells[counts[cells] <= COUNT_CAP]
        if cells.size:
            span = starts[cells + 1].max() - starts[cells].min()
            assert span <= THREADS + 2 * (COUNT_CAP - 1)
    order = np.full(n, -1, np.int64)
    rank = np.full(n, -1, np.int64)
    for c in np.flatnonzero(counts):
        b, e = starts[c], starts[c + 1]
        members = bucket[b:e]
        if e - b <= COUNT_CAP:
            r = (members[None, :] < members[:, None]).sum(1)
            order[b + r] = members
            rank[members] = r
        elif e - b <= BLOCK_CAP:
            srt = _sorted_by_sort(members)
            order[b:e] = srt
            rank[srt] = np.arange(e - b)
        else:
            chunks = [_sorted_by_sort(members[c0:c0 + BLOCK_CAP])
                      for c0 in range(0, e - b, BLOCK_CAP)]
            for own, ch in enumerate(chunks):
                for i, v in enumerate(ch):
                    r = i + sum(int(np.searchsorted(o, v, "left"))
                                for k, o in enumerate(chunks) if k != own)
                    order[b + r] = v
                    rank[v] = r
    return {"starts": starts, "order": order, "rank": rank, "adds": adds,
            "listed": listed, "slice": slice_, "syncs": SYNCS}
