"""The SPH bin kernel's phases, on the CPU.

The kernels (fluidsims_tpu_torch/csrc/sph_bin.cu) are a cooperative launch
of three phases (warp-aggregated counts, the starts by slices of the
cells joined through their sums, a fill in whatever order the atomics
land) and a plain one of the ranks (cells of at most kBinCountCap members
counted in their slots' blocks, larger ones a block each: a bitonic sort
in chunks with binary searches across them).  They cannot
run here, so tests/oracles/sph_bin_phases.py models the phases with the
source's constants, and the model's starts, order and ranks are
held exactly to binning_plain's and to JAX's TPU rank kernel (interpret
mode) and bin_rank on: all particles in one cell (more than a block and
than a sorted chunk), empty cells, M = 1, M not a multiple of the scan's
slice, n not a multiple of the block, and every tier.  The wrapper's
scratch is kept per launch shape and stream.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.ops import cell_dense as jcd
from fluidsims_tpu.ops.rank_pallas import MAX_CELLS, make_rank_kernel
from fluidsims_tpu_torch.kernels import sph_cuda as sk
from fluidsims_tpu_torch.ops import cell_dense as cd
from oracles import sph_bin_phases as bp

torch.set_num_threads(1)
CPU = torch.device("cpu")


def plain_of(cid: np.ndarray, gx: int, gy: int, seed: int = 0):
    """binning_plain on positions inside the cells `cid` of a gx x gy grid
    of unit cells."""
    rng = np.random.default_rng(seed)
    cfg = types.SimpleNamespace(
        n=cid.size, grid=lambda: cd.DenseGrid(Gx=gx, Gy=gy, cell=1.0, K=16))
    pos = np.stack([cid % gx, cid // gx], -1) + rng.uniform(
        0.1, 0.9, (cid.size, 2))
    vel = rng.standard_normal((cid.size, 2))
    b = sk.binning_plain(cfg, torch.tensor(pos), torch.tensor(vel))
    assert np.array_equal(b.cid.numpy(), cid)
    return b


def jax_ranks(cid: np.ndarray, M: int) -> list:
    """JAX's bin_rank and, where it takes M, the TPU rank kernel."""
    out = [np.asarray(jcd.bin_rank(
        jcd.DenseGrid(Gx=M, Gy=1, cell=1.0, K=1 << 20),
        jnp.zeros((cid.size, 2), jnp.float32), cid=jnp.asarray(cid))[0])]
    if M <= MAX_CELLS:
        out.append(np.asarray(make_rank_kernel(cid.size, M, interpret=True)(
            jnp.asarray(cid))))
    return out


def one_cell(n, M, c):
    return np.full(n, c, np.int32)


def empty_cells(n, M, seed=1):
    """Cells of a random third of the grid, the rest empty."""
    rng = np.random.default_rng(seed)
    used = rng.choice(M, max(1, M // 3), replace=False)
    return used[rng.integers(0, used.size, n)].astype(np.int32)


def tiers(n, M, seed=2):
    """One cell at each tier's edges (counted in the slots' blocks, sorted,
    chunked) and scattered ones."""
    rng = np.random.default_rng(seed)
    sizes = [bp.COUNT_CAP, bp.COUNT_CAP + 1, bp.BLOCK_CAP, bp.BLOCK_CAP + 1,
             2 * bp.BLOCK_CAP + 5]
    cid = np.concatenate([np.full(s, k) for k, s in enumerate(sizes)]
                         + [rng.integers(len(sizes), M, n - sum(sizes))])
    return rng.permutation(cid).astype(np.int32)


# (name, n, gx, gy, grid blocks, cells)
CASES = [
    ("one cell, chunked", 5 * bp.BLOCK_CAP + 3, 4, 4, 3,
     lambda n, M: one_cell(n, M, 5)),
    ("one cell, one block", bp.THREADS + 7, 4, 4, 2,
     lambda n, M: one_cell(n, M, 15)),
    ("empty cells", 3000, 37, 11, 5, empty_cells),
    ("M = 1", 1000, 1, 1, 4, lambda n, M: one_cell(n, M, 0)),
    ("M not a multiple of the slice", 2500, 29, 31, 7,
     lambda n, M: np.random.default_rng(3).integers(0, M, n).astype(np.int32)),
    ("n not a multiple of the block", bp.THREADS * 3 + 77, 16, 16, 4,
     lambda n, M: np.random.default_rng(4).integers(0, M, n).astype(np.int32)),
    ("every tier", 4 * bp.BLOCK_CAP + 3000, 64, 64, 9, tiers),
    ("more blocks than cells", 700, 3, 2, 11,
     lambda n, M: np.random.default_rng(5).integers(0, M, n).astype(np.int32)),
]


@pytest.mark.parametrize("name,n,gx,gy,grid,make", CASES,
                         ids=[c[0] for c in CASES])
def test_model_matches_plain_and_jax(name, n, gx, gy, grid, make):
    M = gx * gy
    cid = make(n, M)
    got = bp.bin_model(cid, M, grid, seed=n)
    b = plain_of(cid, gx, gy)
    np.testing.assert_array_equal(got["starts"], b.starts.numpy())
    np.testing.assert_array_equal(got["order"], b.order.numpy())
    np.testing.assert_array_equal(got["rank"], b.rank.numpy())
    for want in jax_ranks(cid, M):
        np.testing.assert_array_equal(got["rank"], want)


def test_fill_order_does_not_matter():
    """Two random orders of the warps' fill adds give the same bits."""
    M = 64 * 64
    cid = tiers(4 * bp.BLOCK_CAP + 3000, M)
    a, b = (bp.bin_model(cid, M, 9, seed=s) for s in (1, 2))
    for k in ("starts", "order", "rank"):
        np.testing.assert_array_equal(a[k], b[k])


def test_every_tier_runs():
    M = 64 * 64
    cid = tiers(4 * bp.BLOCK_CAP + 3000, M)
    got = bp.bin_model(cid, M, 9)
    counts = np.bincount(cid, minlength=M)
    assert counts[got["listed"]].min() == bp.COUNT_CAP + 1
    assert counts[got["listed"]].max() > bp.BLOCK_CAP
    assert counts[(counts > 0) & (counts <= bp.COUNT_CAP)].max() == \
        bp.COUNT_CAP
    assert bp.THREADS + 2 * (bp.COUNT_CAP - 1) <= bp.BLOCK_CAP


def test_counts_fold_a_warp_of_one_cell():
    """One add a cell a warp: a crowded cell costs n / 32 adds, not n."""
    n = 32 * 100
    got = bp.bin_model(one_cell(n, 16, 3), 16, 4)
    assert got["adds"] == n // 32
    got = bp.bin_model(np.arange(n, dtype=np.int32) % 16, 16, 4)
    assert got["adds"] == 16 * (n // 32)


@pytest.mark.parametrize("P", [1, 2, 4, 64, 256, 2048])
def test_bitonic_sort_sorts(P):
    rng = np.random.default_rng(P)
    s = rng.permutation(10 * P)[:P]
    np.testing.assert_array_equal(bp.bitonic_sort(s), np.sort(s))


@pytest.mark.parametrize("n,M,grid", [(1, 1, 1), (1000, 16, 3),
                                      (1 << 20, 1 << 16, 1056)])
def test_layout_parts_fit(n, M, grid):
    lay = bp.layout(n, M, grid)
    assert lay["bucket"] % 2 == 0
    assert lay["listed"] >= lay["sums"] + grid
    assert lay["bucket"] - lay["list"] >= n // (bp.COUNT_CAP + 1) + 1
    assert lay["total"] == lay["bucket"] + 2 * n


def test_scratch_is_kept_per_launch_shape_and_stream():
    """The wrapper's scratch: one for each (n, M, dtype, grid) and stream,
    zeroed when made (a launch leaves its counts at 0), and the same one
    again for the same shape and stream."""
    lay = bp.layout(1000, 64, 4)
    shape = sk.BinLaunch(grid=4, scratch_ints=lay["total"])

    def scratch(n, M, stream, dtype=torch.float32, grid=4):
        return sk._bin_scratch(n, M, dtype, sk.BinLaunch(
            grid=grid, scratch_ints=shape.scratch_ints), CPU, stream)

    first, words = scratch(1000, 64, 0)
    assert first.numel() == lay["total"] and first.dtype == torch.int32
    assert not first.any() and not words.any()
    assert scratch(1000, 64, 0)[0] is first
    others = [scratch(1000, 64, 1)[0], scratch(999, 64, 0)[0],
              scratch(1000, 65, 0)[0], scratch(1000, 64, 0, torch.float64)[0],
              scratch(1000, 64, 0, grid=5)[0]]
    ptrs = {t.data_ptr() for t in others + [first]}
    assert len(ptrs) == len(others) + 1
