"""The tiling of the port's Gray–Scott K-step kernel, on the CPU.

The kernel (fluidsims_tpu_torch/csrc/gray_scott_multistep.cu) steps each
tile's window (the tile and a halo of K, wrapped periodically) K times in
shared memory: in step s its items (strips of rows by a vector of
columns, mapped over the shrinking region [s, S - s)^2) form their new
values, which f64 stores in place after a barrier (one copy of u and v)
and f32 into a second copy (two, ping-ponged).  The kernel cannot run
here, so a plain torch model of that tiling (tests/oracles/gs_tiles.py,
which also checks that every place a step reads holds the value of the
step before and that garbage from the rounded-out vectors, the guard
columns or a copy's older values never reaches the output) is
held to K plain steps bit for bit at K = 1, 3, 16 and 32: on a ragged
37x23 grid with small tiles and with the kernel's tiles, and on 20x17
(narrower than the window) with the kernel's tiles and one tile of the
whole grid, f32 and f64 (each dtype's design, and the other design on
the ragged grid), with and without feed=0.04, kill=0.058; the same model
with a halo one cell short is not bitwise.  The
model is held to JAX's interpreted Pallas K-step kernel #4 at the bar of
tests/test_torch_gray_scott.py, and the source's tile rule fits the shared
memory and the threads of a block at every K.
"""

import numpy as np
import pytest
import torch

from fluidsims_tpu.kernels import gray_scott_pallas as jgp
from fluidsims_tpu.solvers import gray_scott as jgs
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.kernels import gray_scott_cuda as gk
from fluidsims_tpu_torch.solvers import gray_scott as tgs
from tests.oracles import gs_tiles

torch.set_num_threads(1)
CPU = torch.device("cpu")

# the H100's shared memory a block (227 KB)
SMEM_MAX = 232448


def noisy(cfg, seed=7):
    """init() plus seeded normal noise (0.05) on u and v, as
    chip_smoke.py's gs_state."""
    s = tgs.init(cfg, CPU)
    rng = np.random.default_rng(seed)
    return tgs.GrayScottState(*(
        f + torch.tensor(0.05 * rng.standard_normal(tuple(f.shape)),
                         dtype=f.dtype) for f in s))


def bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    it = torch.int32 if a.element_size() == 4 else torch.int64
    return torch.equal(a.contiguous().view(it), b.contiguous().view(it))


def plain(cfg, s, k, **over):
    for _ in range(k):
        s = tgs.step(cfg, s, **over)
    return s


# (nx, ny, tile): the ragged grid with small tiles (8 x 6) and with the
# kernel's, and the narrow one with the kernel's and with one tile of the
# whole grid (its window wider than the grid at every K)
GRIDS = [(37, 23, (8, 6)), (37, 23, None), (20, 17, None),
         (20, 17, (20, 17))]


@pytest.mark.parametrize("over", [{}, {"feed": 0.04, "kill": 0.058}])
@pytest.mark.parametrize("k", [1, 3, 16, 32])
@pytest.mark.parametrize("nx, ny, tile", GRIDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tiled_steps_are_k_plain_steps_bitwise(dtype, nx, ny, tile, k, over):
    cfg = tgs.GrayScottConfig(nx=nx, ny=ny, dtype=dtype)
    s = noisy(cfg)
    got = gs_tiles.tiled_run(cfg, s, k, tile, **over)
    ref = plain(cfg, s, k, **over)
    assert bits(got.u, ref.u) and bits(got.v, ref.v)


@pytest.mark.parametrize("k", [3, 16])
@pytest.mark.parametrize("tile", [(8, 6), None])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_other_design_is_k_plain_steps_bitwise(dtype, tile, k):
    """The design the dtype does not take (one copy in place for f32, two
    copies for f64), which the source's macros select, is as exact."""
    cfg = tgs.GrayScottConfig(nx=37, ny=23, dtype=dtype)
    itemsize = 4 if dtype == "float32" else 8
    other = 3 - gs_tiles.design(itemsize)["copies"]
    s = noisy(cfg)
    got = gs_tiles.tiled_run(cfg, s, k, tile, copies=other)
    ref = plain(cfg, s, k)
    assert bits(got.u, ref.u) and bits(got.v, ref.v)


def test_designs_of_the_source():
    """f32: two copies of 1024 threads, strips of 4 rows; f64: one copy in
    place of 512 threads, strips of 8 rows."""
    assert gs_tiles.design(4) == {"threads": 1024, "min_blocks": 1,
                                  "rows": 4, "copies": 2}
    assert gs_tiles.design(8) == {"threads": 512, "min_blocks": 1,
                                  "rows": 8, "copies": 1}


def test_narrow_grid_is_narrower_than_the_window():
    """20x17 at K = 16 and 32: the kernel's window (tile and halo) is wider
    than the grid in both axes, so it holds wrapped copies of rows and
    columns."""
    for k in (16, 32):
        for itemsize in (4, 8):
            t = gs_tiles.kernel_tile(17, 20, k, itemsize)
            assert t["tile_x"] + 2 * k > 20 and t["tile_y"] + 2 * k > 17


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_halo_one_short_is_not_enough(dtype):
    """A cell's neighbours reach one cell a step: K steps need a halo of
    K."""
    cfg = tgs.GrayScottConfig(nx=37, ny=23, dtype=dtype)
    s = noisy(cfg)
    got = gs_tiles.tiled_run(cfg, s, 3, (8, 6), loaded=2)
    ref = plain(cfg, s, 3)
    assert not (bits(got.u, ref.u) and bits(got.v, ref.v))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_steps_write_places_they_read(dtype):
    """One copy stepped in place: each step stores into places that its
    own items read (so the barrier between the two is what keeps it
    exact), and every read still found the step before's value."""
    cfg = tgs.GrayScottConfig(nx=37, ny=23, dtype=dtype)
    shared = []
    gs_tiles.tiled_run(cfg, noisy(cfg), 16, (8, 6), copies=1,
                       shared=shared)
    assert len(shared) == 16 * 5 * 4 and min(shared) > 0


@pytest.mark.parametrize("over", [{}, {"feed": 0.04, "kill": 0.058}])
def test_model_matches_pallas_multistep_interpret(over):
    """16 steps of the model at K = 8 against run_multistep(k=8, band=16)
    of TPU kernel #4 in interpret mode, at tests/test_torch_gray_scott.py's
    bar (5e-6), on its 128x64 grid."""
    jc = jgs.GrayScottConfig(nx=128, ny=64, feed=0.0367, kill=0.0649,
                             block_k=8)
    tc = interop.gs_config_from_dict(jc.asdict())
    sj, st = jgs.init(jc), tgs.init(tc, CPU)
    a = jgp.run_multistep(jc, sj, 16, k=8, band=16, interpret=True, **over)
    b = gs_tiles.tiled_run(tc, gs_tiles.tiled_run(tc, st, 8, **over), 8,
                           **over)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), y.numpy(), atol=5e-6)


@pytest.mark.parametrize("k", range(1, 33))
@pytest.mark.parametrize("itemsize", [4, 8])
def test_kernel_tile_fits_shared_memory(itemsize, k):
    """The source's tile rule, as the model reads it: at every K up to the
    wrapper's bound (32) a tile fits on a 2048^2 grid with its halo of K
    in the shared memory of a block, and in place no step has more items
    than the block has threads."""
    assert gs_tiles.MAX_K == gk.MAX_BLOCK_K == 32
    d = gs_tiles.design(itemsize)
    t = gs_tiles.kernel_tile(2048, 2048, k, itemsize)
    sx, sy = t["tile_x"] + 2 * k, t["tile_y"] + 2 * k
    assert t["smem"] == gs_tiles.smem(sx, sy, itemsize) <= SMEM_MAX
    assert gs_tiles.SMEM <= SMEM_MAX and t["tile_x"] >= 16
    assert d["copies"] == 2 or all(
        gs_tiles.items(sx, sy, s, itemsize) <= d["threads"]
        for s in range(1, k + 1))


@pytest.mark.parametrize("itemsize, tile, tiles, waves",
                         [(4, 82, 625, 5), (8, 57, 1296, 10)])
def test_kernel_tile_at_the_main_grid(itemsize, tile, tiles, waves):
    """2048^2 at K = 16: the tile the card's grid query reported
    (fst_gs_multistep_shape_*, one block an SM; an H100 80GB HBM3), which
    the model's rule gives for 132 SMs."""
    t = gs_tiles.kernel_tile(2048, 2048, 16, itemsize)
    assert (t["tile_x"], t["tile_y"], t["tiles"], t["waves"]) == (
        tile, tile, tiles, waves)
