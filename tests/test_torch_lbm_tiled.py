"""The tiling of the port's LBM K-step kernel, on the CPU.

The kernel (fluidsims_tpu_torch/csrc/lbm_multistep.cu) steps each tile's
window (the tile and a halo of K) K times in shared memory, with one copy
of the packets stepped in place: streaming is a moving frame, a bounced
link reads the cell's own post of the step before, the link masks are
formed once a launch, and each step is one pass with one barrier.  The
kernel cannot run here, so a plain torch model of that tiling
(tests/oracles/lbm_tiles.py, which also checks that no place a cell reads
in a step is written in that step by another cell) is held to K plain
steps bit for bit at K = 1, 3, 8 and 16: on a ragged 37x23 grid with
small tiles and an obstacle on a tile corner, on 200x75 without the top
wall and on 20x17 (narrower than the window), with the kernel's tiles,
f32 and f64, with and without a drive override; the same model with a
halo one cell short is not bitwise.  The model is held to JAX's
interpreted Pallas K-step kernel #6 at the JAX suite's bar, and the
source's tile rule fits the shared memory of a block at every K.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.kernels import lbm_pallas as jlp
from fluidsims_tpu.solvers import lbm as jl
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.solvers import lbm as tl
from tests.oracles import lbm_tiles

torch.set_num_threads(1)
CPU = torch.device("cpu")

# the H100's shared memory a block (227 KB)
SMEM_MAX = 232448


def noisy(cfg, seed=7, top_wall=True, block=None):
    """init() with the populations scaled by 1 + 0.05 x seeded noise;
    without the top wall row if `top_wall` is False; `block` = (y, x): a
    2x2 obstacle with its corner there."""
    s = tl.init(cfg, CPU)
    rng = np.random.default_rng(seed)
    f = s.f * (1.0 + torch.tensor(0.05 * rng.standard_normal(s.f.shape),
                                  dtype=s.f.dtype))
    solid = s.solid.clone()
    if not top_wall:
        solid[-1] = False
    if block is not None:
        y, x = block
        solid[y - 1:y + 1, x - 1:x + 1] = True
    return tl.LBMState(f=f.contiguous(), solid=solid)


def bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    it = torch.int32 if a.element_size() == 4 else torch.int64
    return torch.equal(a.contiguous().view(it), b.contiguous().view(it))


def plain(cfg, s, k, **over):
    for _ in range(k):
        s = tl.step(cfg, s, **over)
    return s


# (nx, ny, top wall, tile, obstacle block): the ragged grid with small
# tiles and the obstacle on the corner of tile (1, 1), the open-top grid
# and the narrow one with the kernel's tiles
GRIDS = [(37, 23, True, (8, 6), (6, 8)), (200, 75, False, None, None),
         (20, 17, True, None, None)]


@pytest.mark.parametrize("over", [{}, {"drive": 3e-4}])
@pytest.mark.parametrize("k", [1, 3, 8, 16])
@pytest.mark.parametrize("nx, ny, top, tile, block", GRIDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tiled_steps_are_k_plain_steps_bitwise(dtype, nx, ny, top, tile,
                                                block, k, over):
    cfg = tl.LBMConfig(nx=nx, ny=ny, dtype=dtype, obstacle_radius=4.0)
    s = noisy(cfg, top_wall=top, block=block)
    got = lbm_tiles.tiled_run(cfg, s, k, tile, **over)
    assert bits(got.f, plain(cfg, s, k, **over).f)


def test_narrow_grid_is_narrower_than_the_window():
    """20x17 at K = 3 and 16: the window (tile and halo) is wider than the
    grid in x, so the window holds wrapped copies of columns."""
    for k in (3, 16):
        tx, ty = lbm_tiles.kernel_tile(17, 20, k, 4)
        assert tx + 2 * k > 20 and (tx, ty) == (20, 17)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_halo_one_short_is_not_enough(dtype):
    """A packet moves one cell a step: K steps need a halo of K."""
    cfg = tl.LBMConfig(nx=37, ny=23, dtype=dtype, obstacle_radius=4.0)
    s = noisy(cfg)
    got = lbm_tiles.tiled_run(cfg, s, 3, (8, 6), loaded=2)
    assert not bits(got.f, plain(cfg, s, 3).f)


def test_model_matches_pallas_multistep_interpret():
    """16 steps of the model at K = 8 against run_multistep(k=8, band=16)
    of TPU kernel #6 in interpret mode, at tests/test_lbm.py's bar (5e-6),
    on tests/test_torch_lbm.py's 128x64 grid with walls, obstacle and
    drive."""
    jc = jl.LBMConfig(nx=128, ny=64, drive=1e-4, obstacle_radius=8.0)
    tc = interop.lbm_config_from_dict(jc.asdict())
    sj, st = jl.init(jc), tl.init(tc, CPU)
    a = jlp.run_multistep(jc, sj, 16, k=8, band=16, interpret=True)
    b = lbm_tiles.tiled_run(tc, lbm_tiles.tiled_run(tc, st, 8), 8)
    np.testing.assert_allclose(np.asarray(a.f), b.f.numpy(), atol=5e-6)
    assert bool(jnp.isfinite(a.f).all())


@pytest.mark.parametrize("k", range(1, 17))
@pytest.mark.parametrize("itemsize", [4, 8])
def test_kernel_tile_fits_shared_memory(itemsize, k):
    """The source's tile rule, as the model reads it: at every K up to
    the wrapper's bound (16) a tile of at least 8 cells fits with its
    halo of K in 227 KB; the threads a block are whole warps."""
    assert lbm_tiles.MAX_K == 16 and lbm_tiles.SMEM <= SMEM_MAX
    tx, ty = lbm_tiles.kernel_tile(4096, 4096, k, itemsize)
    assert tx == ty >= 8
    assert (tx + 2 * k) * (ty + 2 * k) * lbm_tiles.cell_bytes(itemsize) \
        <= lbm_tiles.SMEM
    assert lbm_tiles.THREADS % 32 == 0 and 32 <= lbm_tiles.THREADS <= 1024
