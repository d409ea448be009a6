"""The split of the SPH density kernel's sums, on the CPU.

The kernel (fluidsims_tpu_torch/csrc/sph_density.cu) takes the forces
kernel's blocks: it stages the 3x3 cells of a run of one row's cells in
shared memory, positions only, in chunks, and gives each particle several
lanes whose sums a warp-shuffle butterfly combines in a fixed order.  The
kernel cannot run here, so a plain torch model of that order of work
(tests/oracles/sph_density_split.py: the three contiguous row ranges,
each particle's part of them, position-only chunks, lanes, the combine,
the EOS) is held to the plain version (kernels/sph_cuda.py density_plain)
and to JAX's exact density (fluidsims_tpu/solvers/sph.py::_exact_density),
at 1e-12 (f64) and 1e-5 (f32) of the largest value: with the source's
block shape and with smaller chunks and other lane counts, so that the
chunk loop runs more than once; on a state from init with seeded noise,
on a crowded pool whose one cell holds more particles than a chunk, and on
a sparse pool spread over (and past) the box, whose runs cross many cells
and rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.solvers import sph as js
from fluidsims_tpu_torch.kernels import sph_cuda as sk
from fluidsims_tpu_torch.solvers import sph as ts
from tests.oracles import sph_density_split as split

torch.set_num_threads(1)
TOL = {"float32": 1e-5, "float64": 1e-12}
# (threads, lanes, chunk; None for the kernel's): the source's shape, and
# smaller chunks than a neighbourhood with other lane counts
SHAPES = [(split.THREADS, None, None), (64, 4, 40), (32, 2, 17),
          (128, 16, 64), (64, 1, 24)]


def pool(kind: str, dtype: str, n: int = 512, seed: int = 3):
    """(JAX config, port config, pos) as a numpy array of `dtype`: init
    plus seeded noise ('stirred'), the same with 150 particles packed into
    cell (3, 2) ('crowded'), or uniform over [-0.02, 1.02]^2 ('sparse')."""
    jc = js.SPHConfig(n=n, seed=seed, dtype=dtype, rain=False)
    tc = ts.SPHConfig(n=n, seed=seed, dtype=dtype, rain=False)
    rng = np.random.default_rng(seed)
    pos = np.asarray(js.init(jc).pos, np.float64)
    pos = np.clip(pos + 0.3 * jc.h * rng.standard_normal((n, 2)), 0, 1)
    if kind == "crowded":
        c = tc.grid().cell
        pos[:150] = (np.array([3.5, 2.5]) * c
                     + 0.45 * c * rng.uniform(-1, 1, (150, 2)))
    elif kind == "sparse":
        pos = rng.uniform(-0.02, 1.02, (n, 2))
    return jc, tc, pos.astype(np.dtype(dtype))


def setup(kind, dtype):
    jc, tc, pos = pool(kind, dtype)
    vel = torch.zeros((tc.n, 2), dtype=tc.torch_dtype)
    return jc, tc, pos, sk.binning_plain(tc, torch.tensor(pos), vel)


def rel_cols(got, ref) -> float:
    """The largest over the two columns of max |err| / max |ref|."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return max(float(np.abs(got[:, c] - ref[:, c]).max()
                     / np.abs(ref[:, c]).max()) for c in (0, 1))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["stirred", "crowded", "sparse"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_split_matches_density_plain(dtype, kind, shape):
    _, tc, _, b = setup(kind, dtype)
    rp, _ = split.density_split(tc, b, *shape)
    assert rel_cols(rp, sk.density_plain(tc, b)) <= TOL[dtype]


@pytest.mark.parametrize("kind", ["stirred", "crowded", "sparse"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_split_matches_jax_exact(dtype, kind):
    """Against JAX's all-pairs density and EOS on the same positions, in
    sorted order, with the kernel's shape and with small chunks."""
    jc, tc, pos, b = setup(kind, dtype)
    order = b.order.long().numpy()
    _, rho, press = js._exact_density(jc, jnp.asarray(pos))
    rho_n, press_n = np.asarray(rho), np.asarray(press)
    ref = np.stack([rho_n, press_n / np.maximum(rho_n, 1e-30) ** 2],
                   -1)[order]
    for shape in (SHAPES[0], SHAPES[1]):
        rp, _ = split.density_split(tc, b, *shape)
        assert rel_cols(rp.numpy(), ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_crowded_cell_runs_the_chunk_loop(dtype):
    """The crowded cell holds more particles than a reduced chunk, so its
    runs stage several chunks, and every pair is still summed."""
    _, tc, _, b = setup("crowded", dtype)
    chunk = 96
    assert int(torch.bincount(b.cid.long()).max()) > chunk
    rp, chunks = split.density_split(tc, b, 64, 4, chunk)
    assert max(chunks) >= 3
    assert rel_cols(rp, sk.density_plain(tc, b)) <= TOL[dtype]


@pytest.mark.parametrize("n, lanes", [(512, 8), (4096, 8), (65536, 8),
                                      (131072, 4), (1 << 20, 1)])
def test_kernel_lanes_follow_the_particle_count(n, lanes):
    """The lanes a particle the model takes from the source's constants
    (csrc/sph_density.cu density_lanes, which the library's shape query
    reports on the card); a block's threads are whole warps of whole
    particles."""
    assert split.kernel_lanes(n) == lanes
    assert split.THREADS % 32 == 0 and split.THREADS % lanes == 0


def test_chunk_holds_positions_only():
    """A staged candidate is (x, y) alone: a stage of the forces kernel's
    bytes holds three times its candidates."""
    for dtype, size in ((torch.float32, 8), (torch.float64, 16)):
        assert split.kernel_chunk(dtype) == split.STAGE_BYTES // size
        assert (split.kernel_chunk(dtype, 24576)
                == 3 * (24576 // (3 * size)))


# receiver ranges: r0 off a block's boundary for the source's shape (16
# particles a block at 8 lanes) and the small ones, the last one empty
RANGES = [(5, 200), (37, 512), (0, 129), (300, 300)]


@pytest.mark.parametrize("r0, r1", RANGES)
@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[1]])
@pytest.mark.parametrize("kind", ["stirred", "crowded"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_range_keeps_the_whole_launch_order(dtype, kind, shape, r0, r1):
    """Over a range [r0, r1) the model keeps the blocks of the whole range
    (the first the one holding r0), so each receiver's sum takes the same
    order: the range's rows are bitwise the whole launch's, and within the
    bar of the plain version over the same range."""
    _, tc, _, b = setup(kind, dtype)
    full, full_chunks = split.density_split(tc, b, *shape)
    rp, chunks = split.density_split(tc, b, *shape, r0=r0, r1=r1)
    assert rp.shape == (r1 - r0, 2)
    assert torch.equal(rp, full[r0:r1])
    assert chunks[r0:r1] == full_chunks[r0:r1]
    if r1 > r0:
        assert rel_cols(rp, sk.density_plain(tc, b, r0, r1)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_window_matches_the_whole_grid_inside(dtype):
    """On a window of cell columns 2-5 of the 6x6 grid, over the particles
    that lie in it, the receivers whose 3x3 cells lie in the window
    (columns 3 and 4) get the whole grid's density within the bar, and
    JAX's exact one; the model over the window equals the plain version
    over it."""
    jc, tc, pos, b = setup("stirred", dtype)
    g = tc.grid()
    col = np.clip(np.floor(pos[:, 0] / g.cell), 0, g.Gx - 1)
    keep = np.nonzero((col >= 2) & (col < 6))[0]
    win = sk.Window(2, 4)
    vel = torch.zeros((len(keep), 2), dtype=tc.torch_dtype)
    bw = sk.binning_plain(tc, torch.tensor(pos[keep]), vel, win)
    rp, _ = split.density_split(tc, bw, 64, 4, 40, win=win)
    assert rel_cols(rp, sk.density_plain(tc, bw, win=win)) <= TOL[dtype]
    ids = torch.tensor(keep)[bw.order.long()]      # each local sorted id
    inner = torch.tensor((col >= 3) & (col < 5))[ids]
    assert inner.sum() > 20
    _, rho, press = js._exact_density(jc, jnp.asarray(pos))
    rho_n, press_n = np.asarray(rho), np.asarray(press)
    ref = np.stack([rho_n, press_n / np.maximum(rho_n, 1e-30) ** 2], -1)
    assert rel_cols(rp[inner].numpy(), ref[ids[inner].numpy()]) <= TOL[dtype]
