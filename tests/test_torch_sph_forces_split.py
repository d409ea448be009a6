"""The split of the SPH forces kernel's pair sums, on the CPU.

The kernel (fluidsims_tpu_torch/csrc/sph_forces.cu) stages the 3x3 cells
of a run of one row's cells in shared memory, in chunks, and gives each
particle several lanes whose sums a warp-shuffle butterfly combines in a
fixed order.  The kernel cannot run here, so a plain torch model of that
order of work (tests/oracles/sph_forces_split.py: the three contiguous row
ranges, each particle's part of them, chunks, lanes, the combine) is held
to the plain version (kernels/sph_cuda.py forces_plain) and to JAX's exact
forces and integrate, at 1e-12 (f64) and 1e-5 (f32) of the largest value:
with the sources' block shape and with smaller chunks and other lane
counts, so that the chunk loop runs more than once; on a state from init
with seeded noise, on a crowded pool whose one cell holds more particles
than a chunk, and on a sparse pool spread over (and past) the box, whose
runs cross many cells and rows.  The own-index test skips exactly one
entry a particle, its own, also beside a twin 1e-7 away.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.solvers import sph as js
from fluidsims_tpu_torch.kernels import sph_cuda as sk
from fluidsims_tpu_torch.solvers import sph as ts
from tests.oracles import sph_forces_split as split

torch.set_num_threads(1)
TOL = {"float32": 1e-5, "float64": 1e-12}
# (threads, lanes, chunk; None for the kernel's): the sources' shape, and
# smaller chunks than a neighbourhood with other lane counts
SHAPES = [(split.THREADS, None, None), (64, 4, 40), (32, 2, 17),
          (128, 16, 64), (64, 1, 24)]


def pool(kind: str, dtype: str, n: int = 512, seed: int = 3):
    """(JAX config, port config, pos, vel) as numpy arrays of `dtype`:
    init plus seeded noise ('stirred'), the same with 150 particles packed
    into cell (3, 2) ('crowded'), or uniform over [-0.02, 1.02]^2
    ('sparse')."""
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
    vel = 0.5 * rng.standard_normal((n, 2))
    dt = np.dtype(dtype)
    return jc, tc, pos.astype(dt), vel.astype(dt)


def setup(kind, dtype):
    jc, tc, pos, vel = pool(kind, dtype)
    b = sk.binning_plain(tc, torch.tensor(pos), torch.tensor(vel))
    rp = sk.density_plain(tc, b)
    dt = torch.tensor(2e-3, dtype=tc.torch_dtype)
    return jc, tc, pos, vel, b, rp, dt


def rel(got, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / np.abs(ref).max())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["stirred", "crowded", "sparse"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_split_matches_forces_plain(dtype, kind, shape):
    _, tc, _, _, b, rp, dt = setup(kind, dtype)
    threads, lanes, chunk = shape
    pos, vel, skips, _ = split.forces_split(tc, b, rp, dt, threads, lanes,
                                            chunk)
    for got, ref in zip((pos, vel), sk.forces_plain(tc, b, rp, dt)):
        assert rel(got, ref) <= TOL[dtype]
    assert skips == [1] * tc.n


@pytest.mark.parametrize("kind", ["stirred", "crowded"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_split_matches_jax_exact(dtype, kind):
    """Against JAX's all-pairs forces and integrate on the same state and
    the same (JAX) density, as tests/test_torch_sph_kernels.py holds the
    plain version."""
    jc, tc, pos, vel, b, _, dt = setup(kind, dtype)
    order = b.order.long().numpy()
    _, rho, press = js._exact_density(jc, jnp.asarray(pos))
    rho_n, press_n = np.asarray(rho), np.asarray(press)
    pt = press_n / np.maximum(rho_n, 1e-30) ** 2
    rp = torch.tensor(np.stack([rho_n, pt], -1)[order])
    acc = js._exact_forces(jc, jnp.asarray(pos), jnp.asarray(vel), rho, press)
    jp, jv = js._integrate(jc, jnp.asarray(pos), jnp.asarray(vel), acc,
                           float(dt))
    pos_k, vel_k, _, _ = split.forces_split(tc, b, rp, dt, 64, 4, 40)
    for got, ref in ((pos_k, jp), (vel_k, jv)):
        assert rel(got.numpy(), ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_crowded_cell_runs_the_chunk_loop(dtype):
    """The crowded cell holds more particles than a chunk of the kernel's
    own shape for f32 or a reduced one, so its runs stage several chunks,
    and every pair is still summed."""
    _, tc, _, _, b, rp, dt = setup("crowded", dtype)
    counts = torch.bincount(b.cid.long())
    chunk = 96
    assert int(counts.max()) > chunk
    pos, vel, skips, chunks = split.forces_split(tc, b, rp, dt, 64, 4, chunk)
    assert max(chunks) >= 3
    for got, ref in zip((pos, vel), sk.forces_plain(tc, b, rp, dt)):
        assert rel(got, ref) <= TOL[dtype]


def test_own_index_skip_excludes_exactly_self():
    """A twin 1e-7 from a particle, approaching it (r^2 = 1e-14 > 1e-16:
    a pair that counts, with a viscosity term), is not skipped: every
    particle skips one entry, its own, and the twins' pair enters the sums
    as in the plain version."""
    _, tc, pos, vel = pool("stirred", "float64")
    pos[1] = pos[0] + np.array([1e-7, 0.0])
    vel[1] = vel[0] - np.array([1.0, 0.0])
    b = sk.binning_plain(tc, torch.tensor(pos), torch.tensor(vel))
    rp = sk.density_plain(tc, b)
    dt = torch.tensor(2e-3, dtype=torch.float64)
    got_p, got_v, skips, _ = split.forces_split(tc, b, rp, dt, 64, 4, 40)
    assert skips == [1] * tc.n
    ref_p, ref_v = sk.forces_plain(tc, b, rp, dt)
    assert rel(got_v, ref_v) <= 1e-12 and rel(got_p, ref_p) <= 1e-12
    # the twins' pair term is not zero, so dropping it would show
    s0, s1 = (int((b.order == i).nonzero()) for i in (0, 1))
    cx, _ = sk.pair_forces(tc, b.fields, rp, torch.tensor([s0]),
                           torch.tensor([s1]))
    assert float(cx.abs()) > 0


@pytest.mark.parametrize("n, lanes", [(512, 8), (4096, 8), (65536, 8),
                                      (131072, 4), (1 << 20, 2)])
def test_kernel_lanes_follow_the_particle_count(n, lanes):
    """The lanes a particle the model takes from the sources' constants
    (csrc/sph_forces.cu lanes_for, which the library's shape query
    reports on the card): 8 where n particles give too few warps, down to
    2 at 2^20; a block's threads are whole warps of whole particles."""
    assert split.kernel_lanes(n) == lanes
    assert split.THREADS % 32 == 0 and split.THREADS % lanes == 0
    assert split.kernel_chunk(torch.float32) == split.STAGE_BYTES // 24
    assert split.kernel_chunk(torch.float64) == split.STAGE_BYTES // 48


# receiver ranges: r0 off a block's boundary for the source's shape (16
# particles a block at 8 lanes) and the small ones, the last one empty
RANGES = [(5, 200), (37, 512), (0, 129), (300, 300)]


@pytest.mark.parametrize("r0, r1", RANGES)
@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[1]])
@pytest.mark.parametrize("kind", ["stirred", "crowded"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_range_keeps_the_whole_launch_order(dtype, kind, shape, r0, r1):
    """Over a range [r0, r1) the model keeps the blocks of the whole range
    (the first the one holding r0), so each receiver's sums take the same
    order: the range's rows are bitwise the whole launch's, and within the
    bar of the plain version over the same range; the others are not
    written."""
    _, tc, _, _, b, rp, dt = setup(kind, dtype)
    full_p, full_v, full_skips, full_chunks = split.forces_split(
        tc, b, rp, dt, *shape)
    pos, vel, skips, chunks = split.forces_split(tc, b, rp, dt, *shape,
                                                 r0=r0, r1=r1)
    mine = b.order.long()[r0:r1]
    others = torch.ones(tc.n, dtype=torch.bool)
    others[mine] = False
    assert torch.equal(pos[mine], full_p[mine])
    assert torch.equal(vel[mine], full_v[mine])
    assert bool(pos[others].isnan().all())
    assert skips[r0:r1] == full_skips[r0:r1] and chunks[r0:r1] == (
        full_chunks[r0:r1])
    if r1 > r0:
        ref_p, ref_v = sk.forces_plain(tc, b, rp, dt, r0, r1)
        assert rel(pos[mine], ref_p[mine]) <= TOL[dtype]
        assert rel(vel[mine], ref_v[mine]) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_window_matches_the_whole_grid_inside(dtype):
    """On a window of cell columns 2-5 of the 6x6 grid, over the particles
    that lie in it, the receivers whose 3x3 cells lie in the window (columns
    3 and 4) get the whole grid's forces within the bar, from the whole
    run's densities; the model over the window equals the plain version
    over it."""
    _, tc, pos, vel, b, rp, dt = setup("stirred", dtype)
    g = tc.grid()
    col = np.clip(np.floor(pos[:, 0] / g.cell), 0, g.Gx - 1)
    keep = np.nonzero((col >= 2) & (col < 6))[0]
    win = sk.Window(2, 4)
    bw = sk.binning_plain(tc, torch.tensor(pos[keep]),
                          torch.tensor(vel[keep]), win)
    rank_of = torch.empty(tc.n, dtype=torch.long)
    rank_of[b.order.long()] = torch.arange(tc.n)
    ids = torch.tensor(keep)[bw.order.long()]      # each local sorted id
    rpw = rp[rank_of[ids]]
    pos_w, vel_w, _, _ = split.forces_split(tc, bw, rpw, dt, 64, 4, 40,
                                            win=win)
    ref_p, ref_v = sk.forces_plain(tc, bw, rpw, dt, win=win)
    assert rel(pos_w, ref_p) <= TOL[dtype] and rel(vel_w, ref_v) <= TOL[dtype]
    inner = torch.tensor((col[keep] >= 3) & (col[keep] < 5))
    full_p, full_v = sk.forces_plain(tc, b, rp, dt)
    idx = torch.tensor(keep)[inner]
    assert inner.sum() > 20
    assert rel(pos_w[inner], full_p[idx]) <= TOL[dtype]
    assert rel(vel_w[inner], full_v[idx]) <= TOL[dtype]
