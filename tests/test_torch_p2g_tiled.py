"""The tiled particle-to-grid kernels of the port, on the CPU.

The kernels (fluidsims_tpu_torch/csrc/p2g_tiles.cuh with csrc/mpm_p2g.cu
and csrc/flip_p2g.cu) bin the particles by tile of shifted base nodes,
cut each tile into chunks, sort a chunk by cell, and add each run of one
cell's particles in a warp to the grids once.  They cannot run here, so a
plain torch model of that binning (tests/oracles/p2g_tiles.py), with the
sources' tile, chunk and threads, is held to the plain P2Gs
(solvers/mpm.py::_p2g, solvers/flip_apic.py::_p2g) within 1e-5 (f32) /
1e-12 (f64) relative to each grid's max (the sums' order differs), for
mud, snow and sand and for apic 0, 1 and the config's, on grids that are
not a multiple of the tile, with particles on and past the walls (MPM
drops their out-of-grid targets, FLIP clips them), one cell crowded past a
chunk, and whole tiles left empty; to JAX's scatter P2Gs under
jax.jit at the same bars; and, as the MPM P2G of the 'cuda' engine's step,
to JAX's Pallas MPM step in interpret mode (5e-4 relative over 3 f32
steps, as tests/test_torch_mpm.py holds the plain step).  A model with the
base shifted one node short breaks (its premises fail or its sums differ),
the sources' chunks fit the shared memory of a block at both dtypes, two
launch shapes whose scratch has one size get a scratch each, and
the size from which the wrappers take the tiled design puts bench.py's
runs on the atomic side and 2^20 particles on the tiled side.
"""

import jax
import numpy as np
import pytest
import torch

from fluidsims_tpu.solvers import flip_apic as jf
from fluidsims_tpu.solvers import mpm as jm
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.kernels import mpm_cuda as mk
from fluidsims_tpu_torch.solvers import flip_apic as tf
from fluidsims_tpu_torch.solvers import mpm as tm
from tests.oracles import p2g_tiles

torch.set_num_threads(1)
CPU = torch.device("cpu")
BAR = {"float32": 1e-5, "float64": 1e-12}
NP = {"float32": np.float32, "float64": np.float64}


def positions(rng, n_p: int, X: float, Y: float, crowd: int):
    """Seeded positions over [0, 0.5 X] x [0, Y] (the right half empty but
    for the walls), `crowd` of them in one cell, and twelve on and past the
    walls and corners."""
    pos = rng.random((n_p, 2)) * [0.5 * X, Y]
    pos[12:12 + crowd] = ([0.3 * X, 0.4 * Y]
                          + 1e-3 * X * rng.random((crowd, 2)))
    pos[:12] = [[0, 0], [X, Y], [0, Y], [X, 0], [-0.02 * X, 0.5 * Y],
                [1.03 * X, 0.5 * Y], [0.5 * X, -0.05 * Y],
                [0.3 * X, 1.1 * Y], [-X, -Y], [5 * X, 5 * Y],
                [0.999 * X, 0.001 * Y], [0.001 * X, 0.999 * Y]]
    return pos


def mpm_parts(cfg, seed: int, crowd: int):
    rng = np.random.default_rng(seed)
    pos = positions(rng, cfg.n, (cfg.gx - 1) * cfg.dx, (cfg.gy - 1) * cfg.dx,
                    crowd)
    F = np.eye(2) + 0.05 * rng.standard_normal((cfg.n, 2, 2))
    return [a.astype(NP[cfg.dtype]) for a in
            (pos, rng.standard_normal((cfg.n, 2)), F,
             rng.uniform(0.5, 1.5, cfg.n))]


def flip_parts(cfg, seed: int, crowd: int):
    rng = np.random.default_rng(seed)
    pos = positions(rng, cfg.particles, 1.0, 1.0, crowd)
    return [a.astype(NP[cfg.dtype]) for a in
            (pos, *(rng.standard_normal((cfg.particles, 2))
                    for _ in range(3)))]


def tens(*arrays):
    return [torch.tensor(a) for a in arrays]


def rel_max(got, ref) -> float:
    """max |got - ref| / max |ref| (the bar of a sum)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got.astype(np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-300))


def empty_tiles(q, shape, gx, gy) -> int:
    """Tiles of the grid that no particle joins."""
    n_tx, n = p2g_tiles.tiles(shape, gx, gy)
    s = q.shifted[q.joins]
    used = torch.unique((s[:, 1] // shape.tile_y) * n_tx
                        + s[:, 0] // shape.tile_x)
    return n - len(used)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(37, 53), (64, 40)])
@pytest.mark.parametrize("material", ["mud", "snow", "sand"])
def test_mpm_model_matches_plain(material, shape, dtype):
    gx, gy = shape
    cfg = tm.MPMConfig(n=4 * gx * gy, gx=gx, gy=gy, material=material,
                       dtype=dtype)
    crowd = 2 * p2g_tiles.MPM.chunk + 100
    parts = tens(*mpm_parts(cfg, gx + gy, crowd))
    stats = {}
    got = p2g_tiles.mpm_p2g_tiled(cfg, *parts, stats=stats)
    ref = tm._p2g(cfg, *parts)
    for g, r in zip(got, ref):
        assert g.shape == (gy, gx) and g.dtype == cfg.torch_dtype
        assert rel_max(g, r) <= BAR[dtype], rel_max(g, r)
    # the cases the inputs are there for
    q = p2g_tiles.mpm_targets(cfg, *parts)
    assert gx % p2g_tiles.MPM.tile_x or gy % p2g_tiles.MPM.tile_y
    assert stats["most_in_tile"] > p2g_tiles.MPM.chunk
    assert not bool(q.joins.all())          # past the walls: no tile
    assert not bool(q.inside[q.joins].all())  # targets dropped at a wall
    if gx == 64:  # a column of tiles between the bulk and the right wall
        assert empty_tiles(q, p2g_tiles.MPM, gx, gy) > 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [37, 50])
@pytest.mark.parametrize("apic", [None, 0.0, 1.0])
def test_flip_model_matches_plain(apic, n, dtype):
    cfg = tf.FlipApicConfig(particles=4 * n * n, grid=n, dtype=dtype)
    crowd = 2 * p2g_tiles.FLIP.chunk + 100
    parts = tens(*flip_parts(cfg, n, crowd))
    stats = {}
    got = p2g_tiles.flip_p2g_tiled(cfg, *parts, apic, stats=stats)
    ref = tf._p2g(cfg, *parts, apic)
    for g, r in zip(got, ref):
        assert g.shape == (n, n) and g.dtype == cfg.torch_dtype
        assert rel_max(g, r) <= BAR[dtype], rel_max(g, r)
    q = p2g_tiles.flip_targets(cfg, *parts, apic)
    assert n % p2g_tiles.FLIP.tile_x
    assert stats["most_in_tile"] > p2g_tiles.FLIP.chunk
    assert bool((q.shifted == 0).any()) and bool((q.shifted == n + 1).any())
    if n == 50:  # a column of tiles between the bulk and the right wall
        assert empty_tiles(q, p2g_tiles.FLIP, n, n) > 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_runs_cut_the_global_adds(dtype):
    """The kernel's point: in a dense block (MPM's start, ~19 particles a
    cell) a warp's run of one cell makes one add a target where a particle
    made one; FLIP's ~4 a cell cut them too."""
    cfg = tm.MPMConfig(n=8192, gx=48, gy=48, dtype=dtype)
    s = tm.init(cfg, CPU)
    stats = {}
    p2g_tiles.mpm_p2g_tiled(cfg, *s, stats=stats)
    assert stats["global_adds"] * 4 < stats["particle_adds"], stats
    fc = tf.FlipApicConfig(particles=16384, grid=64, dtype=dtype)
    fs = tf.init(fc, CPU)
    stats = {}
    p2g_tiles.flip_p2g_tiled(fc, fs.pos, fs.vel, fs.affine_x, fs.affine_y,
                             stats=stats)
    assert stats["global_adds"] * 2 < stats["particle_adds"], stats


def test_a_base_shifted_short_breaks_the_model():
    """MPM's bases reach -2 and FLIP's -1: with one node less of shift the
    particles at the low walls fall out of every tile (MPM: their targets
    inside the grid are lost) or below the first tile (FLIP)."""
    cfg = tm.MPMConfig(n=4 * 37 * 53, gx=37, gy=53, dtype="float64")
    parts = tens(*mpm_parts(cfg, 90, 300))
    got = p2g_tiles.mpm_p2g_tiled(cfg, *parts, shift=1)
    ref = tm._p2g(cfg, *parts)
    assert max(rel_max(g, r) for g, r in zip(got, ref)) > 1e-6
    fc = tf.FlipApicConfig(particles=4 * 37 * 37, grid=37, dtype="float64")
    fparts = tens(*flip_parts(fc, 37, 300))
    with pytest.raises(AssertionError, match="below 0"):
        p2g_tiles.flip_p2g_tiled(fc, *fparts, shift=0)


@pytest.mark.parametrize("shape", [(8, 8, 64), (16, 8, 512), (32, 32, 1024)])
def test_other_tiles_and_chunks_match_plain(shape):
    """The tiles and chunks the sweep tries hold the plain version too."""
    tx, ty, chunk = shape
    cfg = tm.MPMConfig(n=4 * 37 * 53, gx=37, gy=53, dtype="float64")
    parts = tens(*mpm_parts(cfg, 7, 2 * chunk + 5))
    sh = p2g_tiles.MPM._replace(tile_x=tx, tile_y=ty, chunk=chunk)
    got = p2g_tiles.mpm_p2g_tiled(cfg, *parts, shape=sh)
    for g, r in zip(got, tm._p2g(cfg, *parts)):
        assert rel_max(g, r) <= BAR["float64"]
    fc = tf.FlipApicConfig(particles=4 * 37 * 37, grid=37, dtype="float64")
    fparts = tens(*flip_parts(fc, 7, 2 * chunk + 5))
    sh = p2g_tiles.FLIP._replace(tile_x=tx, tile_y=ty, chunk=chunk)
    got = p2g_tiles.flip_p2g_tiled(fc, *fparts, shape=sh)
    for g, r in zip(got, tf._p2g(fc, *fparts)):
        assert rel_max(g, r) <= BAR["float64"]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("material", ["mud", "snow", "sand"])
def test_mpm_model_matches_jax_scatter(material, dtype):
    """The model against the P2G grids JAX's scatter engine hands its
    grid_reduce hook, under jit."""
    gx, gy = 40, 24
    jc = jm.MPMConfig(n=3000, gx=gx, gy=gy, material=material, dtype=dtype)
    tc = tm.MPMConfig(n=3000, gx=gx, gy=gy, material=material, dtype=dtype)
    parts = mpm_parts(tc, 11, 700)

    def grids(*a):
        seen = []

        def hook(g):
            seen.append(g)
            return g

        jm._step_scatter(jc, jm.MPMState(*a), hook)
        return seen[0]

    ref = [np.asarray(g) for g in jax.jit(grids)(*parts)]
    got = p2g_tiles.mpm_p2g_tiled(tc, *tens(*parts))
    for g, r in zip(got, ref):
        assert rel_max(g, r) <= BAR[dtype], rel_max(g, r)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("apic", [None, 0.0, 1.0])
def test_flip_model_matches_jax_scatter(apic, dtype):
    n = 40
    jc = jf.FlipApicConfig(particles=4000, grid=n, dtype=dtype)
    tc = tf.FlipApicConfig(particles=4000, grid=n, dtype=dtype)
    parts = flip_parts(tc, 13, 700)
    ref = jax.jit(lambda *a: jf._p2g(jc, *a, apic=apic))(*parts)
    got = p2g_tiles.flip_p2g_tiled(tc, *tens(*parts), apic)
    for g, r in zip(got, ref):
        assert rel_max(g, r) <= BAR[dtype], rel_max(g, r)


def test_model_step_matches_jax_pallas_interpret():
    """The 'cuda' engine's step with the model in place of the P2G kernel,
    against JAX's Pallas engine in interpret mode (n=4096 on 48^2, 3 f32
    steps, as tests/test_torch_mpm.py runs the plain step): no particle
    passes the Pallas engine's K slots here, within 5e-4 relative."""
    jc = jm.MPMConfig(n=4096, gx=48, gy=48, engine="pallas")
    tc = interop.mpm_config_from_dict(jc.asdict())
    sj = jm.init(jc)
    st = interop.mpm_state_from_numpy(*(np.asarray(f) for f in sj),
                                      dtype=tc.torch_dtype, device=CPU)
    assert int(jm.overflow_count(jc.replace(engine="dense"), sj)) == 0
    stepj = jax.jit(lambda s: jm.step(jc, s))

    def p2g(pos, vel, F, Jp):
        return p2g_tiles.mpm_p2g_tiled(tc, pos, vel, F, Jp)

    def step(s):
        return tm._step(tc, s, p2g, lambda *a: mk.g2p(tc, *a), None)

    for _ in range(3):
        sj, st = stepj(sj), step(st)
    for name in ("pos", "vel", "F", "Jp"):
        ref = np.asarray(getattr(sj, name), np.float64)
        err = (np.abs(getattr(st, name).numpy().astype(np.float64) - ref)
               .max() / max(np.abs(ref).max(), 1.0))
        assert err <= 5e-4, (name, err)


@pytest.mark.parametrize("gx, gy", [(96, 96), (128, 128), (512, 512),
                                    (2048, 2048), (37, 53)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_sources_fit_a_block(gx, gy, itemsize):
    """The sources' chunk and sort arrays (or the tile counts) fit 227 KB
    at both dtypes; threads are whole warps; a chunk is whole warps."""
    for shape in (p2g_tiles.MPM, p2g_tiles.FLIP):
        assert p2g_tiles.smem_bytes(shape, itemsize, gx, gy) <= 232448
        assert shape.threads % 32 == 0 and 32 <= shape.threads <= 1024
        assert shape.chunk % 32 == 0
    assert p2g_tiles.ATOMIC_THREADS % 32 == 0


@pytest.mark.parametrize("n_p", [1, 31, 4096, 1 << 20])
@pytest.mark.parametrize("n_tiles", [1, 81, 1089, 20000])
def test_scratch_layout_is_aligned(n_p, n_tiles):
    """The keys start on 8 bytes (int2) and the chunks on 16 (int4), and
    the chunks have room for every tile's partial chunk."""
    lay = p2g_tiles.layout(n_p, n_tiles, p2g_tiles.MPM.chunk)
    assert lay["keys"] % 2 == 0 and lay["chunks"] % 4 == 0
    assert lay["keys"] >= lay["first_chunk"] + n_tiles
    assert lay["idx"] >= lay["keys"] + 2 * n_p
    most = n_tiles + -(-n_p // p2g_tiles.MPM.chunk)
    assert lay["total"] - lay["chunks"] == 4 * most


def test_design_switch_splits_the_main_runs():
    """bench.py's runs (32,768 MPM, 65,536 FLIP particles) take the first
    design, 2^18 and 2^20 the tiled one."""
    assert p2g_tiles.design(32768) == "atomic"
    assert p2g_tiles.design(65536) == "atomic"
    assert p2g_tiles.design(1 << 18) == "tiled"
    assert p2g_tiles.design(1 << 20) == "tiled"


@pytest.mark.parametrize("kernel", ["mpm", "flip"])
def test_scratch_is_kept_per_launch_shape(kernel):
    """Two tiled launch shapes whose scratch has one size, the second with
    more tiles, so that its tile counts lie where the first keeps its
    offsets: the wrappers give each shape a scratch of its own (a launch
    leaves only its own counts at 0), zeroed, and the same one again for
    the same shape."""
    from fluidsims_tpu_torch.kernels import flip_cuda as fk
    from fluidsims_tpu_torch.kernels._common import P2GLaunch
    shape = p2g_tiles.MPM if kernel == "mpm" else p2g_tiles.FLIP

    def words(n_p, g):
        return p2g_tiles.layout(n_p, p2g_tiles.tiles(shape, g, g)[1],
                                shape.chunk)

    a = words(10007, 30)
    n_b = next(m for m in range(9500, 10500)
               if words(m, 46)["total"] == a["total"])
    b = words(n_b, 46)
    assert b["counts"] + p2g_tiles.tiles(shape, 46, 46)[1] > a["offsets"]

    def scratch(n_p, g):
        launch = P2GLaunch(design=1, scratch_ints=a["total"])
        if kernel == "mpm":
            return mk._p2g_scratch(n_p, g, g, torch.float32, launch, CPU, 0)
        return fk._p2g_scratch(n_p, g, torch.float32, launch, CPU, 0)

    first, other = scratch(10007, 30)[0], scratch(n_b, 46)[0]
    assert first.numel() == other.numel() == a["total"]
    assert first.data_ptr() != other.data_ptr()
    assert not first.any() and not other.any()
    assert scratch(10007, 30)[0] is first
