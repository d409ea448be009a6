"""The MLS-MPM G2P that updates each node it gathers (csrc/mpm_g2p.cu,
kernels/mpm_cuda.py `g2p`): the grid update and the G2P in one launch.

On the CPU the wrapper is its plain version, `g2p_plain`: the G2P
(solvers/mpm.py::_g2p) of the grid update's node velocities
(::_grid_update).  Here that plain version, and a torch model of the
kernel's order of work (tests/oracles/mpm_g2p_fused.py: each node's
velocity formed once in its block's window, or where a particle gathers
it, and no velocity grid), are held
bitwise to that composition on chip_smoke.py's particles (the first eight
on the walls and corners) over the P2G grids and over synthetic grids with
empty nodes beside particles and outward momenta in every sticky band,
with the particles in their random order (the kernel's blocks form each
node where it is gathered) and sorted by cell (each block forms its nodes
once in a window); and the same inputs go through JAX: its Pallas grid kernel (TPU kernel
#20) in interpret mode, then its scatter engine's G2P (#21's exact
counterpart), within 1e-12 (f64) / 1e-5 (f32) relative; a few steps of
the 'cuda' engine's step against JAX's Pallas engine in interpret mode
within 5e-4 (f32).  chip_smoke.py holds the kernel bitwise to the same
plain version on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke
from fluidsims_tpu.kernels import mpm_pallas
from fluidsims_tpu.solvers import mpm as jm
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.kernels import mpm_cuda as mk
from fluidsims_tpu_torch.solvers import mpm as tm
from tests.oracles.mpm_g2p_fused import fused_g2p, source_shape

torch.set_num_threads(1)
CPU = torch.device("cpu")
PARTS = ("pos", "vel", "F", "Jp")
MATS = ("mud", "snow", "sand")
SHAPES = ((96, 96), (37, 53))
DTYPES = ("float32", "float64")
TOL = {"float64": 1e-12, "float32": 1e-5}


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits (NaN payloads and the sign of zero included)."""
    it = torch.int32 if t.element_size() == 4 else torch.int64
    return t.contiguous().view(it)


def same_bits(got, ref) -> bool:
    return all(a.dtype == b.dtype and a.shape == b.shape
               and torch.equal(bits(a), bits(b)) for a, b in zip(got, ref))


def rel(got, ref) -> float:
    """max |got - ref| / max(max |ref|, 1)."""
    ref = np.asarray(ref, np.float64)
    return np.abs(got.numpy().astype(np.float64) - ref).max() / max(
        np.abs(ref).max(), 1.0)


def case(dtype, material, shape, order="given"):
    """chip_smoke.py's kernel case: 4 Gx Gy seeded particles over the
    grid, the first eight on its walls and corners and at the box's
    corner (order "given"), or the same sorted by base cell
    (chip_smoke.mpm_cell_order, order "by_cell"); with their P2G grids and
    synthetic grids."""
    gx, gy = shape
    cfg = tm.MPMConfig(n=4 * gx * gy, gx=gx, gy=gy, material=material,
                       dtype=dtype)
    parts = chip_smoke.mpm_particles(cfg, CPU, chip_smoke.SEED + gx + gy)
    grids = tm._p2g(cfg, *parts)
    if order == "by_cell":
        idx = chip_smoke.mpm_cell_order(cfg, parts[0])
        parts = [t[idx].contiguous() for t in parts]
    syn = chip_smoke.mpm_synthetic_grids(cfg, CPU, cfg.n + cfg.gx)
    return cfg, parts, {"p2g": grids, "synthetic": syn}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("material", MATS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_version_is_the_composition_bitwise(dtype, material, shape):
    cfg, (pos, vel, F, Jp), grids = case(dtype, material, shape)
    for name, g in grids.items():
        got = mk.g2p_plain(cfg, pos, F, Jp, *g)
        ref = tm._g2p(cfg, pos, F, Jp, *tm._grid_update(cfg, *g))
        assert same_bits(got, ref), name
        assert [tuple(t.shape) for t in got] == [
            (cfg.n, 2), (cfg.n, 2), (cfg.n, 2, 2), (cfg.n,)]


@pytest.mark.parametrize("order", ["given", "by_cell"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_order_model_is_bitwise(dtype, shape, order):
    """Each node formed in its block's window, or where it is gathered,
    gives the bits of the grid updated once and then gathered: the node
    velocities each particle sees, and the G2P's outputs.  Particles in
    random order over the grid spread every block past a window; sorted by
    cell, every block forms one."""
    material = MATS[(len(order) + shape[0]) % 3]
    cfg, (pos, vel, F, Jp), grids = case(dtype, material, shape, order)
    for name, g in grids.items():
        got, seen, windowed = fused_g2p(cfg, pos, F, Jp, *g)
        assert same_bits(got, mk.g2p_plain(cfg, pos, F, Jp, *g)), name
        assert bool(windowed.all() if order == "by_cell"
                    else not windowed.any())
        gu, gv = tm._grid_update(cfg, *g)
        base, _ = tm._base_frac(cfg, pos)
        for j, (ox, oy) in enumerate((a, b) for a in range(3)
                                     for b in range(3)):
            ix, iy = base[:, 0] + ox, base[:, 1] + oy
            ok = (ix >= 0) & (ix < cfg.gx) & (iy >= 0) & (iy < cfg.gy)
            flat = (iy.clamp(0, cfg.gy - 1) * cfg.gx
                    + ix.clamp(0, cfg.gx - 1))
            zero = torch.zeros((), dtype=pos.dtype)
            for k, grid in enumerate((gu, gv)):
                ref = torch.where(ok, grid.reshape(-1)[flat], zero)
                assert torch.equal(bits(seen[:, j, k]), bits(ref)), (name, j)


@pytest.mark.parametrize("threads,window", [(256, 150), (64, 60)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_order_model_mixes_windows_and_gathers(dtype, threads,
                                                      window):
    """Smaller windows on the sorted particles: some blocks form a window,
    the rest (a box across a row's end) form each node where it is
    gathered, in one launch; bitwise."""
    cfg, (pos, vel, F, Jp), grids = case(dtype, "sand", (37, 53), "by_cell")
    got, _, windowed = fused_g2p(cfg, pos, F, Jp, *grids["synthetic"],
                                 threads=threads, window=window)
    assert 0 < int(windowed.sum()) < windowed.numel()
    assert same_bits(got, mk.g2p_plain(cfg, pos, F, Jp, *grids["synthetic"]))


def test_model_reads_the_shipped_shape():
    """The source's threads a block are whole warps, and its window of
    both velocities fits the static shared memory at f64."""
    threads, window = source_shape()
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert 2 * window * 8 + 4 * 4 * threads // 32 <= 48 * 1024


@pytest.mark.parametrize("shape", SHAPES)
def test_cases_reach_the_walls_bands_and_empty_nodes(shape):
    """What the bitwise cases cover: particles whose 3x3 nodes leave the
    grid on every side; synthetic grids with empty nodes that particles
    gather, and outward and inward momenta in each of the four sticky
    bands, so that the band tests zero some velocities and keep others."""
    cfg, (pos, vel, F, Jp), grids = case("float64", "snow", shape)
    base, _ = tm._base_frac(cfg, pos)
    assert (base[:8] < 0).any() and (base[:8, 0] + 2 >= cfg.gx).any()
    assert (base[:8, 1] + 2 >= cfg.gy).any()
    mass, mx, my = grids["synthetic"]
    gu, gv = tm._grid_update(cfg, mass, mx, my)
    has = mass > 0
    gathered = torch.zeros_like(has)
    for ox in range(3):
        for oy in range(3):
            ix = (base[:, 0] + ox).clamp(0, cfg.gx - 1)
            iy = (base[:, 1] + oy).clamp(0, cfg.gy - 1)
            gathered[iy, ix] = True
    assert (gathered & ~has).sum() > 100
    u = mx / mass.clamp_min(1e-30)
    v = my / mass.clamp_min(1e-30) - cfg.gravity * cfg.dt
    for band, out, kept in (
            ((slice(None), slice(0, 3)), u < 0, gu > 0),
            ((slice(None), slice(-3, None)), u > 0, gu < 0),
            ((slice(0, 3), slice(None)), v < 0, gv > 0),
            ((slice(-3, None), slice(None)), v > 0, gv < 0)):
        assert (has & out)[band].sum() > 10
        assert (gu if band[0] == slice(None) else gv)[band][
            (has & out)[band]].eq(0).all()
        assert kept[band].sum() > 10


def jax_pallas_grid_then_scatter_g2p(jc, parts, grids):
    """JAX's Pallas grid kernel (#20) in interpret mode on the lane-padded
    grids, then its scatter engine's G2P on those node velocities: handed
    to `_step_scatter` by its grid_reduce hook as unit masses with zero
    gravity, whose grid update then passes them through unchanged (the
    G2P reads neither gravity nor the P2G)."""
    gx, gy = jc.gx, jc.gy
    padded = [np.pad(g, ((0, 0), (0, 128 - gx))) for g in grids]
    call = pl.pallas_call(
        functools.partial(mpm_pallas._grid_kernel, cfg=jc, Gx=gx, Gy=gy),
        out_shape=[jax.ShapeDtypeStruct((gy, 128), jc.jax_dtype)] * 2,
        interpret=True)
    gu, gv = (jnp.asarray(np.asarray(r)[:, :gx]) for r in call(*padded))
    unit = jnp.asarray((grids[0] > 0).astype(grids[0].dtype))
    j0 = jc.replace(gravity=0.0)
    return jax.jit(lambda *a: jm._step_scatter(
        j0, jm.MPMState(*a), lambda _: (unit, gu, gv)))(*parts)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("material", MATS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_matches_jax_pallas_grid_kernel_then_scatter_g2p(dtype, material,
                                                         shape):
    cfg, parts, grids = case(dtype, material, shape)
    jc = jm.MPMConfig(n=cfg.n, gx=cfg.gx, gy=cfg.gy, material=material,
                      dtype=dtype)
    np_parts = [t.numpy() for t in parts]
    pos, _, F, Jp = parts
    for name, g in grids.items():
        ref = jax_pallas_grid_then_scatter_g2p(jc, np_parts,
                                               [t.numpy() for t in g])
        got = mk.g2p_plain(cfg, pos, F, Jp, *g)
        for field, a, b in zip(PARTS, got, ref):
            assert rel(a, b) <= TOL[dtype], (name, field, rel(a, b))


@pytest.mark.parametrize("material", ["mud", "sand"])
def test_steps_match_jax_pallas_interpret(material):
    """solvers/mpm.py::_step on the P2G's and this launch's plain versions
    against JAX's Pallas engine in interpret mode (n=4096 on 48^2, 3 f32
    steps, as tests/test_torch_mpm.py runs snow): no particle passes the
    Pallas engine's K slots here, within 5e-4 relative."""
    jc = jm.MPMConfig(n=4096, gx=48, gy=48, material=material,
                      engine="pallas")
    tc = interop.mpm_config_from_dict(jc.asdict())
    sj = jm.init(jc)
    st = interop.mpm_state_from_numpy(*(np.asarray(f) for f in sj),
                                      dtype=tc.torch_dtype, device=CPU)
    assert int(jm.overflow_count(jc.replace(engine="dense"), sj)) == 0
    stepj = jax.jit(lambda s: jm.step(jc, s))
    for _ in range(3):
        sj = stepj(sj)
        st = tm._step(tc, st, functools.partial(mk.p2g_plain, tc),
                      functools.partial(mk.g2p_plain, tc))
    for name in PARTS:
        err = rel(getattr(st, name), getattr(sj, name))
        assert err <= 5e-4, (name, err)


@pytest.mark.parametrize("material", MATS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_step_on_cpu_is_scatter_bitwise(dtype, material):
    """make_step_cuda's step on CPU tensors (the wrappers' plain versions)
    equals the 'scatter' engine's bitwise over 5 steps, launching
    nothing."""
    cfg = tm.MPMConfig(n=2048, gx=37, gy=53, material=material, dtype=dtype,
                       engine="scatter")
    a = b = tm.init(cfg, CPU)
    step = mk.make_step_cuda(cfg)
    mk.reset_launches()
    for _ in range(5):
        a, b = step(a), tm._step_scatter(cfg, b)
        assert same_bits(a, b)
    assert mk.LAUNCHES == {"p2g": 0, "g2p": 0}


@pytest.mark.parametrize("dtype", DTYPES)
def test_grid_reduce_hook_sees_the_three_p2g_grids(dtype):
    """The hook gets (mass, mom_x, mom_y) before the G2P, and the G2P
    reads what it returns: scaling mass and both momenta by 4 leaves the
    step's bits (a power of two, so every quotient rounds alike)."""
    cfg = tm.MPMConfig(n=700, gx=24, gy=40, dtype=dtype)
    s = tm.init(cfg, CPU)
    step = mk.make_step_cuda(cfg)
    seen = []

    def hook(grids):
        seen.append([g.clone() for g in grids])
        return tuple(4 * g for g in grids)

    out = step(s, grid_reduce=hook)
    assert len(seen) == 1 and len(seen[0]) == 3
    assert all(g.shape == (40, 24) and g.dtype == cfg.torch_dtype
               for g in seen[0])
    for g, r in zip(seen[0], mk.p2g_plain(cfg, s.pos, s.vel, s.F, s.Jp)):
        assert torch.equal(g, r)
    assert same_bits(out, step(s))
    zeroed = step(s, grid_reduce=lambda g: tuple(torch.zeros_like(x)
                                                 for x in g))
    assert torch.equal(zeroed.vel, torch.zeros_like(s.vel))


def test_wrapper_on_cpu_counts_nothing():
    cfg = tm.MPMConfig(n=500, gx=19, gy=27, material="mud")
    pos, vel, F, Jp = chip_smoke.mpm_particles(cfg, CPU, 11)
    mk.reset_launches()
    grids = mk.p2g(cfg, pos, vel, F, Jp)
    out = mk.g2p(cfg, pos, F, Jp, *grids)
    assert same_bits(out, mk.g2p_plain(cfg, pos, F, Jp, *grids))
    assert mk.LAUNCHES == {"p2g": 0, "g2p": 0}
    assert not hasattr(mk, "grid_update")
