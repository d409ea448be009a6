"""Port vs JAX: MLS-MPM (solvers/mpm.py) and the plain versions of its CUDA
kernels (kernels/mpm_cuda.py).

The same seeded numpy inputs, or the same initial state carried over by
interop, go through JAX's functions (jit) and the port's: float64 within
1e-12 (absolute, or relative to each grid's max where the values are
sums), float32 within 1e-5 for one transfer and 5e-4 relative for whole
steps (ROADMAP.md); the port against the float64 loop oracle within
1e-12.  JAX's scatter engine is one function, so its slices are read
through its own `grid_reduce` hook: the P2G grids it hands the hook, and
the steps it takes from grids the hook substitutes.  The grid update is
also held to JAX's Pallas grid kernel, and JAX's Pallas engine runs in
interpret mode, as tests/test_flip_mpm.py runs it.  The 'cuda' engine's
step composed from the kernels' plain versions (the wrappers take them
for CPU tensors) is the 'scatter' engine, which chip_smoke.py holds the
CUDA kernels to on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fluidsims_tpu.kernels import mpm_pallas
from fluidsims_tpu.solvers import mpm as jm
from fluidsims_tpu_torch import cli, interop
from fluidsims_tpu_torch.kernels import _build
from fluidsims_tpu_torch.kernels import mpm_cuda as mk
from fluidsims_tpu_torch.solvers import mpm as tm
from tests.oracles.mpm_oracle import MPMOracle

torch.set_num_threads(1)
CPU = torch.device("cpu")
PARTS = ("pos", "vel", "F", "Jp")
NP = {"float32": np.float32, "float64": np.float64}
ONE_TOL = {"float64": 1e-12, "float32": 1e-5}
STEP_TOL = {"float64": 1e-12, "float32": 5e-4}
MATS = ("mud", "snow", "sand")


def both(**kw):
    """(JAX config, port config, JAX init state, port state moved over by
    interop)."""
    jc = jm.MPMConfig(**kw)
    tc = interop.mpm_config_from_dict(jc.asdict())
    sj = jm.init(jc)
    st = interop.mpm_state_from_numpy(*(np.asarray(f) for f in sj),
                                      dtype=tc.torch_dtype, device=CPU)
    return jc, tc, sj, st


def rel(got, ref) -> float:
    """max |got - ref| / max(max |ref|, 1)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    return np.abs(got.astype(np.float64) - ref).max() / max(
        np.abs(ref).max(), 1.0)


def rel_max(got, ref) -> float:
    """max |got - ref| / max |ref| (the bar of a sum)."""
    ref = np.asarray(ref, np.float64)
    return np.abs(got.numpy().astype(np.float64) - ref).max() / max(
        np.abs(ref).max(), 1e-300)


def particles(cfg, seed):
    """Seeded (pos, vel, F, Jp) as numpy: positions uniform over the grid's
    extent [0, (Gx-1)dx] x [0, (Gy-1)dx], eight of them on its walls and
    corners and at the box's corner (base -1 and G-2 reach past the grid),
    velocities standard normal, F = I + 0.05 N, Jp in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    n = cfg.n
    X, Y = (cfg.gx - 1) * cfg.dx, (cfg.gy - 1) * cfg.dx
    pos = rng.random((n, 2)) * [X, Y]
    pos[:8] = [[0, 0], [X, Y], [0, Y], [X, 0], [0, 0.5 * Y], [X, 0.5 * Y],
               [0.5 * X, 0], [cfg.box_x, cfg.box_y]]
    vel = rng.standard_normal((n, 2))
    F = np.eye(2) + 0.05 * rng.standard_normal((n, 2, 2))
    Jp = rng.uniform(0.5, 1.5, n)
    return [a.astype(NP[cfg.dtype]) for a in (pos, vel, F, Jp)]


def tens(*arrays):
    return [torch.tensor(a) for a in arrays]


def reaches_past(cfg, pos) -> bool:
    """Some particle's 3x3 targets leave the grid on each side."""
    base = np.floor(pos / cfg.dx - 0.5)
    return ((base[:, 0] < 0).any() and (base[:, 0] + 2 >= cfg.gx).any()
            and (base[:, 1] < 0).any() and (base[:, 1] + 2 >= cfg.gy).any())


def test_config_fields_capacity_and_dx():
    for kw in ({}, {"n": 4096, "gx": 40, "gy": 24, "bin_capacity": 12},
               {"n": 1 << 20, "gx": 512, "gy": 512, "material": "mud"}):
        jc, tc = jm.MPMConfig(**kw), tm.MPMConfig(**kw)
        assert tc.asdict() == {**jc.asdict(), "engine": "auto"}
        assert tc.capacity == jc.capacity and tc.dx == jc.dx
    cfg = tm.MPMConfig()
    assert (cfg.n, cfg.gx, cfg.gy, cfg.dt, cfg.material, cfg.engine,
            cfg.dtype) == (32768, 96, 96, 8e-5, "snow", "auto", "float32")
    assert cfg.capacity == 64 and cfg.dx == 1.0 / 95
    with pytest.raises(ValueError, match="engine"):
        tm.MPMConfig(engine="pallas")
    with pytest.raises(ValueError, match="material"):
        tm.MPMConfig(material="ice")
    with pytest.raises(ValueError, match="grid"):
        tm.MPMConfig(gx=7)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [4096, 1000])
def test_init_matches_jax_bitwise(dtype, n):
    jc = jm.MPMConfig(n=n, gx=32, gy=32, dtype=dtype)
    tc = tm.MPMConfig(n=n, gx=32, gy=32, dtype=dtype)
    sj, st = jm.init(jc), tm.init(tc, CPU)
    for name in PARTS:
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(sj, name)))
        assert getattr(st, name).dtype == tc.torch_dtype
        assert getattr(st, name).is_contiguous()
    assert st.F.shape == (n, 2, 2) and st.F.stride() == (4, 2, 1)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("material", MATS)
def test_plastic_and_stress_matches_jax(material, dtype):
    jc = jm.MPMConfig(n=2000, gx=32, gy=32, material=material, dtype=dtype)
    tc = tm.MPMConfig(n=2000, gx=32, gy=32, material=material, dtype=dtype)
    pos, vel, F, Jp = particles(tc, seed=7)
    F[:20, 0, 0] = 1.2   # snow's clamp bites on both sides
    F[20:40, 1, 1] = 0.8
    ref = jax.jit(lambda *a: jm._plastic_and_stress(jc, jm.MPMState(*a)))(
        pos, vel, F, Jp)
    got = tm._plastic_and_stress(tc, tm.MPMState(*tens(pos, vel, F, Jp)))
    for g, r in zip(got, ref):
        assert g.shape == (2000, 2, 2) and g.dtype == tc.torch_dtype
        assert rel_max(g, r) <= ONE_TOL[dtype], rel_max(g, r)
    if material == "snow":
        hi = NP[dtype](1.0 + tc.critical_stretch)
        assert got[0][:, 0, 0].max() == hi and got[0][:, 1, 1].max() == hi
    else:
        np.testing.assert_array_equal(got[0].numpy(), F)


def jax_p2g(jc, pos, vel, F, Jp):
    """The P2G grids that JAX's `_step_scatter` hands its grid_reduce."""
    def grids(*a):
        seen = []

        def hook(g):
            seen.append(g)
            return g

        jm._step_scatter(jc, jm.MPMState(*a), hook)
        return seen[0]

    return [np.asarray(g) for g in jax.jit(grids)(pos, vel, F, Jp)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(32, 32), (40, 24), (48, 48)])
@pytest.mark.parametrize("material", MATS)
def test_p2g_matches_jax_scatter(material, shape, dtype):
    """Seeded particles over the whole grid with eight on the walls: each
    grid within 1e-12 (f64) / 1e-5 (f32) of JAX's relative to its max; the
    targets past the grid are dropped in both."""
    gx, gy = shape
    jc = jm.MPMConfig(n=3000, gx=gx, gy=gy, material=material, dtype=dtype)
    tc = tm.MPMConfig(n=3000, gx=gx, gy=gy, material=material, dtype=dtype)
    parts = particles(tc, seed=gx + gy)
    assert reaches_past(tc, parts[0])
    ref = jax_p2g(jc, *parts)
    got = tm._p2g(tc, *tens(*parts))
    for g, r in zip(got, ref):
        assert g.shape == (gy, gx) and g.dtype == tc.torch_dtype
        assert rel_max(g, r) <= ONE_TOL[dtype], rel_max(g, r)


def grid_inputs(cfg, seed):
    """Seeded P2G-like grids: mass >= 0 with a third of the nodes empty,
    momenta standard normal."""
    rng = np.random.default_rng(seed)
    shape = (cfg.gy, cfg.gx)
    mass = rng.uniform(0.0, 3.0, shape) * (rng.random(shape) > 0.33)
    return [a.astype(NP[cfg.dtype]) for a in
            (mass, rng.standard_normal(shape), rng.standard_normal(shape))]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(32, 32), (40, 24)])
def test_grid_update_matches_jax_pallas_grid_kernel(shape, dtype):
    """`_grid_update` against JAX's Pallas `_grid_kernel` (TPU kernel #20)
    in interpret mode on the lane-padded (Gy, 128) grids: bitwise at f64,
    within one rounding of the quotient at f32."""
    gx, gy = shape
    jc = jm.MPMConfig(gx=gx, gy=gy, dtype=dtype)
    tc = tm.MPMConfig(gx=gx, gy=gy, dtype=dtype)
    grids = grid_inputs(tc, seed=gx)
    padded = [np.pad(g, ((0, 0), (0, 128 - gx))) for g in grids]
    call = pl.pallas_call(
        functools.partial(mpm_pallas._grid_kernel, cfg=jc, Gx=gx, Gy=gy),
        out_shape=[jax.ShapeDtypeStruct((gy, 128), jc.jax_dtype)] * 2,
        interpret=True)
    ref = [np.asarray(r)[:, :gx] for r in call(*padded)]
    got = tm._grid_update(tc, *tens(*grids))
    for g, r in zip(got, ref):
        assert g.shape == (gy, gx)
        assert rel(g, r) <= (0.0 if dtype == "float64" else 1e-6), rel(g, r)
        assert (g.numpy()[grids[0] == 0] == 0).all()
    # the sticky bands: no outward velocity in the three wall nodes
    gu, gv = (g.numpy() for g in got)
    assert (gu[:, :3] >= 0).all() and (gu[:, -3:] <= 0).all()
    assert (gv[:3] >= 0).all() and (gv[-3:] <= 0).all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(32, 32), (40, 24)])
@pytest.mark.parametrize("material", MATS)
def test_grid_update_and_g2p_match_jax_scatter(material, shape, dtype):
    """Seeded grids handed to JAX's `_step_scatter` through its grid_reduce
    hook, and the same grids through the port's `_grid_update` and
    `_g2p`: pos, vel, F and Jp within 1e-12 (f64) / 1e-5 (f32), with
    particles on the walls (their out-of-grid nodes weigh 0)."""
    gx, gy = shape
    jc = jm.MPMConfig(n=3000, gx=gx, gy=gy, material=material, dtype=dtype)
    tc = tm.MPMConfig(n=3000, gx=gx, gy=gy, material=material, dtype=dtype)
    pos, vel, F, Jp = particles(tc, seed=gx * gy)
    assert reaches_past(tc, pos)
    grids = grid_inputs(tc, seed=gy)
    jg = [jnp.asarray(g) for g in grids]
    ref = jax.jit(lambda *a: jm._step_scatter(
        jc, jm.MPMState(*a), lambda _: tuple(jg)))(pos, vel, F, Jp)
    gu, gv = tm._grid_update(tc, *tens(*grids))
    got = tm._g2p(tc, *tens(pos, F, Jp), gu, gv)
    for name, g, r in zip(PARTS, got, ref):
        assert g.shape == np.asarray(r).shape and g.is_contiguous()
        assert rel(g, r) <= ONE_TOL[dtype], (name, rel(g, r))


@pytest.mark.parametrize("dtype,material", [
    ("float64", "mud"), ("float64", "snow"), ("float64", "sand"),
    ("float32", "snow")])
def test_scatter_steps_match_jax(dtype, material):
    """5 steps of the exact engine against JAX's scatter engine, step by
    step."""
    jc, tc, sj, st = both(n=2048, gx=32, gy=32, dtype=dtype,
                          material=material, engine="scatter")
    assert tc.engine == "scatter"
    stepj = jax.jit(lambda s: jm.step(jc, s))
    for _ in range(5):
        sj, st = stepj(sj), tm.step(tc, st)
        for name in PARTS:
            err = rel(getattr(st, name), getattr(sj, name))
            assert err <= STEP_TOL[dtype], (name, err)


@pytest.mark.parametrize("dtype,capacity", [
    ("float64", 0), ("float32", 0), ("float64", 3)])
def test_dense_steps_match_jax(dtype, capacity):
    """5 steps of the cell-dense engine against JAX's, at the auto capacity
    and at bin_capacity=3, where the block overflows its cells: the
    dropped particles keep their state in both, and overflow_count equals
    JAX's (engine='dense') before every step."""
    jc, tc, sj, st = both(n=2048, gx=24, gy=40, dtype=dtype, engine="dense",
                          bin_capacity=capacity)
    assert tc.engine == "dense"
    stepj = jax.jit(lambda s: jm.step(jc, s))
    for _ in range(5):
        over = int(tm.overflow_count(tc, st))
        assert over == int(jm.overflow_count(jc, sj))
        assert (over > 0) == (capacity == 3)
        sj, st = stepj(sj), tm.step(tc, st)
        for name in PARTS:
            err = rel(getattr(st, name), getattr(sj, name))
            assert err <= STEP_TOL[dtype], (name, err)
            assert getattr(st, name).is_contiguous()


@pytest.mark.parametrize("engine", ["scatter", "wrappers"])
@pytest.mark.parametrize("material", MATS)
def test_matches_loop_oracle_f64(material, engine):
    """tests/oracles/mpm_oracle.py at the JAX suite's setting (512
    particles, 32^2, 5 steps, < 1e-12), by the 'scatter' engine and by the
    'cuda' engine's step on the wrappers (their plain versions on CPU
    tensors)."""
    tc = tm.MPMConfig(n=512, gx=32, gy=32, material=material,
                      dtype="float64", engine="scatter")
    s = tm.init(tc, CPU)
    orc = MPMOracle(tc, *(getattr(s, f).numpy() for f in PARTS))
    step = (mk.make_step_cuda(tc) if engine == "wrappers"
            else lambda st: tm.step(tc, st))
    mk.reset_launches()
    for _ in range(5):
        s = step(s)
        orc.step()
    assert np.abs(s.pos.numpy() - orc.pos).max() < 1e-12
    assert np.abs(s.vel.numpy() - orc.vel).max() < 1e-12
    assert np.abs(s.F.numpy() - orc.F).max() < 1e-12
    assert np.abs(s.Jp.numpy() - orc.Jp).max() < 1e-12
    assert mk.LAUNCHES == {"p2g": 0, "g2p": 0}


def test_wrappers_match_jax_pallas_interpret():
    """The 'cuda' engine's step on the wrappers' plain versions against
    JAX's Pallas engine in interpret mode (n=4096 on 48^2, 3 f32 steps, as
    tests/test_flip_mpm.py runs it): no particle passes the Pallas
    engine's K slots here, so both are the same physics, within 5e-4
    relative."""
    jc, tc, sj, st = both(n=4096, gx=48, gy=48, engine="pallas")
    assert tc.engine == "cuda"
    assert int(jm.overflow_count(jc.replace(engine="dense"), sj)) == 0
    stepj = jax.jit(lambda s: jm.step(jc, s))
    step = mk.make_step_cuda(tc)
    for _ in range(3):
        sj, st = stepj(sj), step(st)
    for name in PARTS:
        err = rel(getattr(st, name), getattr(sj, name))
        assert err <= STEP_TOL["float32"], (name, err)


def test_in_the_box_after_a_step():
    """tests/test_flip_mpm.py's gate: finite, inside [2dx, (G-3)dx]."""
    cfg = tm.MPMConfig(n=2048)
    out = tm.step(cfg, tm.init(cfg, CPU))
    pos = out.pos.numpy()
    assert np.isfinite(pos).all()
    lo, hi = np.float32(2 * cfg.dx), np.float32((cfg.gx - 3) * cfg.dx)
    assert (pos >= lo).all() and (pos <= hi).all()


def test_materials_diverge():
    """tests/test_flip_mpm.py's gate, on the port's scatter engine."""
    outs = {}
    for m in MATS:
        cfg = tm.MPMConfig(n=1024, material=m, seed=5, engine="scatter")
        outs[m] = tm.run(cfg, tm.init(cfg, CPU), 150).pos.numpy()
        assert np.isfinite(outs[m]).all(), m
    assert np.abs(outs["mud"] - outs["snow"]).max() > 0
    assert np.abs(outs["snow"] - outs["sand"]).max() > 0


@pytest.mark.parametrize("engine,grid,steps", [("scatter", 96, 400),
                                               ("dense", 32, 100)])
def test_settles_under_gravity(engine, grid, steps):
    """tests/test_flip_mpm.py's gate (400 steps at 96^2; the dense engine,
    whose (G, G, K, 16) slab is slow on the CPU, 100 at 32^2): the block
    moves down, Jp in its clamp range, nothing dropped."""
    cfg = tm.MPMConfig(n=1024, gx=grid, gy=grid, seed=3, engine=engine)
    s = tm.init(cfg, CPU)
    out = tm.run(cfg, s, steps)
    assert out.pos[:, 1].mean() < s.pos[:, 1].mean()
    Jp = out.Jp.numpy()
    assert (Jp >= np.float32(0.05)).all() and (Jp <= 20.0).all()
    assert int(tm.overflow_count(cfg, out)) == 0


@pytest.mark.parametrize("engine", ["scatter", "dense", "wrappers"])
def test_grid_reduce_hook_sees_the_three_grids(engine):
    """The hook receives (mass, mom_x, mom_y), each (Gy, Gx), and what it
    returns is what the grid update reads: doubling mass and momentum
    leaves the step unchanged."""
    cfg = tm.MPMConfig(n=512, gx=24, gy=40, dtype="float64",
                       engine="dense" if engine == "dense" else "scatter")
    s = tm.init(cfg, CPU)
    seen = []

    def hook(grids):
        seen.append(grids)
        return tuple(g + g for g in grids)

    step = (mk.make_step_cuda(cfg) if engine == "wrappers"
            else functools.partial(tm.step, cfg))
    out = step(s, grid_reduce=hook)
    assert len(seen) == 1 and len(seen[0]) == 3
    assert all(g.shape == (40, 24) for g in seen[0])
    assert float(seen[0][0].sum()) == pytest.approx(512.0, rel=1e-12)
    ref = step(s)
    for a, b in zip(out, ref):
        assert torch.allclose(a, b, rtol=0, atol=1e-13)


def test_step_leaves_its_input_unchanged():
    cfg = tm.MPMConfig(n=512, gx=20, gy=20, engine="scatter",
                       material="mud")
    s = tm.step(cfg, tm.init(cfg, CPU))
    keep = [f.clone() for f in s]
    for step in (lambda st: tm.step(cfg, st), mk.make_step_cuda(cfg),
                 lambda st: tm.step(cfg.replace(engine="dense"), st)):
        step(s)
        for x, y in zip(s, keep):
            assert torch.equal(x, y)


def test_resolve_engine_and_overflow_count():
    cuda = torch.device("cuda")   # only its type is read
    for dt in ("float32", "float64"):
        for gx, gy in ((96, 96), (37, 53)):
            cfg = tm.MPMConfig(gx=gx, gy=gy, dtype=dt)
            assert tm.resolve_engine(cfg, cuda) == "cuda"
            assert tm.resolve_engine(cfg, CPU) == "dense"
    for eng in ("dense", "scatter"):
        cfg = tm.MPMConfig(engine=eng)
        assert tm.resolve_engine(cfg, cuda) == tm.resolve_engine(cfg, CPU) \
            == eng
    cfg = tm.MPMConfig(n=64, gx=16, gy=16, engine="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tm.resolve_engine(cfg, CPU)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tm.step(cfg, tm.init(cfg, CPU))
    # the overflow is counted by the resolved engine: 'auto' on the CPU
    # runs 'dense' and counts; 'scatter' drops nothing
    cfg = tm.MPMConfig(n=2048, gx=16, gy=16, bin_capacity=2)
    s = tm.init(cfg, CPU)
    assert int(tm.overflow_count(cfg, s)) > 0
    assert int(tm.overflow_count(cfg.replace(engine="scatter"), s)) == 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("material", MATS)
def test_wrappers_on_cpu_are_the_plain_versions_uncounted(material, dtype):
    cfg = tm.MPMConfig(n=1500, gx=19, gy=27, material=material, dtype=dtype)
    pos, vel, F, Jp = tens(*particles(cfg, seed=4))
    mk.reset_launches()
    grids = mk.p2g(cfg, pos, vel, F, Jp)
    for g, r in zip(grids, tm._p2g(cfg, pos, vel, F, Jp)):
        assert torch.equal(g, r)
    vels = mk.grid_update_plain(cfg, *grids)
    for g, r in zip(vels, tm._grid_update(cfg, *grids)):
        assert torch.equal(g, r)
    for g, r in zip(mk.g2p(cfg, pos, F, Jp, *grids),
                    tm._g2p(cfg, pos, F, Jp, *vels)):
        assert torch.equal(g, r)
    assert mk.LAUNCHES == {"p2g": 0, "g2p": 0}


def test_wrapper_checks():
    cfg = tm.MPMConfig(n=16, gx=16, gy=12)
    s = tm.init(cfg, CPU)
    assert mk._check_particles(s.pos, s.F, s.Jp, vel=s.vel) == 16
    mk._check_grids(cfg, s.pos, mass=torch.zeros(12, 16))     # accepted
    with pytest.raises(TypeError, match="vel is"):
        mk._check_particles(s.pos, s.F, s.Jp, vel=s.vel.double())
    with pytest.raises(ValueError, match=r"\(np, 2\)"):
        mk._check_particles(s.pos.reshape(-1), s.F, s.Jp)
    with pytest.raises(ValueError, match="F has shape"):
        mk._check_particles(s.pos, s.F[:, 0], s.Jp)
    with pytest.raises(ValueError, match="Jp has shape"):
        mk._check_particles(s.pos, s.F, s.Jp[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        mk._check_particles(s.pos, s.F.transpose(1, 2), s.Jp)
    with pytest.raises(TypeError, match="no kernel"):
        mk._check_particles(s.pos.half(), s.F, s.Jp)
    with pytest.raises(ValueError, match="shape"):
        mk._check_grids(cfg, s.pos, mass=torch.zeros(16, 12))
    meta = [f.to("meta") for f in s]
    with pytest.raises(ValueError, match="unsupported device"):
        mk.p2g(cfg, *meta)
    with pytest.raises(ValueError, match="mom_y on cpu"):
        mk._check_grids(cfg, meta[0], mom_y=torch.zeros(12, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        mk.g2p(cfg, meta[0], meta[2], meta[3],
               *(torch.zeros(12, 16, device="meta"),) * 3)


def test_kernel_constants_round_once_from_double():
    """The kernels' constants are JAX's Python-double expressions rounded
    to the dtype."""
    cfg = tm.MPMConfig(gx=37, gy=53, material="sand")
    c32, c64 = mk.consts(cfg, torch.float32), mk.consts(cfg, torch.float64)
    dx = 1.0 / 36
    assert (c32.gx, c32.gy, c32.material) == (37, 53, 2)
    assert c64.stress_c == -4.0 * (1 / dx) * (1 / dx) * 8e-5 * 1.0
    assert c32.stress_c == float(np.float32(c64.stress_c))
    assert c32.y_hi == float(np.float32(50.0 * dx))
    assert c64.fe_lo == 1.0 - 2.5e-2 and c64.c4 == 4.0 * (1 / dx)


def test_load_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path / "no-cuda")
    _build.load_library.cache_clear()
    mk.load.cache_clear()
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        mk.load()


def test_interop_round_trip_and_engine_map():
    jc, tc, sj, st = both(n=100, gx=16, gy=20, dtype="float64",
                          engine="scatter", material="sand",
                          bin_capacity=40)
    assert (tc.engine, tc.gx, tc.gy, tc.material, tc.bin_capacity,
            tc.capacity) == ("scatter", 16, 20, "sand", 40, 40)
    for engine, want in (("pallas", "cuda"), ("dense", "dense"),
                         ("scatter", "scatter"), ("auto", "auto")):
        assert interop.mpm_config_from_dict(
            jm.MPMConfig(engine=engine).asdict()).engine == want
    assert interop.mpm_config_from_dict(
        jm.MPMConfig().asdict()) == tm.MPMConfig()
    assert st.F.is_contiguous()
    back = interop.mpm_state_to_numpy(st)
    assert len(back) == 4
    for got, ref in zip(back, sj):
        np.testing.assert_array_equal(got, np.asarray(ref))
    with pytest.raises(ValueError, match=r"\(np, 2, 2\)"):
        interop.mpm_state_from_numpy(back[0], back[1], back[2][:, 0],
                                     back[3], dtype=torch.float64,
                                     device=CPU)


def test_init_defaults_to_gpu():
    cfg = tm.MPMConfig(n=16, gx=16, gy=16)
    if torch.cuda.is_available():
        assert tm.init(cfg).pos.is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tm.init(cfg)


@pytest.mark.parametrize("engine", ["scatter", "dense", "auto"])
def test_cli_mpm_cpu(capsys, engine):
    assert cli.main(["mpm", "--device", "cpu", "--engine", engine, "--n",
                     "256", "--gx", "32", "--gy", "24", "--material", "mud",
                     "--steps", "2"]) == 0
    out = capsys.readouterr().out
    ran = "dense" if engine == "auto" else engine
    assert f"mpm n=256 grid=32x24 mud float32 engine={ran}" in out
    assert "steps/s" in out and "M particle-steps/s" in out
    assert "mean y" in out
    assert "overflow: 0 particles beyond the cell capacity K=32" in out


def test_cli_mpm_engines_overflow_and_defaults(capsys):
    with pytest.raises(ValueError, match="CUDA tensors"):
        cli.main(["mpm", "--device", "cpu", "--engine", "cuda", "--n", "64",
                  "--gx", "16", "--gy", "16", "--steps", "1"])
    with pytest.raises(SystemExit):
        cli.main(["mpm", "--device", "cpu", "--engine", "pallas"])
    assert cli.main(["mpm", "--device", "cpu", "--engine", "dense", "--n",
                     "2048", "--gx", "16", "--gy", "16", "--bin-capacity",
                     "2", "--steps", "1", "--dtype", "float64"]) == 0
    captured = capsys.readouterr()
    dropped = int(captured.out.split("overflow: ")[1].split()[0])
    assert dropped > 0 and "WARNING" in captured.err
    args = cli.build_parser().parse_args(["mpm"])
    assert (args.n, args.gx, args.gy, args.dt, args.gravity, args.seed,
            args.material, args.engine, args.bin_capacity, args.steps,
            args.dtype, args.device) == (
        32768, 96, 96, 8e-5, 9.81, 2026, "snow", "auto", 0, 500, "float32",
        "cuda")
