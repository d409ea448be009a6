"""Port vs JAX: FLIP/APIC (solvers/flip_apic.py) and the plain versions of
its CUDA kernels (kernels/flip_cuda.py).

The same seeded numpy inputs, or the same initial state carried over by
interop, go through JAX's functions (jit) and the port's: float64 within
1e-12 (absolute, or relative to each grid's max where the values are
sums), float32 within 1e-5 for one transfer and 5e-4 relative for whole
steps (ROADMAP.md); the port against the float64 loop oracle within
1e-12.  JAX's Pallas engine runs in interpret mode, as
tests/test_flip_mpm.py runs it.  The 'cuda' engine's step composed from
the kernels' plain versions (the wrappers take them for CPU tensors) is
the 'scatter' engine, which chip_smoke.py holds the CUDA kernels to on
the card.
"""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from fluidsims_tpu.solvers import flip_apic as jf
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.kernels import _build
from fluidsims_tpu_torch.kernels import flip_cuda as fk
from fluidsims_tpu_torch.solvers import flip_apic as tf
from tests.oracles.flip_apic_oracle import FlipOracle

torch.set_num_threads(1)
CPU = torch.device("cpu")
PARTS = ("pos", "vel", "affine_x", "affine_y")
NP = {"float32": np.float32, "float64": np.float64}
STEP_TOL = {"float64": 1e-12, "float32": 5e-4}


def both(**kw):
    """(JAX config, port config, JAX init state, port state moved over by
    interop)."""
    jc = jf.FlipApicConfig(**kw)
    tc = interop.flip_config_from_dict(jc.asdict())
    sj = jf.init(jc)
    st = interop.flip_state_from_numpy(*(np.asarray(f) for f in sj),
                                       dtype=tc.torch_dtype, device=CPU)
    return jc, tc, sj, st


def rel(got, ref) -> float:
    """max |got - ref| / max(max |ref|, 1)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    return np.abs(got.astype(np.float64) - ref).max() / max(
        np.abs(ref).max(), 1.0)


def particles(n_p, dtype, seed, lo=0.01, hi=0.99):
    """Seeded (pos, vel, affine_x, affine_y) as numpy: positions uniform in
    [lo, hi]^2 with the first eight on the walls and corners, velocities
    and affine matrices standard normal."""
    rng = np.random.default_rng(seed)
    pos = lo + (hi - lo) * rng.random((n_p, 2))
    pos[:8] = [[lo, lo], [hi, hi], [lo, hi], [hi, lo], [lo, 0.5],
               [hi, 0.5], [0.5, lo], [0.5, hi]]
    out = [pos] + [rng.standard_normal((n_p, 2)) for _ in range(3)]
    return [a.astype(NP[dtype]) for a in out]


def tens(*arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n_p", [4096, 1000])
def test_init_matches_jax_bitwise(dtype, n_p):
    jc = jf.FlipApicConfig(particles=n_p, grid=32, dtype=dtype)
    tc = tf.FlipApicConfig(particles=n_p, grid=32, dtype=dtype)
    sj, st = jf.init(jc), tf.init(tc, CPU)
    for name in PARTS + ("density",):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(sj, name)))
    assert st.pos.dtype == tc.torch_dtype and st.pos.shape == (n_p, 2)
    assert st.density.dtype == torch.int32 and st.density.shape == (32, 32)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [32, 64])
def test_p2g_matches_jax(dtype, n):
    """Seeded particles in [0.01, 0.99] (below n = 101 the base node is 0
    for some, so offsets fold onto the wall), nonzero affine matrices,
    apic from the config and 0.3: each grid within 1e-12 (f64) / 1e-5
    (f32) relative to its max."""
    jc = jf.FlipApicConfig(particles=2048, grid=n, dtype=dtype)
    tc = tf.FlipApicConfig(particles=2048, grid=n, dtype=dtype)
    pos, vel, ax, ay = particles(2048, dtype, seed=n)
    assert (np.floor(pos * (n - 1)) == 0).any()
    for apic in (None, 0.3):
        ref = jax.jit(lambda *a: jf._p2g(jc, *a, apic=apic))(pos, vel, ax, ay)
        got = tf._p2g(tc, *tens(pos, vel, ax, ay), apic=apic)
        bar = 1e-12 if dtype == "float64" else 1e-5
        for g, r in zip(got, ref):
            assert g.shape == (n, n) and g.dtype == tc.torch_dtype
            assert rel(g, r) <= bar, rel(g, r)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [32, 64])
def test_grid_phase_matches_jax(dtype, n):
    """JAX's P2G grids of seeded particles through both grid phases (48
    sweeps and 5): f64 within 1e-12, f32 within 1e-5, relative to each
    output's max; the rings of u_proj and v_proj are 0."""
    pos, vel, ax, ay = particles(4 * n * n, dtype, seed=n + 1)
    for jac in (48, 5):
        jc = jf.FlipApicConfig(grid=n, jacobi=jac, dtype=dtype)
        tc = tf.FlipApicConfig(grid=n, jacobi=jac, dtype=dtype)
        grids = [np.asarray(g) for g in jax.jit(
            lambda *a: jf._p2g(jc, *a))(pos, vel, ax, ay)]
        ref = jax.jit(lambda *g: jf._grid_phase(jc, *g))(*grids)
        got = tf._grid_phase(tc, *tens(*grids))
        bar = 1e-12 if dtype == "float64" else 1e-5
        for g, r in zip(got, ref):
            assert rel(g, r) <= bar, (jac, rel(g, r))
        for g in got[2:]:
            ring = torch.cat([g[0], g[-1], g[:, 0], g[:, -1]])
            assert torch.count_nonzero(ring) == 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sample_matches_jax(dtype):
    """The bilinear sample at coordinates past both edges (-0.2 to 1.2),
    on seeded grids: f64 1e-13, f32 1e-6 (absolute, values in [-1, 1))."""
    n = 37
    rng = np.random.default_rng(3)
    u, v = (rng.uniform(-1, 1, (n, n)).astype(NP[dtype]) for _ in range(2))
    px, py = (rng.uniform(-0.2, 1.2, 4000).astype(NP[dtype])
              for _ in range(2))
    assert (px < 0).any() and (px > 1).any() and (py < 0).any()
    ref = jax.jit(lambda *a: jf._sample(*a, n))(u, v, px, py)
    got = tf._sample(*tens(u, v, px, py), n)
    bar = 1e-13 if dtype == "float64" else 1e-6
    for g, r in zip(got, ref):
        assert np.abs(g.numpy().astype(np.float64) - np.asarray(r)).max() \
            <= bar


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_scatter_step_and_run_match_jax(dtype):
    """One step and run(3) of the exact engine: f64 within 1e-12, f32
    within 5e-4 relative; the density rasters equal."""
    jc, tc, sj, st = both(particles=2048, grid=32, dtype=dtype,
                          engine="scatter")
    assert tc.engine == "scatter"
    for k, (rj, rt) in enumerate((
            (jax.jit(lambda s: jf.step(jc, s))(sj), tf.step(tc, st)),
            (jax.jit(lambda s: jf.run(jc, s, 3))(sj), tf.run(tc, st, 3)))):
        for name in PARTS:
            err = rel(getattr(rt, name), getattr(rj, name))
            assert err <= STEP_TOL[dtype], (k, name, err)
        np.testing.assert_array_equal(rt.density.numpy(),
                                      np.asarray(rj.density))
        assert int(rt.density.sum()) == 2048


@pytest.mark.parametrize("dtype,capacity,steps", [
    ("float64", 0, 3), ("float32", 0, 1), ("float64", 2, 2)])
def test_dense_step_matches_jax(dtype, capacity, steps):
    """The cell-dense engine against JAX's, at the auto capacity and at
    bin_capacity=2, where the clustered block overflows its cells: the
    dropped particles keep their state in both, and overflow_count equals
    JAX's (engine='dense') before every step."""
    jc, tc, sj, st = both(particles=2048, grid=24, dtype=dtype,
                          engine="dense", bin_capacity=capacity)
    assert tc.engine == "dense"
    stepj = jax.jit(lambda s: jf.step(jc, s))
    for _ in range(steps):
        over = int(tf.overflow_count(tc, st))
        assert over == int(jf.overflow_count(jc, sj))
        assert (over > 0) == (capacity == 2)
        sj, st = stepj(sj), tf.step(tc, st)
        for name in PARTS:
            err = rel(getattr(st, name), getattr(sj, name))
            assert err <= STEP_TOL[dtype], (name, err)
            assert getattr(st, name).is_contiguous()
        np.testing.assert_array_equal(st.density.numpy(),
                                      np.asarray(sj.density))


@pytest.mark.parametrize("engine", ["scatter", "wrappers"])
def test_matches_loop_oracle_f64(engine):
    """tests/oracles/flip_apic_oracle.py at the JAX suite's setting (1024
    particles, grid 32, jacobi 12, 5 steps, < 1e-12), by the 'scatter'
    engine and by the 'cuda' engine's step on the wrappers (their plain
    versions on CPU tensors); the density rasters equal."""
    tc = tf.FlipApicConfig(particles=1024, grid=32, jacobi=12,
                           dtype="float64", engine="scatter")
    s = tf.init(tc, CPU)
    orc = FlipOracle(tc, *(getattr(s, f).numpy() for f in PARTS))
    step = (fk.make_step_cuda(tc) if engine == "wrappers"
            else lambda st: tf.step(tc, st))
    fk.reset_launches()
    for _ in range(5):
        s = step(s)
        orc.step()
    assert np.abs(s.pos.numpy() - orc.pos).max() < 1e-12
    assert np.abs(s.vel.numpy() - orc.vel).max() < 1e-12
    np.testing.assert_array_equal(s.density.numpy(), orc.density)
    assert fk.LAUNCHES == {"p2g": 0, "grid": 0, "g2p": 0}


def test_wrappers_match_jax_pallas_interpret():
    """The 'cuda' engine's step on the wrappers' plain versions against
    JAX's Pallas engine in interpret mode (grid 128, 2048 particles, one
    f32 step): pos and vel within 1e-5; the rasters equal."""
    jc, tc, sj, st = both(particles=2048, engine="pallas")
    assert tc.engine == "cuda" and jc.grid == 128
    rj = jax.jit(lambda s: jf.step(jc, s))(sj)
    rt = fk.make_step_cuda(tc)(st)
    assert np.abs(rt.pos.numpy() - np.asarray(rj.pos)).max() <= 1e-5
    assert np.abs(rt.vel.numpy() - np.asarray(rj.vel)).max() <= 1e-5
    np.testing.assert_array_equal(rt.density.numpy(), np.asarray(rj.density))


@pytest.mark.parametrize("engine", ["scatter", "wrappers", "dense"])
def test_blend_overrides_equal_replaced_config(engine):
    """run(cfg, s, 2, flip=0.5, apic=0.3) is bitwise run(replace(cfg,
    flip=0.5, apic=0.3), s, 2) (tests/test_interactive.py's FLIP case):
    the wrappers take the factors as launch arguments, nothing
    reroutes."""
    cfg = tf.FlipApicConfig(particles=256, grid=24,
                            engine="dense" if engine == "dense"
                            else "scatter")
    s = tf.init(cfg, CPU)
    alt = replace(cfg, flip=0.5, apic=0.3)
    if engine == "wrappers":
        a = b = s
        for _ in range(2):
            a = fk.make_step_cuda(alt)(a)
            b = fk.make_step_cuda(cfg)(b, flip=0.5, apic=0.3)
    else:
        a = tf.run(alt, s, 2)
        b = tf.run(cfg, s, 2, flip=0.5, apic=0.3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.vel, tf.run(cfg, s, 2).vel)


def test_p2g_partition_of_unity_and_momentum():
    """tests/test_flip_mpm.py's gate: the hat weights sum to 1 a particle
    and, with zero affine matrices, grid momentum is particle momentum."""
    cfg = tf.FlipApicConfig(particles=2048, grid=64)
    s = tf.init(cfg, CPU)
    mass, u, v = fk.p2g(cfg, s.pos, s.vel, s.affine_x, s.affine_y)
    np.testing.assert_allclose(float(mass.sum()), cfg.particles, rtol=1e-4)
    np.testing.assert_allclose(float(u.sum()), float(s.vel[:, 0].sum()),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(v.sum()), float(s.vel[:, 1].sum()),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("engine", ["scatter", "dense"])
def test_runs_stable_and_counts_particles(engine):
    """tests/test_flip_mpm.py's gate: 40 steps finite, inside the walls,
    every particle counted once, the blob pulled down by gravity."""
    cfg = tf.FlipApicConfig(particles=4096, grid=64, engine=engine)
    s = tf.init(cfg, CPU)
    out = tf.run(cfg, s, 40)
    pos = out.pos.numpy()
    assert np.isfinite(pos).all()
    assert (pos >= 0.01 - 1e-6).all() and (pos <= 0.99 + 1e-6).all()
    assert int(out.density.sum()) == cfg.particles
    assert pos[:, 1].mean() < float(s.pos[:, 1].mean())
    assert int(tf.overflow_count(cfg, out)) == 0


def test_projection_does_not_blow_up():
    """tests/test_flip_mpm.py's gate: jacobi 80, one step then 20 more,
    velocities finite and below 50."""
    cfg = tf.FlipApicConfig(particles=8192, grid=64, jacobi=80,
                            engine="scatter")
    out = tf.run(cfg, tf.step(cfg, tf.init(cfg, CPU)), 20)
    v = out.vel.numpy()
    assert np.isfinite(v).all() and np.abs(v).max() < 50.0


def test_step_leaves_its_input_unchanged():
    cfg = tf.FlipApicConfig(particles=512, grid=20, engine="scatter")
    s = tf.step(cfg, tf.init(cfg, CPU))
    keep = [f.clone() for f in s]
    for step in (lambda st: tf.step(cfg, st), fk.make_step_cuda(cfg),
                 lambda st: tf.step(cfg.replace(engine="dense"), st)):
        step(s)
        for x, y in zip(s, keep):
            assert torch.equal(x, y)


def test_resolve_engine_and_overflow_count():
    cuda = torch.device("cuda")   # only its type is read
    for dt in ("float32", "float64"):
        for n in (128, 37):
            cfg = tf.FlipApicConfig(grid=n, dtype=dt)
            assert tf.resolve_engine(cfg, cuda) == "cuda"
            assert tf.resolve_engine(cfg, CPU) == "dense"
    for eng in ("dense", "scatter"):
        cfg = tf.FlipApicConfig(engine=eng)
        assert tf.resolve_engine(cfg, cuda) == tf.resolve_engine(cfg, CPU) \
            == eng
    cfg = tf.FlipApicConfig(particles=64, grid=16, engine="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tf.resolve_engine(cfg, CPU)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tf.step(cfg, tf.init(cfg, CPU))
    with pytest.raises(ValueError, match="engine"):
        tf.FlipApicConfig(engine="pallas")
    with pytest.raises(ValueError, match="grid"):
        tf.FlipApicConfig(grid=8)
    # the overflow is counted by the resolved engine: 'auto' on the CPU
    # runs 'dense' and counts; 'scatter' drops nothing
    cfg = tf.FlipApicConfig(particles=2048, grid=16, bin_capacity=2)
    s = tf.init(cfg, CPU)
    assert int(tf.overflow_count(cfg, s)) > 0
    assert int(tf.overflow_count(cfg.replace(engine="scatter"), s)) == 0
    assert tf.density_grid(s) is s.density


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_wrappers_on_cpu_are_the_plain_versions_uncounted(dtype):
    cfg = tf.FlipApicConfig(particles=1500, grid=19, dtype=dtype)
    pos, vel, ax, ay = tens(*particles(1500, dtype, seed=4, lo=0.0, hi=1.0))
    fk.reset_launches()
    for apic in (None, 0.3):
        for g, r in zip(fk.p2g(cfg, pos, vel, ax, ay, apic),
                        tf._p2g(cfg, pos, vel, ax, ay, apic)):
            assert torch.equal(g, r)
    grids = fk.p2g_plain(cfg, pos, vel, ax, ay)
    out = fk.grid_phase(cfg, *grids)
    for g, r in zip(out, fk.grid_phase_plain(cfg, *grids)):
        assert torch.equal(g, r)
    for flip in (None, 0.5):
        for g, r in zip(fk.g2p(cfg, pos, vel, *out, flip),
                        tf._g2p(cfg, pos, vel, *out, flip)):
            assert torch.equal(g, r)
    assert fk.LAUNCHES == {"p2g": 0, "grid": 0, "g2p": 0}


def test_wrapper_checks():
    cfg = tf.FlipApicConfig(particles=16, grid=16)
    s = tf.init(cfg, CPU)
    assert fk._check_particles(pos=s.pos, vel=s.vel) == 16     # accepted
    fk._check_grids(cfg, u=torch.zeros(16, 16))               # accepted
    with pytest.raises(TypeError, match="vel is"):
        fk._check_particles(pos=s.pos, vel=s.vel.double())
    with pytest.raises(ValueError, match=r"\(np, 2\)"):
        fk._check_particles(pos=s.pos.reshape(-1))
    with pytest.raises(ValueError, match="shape"):
        fk._check_particles(pos=s.pos, vel=s.vel[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        fk._check_particles(pos=s.pos, vel=s.vel.t().contiguous().t())
    with pytest.raises(TypeError, match="no kernel"):
        fk._check_particles(pos=s.pos.half())
    with pytest.raises(ValueError, match="shape"):
        fk._check_grids(cfg, u=torch.zeros(16, 15))
    meta = [f.to("meta") for f in s[:4]]
    with pytest.raises(ValueError, match="unsupported device"):
        fk.p2g(cfg, *meta)
    with pytest.raises(ValueError, match="unsupported device"):
        fk.grid_phase(cfg, *(torch.zeros(16, 16, device="meta"),) * 3)


def test_load_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path / "no-cuda")
    _build.load_library.cache_clear()
    fk.load.cache_clear()
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        fk.load()


def test_interop_round_trip_and_engine_map():
    jc, tc, sj, st = both(particles=100, grid=16, dtype="float64",
                          engine="scatter", jacobi=6, bin_capacity=40)
    assert (tc.engine, tc.jacobi, tc.grid, tc.bin_capacity, tc.capacity) \
        == ("scatter", 6, 16, 40, 40)
    for engine, want in (("pallas", "cuda"), ("dense", "dense"),
                         ("scatter", "scatter"), ("auto", "auto")):
        assert interop.flip_config_from_dict(
            jf.FlipApicConfig(engine=engine).asdict()).engine == want
    assert interop.flip_config_from_dict(
        jf.FlipApicConfig().asdict()) == tf.FlipApicConfig()
    back = interop.flip_state_to_numpy(st)
    assert len(back) == 5
    for got, ref in zip(back, sj):
        np.testing.assert_array_equal(got, np.asarray(ref))
    assert back[4].dtype == np.int32
    with pytest.raises(ValueError, match=r"\(np, 2\)"):
        interop.flip_state_from_numpy(back[0], back[1][:-1], *back[2:],
                                      dtype=torch.float64, device=CPU)


def test_init_defaults_to_gpu():
    cfg = tf.FlipApicConfig(particles=16, grid=16)
    if torch.cuda.is_available():
        assert tf.init(cfg).pos.is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tf.init(cfg)
