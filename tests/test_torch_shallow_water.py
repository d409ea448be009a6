"""Port vs JAX: shallow water (solvers/shallow_water.py and
kernels/shallow_water_cuda.py).

The same initial state (bitwise equal: both packages draw it with the same
numpy code) goes through the JAX solver and the port:

* the port's torch `step` against JAX's jitted XLA step, with and without
  viscosity: 1e-12 at f64 over 4 steps, 5e-4 relative at f32;
* against the f64 loop oracle (tests/oracles/shallow_water_oracle.py) at
  1e-12;
* the kernel's plain version and the 'cuda' engine's run on CPU tensors
  against JAX's interpreted Pallas kernel #7 (the shallow-water
  instantiation) at the JAX suite's bars;
* the physics gates: mass at 1e-12 (f64), positivity and wave spread, the
  standing-wave dispersion relation.
"""

import math

import jax
import numpy as np
import pytest
import torch

from fluidsims_tpu.kernels import sw_resident_pallas as jsp
from fluidsims_tpu.solvers import shallow_water as jsw
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.core.config import ConfigError
from fluidsims_tpu_torch.kernels import shallow_water_cuda as swk
from fluidsims_tpu_torch.solvers import shallow_water as tsw
from tests.oracles.shallow_water_oracle import SWOracle
from tests.oracles.tiled_step import kernel_tile, tiled_step_fields

torch.set_num_threads(1)
CPU = torch.device("cpu")


def both(**kw):
    """(JAX config, port config from its asdict(), JAX init, port init)."""
    jc = jsw.ShallowWaterConfig(**kw)
    tc = interop.sw_config_from_dict(jc.asdict())
    return jc, tc, jsw.init(jc), tsw.init(tc, CPU)


def to_torch(s, dtype):
    return interop.sw_state_from_numpy(*(np.asarray(f) for f in s),
                                       dtype=dtype, device=CPU)


def rel_err(js, ts):
    return max(float(np.abs(np.asarray(a, np.float64) - b.numpy()).max())
               / max(float(np.abs(np.asarray(a)).max()), 1.0)
               for a, b in zip(js, ts))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nx, ny", [(40, 28), (13, 7)])
def test_init_bitwise_and_interop(dtype, nx, ny):
    _, tc, sj, st = both(nx=nx, ny=ny, dtype=dtype)
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype
    for a, b in zip(sj, interop.sw_state_to_numpy(st)):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = to_torch(sj, tc.torch_dtype)
    assert all(torch.equal(a, b) for a, b in zip(back, st))


@pytest.mark.parametrize("jax_engine, port_engine",
                         [("auto", "auto"), ("xla", "torch"),
                          ("pallas", "cuda")])
def test_config_fields_and_engine_map(jax_engine, port_engine):
    jc = jsw.ShallowWaterConfig(nx=40, ny=24, nu=0.01, f0=2.0, block_k=4,
                                engine=jax_engine)
    tc = interop.sw_config_from_dict(jc.asdict())
    assert tc.engine == port_engine
    jf, tf = jc.asdict(), tc.asdict()
    jf.pop("engine"), tf.pop("engine")
    assert jf == tf


def test_interop_refuses_mismatched_fields():
    with pytest.raises(ValueError):
        interop.sw_state_from_numpy(np.zeros((4, 5)), np.zeros((4, 5)),
                                    np.zeros((5, 4)), 1.0, 0.0,
                                    dtype=torch.float32, device=CPU)


@pytest.mark.parametrize("nu", [0.0, 0.01])
@pytest.mark.parametrize("dtype, tol", [("float64", 1e-12),
                                        ("float32", 5e-4)])
def test_step_matches_jitted_xla(nu, dtype, tol):
    jc, tc, a, b = both(nx=40, ny=28, dtype=dtype, nu=nu, dtau=1e-3,
                        offx=0.0, offy=0.0, bump_amp=5.0, bump_sigma=5.0)
    step = jax.jit(lambda s: jsw.step(jc, s))
    for _ in range(4):
        a, b = step(a), tsw.step(tc, b)
    assert rel_err(a, b) <= tol


def test_matches_loop_oracle_f64():
    jc, tc, sj, st = both(nx=40, ny=28, dtype="float64")
    orc = SWOracle(jc, np.asarray(sj.sigma), np.asarray(sj.u),
                   np.asarray(sj.v), float(sj.t), float(sj.tau))
    for _ in range(4):
        st = tsw.step(tc, st)
        orc.step()
    assert np.abs(st.sigma.numpy() - orc.sigma).max() < 1e-12
    assert np.abs(st.u.numpy() - orc.u).max() < 1e-12
    assert np.abs(st.v.numpy() - orc.v).max() < 1e-12
    np.testing.assert_allclose(float(st.t), orc.t, rtol=1e-12)


def test_run_kernels_plain_matches_pallas_interpret():
    """The 'cuda' engine's run on CPU tensors (the kernel's plain version)
    against run_multistep(k=4) of TPU kernel #7 in interpret mode, at
    tests/test_burgers_sw_stam.py's bars: sigma atol 1e-6, u rtol 1e-5 /
    atol 1e-6, t and tau 1e-6."""
    jc, tc, sj, st = both(nx=128, ny=96, dtau=1e-3, block_k=4)
    a = jsp.run_multistep(jc, sj, 11, k=4, interpret=True)
    b = swk.run_kernels(tc, st, 11)
    np.testing.assert_allclose(b.sigma.numpy(), np.asarray(a.sigma),
                               atol=1e-6)
    for x, y in ((a.u, b.u), (a.v, b.v)):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5,
                                   atol=1e-6)
    for x, y in ((a.t, b.t), (a.tau, b.tau)):
        np.testing.assert_allclose(float(y), float(x), rtol=1e-6)


def test_mass_conserved_f64():
    _, tc, _, st = both(nx=64, ny=64, dtau=1e-4, nu=0.0, dtype="float64")
    m0 = float(tsw.depth(st).sum())
    out = tsw.run(tc, st, 50)
    np.testing.assert_allclose(float(tsw.depth(out).sum()), m0, rtol=1e-12)


def test_positivity_and_wave_spread():
    _, tc, _, st = both(nx=96, ny=96, bump_amp=50.0, offx=0.0, offy=0.0,
                        asym=0.0, swirl=0.0, dtau=1e-3)
    out = tsw.run(tc, st, 100)
    h, h0 = tsw.depth(out).numpy(), tsw.depth(st).numpy()
    assert (h > 0).all()
    c = (tc.ny // 2, tc.nx // 2)
    assert abs(h[c] - tc.H0) < abs(h0[c] - tc.H0)


def test_standing_wave_dispersion():
    """h = H0 + eps cos(kx) oscillates at omega = k sqrt(g H0); with the
    CFL-locked dt the zero crossings of the mode amplitude pin the period
    in steps (tests/test_burgers_sw_stam.py:267-301)."""
    cfg = tsw.ShallowWaterConfig(nx=128, ny=8, H0=100.0, nu=0.0,
                                 bump_amp=0.0, swirl=0.0, dtau=1e9)
    s0 = tsw.init(cfg, CPU)
    eps, k = 0.01, 2 * math.pi * 2 / 128.0
    x = np.arange(128.0)
    h = 100.0 + eps * np.cos(k * x)[None, :] * np.ones((8, 1))
    s = s0._replace(sigma=torch.tensor(np.log(h), dtype=torch.float32),
                    u=torch.zeros(8, 128), v=torch.zeros(8, 128))
    c = math.sqrt(9.81 * 100.0)
    expected = 2 * math.pi / (k * c) / (0.5 / c)
    cosk = torch.tensor(np.cos(k * x), dtype=torch.float32)
    amps = []
    for _ in range(200):
        amps.append(float(((torch.exp(s.sigma)[0] - 100.0) * cosk).mean()))
        s = tsw.run(cfg, s, 1)
    zc = np.where(np.diff(np.sign(amps)) != 0)[0]
    assert len(zc) >= 2
    assert abs(2 * (zc[1] - zc[0]) - expected) <= 3


def test_f0_is_not_applied():
    _, tc, _, st = both(nx=24, ny=20)
    a = tsw.step(tc, st)
    b = tsw.step(tc.replace(f0=7.0), st)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_resolve_engine():
    cfg = tsw.ShallowWaterConfig(nx=32, ny=32)
    assert tsw.resolve_engine(cfg, CPU) == "torch"
    assert tsw.resolve_engine(cfg, "cuda") == "cuda"
    assert tsw.resolve_engine(cfg.replace(engine="torch"), "cuda") == "torch"
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsw.resolve_engine(cfg.replace(engine="cuda"), CPU)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsw.run(cfg.replace(engine="cuda"), tsw.init(cfg, CPU), 1)
    with pytest.raises(ValueError, match="block_k"):
        tsw.resolve_engine(cfg.replace(block_k=swk.MAX_BLOCK_K + 1), "cuda")
    with pytest.raises(ConfigError):
        tsw.ShallowWaterConfig(engine="xla")
    with pytest.raises(ValueError):
        swk.sw_multistep(cfg, tsw.init(cfg, CPU), swk.MAX_BLOCK_K + 1)


@pytest.mark.parametrize("n, k, want", [(23, 8, (2, 7)), (16, 8, (2, 0)),
                                        (5, 8, (0, 5)), (7, 1, (0, 7))])
def test_run_kernels_split(monkeypatch, n, k, want):
    calls = {"k": 0, "one": 0}
    orig = swk.sw_multistep

    def counted(cfg, s, kk):
        calls["k" if kk > 1 else "one"] += 1
        return orig(cfg, s, kk)

    monkeypatch.setattr(swk, "sw_multistep", counted)
    cfg = tsw.ShallowWaterConfig(nx=20, ny=16, block_k=k, dtau=1e-3)
    s = tsw.init(cfg, CPU)
    out = swk.run_kernels(cfg, s, n)
    assert (calls["k"], calls["one"]) == want
    ref = tsw.run(cfg, s, n)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cpu_tensors_take_plain_version_uncounted(dtype):
    cfg = tsw.ShallowWaterConfig(nx=24, ny=20, dtype=dtype)
    s = tsw.init(cfg, CPU)
    swk.reset_launches()
    out = swk.sw_multistep(cfg, s, 3)
    assert swk.LAUNCHES == {"step": 0, "multistep": 0}
    assert all(torch.equal(x, y) for x, y in zip(out, tsw.run(cfg, s, 3)))


def test_wrapper_checks():
    cfg = tsw.ShallowWaterConfig(nx=24, ny=20)
    s = tsw.init(cfg, CPU)
    swk._check(cfg, s)
    with pytest.raises(TypeError):
        swk._check(cfg, s._replace(u=s.u.double()))
    with pytest.raises(ValueError, match="shape"):
        swk._check(cfg, s._replace(v=s.v[1:]))
    with pytest.raises(ValueError, match="shape"):
        swk._check(cfg, s._replace(tau=s.tau.reshape(1, 1)))


def test_params_are_the_python_constants():
    cfg = tsw.ShallowWaterConfig(dx=0.5, dy=2.0, g=9.0, cfl=0.4, dtau=0.3,
                                 nu=0.02)
    p = swk._params(cfg, 5)
    assert (p.ny, p.nx, p.k, p.visc) == (cfg.ny, cfg.nx, 5, 1)
    assert (p.g, p.half_g, p.cfl_min, p.dtau) == (9.0, 4.5, 0.4 * 0.5, 0.3)
    assert (p.inv_dx, p.inv_dy, p.inv_dx2, p.inv_dy2, p.nu) == (
        2.0, 0.5, 4.0, 0.25, 0.02)
    assert swk._params(cfg.replace(nu=0.0), 1).visc == 0
    assert (swk.halo(cfg), swk.halo(cfg.replace(nu=0.0))) == (2, 1)


def noisy(cfg, seed):
    s = tsw.init(cfg, CPU)
    rng = np.random.default_rng(seed)
    return s._replace(**{f: getattr(s, f) + torch.tensor(
        amp * rng.standard_normal((cfg.ny, cfg.nx)), dtype=s.u.dtype)
        for f, amp in (("sigma", 1e-3), ("u", 0.5), ("v", 0.5))})


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nu", [0.01, 0.0])
@pytest.mark.parametrize("nx, ny", [(40, 28), (5, 3), (1, 1)])
def test_tiled_step_model_is_bitwise_the_step(dtype, nu, nx, ny):
    """The kernel's tiling (its tile clipped to the grid; swk.halo: 1 for
    the HLL faces on both sides of a cell, plus 1 for the viscosity when
    nu > 0), modelled in torch, is bitwise the plain step:
    on a ragged 40x28 grid, on 5x3 and 1x1 (narrower than the halo:
    windows wrap onto the tile)."""
    cfg = tsw.ShallowWaterConfig(nx=nx, ny=ny, dtype=dtype, nu=nu,
                                 dtau=1e-3)
    assert swk.halo(cfg) == (2 if nu > 0 else 1)
    s = noisy(cfg, nx * ny)
    for _ in range(2):
        ref = tsw.step(cfg, s)
        got = tiled_step_fields(tsw.step_fields, cfg, (s.sigma, s.u, s.v),
                                s.t, kernel_tile(nx, ny), swk.halo(cfg))
        assert all(torch.equal(a, b) for a, b in zip(got, ref[:3]))
        s = ref


@pytest.mark.parametrize("nu", [0.01, 0.0])
def test_tiled_step_model_needs_the_full_halo(nu):
    """One cell less of halo and the model is no longer the step: the
    test above can see a wrong halo."""
    cfg = tsw.ShallowWaterConfig(nx=40, ny=28, dtype="float64", nu=nu,
                                 dtau=1e-3)
    s = noisy(cfg, 1)
    ref = tsw.step(cfg, s)
    got = tiled_step_fields(tsw.step_fields, cfg, (s.sigma, s.u, s.v), s.t,
                            kernel_tile(cfg.nx, cfg.ny), swk.halo(cfg) - 1)
    assert not all(torch.equal(a, b) for a, b in zip(got, ref[:3]))


def test_init_defaults_to_gpu():
    cfg = tsw.ShallowWaterConfig(nx=16, ny=16)
    if torch.cuda.is_available():
        assert tsw.init(cfg).sigma.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tsw.init(cfg)
