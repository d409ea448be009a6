"""Port vs JAX: D2Q9 LBM (solvers/lbm.py, kernels/lbm_cuda.py).

The same initial state (bitwise equal: both packages form it with the same
numpy code) goes through the JAX solver and the port:

* the port's torch `step` (pull form, moments summed in the TPU kernels'
  explicit order) against the JAX XLA step: bitwise against eager JAX at
  f32 and f64, and against jitted JAX within 1e-6 (f32) / 1e-13 (f64, the
  oracle bar of tests/test_lbm.py:96), with and without a drive override;
* against the f64 push oracle (tests/oracles/lbm_oracle.py);
* with the top wall row removed, still equal to the JAX XLA step: rows
  outside [0, ny) are out of bounds (its `oob` rule), which the CUDA
  kernels keep too, where JAX's K-step Pallas kernel wraps;
* the kernels' plain versions (what chip_smoke.py holds the CUDA kernels
  to on the card) against JAX's interpreted Pallas kernels #5 and #6 as
  the JAX suite runs them, at its bars.

Off the GPU the wrappers take the plain versions and count no launch, and
the 'cuda' engine's run makes the n // K + n % K split of wrapper calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.kernels import lbm_pallas as jlp
from fluidsims_tpu.solvers import lbm as jl
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.core.config import ConfigError
from fluidsims_tpu_torch.kernels import lbm_cuda as lk
from fluidsims_tpu_torch.solvers import lbm as tl
from tests.oracles.lbm_oracle import LBMOracle

torch.set_num_threads(1)
CPU = torch.device("cpu")


def both(**kw):
    """(JAX config, port config from its asdict(), JAX init, port init)."""
    jc = jl.LBMConfig(**kw)
    tc = interop.lbm_config_from_dict(jc.asdict())
    return jc, tc, jl.init(jc), tl.init(tc, CPU)


def max_err(a, b):
    return float(np.abs(np.asarray(a.f, np.float64) - b.f.numpy()).max())


def open_top(sj, tc):
    """Both packages' states without the top wall row."""
    solid = np.asarray(sj.solid).copy()
    solid[-1] = False
    f = np.asarray(sj.f)
    return (jl.LBMState(f=jnp.asarray(f), solid=jnp.asarray(solid)),
            interop.lbm_state_from_numpy(f, solid, dtype=tc.torch_dtype,
                                         device=CPU))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kw", [dict(nx=48, ny=32),
                                dict(nx=64, ny=40, obstacle=False),
                                dict(nx=200, ny=75, obstacle_radius=8.0)])
def test_init_bitwise_and_interop(dtype, kw):
    _, tc, sj, st = both(dtype=dtype, **kw)
    np.testing.assert_array_equal(np.asarray(sj.f), st.f.numpy())
    assert np.asarray(sj.f).dtype == st.f.numpy().dtype
    np.testing.assert_array_equal(np.asarray(sj.solid), st.solid.numpy())
    assert st.solid.dtype == torch.bool
    np.testing.assert_array_equal(tl.build_solid(tc), jl.build_solid(tc))
    f, solid = interop.lbm_state_to_numpy(st)
    np.testing.assert_array_equal(f, np.asarray(sj.f))
    back = interop.lbm_state_from_numpy(f, solid.astype(np.uint8),
                                        dtype=tc.torch_dtype, device=CPU)
    assert torch.equal(back.f, st.f) and torch.equal(back.solid, st.solid)


@pytest.mark.parametrize("jax_engine, port_engine",
                         [("auto", "auto"), ("xla", "torch"),
                          ("pallas", "cuda")])
def test_config_fields_and_engine_map(jax_engine, port_engine):
    jc = jl.LBMConfig(nx=64, ny=32, drive=1e-4, block_k=4, engine=jax_engine)
    tc = interop.lbm_config_from_dict(jc.asdict())
    assert tc.engine == port_engine
    jf, tf = jc.asdict(), tc.asdict()
    jf.pop("engine"), tf.pop("engine")
    assert jf == tf


def test_interop_refuses_mismatched_shapes():
    with pytest.raises(ValueError):
        interop.lbm_state_from_numpy(np.zeros((9, 4, 5)), np.zeros((5, 4)),
                                     dtype=torch.float32, device=CPU)


DRIVES = [{}, {"drive": 3e-4}]


@pytest.mark.parametrize("over", DRIVES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kw", [dict(nx=48, ny=32, obstacle_radius=6.0),
                                dict(nx=33, ny=17, obstacle_radius=3.0)])
def test_step_bitwise_to_eager_jax(dtype, kw, over):
    jc, tc, a, b = both(dtype=dtype, drive=1e-4, **kw)
    for _ in range(6):
        a, b = jl.step(jc, a, **over), tl.step(tc, b, **over)
    np.testing.assert_array_equal(np.asarray(a.f), b.f.numpy())


@pytest.mark.parametrize("over", DRIVES)
@pytest.mark.parametrize("dtype, tol", [("float32", 1e-6),
                                        ("float64", 1e-13)])
def test_run_matches_jitted_xla(dtype, tol, over):
    jc, tc, sj, st = both(nx=48, ny=32, dtype=dtype, drive=1e-4,
                          obstacle_radius=6.0, engine="xla")
    a = jax.jit(lambda s: jl.run(jc, s, 8, **over))(sj)
    b = tl.run(tc, st, 8, **over)
    assert max_err(a, b) <= tol


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_open_top_row_matches_xla(dtype):
    """No wall at row ny-1: the upstream rows past the grid are out of
    bounds (bounce-back), not wrapped."""
    jc, tc, sj, _ = both(nx=40, ny=24, dtype=dtype, drive=1e-4,
                         obstacle_radius=4.0)
    a, b = open_top(sj, tc)
    for _ in range(6):
        a, b = jl.step(jc, a), tl.step(tc, b)
    np.testing.assert_array_equal(np.asarray(a.f), b.f.numpy())
    c = lk.run_kernels(tc.replace(block_k=4), open_top(sj, tc)[1], 6)
    assert torch.equal(c.f, b.f)


def test_matches_push_oracle_f64():
    jc, tc, sj, st = both(nx=48, ny=32, dtype="float64")
    orc = LBMOracle(jc, np.asarray(sj.f), np.asarray(sj.solid))
    for _ in range(5):
        st = tl.step(tc, st)
        orc.step()
    assert np.abs(st.f.numpy() - orc.f).max() < 1e-13


def test_mass_conserved_without_drive():
    _, tc, _, st = both(nx=64, ny=32, drive=0.0)
    m0 = float(st.f.double().sum())
    m1 = float(tl.run(tc, st, 50).f.double().sum())
    np.testing.assert_allclose(m1, m0, rtol=1e-5)


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-7),
                                        ("float64", 1e-15)])
def test_observables_match_jax(dtype, tol):
    jc, tc, sj, st = both(nx=48, ny=32, dtype=dtype, drive=1e-4,
                          obstacle_radius=6.0)
    sj, st = jl.step(jc, sj), tl.step(tc, st)
    for a, b in zip(jl.macroscopic(sj.f), tl.macroscopic(st.f)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=tol)
    np.testing.assert_allclose(np.asarray(jl.speed_field(jc, sj)),
                               tl.speed_field(tc, st).numpy(), rtol=0,
                               atol=tol)


def test_step_plain_matches_pallas_one_step_interpret():
    """Kernel #5's plain version against make_step_pallas(band=8) in
    interpret mode, at tests/test_pallas_kernels.py's bars."""
    jc, tc, sj, st = both(nx=64, ny=32, drive=1e-4)
    step_p = jlp.make_step_pallas(jc, band=8, interpret=True)
    a, b = sj, st
    for _ in range(5):
        a, b = step_p(a), lk.lbm_step_plain(tc, b)
    np.testing.assert_allclose(np.asarray(a.f), b.f.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n, over", [(19, {}), (8, {"drive": 3e-4})])
def test_run_kernels_plain_matches_pallas_multistep_interpret(n, over):
    """The 'cuda' engine's run on CPU tensors (plain versions of #5 and #6)
    against run_multistep(k=8, band=16) in interpret mode at 5e-6, as
    tests/test_lbm.py runs it (obstacle and walls, a remainder, a drive
    override)."""
    jc, tc, sj, st = both(nx=128, ny=64, drive=1e-4, obstacle_radius=8.0,
                          block_k=8)
    a = jlp.run_multistep(jc, sj, n, k=8, band=16, interpret=True, **over)
    b = lk.run_kernels(tc, st, n, **over)
    np.testing.assert_allclose(np.asarray(a.f), b.f.numpy(), atol=5e-6)


def test_multistep_plain_exact_boundary():
    """One k=4 superstep at the creep boundary (band=16) against the K-step
    plain version at 1e-6."""
    jc, tc, sj, st = both(nx=128, ny=64, drive=1e-4)
    a = jlp.make_multistep_pallas(jc, k=4, band=16, interpret=True)(sj)
    b = lk.lbm_multistep_plain(tc, st, 4)
    np.testing.assert_allclose(np.asarray(a.f), b.f.numpy(), atol=1e-6)


def test_resolve_engine():
    cfg = tl.LBMConfig(nx=32, ny=32)
    assert tl.resolve_engine(cfg, CPU) == "torch"
    assert tl.resolve_engine(cfg, "cuda") == "cuda"
    assert tl.resolve_engine(cfg.replace(engine="torch"), "cuda") == "torch"
    assert tl.resolve_engine(cfg.replace(block_k=lk.MAX_BLOCK_K), "cuda") \
        == "cuda"
    with pytest.raises(ValueError, match="CUDA tensors"):
        tl.resolve_engine(cfg.replace(engine="cuda"), CPU)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tl.run(cfg.replace(engine="cuda"), tl.init(cfg, CPU), 1)
    with pytest.raises(ValueError, match="block_k"):
        tl.resolve_engine(cfg.replace(block_k=lk.MAX_BLOCK_K + 1), "cuda")
    with pytest.raises(ConfigError):
        tl.LBMConfig(block_k=0)
    with pytest.raises(ConfigError):
        tl.LBMConfig(engine="xla")
    with pytest.raises(ValueError):
        lk.lbm_multistep(cfg, tl.init(cfg, CPU), 0)


@pytest.mark.parametrize("n, k, want", [(23, 8, (2, 7)), (16, 8, (2, 0)),
                                        (5, 8, (0, 5)), (6, 1, (0, 6))])
def test_run_kernels_split(monkeypatch, n, k, want):
    calls = {"multistep": 0, "step": 0}

    def counted(name, fn):
        def f(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return f

    monkeypatch.setattr(lk, "lbm_multistep",
                        counted("multistep", lk.lbm_multistep))
    monkeypatch.setattr(lk, "lbm_step", counted("step", lk.lbm_step))
    cfg = tl.LBMConfig(nx=24, ny=16, obstacle_radius=3.0, block_k=k)
    s = tl.init(cfg, CPU)
    out = lk.run_kernels(cfg, s, n)
    assert (calls["multistep"], calls["step"]) == want
    assert torch.equal(out.f, tl.run(cfg, s, n).f)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cpu_tensors_take_plain_version_uncounted(dtype):
    cfg = tl.LBMConfig(nx=24, ny=16, obstacle_radius=3.0, dtype=dtype)
    s = tl.init(cfg, CPU)
    lk.reset_launches()
    a = lk.lbm_step(cfg, s, drive=2e-4)
    b = lk.lbm_multistep(cfg, s, 3)
    assert lk.LAUNCHES == {"step": 0, "multistep": 0}
    assert torch.equal(a.f, tl.step(cfg, s, drive=2e-4).f)
    assert torch.equal(b.f, tl.run(cfg, s, 3).f)


def test_params_are_the_python_constants():
    cfg = tl.LBMConfig(tau=0.7, drive=2e-6)
    p = lk._params(cfg, 6, lk._drive(cfg, None))
    assert (p.ny, p.nx, p.k) == (cfg.ny, cfg.nx, 6)
    assert (p.omega, p.drive) == (1.0 / 0.7, 2e-6)
    assert list(p.w) == [float(w) for w in jl.W]
    assert lk._drive(cfg, torch.tensor(3e-4, dtype=torch.float64)) == 3e-4


def test_init_defaults_to_gpu():
    cfg = tl.LBMConfig(nx=16, ny=16)
    if torch.cuda.is_available():
        assert tl.init(cfg).f.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tl.init(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            interop.lbm_state_from_numpy(np.zeros((9, 2, 2)),
                                         np.zeros((2, 2)),
                                         dtype=torch.float32)
