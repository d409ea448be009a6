"""Port vs JAX: Gray–Scott (solvers/gray_scott.py and
kernels/gray_scott_cuda.py).

The same initial state (bitwise equal: both packages draw it with the same
numpy code) goes through the JAX solver and the port:

* the port's torch `step` against the JAX XLA step: bitwise against eager
  JAX at f32 and f64 (the same operations in the same order), and against
  jitted JAX within 1e-6 (f32) / 1e-13 (f64, the oracle bar of
  tests/test_gray_scott.py:89), with and without feed/kill overrides;
* against the f64 loop oracle (tests/oracles/gray_scott_oracle.py);
* the kernels' plain versions (what chip_smoke.py holds the CUDA kernels
  to on the card) against JAX's interpreted Pallas kernels #3 and #4 as
  the JAX suite runs them, at its bars.

Off the GPU the wrappers take the plain versions and count no launch, and
the 'cuda' engine's run makes the n // K + n % K split of wrapper calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.kernels import gray_scott_pallas as jgp
from fluidsims_tpu.solvers import gray_scott as jgs
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.core.config import ConfigError
from fluidsims_tpu_torch.kernels import gray_scott_cuda as gk
from fluidsims_tpu_torch.solvers import gray_scott as tgs
from tests.oracles.gray_scott_oracle import GrayScottOracle

torch.set_num_threads(1)
CPU = torch.device("cpu")


def both(**kw):
    """(JAX config, port config from its asdict(), JAX init, port init)."""
    jc = jgs.GrayScottConfig(**kw)
    tc = interop.gs_config_from_dict(jc.asdict())
    return jc, tc, jgs.init(jc), tgs.init(tc, CPU)


def to_torch(s, dtype):
    return interop.gs_state_from_numpy(*(np.asarray(f) for f in s),
                                       dtype=dtype, device=CPU)


def max_err(js, ts):
    return max(float(np.abs(np.asarray(a, np.float64) - b.numpy()).max())
               for a, b in zip(js, ts))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nx, ny", [(64, 48), (75, 200), (13, 7)])
def test_init_bitwise_and_interop(dtype, nx, ny):
    _, tc, sj, st = both(nx=nx, ny=ny, dtype=dtype, seed=nx)
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype
    for a, b in zip(sj, interop.gs_state_to_numpy(st)):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = to_torch(sj, tc.torch_dtype)
    assert all(torch.equal(a, b) for a, b in zip(back, st))


@pytest.mark.parametrize("jax_engine, port_engine",
                         [("auto", "auto"), ("xla", "torch"),
                          ("pallas", "cuda")])
def test_config_fields_and_engine_map(jax_engine, port_engine):
    jc = jgs.GrayScottConfig(nx=40, ny=24, feed=0.04, block_k=8,
                             engine=jax_engine)
    tc = interop.gs_config_from_dict(jc.asdict())
    assert tc.engine == port_engine
    jf, tf = jc.asdict(), tc.asdict()
    jf.pop("engine"), tf.pop("engine")
    assert jf == tf


def test_interop_refuses_mismatched_fields():
    with pytest.raises(ValueError):
        interop.gs_state_from_numpy(np.zeros((4, 5)), np.zeros((5, 4)),
                                    dtype=torch.float32, device=CPU)


OVERRIDES = [{}, {"feed": 0.04, "kill": 0.058}]


@pytest.mark.parametrize("over", OVERRIDES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nx, ny", [(40, 24), (75, 33)])
def test_step_bitwise_to_eager_jax(dtype, nx, ny, over):
    jc, tc, a, b = both(nx=nx, ny=ny, dtype=dtype)
    for _ in range(8):
        a, b = jgs.step(jc, a, **over), tgs.step(tc, b, **over)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("over", OVERRIDES)
@pytest.mark.parametrize("dtype, tol", [("float32", 1e-6),
                                        ("float64", 1e-13)])
def test_run_matches_jitted_xla(dtype, tol, over):
    jc, tc, sj, st = both(nx=48, ny=40, dtype=dtype, engine="xla")
    a = jax.jit(lambda s: jgs.run(jc, s, 10, **over))(sj)
    b = tgs.run(tc, st, 10, **over)
    assert max_err(a, b) <= tol


def test_tensor_overrides_sum_in_their_dtype():
    """0-d f32 tensor overrides: feed + kill rounds in f32, as JAX's f32
    scalars do; Python numbers sum in double (f32(0.03 + 0.06) is
    0.0900000036, f32(0.03) + f32(0.06) is 0.0899999961)."""
    jc, tc, a, b = both(nx=32, ny=24)
    fj, kj = jnp.float32(0.03), jnp.float32(0.06)
    ft, kt = torch.tensor(0.03), torch.tensor(0.06)
    for _ in range(5):
        a, b = jgs.step(jc, a, feed=fj, kill=kj), tgs.step(tc, b, feed=ft,
                                                         kill=kt)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    assert gk._scalars(tc, ft, kt) == (float(ft), float(ft + kt))
    assert gk._scalars(tc, 0.03, 0.06) == (0.03, 0.03 + 0.06)
    assert float(ft + kt) != float(np.float32(0.03 + 0.06))


def test_matches_loop_oracle_f64():
    jc, tc, sj, st = both(nx=32, ny=24, dtype="float64")
    orc = GrayScottOracle(jc, np.asarray(sj.u), np.asarray(sj.v))
    for _ in range(5):
        st = tgs.step(tc, st)
        orc.step()
    np.testing.assert_allclose(st.u.numpy(), orc.u, atol=1e-13)
    np.testing.assert_allclose(st.v.numpy(), orc.v, atol=1e-13)


def test_step_plain_matches_pallas_one_step_interpret():
    """Kernel #3's plain version against make_step_pallas(band=8) in
    interpret mode, at tests/test_pallas_kernels.py's bars."""
    jc, tc, sj, st = both(nx=48, ny=32)
    step_p = jgp.make_step_pallas(jc, band=8, interpret=True)
    a, b = sj, st
    for _ in range(10):
        a, b = step_p(a), gk.gs_step_plain(tc, b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), y.numpy(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("n, over", [(23, {}),
                                     (16, {"feed": 0.04, "kill": 0.058})])
def test_run_kernels_plain_matches_pallas_multistep_interpret(n, over):
    """The 'cuda' engine's run on CPU tensors (plain versions of #3 and #4)
    against run_multistep(k=8, band=16) in interpret mode at 5e-6, as
    tests/test_gray_scott.py runs it."""
    jc, tc, sj, st = both(nx=128, ny=64, feed=0.0367, kill=0.0649,
                          block_k=8)
    a = jgp.run_multistep(jc, sj, n, k=8, band=16, interpret=True, **over)
    b = gk.run_kernels(tc, st, n, **over)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), y.numpy(), atol=5e-6)


def test_multistep_plain_exact_boundary():
    """One k=2 superstep at the creep boundary (band=16) against the K-step
    plain version at 1e-6."""
    jc, tc, sj, st = both(nx=128, ny=64, feed=0.0367, kill=0.0649)
    a = jgp.make_multistep_pallas(jc, k=2, band=16, interpret=True)(sj)
    b = gk.gs_multistep_plain(tc, st, 2)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), y.numpy(), atol=1e-6)


def test_resolve_engine():
    cfg = tgs.GrayScottConfig(nx=32, ny=32)
    assert tgs.resolve_engine(cfg, CPU) == "torch"
    assert tgs.resolve_engine(cfg, "cuda") == "cuda"
    assert tgs.resolve_engine(cfg.replace(engine="torch"), "cuda") == "torch"
    assert tgs.resolve_engine(cfg.replace(block_k=gk.MAX_BLOCK_K), "cuda") \
        == "cuda"
    with pytest.raises(ValueError, match="CUDA tensors"):
        tgs.resolve_engine(cfg.replace(engine="cuda"), CPU)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tgs.run(cfg.replace(engine="cuda"), tgs.init(cfg, CPU), 1)
    with pytest.raises(ValueError, match="block_k"):
        tgs.resolve_engine(cfg.replace(block_k=gk.MAX_BLOCK_K + 1), "cuda")
    with pytest.raises(ConfigError):
        tgs.GrayScottConfig(block_k=0)
    with pytest.raises(ConfigError):
        tgs.GrayScottConfig(engine="pallas")
    with pytest.raises(ValueError):
        gk.gs_multistep(cfg, tgs.init(cfg, CPU), gk.MAX_BLOCK_K + 1)


@pytest.mark.parametrize("n, k, want", [(23, 8, (2, 7)), (32, 16, (2, 0)),
                                        (5, 16, (0, 5)), (7, 1, (0, 7))])
def test_run_kernels_split(monkeypatch, n, k, want):
    calls = {"multistep": 0, "step": 0}

    def counted(name, fn):
        def f(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return f

    monkeypatch.setattr(gk, "gs_multistep",
                        counted("multistep", gk.gs_multistep))
    monkeypatch.setattr(gk, "gs_step", counted("step", gk.gs_step))
    cfg = tgs.GrayScottConfig(nx=20, ny=16, block_k=k)
    s = tgs.init(cfg, CPU)
    out = gk.run_kernels(cfg, s, n)
    assert (calls["multistep"], calls["step"]) == want
    ref = tgs.run(cfg, s, n)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cpu_tensors_take_plain_version_uncounted(dtype):
    cfg = tgs.GrayScottConfig(nx=24, ny=20, dtype=dtype)
    s = tgs.init(cfg, CPU)
    gk.reset_launches()
    a = gk.gs_step(cfg, s, feed=0.04)
    b = gk.gs_multistep(cfg, s, 3)
    assert gk.LAUNCHES == {"step": 0, "multistep": 0}
    assert all(torch.equal(x, y) for x, y in
               zip(a, tgs.step(cfg, s, feed=0.04)))
    assert all(torch.equal(x, y) for x, y in zip(b, tgs.run(cfg, s, 3)))


def test_params_are_the_python_constants():
    cfg = tgs.GrayScottConfig(dx=0.5, Du=0.21, Dv=0.11, dt=0.9)
    p = gk._params(cfg, 5, gk._scalars(cfg, None, None))
    assert (p.ny, p.nx, p.k) == (cfg.ny, cfg.nx, 5)
    assert (p.inv_dx2, p.Du, p.Dv, p.dt) == (4.0, 0.21, 0.11, 0.9)
    assert (p.feed, p.fk) == (cfg.feed, cfg.feed + cfg.kill)


def test_init_defaults_to_gpu():
    cfg = tgs.GrayScottConfig(nx=16, ny=16)
    if torch.cuda.is_available():
        assert tgs.init(cfg).u.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tgs.init(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            interop.gs_state_from_numpy(np.zeros((2, 2)), np.zeros((2, 2)),
                                        dtype=torch.float32)
