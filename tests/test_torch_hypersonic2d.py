"""Port vs JAX: the flagship 2-D hypersonic solver.

The same state (made with seeded numpy, or by the JAX package and carried
over with fluidsims_tpu_torch.interop) goes through the JAX function and its
port: the mask and init, the plain cell update against JAX's pad_bc +
step_core_padded (f64, 1e-12) and against the Pallas kernel as the JAX
tests run it (interpret mode, f32, 1e-5), whole steps against JAX
(f64, 1e-10) and against the float64 numpy oracle (f64 1e-10, f32 5e-4),
all with the |err| / max(|ref|, 1) scaling of tests/test_hypersonic2d.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.kernels import hypersonic2d_pallas as jhp
from fluidsims_tpu.ops.euler2d import Cons as JCons
from fluidsims_tpu.solvers import hypersonic2d as jh2
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.kernels import hypersonic2d_cuda as hk
from fluidsims_tpu_torch.ops.euler2d import Cons as TCons
from fluidsims_tpu_torch.solvers import hypersonic2d as th2
from tests.oracles import hypersonic2d_oracle as oracle

torch.set_num_threads(1)
CPU = torch.device("cpu")


def small_kw(nx=40, ny=20, dtype="float64"):
    return dict(nx=nx, ny=ny, geom_x0=nx / 8.0, geom_cy=ny / 2.0,
                geom_Rb=ny / 12.0, geom_Rn=ny / 24.0, dtype=dtype)


def as_np(U):
    return np.stack([np.asarray(f, np.float64) for f in U], axis=-1)


def t_np(U):
    return np.stack([f.numpy().astype(np.float64) for f in U], axis=-1)


def max_rel(got, ref, where=None):
    if where is not None:
        got, ref = got[where], ref[where]
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    return float((np.abs(got[fin] - ref[fin])
                  / np.maximum(np.abs(ref[fin]), 1.0)).max())


def perturbed(cfg_kw, seed=5):
    """JAX init + seeded noise in the fluid cells' primitives, as numpy."""
    s = jh2.init(jh2.Hypersonic2DConfig(**cfg_kw))
    rng = np.random.default_rng(seed)
    mask = np.asarray(s.mask)
    rho, mx, my, E = [np.asarray(f, np.float64) for f in s.U]
    g = 1.1
    u, v = mx / rho, my / rho
    p = (g - 1.0) * (E - 0.5 * rho * (u * u + v * v))
    rho = rho * (1 + 0.2 * rng.uniform(-1, 1, rho.shape))
    u = u + 3.0 * rng.standard_normal(rho.shape)
    v = v + 3.0 * rng.standard_normal(rho.shape)
    p = p * (1 + 0.2 * rng.uniform(-1, 1, rho.shape))
    ny, nx = rho.shape
    rho[ny // 5:ny // 5 + 2, nx // 3:nx // 3 + 3] = 1e-20   # near vacuum
    p[ny // 5:ny // 5 + 2, nx // 3:nx // 3 + 3] = 1e-24
    U = [rho, rho * u, rho * v, p / (g - 1.0) + 0.5 * rho * (u * u + v * v)]
    U = [np.where(mask, np.asarray(o, np.float64), n) for o, n in zip(s.U, U)]
    dt = np.dtype(cfg_kw["dtype"])
    return [f.astype(dt) for f in U], mask


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nx,ny", [(40, 20), (96, 48), (75, 31)])
def test_build_mask_equal(dtype, nx, ny):
    kw = small_kw(nx, ny, dtype)
    j = np.asarray(jh2.build_mask(jh2.Hypersonic2DConfig(**kw)))
    t = th2.build_mask(th2.Hypersonic2DConfig(**kw)).numpy()
    np.testing.assert_array_equal(j, t)
    assert t.any() and not t.all()


def test_default_config_mask_equal():
    j = np.asarray(jh2.build_mask(jh2.default_config(nx=256, ny=128)))
    t = th2.build_mask(th2.default_config(nx=256, ny=128)).numpy()
    np.testing.assert_array_equal(j, t)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_init_matches(dtype):
    kw = small_kw(64, 32, dtype)
    sj = jh2.init(jh2.Hypersonic2DConfig(**kw))
    st = th2.init(th2.Hypersonic2DConfig(**kw), CPU)
    np.testing.assert_allclose(t_np(st.U), as_np(sj.U), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    assert st.t.dtype == getattr(torch, dtype) and float(st.t) == 0.0


def test_plain_core_matches_jax_f64():
    kw = small_kw(48, 24, "float64")
    U, mask = perturbed(kw)
    jcfg, tcfg = jh2.Hypersonic2DConfig(**kw), th2.Hypersonic2DConfig(**kw)
    jU = JCons(*(jnp.asarray(f) for f in U))
    dt = jh2.compute_dt(jcfg, jU, jnp.asarray(mask))
    Up, Mp = jh2.pad_bc(jcfg, jU, jnp.asarray(mask))
    ref = jh2.step_core_padded(jcfg, Up, Mp, dt)
    st = interop.state_from_numpy(U, mask, 0.0, dtype=torch.float64, device=CPU)
    got = hk.step_core_plain(tcfg, st.U, st.mask,
                             torch.tensor(float(dt), dtype=torch.float64))
    assert max_rel(t_np(got), as_np(ref)) <= 1e-12
    # the padded state itself
    tUp, tMp = th2.pad_bc(tcfg, st.U, st.mask)
    np.testing.assert_array_equal(tMp.numpy(), np.asarray(Mp))
    np.testing.assert_array_equal(t_np(tUp), as_np(Up))


def test_wavespeed_and_dt_match_jax():
    kw = small_kw(48, 24, "float64")
    U, mask = perturbed(kw, seed=9)
    U[0][3, 7] = np.nan
    jcfg, tcfg = jh2.Hypersonic2DConfig(**kw), th2.Hypersonic2DConfig(**kw)
    jU = JCons(*(jnp.asarray(f) for f in U))
    st = interop.state_from_numpy(U, mask, 0.0, dtype=torch.float64, device=CPU)
    j = jh2.max_wavespeed(jcfg, jU, jnp.asarray(mask))
    t = th2.max_wavespeed(tcfg, st.U, st.mask)
    assert float(j) == float(t)
    assert float(jh2.compute_dt(jcfg, jU, jnp.asarray(mask))) == float(
        th2.compute_dt(tcfg, st.U, st.mask))


def test_plain_core_matches_pallas_interpret_f32():
    cfg_kw = dict(nx=64, ny=32)
    jcfg = jh2.default_config(**cfg_kw)
    tcfg = th2.default_config(**cfg_kw)
    U, mask = perturbed(jcfg.asdict() | {"dtype": "float32"}, seed=2)
    jU = JCons(*(jnp.asarray(f) for f in U))
    jm = jnp.asarray(mask)
    dt = jh2.compute_dt(jcfg, jU, jm)
    core = jhp.make_core_pallas(jcfg, band=8, interpret=True)
    ref = core(jU, jm, dt)
    st = interop.state_from_numpy(U, mask, 0.0, dtype=torch.float32, device=CPU)
    got = hk.step_core_plain(tcfg, st.U, st.mask,
                             torch.tensor(np.asarray(dt), dtype=torch.float32))
    assert max_rel(t_np(got), as_np(ref)) <= 1e-5


def test_steps_match_jax_f64():
    kw = small_kw(40, 20, "float64")
    jcfg, tcfg = jh2.Hypersonic2DConfig(**kw), th2.Hypersonic2DConfig(**kw)
    sj = jh2.init(jcfg)
    st = th2.init(tcfg, CPU)
    jstep = jax.jit(lambda s: jh2.step(jcfg, s))
    for _ in range(6):
        sj, st = jstep(sj), th2.step(tcfg, st)
    assert max_rel(t_np(st.U), as_np(sj.U)) <= 1e-10
    assert abs(float(st.t) - float(sj.t)) <= 1e-10 * abs(float(sj.t))


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-10), ("float32", 5e-4)])
def test_steps_match_oracle(dtype, tol):
    tcfg = th2.Hypersonic2DConfig(**small_kw(40, 20, dtype))
    s = th2.init(tcfg, CPU)
    oU, omask = oracle.init(oracle.Cfg(nx=40, ny=20))
    np.testing.assert_array_equal(s.mask.numpy(), omask)
    for _ in range(6):
        s = th2.step(tcfg, s)
        oU, _ = oracle.step(oracle.Cfg(nx=40, ny=20), oU, omask)
    assert max_rel(t_np(s.U), oU, where=~omask) <= tol


def test_interop_roundtrip_and_continue():
    kw = small_kw(40, 20, "float64")
    jcfg, tcfg = jh2.Hypersonic2DConfig(**kw), th2.Hypersonic2DConfig(**kw)
    jstep = jax.jit(lambda s: jh2.step(jcfg, s))
    sj = jh2.init(jcfg)
    for _ in range(3):
        sj = jstep(sj)
    st = interop.state_from_numpy([np.asarray(f) for f in sj.U],
                                  np.asarray(sj.mask), np.asarray(sj.t),
                                  dtype=torch.float64, device=CPU)
    U, m, t = interop.state_to_numpy(st)
    for a, b in zip(U, sj.U):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(m, np.asarray(sj.mask))
    assert float(t) == float(sj.t)
    for _ in range(3):
        sj, st = jstep(sj), th2.step(tcfg, st)
    assert max_rel(t_np(st.U), as_np(sj.U)) <= 1e-10
    with pytest.raises(ValueError):
        interop.state_from_numpy([np.zeros((3, 4))] * 3 + [np.zeros((3, 5))],
                                 np.zeros((3, 4), bool), 0.0,
                                 dtype=torch.float64, device=CPU)


def test_step_hooks_and_inplace_inflow():
    tcfg = th2.Hypersonic2DConfig(**small_kw(40, 20, "float64"))
    s = th2.init(tcfg, CPU)
    s.U.rho[:, 0] = 2.0               # the step restores the inflow column
    a = th2.step(tcfg, s)
    assert float(s.U.rho[~s.mask[:, 0], 0].max()) == 1.0   # in place
    b = th2.step(tcfg, s,
                 core=lambda U, m, dt: hk.step_core_plain(tcfg, U, m, dt),
                 wavespeed=lambda U, m: hk.inflow_wavespeed_plain(tcfg, U, m))
    for x, y in zip(a.U, b.U):
        assert torch.equal(x, y)      # idempotent inflow, same engine on CPU
    assert torch.equal(a.t, b.t)
    r = th2.run(tcfg, th2.init(tcfg, CPU), 2)
    assert float(r.t) > float(a.t) > 0.0
