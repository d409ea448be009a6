"""Port vs JAX: GLM-MHD (solvers/mhd.py and kernels/mhd_cuda.py).

The same initial state (bitwise equal: both packages build it with the same
numpy code and the same prim_to_cons) goes through the JAX solver and the
port:

* the port's torch `step` against JAX's jitted XLA step, Brio–Wu and
  Orszag–Tang, both flux signs: 1e-12 at f64 over 4 steps, 5e-4 relative
  at f32;
* against the f64 loop oracle (tests/oracles/mhd_oracle.py) at 1e-12;
* the kernel's plain version and the 'cuda' engine's run on CPU tensors
  against JAX's interpreted Pallas kernel #8 at the JAX suite's bar
  (max |err| / max |ref| < 5e-5 a field, t equal);
* the flux pieces (cons_to_prim, fast_speed, glm_flux, hlld_glm_flux) and
  view_field against JAX's, and the physics gates at small size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.kernels import mhd_resident_pallas as jmp
from fluidsims_tpu.solvers import mhd as jm
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.core.config import ConfigError
from fluidsims_tpu_torch.kernels import mhd_cuda as mk
from fluidsims_tpu_torch.solvers import mhd as tm
from tests.oracles.mhd_oracle import MHDOracle

torch.set_num_threads(1)
CPU = torch.device("cpu")
CASES = [("briowu", False), ("briowu", True), ("orszag-tang", False),
         ("orszag-tang", True)]


def both(**kw):
    """(JAX config, port config from its asdict(), JAX init, port init)."""
    jc = jm.MHDConfig(**kw)
    tc = interop.mhd_config_from_dict(jc.asdict())
    return jc, tc, jm.init(jc), tm.init(tc, CPU)


def flat(s):
    return [*s.U, s.t]


def rel_err(js, ts):
    return max(float(np.abs(np.asarray(a, np.float64) - b.numpy()).max())
               / max(float(np.abs(np.asarray(a)).max()), 1.0)
               for a, b in zip(flat(js), flat(ts)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("problem", ["briowu", "orszag-tang"])
def test_init_bitwise_and_interop(dtype, problem):
    _, tc, sj, st = both(nx=40, ny=28, dtype=dtype, problem=problem)
    for a, b in zip(flat(sj), flat(st)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype
    U, t = interop.mhd_state_to_numpy(st)
    for a, b in zip(sj.U, U):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = interop.mhd_state_from_numpy([np.asarray(f) for f in sj.U],
                                        np.asarray(sj.t),
                                        dtype=tc.torch_dtype, device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(flat(back), flat(st)))


@pytest.mark.parametrize("jax_engine, port_engine",
                         [("auto", "auto"), ("xla", "torch"),
                          ("pallas", "cuda")])
def test_config_fields_and_engine_map(jax_engine, port_engine):
    jc = jm.MHDConfig(nx=40, ny=24, stable_hll=True, problem="orszag-tang",
                      block_k=4, engine=jax_engine)
    tc = interop.mhd_config_from_dict(jc.asdict())
    assert tc.engine == port_engine
    jf, tf = jc.asdict(), tc.asdict()
    jf.pop("engine"), tf.pop("engine")
    assert jf == tf


def test_interop_refuses_bad_fields():
    with pytest.raises(ValueError):
        interop.mhd_state_from_numpy([np.zeros((4, 5))] * 6, 0.0,
                                     dtype=torch.float32, device=CPU)
    with pytest.raises(ValueError):
        interop.mhd_state_from_numpy([np.zeros((4, 5))] * 6
                                     + [np.zeros((5, 4))], 0.0,
                                     dtype=torch.float32, device=CPU)


def test_flux_pieces_match_jax_f64():
    """cons_to_prim, fast_speed, glm_flux and both hlld_glm_flux signs on
    seeded random states, against JAX's eager functions to 1e-14 (an ulp
    or two where XLA rounds a fused expression otherwise)."""
    rng = np.random.default_rng(7)
    shape = (6, 9)
    prim = [rng.uniform(0.2, 2.0, shape), rng.normal(size=shape),
            rng.normal(size=shape), rng.uniform(0.1, 1.5, shape),
            rng.normal(size=shape), rng.normal(size=shape),
            0.1 * rng.normal(size=shape)]
    qj = jm.PrimM(*(jnp.asarray(x) for x in prim))
    qt = tm.PrimM(*(torch.tensor(x) for x in prim))
    Uj, Ut = jm.prim_to_cons(qj, 1.4), tm.prim_to_cons(qt, 1.4)
    Uj2 = jm.ConsM(*(jnp.roll(f, 1, 1) for f in Uj))
    Ut2 = tm.ConsM(*(torch.roll(f, 1, 1) for f in Ut))
    chj, cht = jnp.asarray(0.7), torch.tensor(0.7, dtype=torch.float64)

    def eq(a, b):
        for x, y in zip(a, b):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-14,
                                       atol=1e-14)

    eq(Uj, Ut)
    eq(jm.cons_to_prim(Uj, 1.4), tm.cons_to_prim(Ut, 1.4))
    for xdir in (True, False):
        eq([jm.fast_speed(jm.cons_to_prim(Uj, 1.4), 1.4, xdir)],
           [tm.fast_speed(tm.cons_to_prim(Ut, 1.4), 1.4, xdir)])
        eq(jm.glm_flux(Uj, 1.4, chj, xdir), tm.glm_flux(Ut, 1.4, cht, xdir))
        for stable in (False, True):
            eq(jm.hlld_glm_flux(Uj, Uj2, 1.4, chj, xdir, stable),
               tm.hlld_glm_flux(Ut, Ut2, 1.4, cht, xdir, stable))


def test_glm_flux_consistency():
    """With ch = 0 and equal states the HLL flux is the physical flux."""
    q = tm.PrimM(*(torch.tensor(x, dtype=torch.float64) for x in
                   (1.0, 0.3, -0.2, 0.8, 0.4, -0.1, 0.0)))
    U = tm.prim_to_cons(q, 1.4)
    ch = torch.tensor(0.0, dtype=torch.float64)
    for xdir in (True, False):
        for a, b in zip(tm.hlld_glm_flux(U, U, 1.4, ch, xdir),
                        tm.glm_flux(U, 1.4, ch, xdir)):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-10,
                                       atol=1e-12)


@pytest.mark.parametrize("problem, stable", CASES)
@pytest.mark.parametrize("dtype, tol", [("float64", 1e-12),
                                        ("float32", 5e-4)])
def test_step_matches_jitted_xla(problem, stable, dtype, tol):
    jc, tc, a, b = both(nx=40, ny=28, dtype=dtype, problem=problem,
                        stable_hll=stable)
    step = jax.jit(lambda s: jm.step(jc, s))
    for _ in range(4):
        a, b = step(a), tm.step(tc, b)
    assert rel_err(a, b) <= tol


def test_matches_loop_oracle_f64():
    jc, tc, sj, st = both(nx=32, ny=24, problem="briowu", dtype="float64")
    orc = MHDOracle(jc, tuple(np.asarray(f) for f in sj.U), float(sj.t))
    for _ in range(4):
        st = tm.step(tc, st)
        orc.step()
    got = np.stack([f.numpy() for f in st.U], -1)
    assert np.abs(got - orc.U).max() < 1e-12
    np.testing.assert_allclose(float(st.t), orc.t, rtol=1e-12)


@pytest.mark.parametrize("problem", ["briowu", "orszag-tang"])
def test_run_kernels_plain_matches_pallas_interpret(problem):
    """The 'cuda' engine's run on CPU tensors (the kernel's plain version)
    against run_multistep(k=4) of TPU kernel #8 in interpret mode at
    tests/test_mhd_stam3d.py:292-310's bar."""
    jc, tc, sj, st = both(nx=40, ny=28, problem=problem, block_k=4)
    a = jmp.run_multistep(jc, sj, 10, k=4, interpret=True)
    b = mk.run_kernels(tc, st, 10)
    assert float(a.t) == float(b.t)
    for name, x, y in zip(tm.FIELDS, a.U, b.U):
        x = np.asarray(x)
        d = np.abs(x - y.numpy()).max() / max(np.abs(x).max(), 1e-3)
        assert d < 5e-5, (name, d)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_view_field_matches_jax(mode):
    jc, tc, sj, st = both(nx=40, ny=28, problem="orszag-tang",
                          dtype="float64")
    sj, st = jm.step(jc, sj), tm.step(tc, st)
    np.testing.assert_allclose(tm.view_field(tc, st, mode).numpy(),
                               np.asarray(jm.view_field(jc, sj, mode)),
                               rtol=1e-13, atol=1e-13)


def test_default_face_masks_match_jax():
    for a, b in zip(jm.default_face_masks(11, 7),
                    tm.default_face_masks(11, 7)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_mass_nearly_conserved_stable_mode():
    _, tc, _, st = both(nx=48, ny=32, dtype="float64", stable_hll=True)
    m0 = float(st.U.rho.sum())
    out = tm.run(tc, st, 20)
    assert abs(float(out.U.rho.sum()) - m0) / m0 < 1e-3


def test_briowu_shocks_form():
    _, tc, _, st = both(nx=128, ny=16, problem="briowu")
    out = tm.run(tc, st, 100)
    rho = tm.cons_to_prim(out.U, tc.gamma).rho.numpy()
    assert np.isfinite(rho).all() and rho.min() > 0
    mid = rho[8, tc.nx // 2 - 10: tc.nx // 2 + 10]
    assert ((mid > 0.14) & (mid < 0.99)).any()
    assert float(out.t) > 0


def test_resolve_engine():
    cfg = tm.MHDConfig(nx=32, ny=32)
    assert tm.resolve_engine(cfg, CPU) == "torch"
    assert tm.resolve_engine(cfg, "cuda") == "cuda"
    assert tm.resolve_engine(cfg.replace(dtype="float64"), "cuda") == "cuda"
    with pytest.raises(ValueError, match="CUDA tensors"):
        tm.resolve_engine(cfg.replace(engine="cuda"), CPU)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tm.run(cfg.replace(engine="cuda"), tm.init(cfg, CPU), 1)
    with pytest.raises(ValueError, match="block_k"):
        tm.resolve_engine(cfg.replace(block_k=mk.MAX_BLOCK_K + 1), "cuda")
    with pytest.raises(ConfigError):
        tm.MHDConfig(problem="otv")
    with pytest.raises(ValueError):
        mk.mhd_multistep(cfg, tm.init(cfg, CPU), 0)


@pytest.mark.parametrize("n, k, want", [(23, 8, (2, 7)), (16, 8, (2, 0)),
                                        (5, 8, (0, 5)), (7, 1, (0, 7))])
def test_run_kernels_split(monkeypatch, n, k, want):
    calls = {"k": 0, "one": 0}
    orig = mk.mhd_multistep

    def counted(cfg, s, kk):
        calls["k" if kk > 1 else "one"] += 1
        return orig(cfg, s, kk)

    monkeypatch.setattr(mk, "mhd_multistep", counted)
    cfg = tm.MHDConfig(nx=20, ny=16, block_k=k)
    s = tm.init(cfg, CPU)
    out = mk.run_kernels(cfg, s, n)
    assert (calls["k"], calls["one"]) == want
    ref = tm.run(cfg, s, n)
    assert all(torch.equal(a, b) for a, b in zip(flat(out), flat(ref)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cpu_tensors_take_plain_version_uncounted(dtype):
    cfg = tm.MHDConfig(nx=24, ny=20, dtype=dtype)
    s = tm.init(cfg, CPU)
    mk.reset_launches()
    out = mk.mhd_multistep(cfg, s, 3)
    assert mk.LAUNCHES == {"step": 0, "multistep": 0}
    assert all(torch.equal(x, y) for x, y in
               zip(flat(out), flat(tm.run(cfg, s, 3))))


def test_wrapper_checks():
    cfg = tm.MHDConfig(nx=24, ny=20)
    s = tm.init(cfg, CPU)
    mk._check(cfg, s)
    with pytest.raises(TypeError):
        mk._check(cfg, s._replace(U=s.U._replace(E=s.U.E.double())))
    with pytest.raises(ValueError, match="shape"):
        mk._check(cfg, s._replace(U=s.U._replace(psi=s.U.psi[:, 1:])))
    with pytest.raises(ValueError, match="shape"):
        mk._check(cfg, s._replace(t=s.t.reshape(1)))


def test_params_are_the_python_constants():
    cfg = tm.MHDConfig(nx=40, ny=20, gamma=5 / 3, cfl=0.3, stable_hll=True)
    p = mk._params(cfg, 6)
    assert (p.ny, p.nx, p.k, p.stable) == (20, 40, 6, 1)
    assert (p.gamma, p.gm1) == (5 / 3, 5 / 3 - 1.0)
    assert (p.dx, p.dy, p.min_dxdy) == (1 / 40, 1 / 20, 1 / 40)
    assert (p.cfl_min, p.neg_alpha) == (0.3 * (1 / 40), -tm.GLM_ALPHA)


def test_init_defaults_to_gpu():
    cfg = tm.MHDConfig(nx=16, ny=16)
    if torch.cuda.is_available():
        assert tm.init(cfg).t.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tm.init(cfg)
