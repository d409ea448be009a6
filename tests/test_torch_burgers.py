"""Port vs JAX: Burgers (solvers/burgers.py and kernels/burgers_cuda.py).

The same initial state (bitwise equal: both packages draw it with the same
numpy code) goes through the JAX solver and the port:

* the port's torch `step` against JAX's jitted XLA step: 1e-12 at f64 over
  4 steps, 5e-4 relative at f32 (sinh/asinh differ by ulps between the two
  libraries), plain, MUSCL, two viscosity substeps and Cole–Hopf (1-D);
* against the f64 loop oracle (tests/oracles/burgers_oracle.py) at 1e-12;
* the kernel's plain version and the 'cuda' engine's run on CPU tensors
  (what chip_smoke.py holds the CUDA kernel to) against JAX's interpreted
  Pallas kernel #7 (the Burgers instantiation) at the JAX suite's bars;
* the physics gates: the Cole–Hopf error and viscous decay.

Off the GPU the wrapper takes the plain version and counts no launch, and
the 'cuda' engine's run makes the n // K + n % K split of wrapper calls.
"""

import jax
import numpy as np
import pytest
import torch

from fluidsims_tpu.kernels import burgers_resident_pallas as jbp
from fluidsims_tpu.solvers import burgers as jbg
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.core.config import ConfigError
from fluidsims_tpu_torch.kernels import burgers_cuda as bk
from fluidsims_tpu_torch.solvers import burgers as tbg
from tests.oracles.burgers_oracle import BurgersOracle
from tests.oracles.tiled_step import kernel_tile, tiled_step_fields

torch.set_num_threads(1)
CPU = torch.device("cpu")

OPTS = {"plain": {}, "muscl": {"muscl": True},
        "visc2": {"visc_substeps": 2},
        "colehopf": {"colehopf": True, "ny": 1, "nx": 64, "dtau": 1e-3}}


def both(**kw):
    """(JAX config, port config from its asdict(), JAX init, port init)."""
    jc = jbg.BurgersConfig(**kw)
    tc = interop.burgers_config_from_dict(jc.asdict())
    return jc, tc, jbg.init(jc), tbg.init(tc, CPU)


def to_torch(s, dtype):
    return interop.burgers_state_from_numpy(*(np.asarray(f) for f in s),
                                            dtype=dtype, device=CPU)


def rel_err(js, ts):
    """max over fields of max |err| / max(max |ref|, 1)."""
    return max(float(np.abs(np.asarray(a, np.float64) - b.numpy()).max())
               / max(float(np.abs(np.asarray(a)).max()), 1.0)
               for a, b in zip(js, ts))


def small(opt, **kw):
    return dict(dict(nx=40, ny=28, dtau=1e-2), **OPTS[opt], **kw)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("opt", ["plain", "colehopf"])
def test_init_bitwise_and_interop(dtype, opt):
    _, tc, sj, st = both(**small(opt, dtype=dtype))
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype
    for a, b in zip(sj, interop.burgers_state_to_numpy(st)):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = to_torch(sj, tc.torch_dtype)
    assert all(torch.equal(a, b) for a, b in zip(back, st))


@pytest.mark.parametrize("jax_engine, port_engine",
                         [("auto", "auto"), ("xla", "torch"),
                          ("pallas", "cuda")])
def test_config_fields_and_engine_map(jax_engine, port_engine):
    jc = jbg.BurgersConfig(nx=40, ny=24, muscl=True, block_k=8,
                           engine=jax_engine)
    tc = interop.burgers_config_from_dict(jc.asdict())
    assert tc.engine == port_engine
    jf, tf = jc.asdict(), tc.asdict()
    jf.pop("engine"), tf.pop("engine")
    assert jf == tf


def test_interop_refuses_mismatched_fields():
    with pytest.raises(ValueError):
        interop.burgers_state_from_numpy(np.zeros((4, 5)), np.zeros((5, 4)),
                                         1.0, 0.0, dtype=torch.float32,
                                         device=CPU)


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("dtype, tol", [("float64", 1e-12),
                                        ("float32", 5e-4)])
def test_step_matches_jitted_xla(opt, dtype, tol):
    jc, tc, a, b = both(**small(opt, dtype=dtype))
    step = jax.jit(lambda s: jbg.step(jc, s))
    for _ in range(4):
        a, b = step(a), tbg.step(tc, b)
    assert rel_err(a, b) <= tol


@pytest.mark.parametrize("muscl", [False, True])
def test_matches_loop_oracle_f64(muscl):
    jc, tc, sj, st = both(nx=32, ny=24, muscl=muscl, visc_substeps=2,
                          dtype="float64")
    orc = BurgersOracle(jc, np.asarray(sj.phi_u), np.asarray(sj.phi_v),
                        float(sj.t), float(sj.tau))
    for _ in range(4):
        st = tbg.step(tc, st)
        orc.step()
    assert np.abs(st.phi_u.numpy() - orc.pu).max() < 1e-12
    assert np.abs(st.phi_v.numpy() - orc.pv).max() < 1e-12
    np.testing.assert_allclose(float(st.t), orc.t, rtol=1e-12)


def test_run_kernels_plain_matches_pallas_interpret():
    """The 'cuda' engine's run on CPU tensors (the kernel's plain version)
    against run_multistep(k=4) of TPU kernel #7 in interpret mode, at
    tests/test_burgers_sw_stam.py's bars: rtol 1e-4 / atol 1e-5 (an ulp
    can flip a Rusanov upwind select), t and tau at 1e-6."""
    jc, tc, sj, st = both(nx=128, ny=96, dtau=1e-2, block_k=4)
    a = jbp.run_multistep(jc, sj, 11, k=4, interpret=True)
    b = bk.run_kernels(tc, st, 11)
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-4,
                                   atol=1e-5)
    for x, y in zip(a[2:], b[2:]):
        np.testing.assert_allclose(float(y), float(x), rtol=1e-6)


def test_multistep_plain_is_k_steps():
    _, tc, _, st = both(nx=24, ny=20, muscl=True)
    a = bk.burgers_multistep_plain(tc, st, 3)
    b = tbg.step(tc, tbg.step(tc, tbg.step(tc, st)))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_colehopf_analytic_error_small():
    """The reference's convergence-against-truth gate at f64."""
    _, tc, _, st = both(nx=256, ny=1, colehopf=True, nu=0.1, ck=4, ca=0.5,
                        dtau=1e-3, t0=1.0, cfl=0.45, dtype="float64")
    u0 = tbg.velocities(tc, st)[0].numpy()[0]
    np.testing.assert_allclose(u0, tbg.cole_hopf_exact(tc, 0.0), rtol=1e-10)
    out = tbg.run(tc, st, 200)
    assert tbg.cole_hopf_rel_l2(tc, out) < 0.05


def test_2d_decays_and_finite():
    _, tc, _, st = both(nx=64, ny=64, nu=0.05, dtau=1e-3, swirl=5.0)
    u0, v0 = tbg.velocities(tc, st)
    e0 = float((u0.double() ** 2 + v0.double() ** 2).sum())
    out = tbg.run(tc, st, 100)
    u1, v1 = tbg.velocities(tc, out)
    e1 = float((u1.double() ** 2 + v1.double() ** 2).sum())
    assert np.isfinite(e1) and e1 < e0
    assert float(out.tau) > 0


def test_resolve_engine():
    cfg = tbg.BurgersConfig(nx=32, ny=32)
    assert tbg.resolve_engine(cfg, CPU) == "torch"
    assert tbg.resolve_engine(cfg, "cuda") == "cuda"
    assert tbg.resolve_engine(cfg.replace(engine="torch"), "cuda") == "torch"
    assert tbg.resolve_engine(cfg.replace(colehopf=True, ny=1), "cuda") \
        == "cuda"
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbg.resolve_engine(cfg.replace(engine="cuda"), CPU)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbg.run(cfg.replace(engine="cuda"), tbg.init(cfg, CPU), 1)
    with pytest.raises(ValueError, match="block_k"):
        tbg.resolve_engine(cfg.replace(block_k=bk.MAX_BLOCK_K + 1), "cuda")
    with pytest.raises(ConfigError):
        tbg.BurgersConfig(engine="pallas")
    with pytest.raises(ConfigError):
        tbg.BurgersConfig(visc_substeps=0)
    with pytest.raises(ValueError):
        bk.burgers_multistep(cfg, tbg.init(cfg, CPU), 0)


@pytest.mark.parametrize("n, k, want", [(23, 8, (2, 7)), (32, 16, (2, 0)),
                                        (5, 16, (0, 5)), (7, 1, (0, 7))])
def test_run_kernels_split(monkeypatch, n, k, want):
    calls = {"k": 0, "one": 0}
    orig = bk.burgers_multistep

    def counted(cfg, s, kk):
        calls["k" if kk > 1 else "one"] += 1
        return orig(cfg, s, kk)

    monkeypatch.setattr(bk, "burgers_multistep", counted)
    cfg = tbg.BurgersConfig(nx=20, ny=16, block_k=k, dtau=1e-2)
    s = tbg.init(cfg, CPU)
    out = bk.run_kernels(cfg, s, n)
    assert (calls["k"], calls["one"]) == want
    ref = tbg.run(cfg, s, n)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cpu_tensors_take_plain_version_uncounted(dtype):
    cfg = tbg.BurgersConfig(nx=24, ny=20, dtype=dtype)
    s = tbg.init(cfg, CPU)
    bk.reset_launches()
    out = bk.burgers_multistep(cfg, s, 3)
    assert bk.LAUNCHES == {"step": 0, "multistep": 0}
    assert all(torch.equal(x, y) for x, y in zip(out, tbg.run(cfg, s, 3)))


def test_wrapper_checks():
    cfg = tbg.BurgersConfig(nx=24, ny=20)
    s = tbg.init(cfg, CPU)
    bk._check(cfg, s)
    with pytest.raises(TypeError):
        bk._check(cfg, s._replace(phi_v=s.phi_v.double()))
    with pytest.raises(ValueError, match="shape"):
        bk._check(cfg, s._replace(phi_u=s.phi_u[:, :-1]))
    with pytest.raises(ValueError, match="contiguous"):
        bk._check(cfg.replace(nx=20, ny=20), tbg.init(
            cfg.replace(nx=20, ny=20), CPU)._replace(
                phi_u=torch.zeros(20, 20).t()))
    with pytest.raises(ValueError, match="shape"):
        bk._check(cfg, s._replace(t=s.t.reshape(1)))


def test_params_are_the_python_constants():
    cfg = tbg.BurgersConfig(dx=0.5, dy=0.25, nu=0.07, u0=2.0, cfl=0.4,
                            dtau=0.3, muscl=True, visc_substeps=3)
    p = bk._params(cfg, 5)
    assert (p.ny, p.nx, p.k, p.muscl, p.one_d, p.visc_substeps) == (
        cfg.ny, cfg.nx, 5, 1, 0, 3)
    assert (p.u0, p.dx, p.dy, p.inv_dy, p.cfl, p.dtau, p.nu) == (
        2.0, 0.5, 0.25, 4.0, 0.4, 0.3, 0.07)
    assert (p.inv_dx2, p.inv_dy2) == (4.0, 16.0)
    one_d = bk._params(cfg.replace(colehopf=True, ny=1), 1)
    assert (one_d.one_d, one_d.inv_dy, one_d.inv_dy2) == (1, 0.0, 0.0)
    assert (p.first, p.per_pass) == (3, bk.MAX_HALO)
    assert bk._scratch_fields(cfg) == 2
    assert bk._scratch_fields(cfg.replace(visc_substeps=1)) == 2


def decode_alike_everywhere(cfg, phi):
    """u0 sinh(phi) from exp, whose bits do not depend on a cell's place
    in the array (torch's CPU sinh takes another path at an array's tail,
    so a window and the whole grid would differ by ulps)."""
    return cfg.u0 * (0.5 * (torch.exp(phi) - torch.exp(-phi)))


TILED = [(nx, ny, opt) for nx, ny in ((40, 28), (5, 3))
         for opt in ("plain", "muscl", "visc3", "muscl_visc3", "nu0")] + [
    (64, 1, "colehopf")]
TILED_OPTS = {"plain": {}, "muscl": {"muscl": True},
              "visc3": {"visc_substeps": 3},
              "muscl_visc3": {"muscl": True, "visc_substeps": 3},
              "nu0": {"nu": 0.0},
              "colehopf": {"colehopf": True, "dtau": 1e-3}}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nx, ny, opt", TILED)
def test_tiled_step_model_is_bitwise_the_step(monkeypatch, dtype, nx, ny,
                                              opt):
    """The kernel's tiling (its tile clipped to the grid; bk.plan's halo:
    the flux stencil's reach, 2 with MUSCL and 1 without, plus the
    viscosity substeps), modelled in torch, is bitwise the plain step: on
    a ragged 40x28 grid, on 5x3 (narrower than the halo: windows wrap
    onto the tile) and in Cole–Hopf's ny = 1."""
    monkeypatch.setattr(tbg, "_decode", decode_alike_everywhere)
    cfg = tbg.BurgersConfig(nx=nx, ny=ny, dtype=dtype,
                            **dict(dict(dtau=1e-2), **TILED_OPTS[opt]))
    reach, halo, passes = bk.plan(cfg)
    assert (reach, len(passes)) == (2 if cfg.muscl else 1, 1)
    assert halo == reach + cfg.visc_substeps
    rng = np.random.default_rng(nx * ny)
    s = tbg.init(cfg, CPU)
    s = s._replace(**{f: getattr(s, f) + torch.tensor(
        0.1 * rng.standard_normal((ny, nx)), dtype=s.phi_u.dtype)
        for f in ("phi_u", "phi_v")})
    for _ in range(2):
        ref = tbg.step(cfg, s)
        got = tiled_step_fields(tbg.step_fields, cfg, (s.phi_u, s.phi_v),
                                s.t, kernel_tile(nx, ny), halo)
        assert all(torch.equal(a, b) for a, b in zip(got, ref[:2]))
        s = ref


@pytest.mark.parametrize("opt", ["plain", "muscl", "visc3"])
def test_tiled_step_model_needs_the_full_halo(monkeypatch, opt):
    """One cell less of halo and the model is no longer the step: the
    test above can see a wrong halo."""
    monkeypatch.setattr(tbg, "_decode", decode_alike_everywhere)
    cfg = tbg.BurgersConfig(nx=40, ny=28, dtype="float64", dtau=1e-2,
                            **TILED_OPTS[opt])
    s = tbg.init(cfg, CPU)
    _, halo, _ = bk.plan(cfg)
    ref = tbg.step(cfg, s)
    got = tiled_step_fields(tbg.step_fields, cfg, (s.phi_u, s.phi_v), s.t,
                            kernel_tile(cfg.nx, cfg.ny), halo - 1)
    assert not all(torch.equal(a, b) for a, b in zip(got, ref[:2]))


@pytest.mark.parametrize("muscl, nsub, passes", [
    (False, 1, (1,)), (True, 1, (1,)), (False, 7, (7,)), (True, 6, (6,)),
    (True, 7, (6, 1)), (False, 8, (7, 1)), (True, 15, (6, 8, 1)),
    (False, 23, (7, 8, 8))])
def test_plan_splits_substeps_into_passes(muscl, nsub, passes):
    """A pass holds at most MAX_HALO cells of halo: the first runs the
    convective update and MAX_HALO - reach substeps at most, each later
    one MAX_HALO at most; the kernel's scratch holds the (u, v) pairs
    between passes only when there is more than one."""
    cfg = tbg.BurgersConfig(nx=24, ny=20, muscl=muscl, visc_substeps=nsub)
    reach, halo, got = bk.plan(cfg)
    assert got == passes and sum(got) == nsub
    assert halo == reach + got[0] <= bk.MAX_HALO
    assert max(got[1:], default=0) <= bk.MAX_HALO
    assert bk._scratch_fields(cfg) == (2 if len(got) == 1 else 6)
    p = bk._params(cfg, 3)
    assert (p.first, p.per_pass) == (got[0], bk.MAX_HALO)


def test_init_defaults_to_gpu():
    cfg = tbg.BurgersConfig(nx=16, ny=16)
    if torch.cuda.is_available():
        assert tbg.init(cfg).phi_u.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tbg.init(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            interop.burgers_state_from_numpy(np.zeros((2, 2)),
                                             np.zeros((2, 2)), 1.0, 0.0,
                                             dtype=torch.float32)
