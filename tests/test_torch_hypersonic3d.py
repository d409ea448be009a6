"""Port vs JAX: the 3-D hypersonic step, its kernels' plain versions and
its CLI, on the CPU.

The same state (made by the JAX package, u0-seeded as
tests/test_hypersonic3d.py seeds it, carried over with interop) goes
through JAX's step and the port's: 3 steps at 16^3 f64 to 1e-12 (the bars
of tests/test_pallas_kernels.py), 20 steps at 16^3 f32 to 5e-4 relative,
10 characteristic-outflow steps at 12^3 f64.  The step kernel's plain
version (what its wrapper runs for CPU tensors) is held against the TPU
kernel as the JAX tests run it (interpret mode), and the wavespeed's plain
version against JAX's masked max, bitwise.  JAX's compiled steps are
shared through module-scoped fixtures.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.kernels import hypersonic3d_pallas as jhp
from fluidsims_tpu.solvers import hypersonic3d as jh
from fluidsims_tpu_torch import cli, interop
from fluidsims_tpu_torch.kernels import hypersonic3d_cuda as hk
from fluidsims_tpu_torch.solvers import hypersonic3d as th

torch.set_num_threads(1)
CPU = torch.device("cpu")
LOG_FIELDS = ("xi", "phix", "phiy", "phiz", "lam", "zet")


def seeded(cfg, u0=0.05):
    """JAX init with a uniform +x velocity u0 in the fluid cells, so the
    transmissive outlet's reversed-flow branch is well determined."""
    s = jh.init(cfg)
    fl = ~np.asarray(s.solid)
    phix = np.asarray(s.phix).copy()
    phix[fl] = np.arcsinh(u0 / cfg.u_ref)
    return s._replace(phix=jnp.asarray(phix))


def to_port(s, dtype):
    return interop.hyp3d_state_from_numpy(*(np.asarray(f) for f in s),
                                          dtype=dtype, device=CPU)


def jax_run(cfg, s, n):
    step = jax.jit(lambda st: jh.step(cfg, st))
    for _ in range(n):
        s = step(s)
    return s


def tcfg(jcfg):
    return interop.hyp3d_config_from_dict(jcfg.asdict())


@pytest.fixture(scope="module")
def f64_16():
    cfg = jh.default_config(16, dtype="float64")
    s0 = seeded(cfg)
    return cfg, s0, jax_run(cfg, s0, 3)


def test_three_steps_f64_match_jax(f64_16):
    cfg, s0, ref = f64_16
    out = th.run(tcfg(cfg), to_port(s0, torch.float64), 3)
    for name in LOG_FIELDS:
        a, b = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert np.abs(a - b).max() < 1e-12, name
    np.testing.assert_allclose(float(out.t), float(ref.t), rtol=1e-12)
    np.testing.assert_allclose(float(out.dtau), float(ref.dtau), rtol=1e-12)
    assert torch.equal(out.solid, to_port(s0, torch.float64).solid)


def test_twenty_steps_f32_match_jax():
    cfg = jh.default_config(16)
    s0 = seeded(cfg)
    ref = jax.jit(lambda st: jh.run(cfg, st, 20))(s0)
    out = th.run(tcfg(cfg), to_port(s0, torch.float32), 20)
    for name in LOG_FIELDS:
        a = getattr(out, name).numpy().astype(np.float64)
        b = np.asarray(getattr(ref, name), np.float64)
        assert np.abs(a - b).max() <= 5e-4 * max(np.abs(b).max(), 1e-3), name
    np.testing.assert_allclose(float(out.t), float(ref.t), rtol=5e-4)
    np.testing.assert_allclose(float(out.dtau), float(ref.dtau), rtol=5e-4)


def test_characteristic_outflow_ten_steps_f64():
    cfg = jh.default_config(12, outflow="characteristic", dtype="float64")
    s0 = seeded(cfg)
    ref = jax.jit(lambda st: jh.run(cfg, st, 10))(s0)
    out = th.run(tcfg(cfg), to_port(s0, torch.float64), 10)
    for name in LOG_FIELDS:
        a, b = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert np.abs(a - b).max() < 1e-12, name
        assert np.isfinite(a).all(), name
    np.testing.assert_allclose(float(out.t), float(ref.t), rtol=1e-12)
    np.testing.assert_allclose(float(out.dtau), float(ref.dtau), rtol=1e-12)


def padded_inputs(cfg, seed=4):
    """BC-resolved padded prims of a noisy seeded state (JAX), the padded
    mask, and dt, gain."""
    s = seeded(cfg)
    q = jh._decode(cfg, s.xi, s.phix, s.phiy, s.phiz, s.lam, s.zet)
    rng = np.random.default_rng(seed)
    solid = np.asarray(s.solid)
    noisy = []
    for f in q:
        f = np.asarray(f, np.float64)
        f = f * (1.0 + np.where(solid, 0.0, 0.1 * rng.standard_normal(f.shape)))
        noisy.append(jnp.asarray(f))
    sp = jnp.asarray(jh.build_solid(cfg, pad=jh.HALO))
    qp = jh._padded_prims(cfg, jh.PrimT(*noisy), sp)
    return qp, sp, 3e-5, 0.8


def test_step_kernel_plain_matches_pallas_interpret():
    """One call of the step kernel's wrapper on CPU tensors (its plain
    version) against the TPU kernel in interpret mode, 16^3 f64."""
    cfg = jh.default_config(16, dtype="float64")
    qp, sp, dt, gain = padded_inputs(cfg)
    core = jhp.make_core_pallas(cfg, band=4, interpret=True)
    ref = jax.jit(core)(qp, sp, jnp.float64(dt), jnp.float64(gain))
    hk.reset_launches()
    got = hk.step_core(tcfg(cfg), th.PrimT(*(torch.from_numpy(np.array(f))
                                             for f in qp)),
                       torch.from_numpy(np.array(sp)),
                       torch.tensor(dt, dtype=torch.float64),
                       torch.tensor(gain, dtype=torch.float64))
    assert hk.LAUNCHES == {"step": 0, "wavespeed": 0, "pad": 0}
    for name, a, b in zip(th.PrimT._fields, got, ref):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max(), name


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_wavespeed_plain_matches_jax_masked_max_bitwise(dtype):
    cfg = jh.default_config(12, dtype=dtype)
    rng = np.random.default_rng(5)
    shape = (12, 12, 12)
    fields = [rng.uniform(0.01, 2, shape), rng.normal(0, 50, shape),
              rng.normal(0, 5, shape), rng.normal(0, 5, shape),
              rng.uniform(0.01, 3, shape), rng.uniform(0, 1, shape)]
    fields[1][2, 3, 4] = np.nan
    fields[4][5, 5, 5] = np.inf
    fields = [f.astype(dtype) for f in fields]
    solid = jh.build_solid(cfg)
    q1 = jh.PrimT(*(jnp.asarray(f) for f in fields))
    a1 = jh.soundspeed(cfg, q1)
    ssum = (jnp.abs(q1.u) + a1) / cfg.dx + (jnp.abs(q1.v) + a1) / cfg.dy \
        + (jnp.abs(q1.w) + a1) / cfg.dz
    ref = jnp.max(jnp.where(jnp.isfinite(ssum) & ~jnp.asarray(solid), ssum, 0.0))
    got = hk.wavespeed(tcfg(cfg), th.PrimT(*map(torch.from_numpy, fields)),
                       torch.from_numpy(solid))
    assert got.shape == () and got.dtype == getattr(torch, dtype)
    assert got.numpy().tobytes() == np.asarray(ref).tobytes()


def test_default_hooks_are_the_plain_versions_on_cpu(f64_16):
    cfg, s0, _ = f64_16
    tc = tcfg(cfg)
    s = to_port(s0, torch.float64)
    a = th.step(tc, s)
    b = th.step(tc, s, core=functools.partial(hk.step_core_plain, tc),
                wavespeed=functools.partial(hk.wavespeed_plain, tc))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = th.step(tc, s, solid_pad=th.solid_pad_of(tc, CPU),
                wavespeed_reduce=lambda m: m, gain_mul=torch.tensor(1.0))
    for x, y in zip(a, c):
        assert torch.equal(x, y)


def test_step_runs_and_stays_physical():
    cfg = th.default_config(16)
    s = th.init(cfg, CPU)
    out = th.run(cfg, s, 20)
    for name in LOG_FIELDS:
        assert bool(torch.isfinite(getattr(out, name)).all()), name
    assert bool((out.xi.exp() > 0).all()) and bool((out.lam.exp() > 0).all())
    assert float(out.t) > float(s.t)
    assert 1e-7 <= float(out.dtau) <= 5e-2
    assert out.t.device == CPU and out.dtau.shape == ()


def test_flow_develops_toward_sphere():
    cfg = th.default_config(24)
    out = th.run(cfg, th.init(cfg, CPU), 120)
    solid = out.solid
    u = cfg.u_ref * torch.sinh(out.phix)
    assert float(u[~solid].max()) > 0.1
    for mode in th.VIS_MODES:
        f = th.vis_field(cfg, out, mode)
        assert bool(torch.isfinite(f).all()), mode
        assert bool((f[solid] == 0).all()), mode


def test_dtau_controller_reacts():
    cfg = th.default_config(16)
    s = th.init(cfg, CPU)
    dtaus = [float(s.dtau)]
    for _ in range(10):
        s = th.step(cfg, s)
        dtaus.append(float(s.dtau))
    assert any(a != b for a, b in zip(dtaus, dtaus[1:]))


def test_init_defaults_to_the_gpu():
    cfg = th.default_config(8)
    if torch.cuda.is_available():
        assert th.init(cfg).xi.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            th.init(cfg)


def test_cli_hypersonic3d_cpu(capsys):
    assert cli.main(["hypersonic3d", "--device", "cpu", "--impl", "torch",
                     "--n", "16", "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "impl=torch" in out and "steps/s" in out and "Mcell-steps/s" in out
    assert "t = " in out and "dtau = " in out and "refl_dp = " in out
    with pytest.raises(SystemExit, match="needs --device cuda"):
        cli.main(["hypersonic3d", "--device", "cpu", "--n", "8",
                  "--steps", "1"])


def test_cli_th3cs_cpu(tmp_path, capsys):
    from fluidsims_tpu_torch.io import fourspl

    path = tmp_path / "vol.4spl"
    assert cli.main(["th3cs", "--device", "cpu", "--n", "12", "--frames", "2",
                     "--steps-per-frame", "1", "--out", str(path)]) == 0
    out = capsys.readouterr().out
    assert "engine=torch" in out and "frames/s" in out and str(path) in out
    v = fourspl.read_4spl(path)
    assert (v.frames, v.width, v.height, v.depth) == (2, 12, 12, 12)
