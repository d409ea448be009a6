"""The SPH kernels' plain versions against the JAX package, and their
wrappers off the GPU.

The plain versions (kernels/sph_cuda.py) are what chip_smoke.py holds the
CUDA kernels to on the card, which has no JAX; here they are held to JAX:
the binning bitwise to the TPU rank kernel (interpret mode) and to
bin_rank, density and forces + integrate at float64 to 1e-12 of the
array's largest value against JAX's density / forces / _integrate on the
same state.  Without CUDA the wrappers take the plain versions for CPU
tensors, count no launch, check what they are given, and the build raises
when nvcc is absent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.ops import cell_dense as jcd
from fluidsims_tpu.ops.rank_pallas import make_rank_kernel
from fluidsims_tpu.solvers import sph as js
from fluidsims_tpu_torch.kernels import _build
from fluidsims_tpu_torch.kernels import sph_cuda as sk
from fluidsims_tpu_torch.solvers import sph as ts

torch.set_num_threads(1)
CPU = torch.device("cpu")


def stirred(n, dtype="float64", seed=3, **kw):
    """JAX and port configs and one state: init plus seeded position and
    velocity noise, so the pair terms and the viscosity branch all run."""
    jc = js.SPHConfig(n=n, seed=seed, dtype=dtype, rain=False, **kw)
    tc = ts.SPHConfig(n=n, seed=seed, dtype=dtype, rain=False, **kw)
    rng = np.random.default_rng(seed)
    pos = np.asarray(js.init(jc).pos, np.float64)
    pos = np.clip(pos + 0.3 * jc.h * rng.standard_normal((n, 2)), 0, 1)
    vel = 0.5 * rng.standard_normal((n, 2))
    dt = np.dtype(dtype)
    return jc, tc, pos.astype(dt), vel.astype(dt)


def test_rank_matches_tpu_rank_kernel_interpret():
    """n = 5000 particles on 32 x 32 = 1024 cells, as tests/test_sph.py
    runs the TPU kernel; positions at the centres of random cells."""
    n = 5000
    h_mul = (1.0 / 31.5) / (2.0 * np.sqrt(1.0 / n))
    tc = ts.SPHConfig(n=n, h_mul=h_mul)
    g = tc.grid()
    assert (g.Gx, g.Gy) == (32, 32)
    rng = np.random.default_rng(3)
    cid = rng.integers(0, 1024, n).astype(np.int32)
    pos = np.stack([(cid % 32 + 0.5) * g.cell, (cid // 32 + 0.5) * g.cell], -1)
    b = sk.binning_plain(tc, torch.tensor(pos, dtype=torch.float32),
                         torch.zeros((n, 2)))
    np.testing.assert_array_equal(b.cid.numpy(), cid)
    want = np.asarray(make_rank_kernel(n, 1024, interpret=True)(jnp.asarray(cid)))
    np.testing.assert_array_equal(b.rank.numpy(), want)
    jrank, _, _ = jcd.bin_rank(jcd.DenseGrid(Gx=32, Gy=32, cell=1.0, K=1 << 20),
                               jnp.zeros((n, 2), jnp.float32),
                               cid=jnp.asarray(cid))
    np.testing.assert_array_equal(b.rank.numpy(), np.asarray(jrank))
    np.testing.assert_array_equal(b.ok.numpy(), want < g.K)


@pytest.mark.parametrize("cap", [0, 8])
def test_binning_plain_layout(cap):
    _, tc, pos, vel = stirred(512, "float32", cell_capacity=cap)
    p, v = torch.tensor(pos), torch.tensor(vel)
    b = sk.binning_plain(tc, p, v)
    n, g = tc.n, tc.grid()
    order = b.order.long()
    assert sorted(order.tolist()) == list(range(n))
    counts = torch.bincount(b.cid.long(), minlength=g.Gx * g.Gy)
    np.testing.assert_array_equal(np.diff(b.starts.numpy()), counts.numpy())
    # sorted by (cell, particle index); rank = position - cell start
    sc = b.cid.long()[order]
    key = sc * n + order
    assert bool((key[1:] > key[:-1]).all())
    np.testing.assert_array_equal(b.rank.long()[order].numpy(),
                                  (torch.arange(n) - b.starts.long()[sc]).numpy())
    np.testing.assert_array_equal(b.fields.numpy(),
                                  torch.cat([p, v], 1)[order].numpy())
    assert int((~b.ok).sum()) == int(ts.overflow_count(tc, ts.SPHState(
        p, v, *[torch.zeros(())] * 3, torch.zeros((), dtype=torch.int32))))
    assert (cap == 8) == bool((~b.ok).any())


@pytest.mark.parametrize("cap", [0, 8])
def test_density_and_forces_plain_match_jax_f64(cap):
    jc, tc, pos, vel = stirred(512, cell_capacity=cap)
    p, v = torch.tensor(pos), torch.tensor(vel)
    b = sk.binning_plain(tc, p, v)
    order, ok_s = b.order.long().numpy(), b.ok.numpy()[b.order.long().numpy()]

    s, rho, press, cl, grid = js.density(jc, jnp.asarray(pos))
    rp = sk.density_plain(tc, b).numpy()
    rho_j = np.asarray(rho)[order]
    pt_j = (np.asarray(press) / np.maximum(np.asarray(rho), 1e-30) ** 2)[order]
    for got, ref in ((rp[:, 0], rho_j), (rp[:, 1], pt_j)):
        assert np.abs(got[ok_s] - ref[ok_s]).max() <= 1e-12 * np.abs(ref).max()
        assert (got[~ok_s] == 0).all()

    dt = 2e-3
    acc = js.forces(jc, jnp.asarray(pos), jnp.asarray(vel), s, press, grid, cl)
    jp, jv = js._integrate(jc, jnp.asarray(pos), jnp.asarray(vel), acc, dt)
    tp, tv = sk.forces_plain(tc, b, torch.tensor(rp),
                             torch.tensor(dt, dtype=torch.float64))
    for got, ref in ((tp, jp), (tv, jv)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cpu_tensors_take_plain_version_uncounted(dtype):
    _, tc, pos, vel = stirred(300, dtype)
    sk.reset_launches()
    p, v = torch.tensor(pos), torch.tensor(vel)
    b = sk.binning(tc, p, v)
    bp = sk.binning_plain(tc, p, v)
    for x, y in zip(b, bp):
        assert torch.equal(x, y)
    assert b.rank.dtype == b.starts.dtype == b.order.dtype == torch.int32
    rp = sk.density(tc, b)
    assert torch.equal(rp, sk.density_plain(tc, b))
    dt = torch.tensor(1e-3, dtype=tc.torch_dtype)
    for x, y in zip(sk.forces(tc, b, rp, dt), sk.forces_plain(tc, b, rp, dt)):
        assert torch.equal(x, y)
    st = ts.init(tc.replace(engine="cuda"), CPU)
    ts.run(tc.replace(engine="cuda"), st, 2)
    assert sk.LAUNCHES == {"bin": 0, "density": 0, "forces": 0}


def test_wrapper_checks():
    _, tc, pos, vel = stirred(64, "float32")
    p, v = torch.tensor(pos), torch.tensor(vel)
    b = sk.binning_plain(tc, p, v)
    sk._check(tc, **sk._binned_specs(tc, b))   # accepted
    with pytest.raises(TypeError, match="pos"):
        sk._check(tc, pos=(p.double(), None, (64, 2)))
    with pytest.raises(ValueError, match="shape"):
        sk._check(tc, pos=(p[:-1], None, (64, 2)))
    with pytest.raises(ValueError, match="contiguous"):
        sk._check(tc, vel=(v.t().contiguous().t(), None, (64, 2)))
    with pytest.raises(TypeError, match="starts"):
        sk._check(tc, **sk._binned_specs(tc, b._replace(starts=b.starts.long())))
    with pytest.raises(ValueError, match="dt"):
        sk._check(tc, dt=(torch.ones(2), None, ()))
    with pytest.raises(ValueError, match="unsupported device"):
        sk.binning(tc, p.to("meta"), v.to("meta"))


def test_params_are_the_python_constants():
    cfg = ts.SPHConfig(n=4096, gamma_eos=7.0, visc_alpha=0.3)
    p = sk._params(cfg)
    g = cfg.grid()
    assert (p.n, p.Gx, p.Gy, p.K) == (4096, g.Gx, g.Gy, g.K)
    assert p.cell == g.cell and p.inv_h == 1.0 / cfg.h
    assert p.gamma_is_one == 0 and p.gamma_eos == 7.0
    assert p.visc_coef == -0.3 * cfg.c0 * cfg.h
    assert sk._params(ts.SPHConfig(n=64)).gamma_is_one == 1


def test_make_step_cuda_refuses_xsph():
    with pytest.raises(ValueError, match="XSPH"):
        sk.make_step_cuda(ts.SPHConfig(n=64, use_xsph=True))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path / "no-cuda")
    _build.load_library.cache_clear()
    sk.load.cache_clear()
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        sk.load()


def test_jax_density_pressure_helpers_agree():
    """w_cubic, grad_w_cubic and tait_pressure are the JAX functions."""
    cfg_j, cfg_t = js.SPHConfig(n=256, gamma_eos=7.0), ts.SPHConfig(n=256,
                                                                   gamma_eos=7.0)
    r = np.linspace(0.0, 2.5 * cfg_j.h, 97)
    rij = np.stack([r * 0.6, -r * 0.8], -1)
    np.testing.assert_array_equal(
        ts.w_cubic(torch.tensor(r), cfg_t.h).numpy(),
        np.asarray(js.w_cubic(jnp.asarray(r), cfg_j.h)))
    np.testing.assert_allclose(
        ts.grad_w_cubic(torch.tensor(rij), torch.tensor(r), cfg_t.h).numpy(),
        np.asarray(js.grad_w_cubic(jnp.asarray(rij), jnp.asarray(r), cfg_j.h)),
        rtol=1e-15, atol=0)
    rho = np.linspace(0.5, 3.0, 11)
    np.testing.assert_allclose(
        ts.tait_pressure(cfg_t, torch.tensor(rho)).numpy(),
        np.asarray(js.tait_pressure(cfg_j, jnp.asarray(rho))), rtol=1e-14)
    assert jax.numpy.asarray(rho).dtype == np.float64
