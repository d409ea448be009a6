"""Port vs JAX: the 3-D stable fluids (solvers/stam3d.py, ops/gather.py)
and the plain versions of its CUDA kernels (kernels/stam3d_cuda.py).

The same seeded numpy inputs, or the same initial state carried over by
interop, go through JAX's XLA engine (jit) and the port's 'torch' engine:
float64 within 1e-12, float32 within 5e-4 relative (ROADMAP.md), and the
port against the float64 loop oracle within 1e-12.  One case runs JAX's
Pallas step in interpret mode, as tests/test_mhd_stam3d.py does.  The
kernels' plain versions, which chip_smoke.py holds the CUDA kernels to on
the card, must equal the 'torch' engine's functions bitwise, and the
'cuda' engine's step composed from them (the wrappers take the plain
versions for CPU tensors) must equal the 'torch' engine at advect_k = 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.kernels import stam3d_pallas as jsp
from fluidsims_tpu.ops import gather as jgather
from fluidsims_tpu.solvers import stam3d as js
from fluidsims_tpu_torch import cli, interop
from fluidsims_tpu_torch.kernels import _build
from fluidsims_tpu_torch.kernels import stam3d_cuda as sc
from fluidsims_tpu_torch.ops import gather as tgather
from fluidsims_tpu_torch.ops.scalar import div
from fluidsims_tpu_torch.solvers import stam3d as ts
from tests.oracles.stam3d_oracle import Stam3DOracle

torch.set_num_threads(1)
CPU = torch.device("cpu")
FIELDS = ("u", "v", "w", "u0", "v0", "w0", "d", "d0")
TOL = {"float64": 1e-12, "float32": 5e-4}


def both(**kw):
    """(JAX config, port config, JAX init state, port state moved over by
    interop)."""
    jc = js.Stam3DConfig(**kw)
    tc = interop.stam3d_config_from_dict(jc.asdict())
    sj = js.init(jc)
    st = interop.stam3d_state_from_numpy(*(np.asarray(f) for f in sj),
                                         dtype=tc.torch_dtype, device=CPU)
    return jc, tc, sj, st


def noisy(st, seed=0, amp=0.3):
    """The state plus seeded noise on all eight fields, rings included."""
    rng = np.random.default_rng(seed)
    return ts.Stam3DState(*[f + torch.tensor(amp * rng.standard_normal(
        f.shape), dtype=f.dtype) for f in st[:8]], st.step_idx)


def close(got, ref, dtype, what=""):
    """max |got - ref| <= TOL (f64) or TOL * max |ref| (f32)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    err = np.abs(got.astype(np.float64) - ref).max()
    bar = TOL[dtype] * (1.0 if dtype == "float64" else np.abs(ref).max())
    assert err <= bar, f"{what}: {err:.3e} > {bar:.3e}"


def test_gather_matches_jax():
    rng = np.random.default_rng(0)
    f3 = rng.standard_normal((5, 6, 7))
    k, j, i = (rng.integers(0, m, (3, 4)) for m in (5, 6, 7))
    np.testing.assert_array_equal(
        tgather.gather3d(torch.tensor(f3), *map(torch.tensor, (k, j, i))).numpy(),
        np.asarray(jgather.gather3d(jnp.asarray(f3), k, j, i)))
    f2 = rng.standard_normal((6, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        tgather.gather2d(torch.tensor(f2), torch.tensor(j),
                         torch.tensor(i)).numpy(),
        np.asarray(jgather.gather2d(jnp.asarray(f2), j, i)))


@pytest.mark.parametrize("dtype,n", [("float64", 12), ("float32", 16)])
def test_init_and_set_bnd_match_jax(dtype, n):
    jc, tc, sj, _ = both(n=n, dtype=dtype)
    st = ts.init(tc, CPU)
    for name in FIELDS:
        close(getattr(st, name), getattr(sj, name), dtype, name)
    assert st.u.shape == (n + 2,) * 3 and st.u.dtype == tc.torch_dtype
    assert int(st.step_idx) == 0 and st.step_idx.dtype == torch.int32
    st = noisy(st)
    got = ts.set_bnd(st.u, st.v, st.w, st.d)
    ref = js.set_bnd(*(jnp.asarray(f.numpy()) for f in (st.u, st.v, st.w,
                                                         st.d)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("iters", [12, 5])
def test_lin_solve_matches_jax(dtype, iters):
    """Nonzero rings on x: odd counts end on the zero ring."""
    jc, tc, _, st = both(n=12, dtype=dtype, jacobi_iters=iters)
    st = noisy(st)
    a, c = 0.37, 1.0 + 6.0 * 0.37
    got = ts._lin_solve(tc, st.u, st.v, a, c)
    ref = js._lin_solve(jc, jnp.asarray(st.u.numpy()),
                        jnp.asarray(st.v.numpy()), a, c)
    close(got, ref, dtype)
    ring = got.clone()
    ring[1:-1, 1:-1, 1:-1] = 0
    assert (iters % 2 == 1) == bool((ring == 0).all())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("advect_k", [0, 2])
def test_advect_matches_jax(dtype, advect_k):
    jc, tc, _, st = both(n=12, dtype=dtype, advect_k=advect_k)
    st = noisy(st, amp=0.8)
    args = [jnp.asarray(f.numpy()) for f in (st.d, st.u, st.v, st.w)]
    close(ts._advect(tc, st.d, st.u, st.v, st.w), js._advect(jc, *args),
          dtype)


@pytest.mark.parametrize("dtype,n", [("float64", 12), ("float32", 16)])
@pytest.mark.parametrize("advect_k", [0, 2])
def test_step_and_run_match_jax(dtype, n, advect_k):
    jc, tc, sj, st = both(n=n, dtype=dtype, advect_k=advect_k, engine="xla")
    assert tc.engine == "torch"
    sj1 = jax.jit(lambda s: js.step(jc, s))(sj)
    st1 = ts.step(tc, st)
    for name in FIELDS:
        close(getattr(st1, name), getattr(sj1, name), dtype, f"step {name}")
    sj3 = jax.jit(lambda s: js.run(jc, s, 3))(sj)
    st3 = ts.run(tc, st, 3)
    for name in FIELDS:
        close(getattr(st3, name), getattr(sj3, name), dtype, f"run {name}")
    assert int(st3.step_idx) == int(sj3.step_idx) == 3


def test_matches_loop_oracle_f64():
    """tests/oracles/stam3d_oracle.py: decay, the crossed source, the
    warm-started ping-pong Jacobi, set_bnd placement, the gather."""
    jc, tc, sj, st = both(n=12, dtype="float64", advect_k=0)
    orc = Stam3DOracle(jc, *[np.asarray(getattr(sj, f)) for f in FIELDS],
                       int(sj.step_idx))
    for _ in range(2):
        st = ts.step(tc, st)
        orc.step()
    for name in ("u", "v", "w", "d", "u0", "d0"):
        assert np.abs(getattr(st, name).numpy()
                      - getattr(orc, name)).max() < 1e-12, name


def test_torch_engine_tracks_jax_pallas_interpret():
    """JAX's Pallas step (interpret mode; the dense-shift advection at
    K=2, its default) against the port's 'torch' engine at the same K over
    3 steps at n=16 f32, to JAX's own bars for Pallas vs XLA.  The initial
    flow already moves past K cells somewhere, so the 'cuda' engine, which
    gathers exactly, is held to the 'torch' engine at advect_k = 0."""
    jc, tc, sj, st = both(n=16, advect_k=2, engine="pallas")
    assert tc.engine == "cuda"
    assert int(ts.advect_capped_count(tc.replace(engine="torch"), st)) > 0
    step_p = jsp.make_step_pallas(jc, interpret=True)
    for _ in range(3):
        sj, st = step_p(sj), ts._step_torch(tc, st)
    np.testing.assert_allclose(st.d.numpy(), np.asarray(sj.d), atol=2e-6)
    np.testing.assert_allclose(st.u.numpy(), np.asarray(sj.u), atol=5e-6)


def test_advect_capped_count_and_iso_render_match_jax():
    jc, tc, sj, st = both(n=16, dtype="float64", advect_k=2)
    calm = st._replace(u=st.u * 0, v=st.v * 0, w=st.w * 0)
    assert int(ts.advect_capped_count(tc, calm)) == 0
    for scale in (1.0, 3.0, 50.0):
        wild = st._replace(u=st.u * scale, v=st.v * scale)
        jwild = sj._replace(u=sj.u * scale, v=sj.v * scale)
        assert int(ts.advect_capped_count(tc, wild)) == int(
            js.advect_capped_count(jc, jwild))
    assert int(ts.advect_capped_count(tc, st._replace(u=st.u * 50.0))) > 0
    assert int(ts.advect_capped_count(tc.replace(advect_k=0), wild)) == 0
    st = ts.run(tc, st, 2)
    sj = js.run(jc, sj, 2)
    for W, H in ((60, 30), (100, 40)):
        img = ts.iso_render(tc, st, W=W, H=H)
        ref = np.asarray(js.iso_render(jc, sj, W=W, H=H))
        assert img.shape == (H, W) and img.dtype == torch.int32
        np.testing.assert_array_equal(img.numpy(), ref)
        assert 0 < int(img.max()) <= 256


def test_resolve_engine():
    cuda = torch.device("cuda")   # only its type is read
    assert ts.resolve_engine(ts.Stam3DConfig(n=16), CPU) == "torch"
    assert ts.resolve_engine(ts.Stam3DConfig(n=16), cuda) == "cuda"
    for dt in ("float32", "float64"):
        for iters in (12, 5):
            cfg = ts.Stam3DConfig(n=37, dtype=dt, jacobi_iters=iters)
            assert ts.resolve_engine(cfg, cuda) == "cuda"
    assert ts.resolve_engine(ts.Stam3DConfig(n=16, engine="torch"),
                             cuda) == "torch"
    cfg = ts.Stam3DConfig(n=16, engine="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ts.resolve_engine(cfg, CPU)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ts.step(cfg, ts.init(cfg.replace(engine="torch"), CPU))
    # the cuda engine gathers exactly: nothing is capped
    st = ts.init(cfg.replace(engine="torch"), CPU)
    assert int(ts.advect_capped_count(cfg.replace(engine="auto"),
                                      st._replace(u=st.u * 50))) > 0
    with pytest.raises(ValueError):
        ts.Stam3DConfig(n=16, engine="pallas")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [10, 13])
def test_plain_versions_equal_solver_functions_bitwise(dtype, n):
    tc = ts.Stam3DConfig(n=n, dtype=dtype)
    st = noisy(ts.init(tc, CPU), seed=n)
    # one sweep, out's ring untouched
    out = st.w0.clone()
    sc.jacobi_plain(st.u, st.v, out, 0.37, 3.22)
    want = ts._set_interior(st.w0, div(
        ts._interior(st.v) + 0.37 * ts._sum6(st.u), 3.22))
    assert torch.equal(out, want)
    for iters in (12, 5, 1):
        cfg = tc.replace(jacobi_iters=iters)
        x = st.u.clone()
        assert torch.equal(sc.lin_solve(cfg, st.u, st.v, 0.37, 3.22),
                           ts._lin_solve(cfg, st.u, st.v, 0.37, 3.22))
        assert torch.equal(st.u, x)   # x is not written
    # the gather at any displacement, ring passed through
    for scale in (1.0, 6.0):
        vel = [f * scale for f in (st.u, st.v, st.w)]
        assert torch.equal(sc.advect_plain(tc, st.d, *vel),
                           ts._advect(tc.replace(advect_k=0), st.d, *vel))
    # set_bnd in place, edges and corners untouched
    fields = [f.clone() for f in (st.u, st.v, st.w, st.d)]
    got = sc.set_bnd_plain(*fields)
    assert all(g is f for g, f in zip(got, fields))
    for g, r in zip(got, ts.set_bnd(st.u, st.v, st.w, st.d)):
        assert torch.equal(g, r)
    assert torch.equal(got[0][0, 0], st.u[0, 0])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("iters", [12, 5])
def test_cuda_composition_equals_torch_engine(dtype, iters):
    """The 'cuda' engine's step through the plain versions equals the
    'torch' engine at advect_k = 0 bitwise, and leaves its input state
    unchanged; the wrappers count no launch on CPU tensors."""
    tc = ts.Stam3DConfig(n=11, dtype=dtype, jacobi_iters=iters, advect_k=0)
    s0 = noisy(ts.init(tc, CPU), seed=5, amp=0.1)
    keep = [f.clone() for f in s0]
    sc.reset_launches()
    a = b = s0
    step = sc.make_step_cuda(tc)
    for _ in range(3):
        a, b = step(a), ts._step_torch(tc, b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for x, y in zip(s0, keep):
        assert torch.equal(x, y)
    assert sc.LAUNCHES == {"jacobi": 0, "advect": 0, "set_bnd": 0}


def test_wrapper_checks():
    tc = ts.Stam3DConfig(n=10)
    st = ts.init(tc, CPU)
    with pytest.raises(ValueError, match="another buffer"):
        sc.jacobi(st.u, st.v, st.u, 1.0, 6.0)
    sc._check(u=st.u, v=st.v)                                   # accepted
    with pytest.raises(TypeError, match="v is"):
        sc._check(u=st.u, v=st.v.double())
    with pytest.raises(ValueError, match="shape"):
        sc._check(u=st.u, v=st.v[:-1])
    with pytest.raises(ValueError, match=r"\(n\+2"):
        sc._check(u=st.u[:, :, :-1])
    with pytest.raises(ValueError, match="contiguous"):
        sc._check(u=st.u, v=st.v.transpose(0, 2))
    with pytest.raises(TypeError, match="no kernel"):
        sc._check(u=st.u.half())
    with pytest.raises(ValueError, match="unsupported device"):
        sc.set_bnd(*(f.to("meta") for f in (st.u, st.v, st.w, st.d)))


def test_load_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path / "no-cuda")
    _build.load_library.cache_clear()
    sc.load.cache_clear()
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        sc.load()


def test_interop_round_trip():
    jc, tc, sj, st = both(n=8, dtype="float64", engine="pallas",
                          jacobi_iters=6)
    assert (tc.engine, tc.jacobi_iters, tc.n) == ("cuda", 6, 8)
    assert interop.stam3d_config_from_dict(
        js.Stam3DConfig(engine="xla").asdict()).engine == "torch"
    back = interop.stam3d_state_to_numpy(st)
    for got, ref in zip(back, sj):
        np.testing.assert_array_equal(got, np.asarray(ref))
    with pytest.raises(ValueError, match="n\\+2"):
        interop.stam3d_state_from_numpy(*back[:7], back[7][:-1], 0,
                                        dtype=torch.float64, device=CPU)


def test_init_defaults_to_gpu():
    cfg = ts.Stam3DConfig(n=8)
    if torch.cuda.is_available():
        assert ts.init(cfg).u.is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            ts.init(cfg)


def test_cli_stam3d_cpu(capsys):
    assert cli.main(["stam3d", "--device", "cpu", "--n", "12", "--steps", "2",
                     "--advect-k", "0", "--jacobi", "5"]) == 0
    out = capsys.readouterr().out
    assert "engine=torch" in out and "advect_k=0" in out
    assert "steps/s" in out and "advect capped" not in out
