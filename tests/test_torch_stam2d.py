"""Port vs JAX: the 2-D stable fluids (solvers/stam2d.py) and the plain
versions of its CUDA kernels (kernels/stam2d_cuda.py).

The same seeded numpy inputs, or the same initial state carried over by
interop, go through JAX's exact XLA engine (jit) and the port's 'torch'
engine: float64 within 1e-12, float32 within 5e-4 relative (ROADMAP.md),
and the port against the float64 loop oracle within 1e-12.  JAX's jitted
sweep computes fma(a, sum4, b) * (1/c) where the port divides truly, so
the solve is held to JAX at JAX's own Pallas-vs-XLA bar (atol 1e-5 at
f32), not bitwise.  JAX's Pallas solve and banded advection run in
interpret mode, as tests/test_pallas_kernels.py runs them.  The kernels'
plain versions, which chip_smoke.py holds the CUDA kernels to on the card,
must equal the 'torch' engine's functions bitwise, and the 'cuda' engine's
step composed from them (the wrappers take the plain versions for CPU
tensors) must equal the 'torch' engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.kernels import stam2d_pallas as jsp
from fluidsims_tpu.solvers import stam2d as js
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.kernels import _build
from fluidsims_tpu_torch.kernels import stam2d_cuda as sc
from fluidsims_tpu_torch.ops.scalar import div
from fluidsims_tpu_torch.solvers import stam2d as ts
from tests.oracles.stam2d_oracle import Stam2DOracle

torch.set_num_threads(1)
CPU = torch.device("cpu")
FIELDS = ("u", "v", "u0", "v0", "d", "d0")
TOL = {"float64": 1e-12, "float32": 5e-4}
NP = {"float32": np.float32, "float64": np.float64}


def both(**kw):
    """(JAX config, port config, JAX init state, port state moved over by
    interop)."""
    jc = js.Stam2DConfig(**kw)
    tc = interop.stam2d_config_from_dict(jc.asdict())
    sj = js.init(jc)
    st = interop.stam2d_state_from_numpy(*(np.asarray(f) for f in sj),
                                         dtype=tc.torch_dtype, device=CPU)
    return jc, tc, sj, st


def noisy(st, seed=0, amp=0.3):
    """The state plus seeded noise on all six fields."""
    rng = np.random.default_rng(seed)
    return st._replace(**{f: getattr(st, f) + torch.tensor(
        amp * rng.standard_normal(tuple(st.u.shape)), dtype=st.u.dtype)
        for f in FIELDS})


def close(got, ref, dtype, what=""):
    """max |got - ref| <= TOL (f64) or TOL * max |ref| (f32)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    err = np.abs(got.astype(np.float64) - ref).max()
    bar = TOL[dtype] * (1.0 if dtype == "float64" else np.abs(ref).max())
    assert err <= bar, f"{what}: {err:.3e} > {bar:.3e}"


def rand(rng, n, dtype, lo=0.0, hi=1.0):
    return (lo + (hi - lo) * rng.random((n, n))).astype(NP[dtype])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [24, 37])
def test_init_matches_jax_bitwise(dtype, n):
    jc = js.Stam2DConfig(n=n, dtype=dtype)
    tc = ts.Stam2DConfig(n=n, dtype=dtype)
    sj, st = js.init(jc), ts.init(tc, CPU)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(sj, name)))
        assert getattr(st, name).dtype == tc.torch_dtype
    assert st.u.shape == (n, n)
    for f in (st.step_idx, st.ovf):
        assert f.shape == () and f.dtype == torch.int32 and int(f) == 0
    np.testing.assert_array_equal(
        ts.metric(tc, st.u).widths.numpy(),
        np.asarray(jnp.asarray(js._cell_widths(jc), jc.jax_dtype)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("iters", [40, 7])
def test_lin_solve_matches_jax_xla_and_pallas(dtype, iters):
    """The 'torch' solve (the kernel's plain version) against JAX's XLA
    solve and JAX's whole-solve Pallas kernel in interpret mode, warm
    started from a nonzero x: f32 atol 1e-5 (JAX's own Pallas-vs-XLA bar,
    tests/test_pallas_kernels.py), f64 1e-12 relative."""
    n = 32
    jc = js.Stam2DConfig(n=n, jacobi_iters=iters, dtype=dtype)
    rng = np.random.default_rng(iters)
    x, b = rand(rng, n, dtype), rand(rng, n, dtype)
    pallas = jsp.make_lin_solve_pallas(n, iters, jc.jax_dtype, interpret=True)
    for a, c in ((1.0, 4.0), (0.26, 2.04)):
        got = ts._lin_solve(torch.tensor(x), torch.tensor(b), a, c,
                            iters).numpy()
        for ref in (
                jax.jit(lambda x, b: js._lin_solve(jc, x, b, a, c))(x, b),
                jax.jit(lambda x, b: pallas(x, b, a, c))(x, b)):
            ref = np.asarray(ref)
            assert ref.dtype == got.dtype
            err = np.abs(got.astype(np.float64) - ref).max()
            bar = 1e-5 if dtype == "float32" else 1e-12 * np.abs(ref).max()
            assert err <= bar, (a, c, err)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("scale", [0.1, 4.0])
def test_advect_matches_jax(dtype, scale):
    """The exact back-trace of JAX's XLA path, on q in [0, 1) and
    velocities that move up to ~0.3 (scale 0.1) and past the grid edge
    (scale 4, with the metric's 1/x_p): f64 1e-12, f32 atol 1e-5; the
    pair form equals two single-field calls bitwise."""
    n = 32
    jc = js.Stam2DConfig(n=n, dtype=dtype)
    tc = ts.Stam2DConfig(n=n, dtype=dtype)
    rng = np.random.default_rng(7)
    q, q2 = rand(rng, n, dtype), rand(rng, n, dtype)
    uu = scale * rand(rng, n, dtype, -1.0, 1.0)
    vv = scale * rand(rng, n, dtype, -1.0, 1.0)
    got = ts._advect(tc, *map(torch.tensor, (q, uu, vv))).numpy()
    ref = np.asarray(jax.jit(lambda q, u, v: js._advect(jc, q, u, v))(
        q, uu, vv))
    bar = 1e-12 if dtype == "float64" else 1e-5
    assert np.abs(got.astype(np.float64) - ref).max() <= bar
    pa, pb = ts._advect_fields(tc, (torch.tensor(q), torch.tensor(q2)),
                               torch.tensor(uu), torch.tensor(vv))
    assert np.array_equal(pa.numpy(), got)
    assert torch.equal(pb, ts._advect(tc, *map(torch.tensor, (q2, uu, vv))))


def test_exact_advect_against_jax_banded_pallas():
    """JAX's banded TPU advection kernel (interpret mode) on the fixture of
    tests/test_pallas_kernels.py (n=128, advect_band=8, seed 3): the port's
    exact advection agrees with it within atol 1e-4 on the cells whose
    back-trace stays in the band, and on the cells the band clamps it
    agrees with JAX's exact `_advect` (atol 1e-5) instead."""
    cfg = js.Stam2DConfig(n=128, advect_band=8)
    tc = interop.stam2d_config_from_dict(cfg.asdict())
    rng = np.random.default_rng(3)
    q0 = rng.random((128, 128), dtype=np.float32)
    uu = (rng.random((128, 128)) * 0.2 - 0.1).astype(np.float32)
    vv = (rng.random((128, 128)) * 0.3 - 0.15).astype(np.float32)

    banded, ovf = jax.jit(jsp.make_advect_pallas(cfg, interpret=True))(
        q0, uu, vv)
    exact = jax.jit(lambda q, u, v: js._advect(cfg, q, u, v))(q0, uu, vv)
    got = ts._advect(tc, *map(torch.tensor, (q0, uu, vv))).numpy()

    n = cfg.n
    deta = (cfg.eta_max - cfg.eta_min) / n
    eta = cfg.eta_min + (np.arange(1, n + 1) - 0.5) * deta
    tarr = np.clip((eta[:, None] - cfg.dt * vv / np.exp(eta)[:, None]
                    - cfg.eta_min) / deta + 0.5, 0.5, n + 0.5)
    disp = np.floor(tarr).astype(int) - 1 - np.arange(n)[:, None]
    in_band = np.abs(disp) <= cfg.advect_band
    assert int(ovf) == int((~in_band).sum()) > 0
    assert np.abs(got - np.asarray(banded))[in_band].max() < 1e-4
    assert np.abs(got - np.asarray(exact))[~in_band].max() < 1e-5
    # the band did clamp those cells: JAX's kernel differs there
    assert np.abs(np.asarray(banded) - np.asarray(exact))[~in_band].max() \
        > 1e-3


@pytest.mark.parametrize("dtype,n", [("float64", 24), ("float32", 32)])
def test_project_matches_jax(dtype, n):
    jc = js.Stam2DConfig(n=n, dtype=dtype)
    tc = ts.Stam2DConfig(n=n, dtype=dtype)
    rng = np.random.default_rng(n)
    uu, vv = (rand(rng, n, dtype, -1.0, 1.0) for _ in range(2))
    w = jnp.asarray(js._cell_widths(jc), jc.jax_dtype)
    ru, rv = jax.jit(lambda u, v: js._project(jc, u, v, w, w))(uu, vv)
    widths = ts.metric(tc, torch.tensor(uu)).widths
    gu, gv = ts._project(
        tc, torch.tensor(uu), torch.tensor(vv), widths,
        lambda x, b, a, c: ts._lin_solve(x, b, a, c, tc.jacobi_iters))
    close(gu, ru, dtype, "u")
    close(gv, rv, dtype, "v")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [32, 96])
def test_add_source_matches_jax_for_2001_steps(dtype, n):
    """The orbiting source at step_idx 0..2000: the same integer centre
    (the cells inside the source's radius agree exactly, and the port's
    centre lies at its peak), the same fields within the bars."""
    jc = js.Stam2DConfig(n=n, dtype=dtype)
    tc = ts.Stam2DConfig(n=n, dtype=dtype)
    steps = np.arange(2001, dtype=np.int32)
    z = jnp.zeros((n, n), jc.jax_dtype)
    ju, jv, jd = jax.jit(jax.vmap(
        lambda k: js._add_source(jc, z, z, z, k)))(jnp.asarray(steps))
    ju, jv, jd = np.asarray(ju), np.asarray(jv), np.asarray(jd)
    cx, cy, _ = ts._source_centre(tc, torch.tensor(steps), tc.torch_dtype)
    zt = torch.zeros((n, n), dtype=tc.torch_dtype)
    for k in steps:
        u, v, d = ts._add_source(tc, zt, zt, zt, torch.tensor(k))
        np.testing.assert_array_equal(d.numpy() > 0, jd[k] > 0, f"step {k}")
        jj, ii = np.unravel_index(np.argmax(d.numpy()), d.shape)
        assert (ii + 1, jj + 1) == (int(cx[k]), int(cy[k])), k
        if k % 100 == 0:
            for got, ref, name in ((u, ju[k], "u"), (v, jv[k], "v"),
                                   (d, jd[k], "d")):
                close(got, ref, dtype, f"{name} step {k}")


@pytest.mark.parametrize("dtype,n", [("float64", 24), ("float32", 32)])
def test_step_and_run_match_jax_xla(dtype, n):
    jc, tc, sj, st = both(n=n, dtype=dtype, engine="xla")
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
    assert int(st3.ovf) == int(sj3.ovf) == 0


def test_matches_loop_oracle_f64():
    """tests/oracles/stam2d_oracle.py at the JAX suite's setting (n=24,
    jacobi_iters=10, 3 steps, < 1e-12): decay, the truncated orbiting
    source, warm-started Jacobi, metric projection, eta-space advection."""
    jc, tc, sj, st = both(n=24, jacobi_iters=10, dtype="float64")
    orc = Stam2DOracle(jc, *(np.asarray(getattr(sj, f)) for f in FIELDS),
                       int(sj.step_idx))
    for _ in range(3):
        st = ts.step(tc, st)
        orc.step()
    for name in ("u", "v", "d", "u0", "v0", "d0"):
        err = np.abs(getattr(st, name).numpy()
                     - getattr(orc, name)[1:-1, 1:-1]).max()
        assert err < 1e-12, (name, err)


def test_projection_reduces_divergence():
    """tests/test_burgers_sw_stam.py's gate: a Gaussian monopole's mean
    |divergence| falls below 0.75x (the Poisson stencil ignores the
    metric, so the projection reduces, not removes, it)."""
    cfg = ts.Stam2DConfig(n=64, dtype="float64")
    i = np.arange(64)[None, :] - 32.0
    j = np.arange(64)[:, None] - 32.0
    g = np.exp(-(i ** 2 + j ** 2) / 100.0)
    u = torch.tensor(g * i / 10.0)
    v = torch.tensor(g * j / 10.0)
    w = ts.metric(cfg, u).widths

    def divergence(u, v):
        pu = np.pad(u.numpy(), 1)
        pv = np.pad(v.numpy(), 1)
        wn = w.numpy()
        return -0.5 * ((pu[1:-1, 2:] - pu[1:-1, :-2]) / wn[None, :]
                       + (pv[2:, 1:-1] - pv[:-2, 1:-1]) / wn[:, None])

    u2, v2 = ts._project(cfg, u, v, w, lambda x, b, a, c: ts._lin_solve(
        x, b, a, c, cfg.jacobi_iters))
    assert np.abs(divergence(u2, v2)).mean() < \
        0.75 * np.abs(divergence(u, v)).mean()


def test_density_decays_without_negatives_and_is_deterministic():
    cfg = ts.Stam2DConfig(n=48)
    out = ts.run(cfg, ts.init(cfg, CPU), 20)
    d = out.d.numpy()
    assert np.isfinite(d).all() and d.min() >= -1e-5 and d.max() > 0
    for f in out[:6]:
        assert bool(torch.isfinite(f).all())
    assert int(out.ovf) == 0
    cfg = ts.Stam2DConfig(n=32)
    a = ts.run(cfg, ts.init(cfg, CPU), 5)
    b = ts.run(cfg, ts.init(cfg, CPU), 5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_advect_overflow_count_matches_jax(dtype):
    jc, tc, sj, st = both(n=48, dtype=dtype, advect_band=4)
    for k in range(3):
        assert int(ts.advect_overflow_count(tc, st)) == int(
            js.advect_overflow_count(jc, sj)), k
        st = ts.step(tc, st)
        sj = jax.jit(lambda s: js.step(jc, s))(sj)
    assert int(ts.advect_overflow_count(tc, st)) > 0
    assert int(ts.advect_overflow_count(tc.replace(advect_band=128),
                                        st)) == 0
    assert int(st.ovf) == 0


def test_resolve_engine():
    cuda = torch.device("cuda")   # only its type is read
    assert ts.resolve_engine(ts.Stam2DConfig(n=16), CPU) == "torch"
    for dt in ("float32", "float64"):
        for n in (512, 37):
            cfg = ts.Stam2DConfig(n=n, dtype=dt)
            assert ts.resolve_engine(cfg, cuda) == "cuda"
    assert ts.resolve_engine(ts.Stam2DConfig(n=16, engine="torch"),
                             cuda) == "torch"
    cfg = ts.Stam2DConfig(n=16, engine="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ts.resolve_engine(cfg, CPU)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ts.step(cfg, ts.init(cfg.replace(engine="torch"), CPU))
    for engine in ("pallas", "hybrid", "xla"):
        with pytest.raises(ValueError, match="engine"):
            ts.Stam2DConfig(n=16, engine=engine)
    with pytest.raises(ValueError, match="advect_band"):
        ts.Stam2DConfig(advect_band=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [16, 21])
def test_wrappers_on_cpu_are_the_plain_versions_uncounted(dtype, n):
    tc = ts.Stam2DConfig(n=n, dtype=dtype)
    st = noisy(ts.init(tc, CPU), seed=n)
    sc.reset_launches()
    for iters in (40, 7, 1):
        for a, c in ((1.0, 4.0), (0.26, 2.04)):
            x = st.u.clone()
            got = sc.lin_solve(st.u, st.v, a, c, iters)
            assert torch.equal(got, sc.lin_solve_plain(st.u, st.v, a, c,
                                                       iters))
            assert torch.equal(got, ts._lin_solve(st.u, st.v, a, c, iters))
            assert torch.equal(st.u, x)   # x is not written
    for scale in (1.0, 30.0):
        uu, vv = st.u0 * scale, st.v0 * scale
        (one,) = sc.advect(tc, (st.d,), uu, vv)
        assert torch.equal(one, ts._advect(tc, st.d, uu, vv))
        pair = sc.advect(tc, (st.u0, st.v0), uu, vv)
        for got, want in zip(pair, sc.advect_plain(tc, (st.u0, st.v0), uu,
                                                   vv)):
            assert torch.equal(got, want)
    assert sc.LAUNCHES == {"lin_solve": 0, "advect": 0}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("iters", [40, 7])
def test_cuda_composition_equals_torch_engine(dtype, iters):
    """The 'cuda' engine's step through the plain versions equals the
    'torch' engine bitwise and leaves its input state unchanged."""
    tc = ts.Stam2DConfig(n=19, dtype=dtype, jacobi_iters=iters)
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
    assert sc.LAUNCHES == {"lin_solve": 0, "advect": 0}


def tiled_lin_solve(x, b, a, c, iters, tile, short=0):
    """A plain torch model of csrc/stam2d_lin_solve.cu's temporal blocking
    on an (ny, nx) field: phases of up to h sweeps; each tile's window (the
    tile and a halo of the phase's sweeps, zero outside [0, ny) x [0, nx))
    is swept in place, sweep k on the window less a ring of k cells,
    cells outside the grid set to 0; the tile of the window after the
    phase's last sweep is the phase's result there.  `short` cuts the halo
    by that many cells (and sweeps the window less a ring of min(k, halo)
    cells)."""
    tx, ty, h = tile[:3]
    ny, nx = x.shape
    src = x
    for p in range(-(-iters // h)):
        cnt = min(h, iters - p * h)
        halo = cnt - short
        dst = torch.empty_like(x)
        for y0 in range(0, ny, ty):
            for x0 in range(0, nx, tx):
                ys = torch.arange(y0 - halo, y0 + ty + halo)
                xs = torch.arange(x0 - halo, x0 + tx + halo)
                inside = (((ys >= 0) & (ys < ny))[:, None]
                          & ((xs >= 0) & (xs < nx))[None, :])
                yc, xc = ys.clamp(0, ny - 1), xs.clamp(0, nx - 1)
                zero = torch.zeros((), dtype=x.dtype)
                win = torch.where(inside, src[yc][:, xc], zero)
                bw = torch.where(inside, b[yc][:, xc], zero)
                wy, wx = win.shape
                for k in range(1, cnt + 1):
                    k = min(k, halo)
                    r = (slice(k, wy - k), slice(k, wx - k))
                    up = win[k - 1:wy - k - 1, k:wx - k]
                    dn = win[k + 1:wy - k + 1, k:wx - k]
                    lf = win[k:wy - k, k - 1:wx - k - 1]
                    rt = win[k:wy - k, k + 1:wx - k + 1]
                    new = win.clone()
                    new[r] = torch.where(inside[r], div(
                        bw[r] + a * (up + dn + lf + rt), c), zero)
                    win = new
                hy, hx = min(ty, ny - y0), min(tx, nx - x0)
                dst[y0:y0 + hy, x0:x0 + hx] = win[halo:halo + hy,
                                                  halo:halo + hx]
        src = dst
    return src


# The solve kernel's tile and sweeps a grid sync (h): kSolveTileX x
# kSolveTileY and kSolveSweeps of csrc/stam2d_lin_solve.cu (the tile
# clipped to the field; on the card the grid query reports them).
SOLVE_TILE = (64, 32, 8)


def _solve_cases():
    tx, _, h = SOLVE_TILE
    return [(n, iters) for n in (1, 3, 37, tx + 1)
            for iters in sorted({1, 2, h - 1, h, h + 1, 40})]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n, iters", _solve_cases())
def test_tiled_solve_model_is_bitwise_the_plain_solve(dtype, n, iters):
    """The kernel's tiling (its tile clipped to the field, h sweeps a
    grid sync), modelled in torch, is bitwise the plain solve: the halo of
    h cells, the zero ring and the short last phase are right."""
    dt = ts.Stam2DConfig(dtype=dtype).torch_dtype
    rng = np.random.default_rng(n * 100 + iters)
    x, b = (torch.tensor(rng.random((n, n)), dtype=dt) for _ in range(2))
    tile = (min(SOLVE_TILE[0], n), min(SOLVE_TILE[1], n), SOLVE_TILE[2])
    for a, c in ((1.0, 4.0), (0.26, 2.04)):
        ref = ts._lin_solve(x, b, a, c, iters)
        assert torch.equal(tiled_lin_solve(x, b, a, c, iters, tile), ref)
    # a smaller tile, so that the model walks many tiles and halos
    small = (5, 3, 3)
    assert torch.equal(tiled_lin_solve(x, b, 0.26, 2.04, iters, small),
                       ts._lin_solve(x, b, 0.26, 2.04, iters))


def test_tiled_solve_model_needs_its_halo():
    """With a halo one cell short of the sweeps a phase the model is no
    longer the plain solve: the test above would see a wrong halo."""
    rng = np.random.default_rng(0)
    x, b = (torch.tensor(rng.random((37, 37))) for _ in range(2))
    ref = ts._lin_solve(x, b, 1.0, 4.0, 8)
    assert torch.equal(tiled_lin_solve(x, b, 1.0, 4.0, 8, (8, 8, 4)), ref)
    assert not torch.equal(
        tiled_lin_solve(x, b, 1.0, 4.0, 8, (8, 8, 4), short=1), ref)


def test_wrapper_checks():
    tc = ts.Stam2DConfig(n=10)
    st = ts.init(tc, CPU)
    assert sc._check(u=st.u, v=st.v) == 10                     # accepted
    with pytest.raises(TypeError, match="v is"):
        sc._check(u=st.u, v=st.v.double())
    with pytest.raises(ValueError, match="shape"):
        sc._check(u=st.u, v=st.v[:-1, :-1])
    with pytest.raises(ValueError, match=r"\(n, n\)"):
        sc._check(u=st.u[:, :-1])
    with pytest.raises(ValueError, match="contiguous"):
        sc._check(u=st.u, v=st.v.t())
    with pytest.raises(TypeError, match="no kernel"):
        sc._check(u=st.u.half())
    with pytest.raises(ValueError, match="at least one sweep"):
        sc.lin_solve(st.u, st.v, 1.0, 4.0, 0)
    with pytest.raises(ValueError, match="1 or 2 fields"):
        sc.advect(tc, (st.u, st.v, st.d), st.u, st.v)
    meta = [f.to("meta") for f in (st.u, st.v)]
    with pytest.raises(ValueError, match="unsupported device"):
        sc.lin_solve(*meta, 1.0, 4.0, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        sc.advect(tc, (meta[0],), *meta)


def test_load_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path / "no-cuda")
    _build.load_library.cache_clear()
    sc.load.cache_clear()
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        sc.load()


def test_interop_round_trip_and_config_map():
    jc, tc, sj, st = both(n=8, dtype="float64", engine="hybrid",
                          jacobi_iters=6, repair_window=32, advect_band=5)
    assert (tc.engine, tc.jacobi_iters, tc.n, tc.advect_band) == (
        "cuda", 6, 8, 5)
    assert not hasattr(tc, "repair_window")
    for engine, want in (("xla", "torch"), ("pallas", "cuda"),
                         ("auto", "auto")):
        assert interop.stam2d_config_from_dict(
            js.Stam2DConfig(engine=engine).asdict()).engine == want
    back = interop.stam2d_state_to_numpy(st)
    assert len(back) == 8
    for got, ref in zip(back, sj):
        np.testing.assert_array_equal(got, np.asarray(ref))
    assert back[6].dtype == np.int32 and back[7].dtype == np.int32
    with pytest.raises(ValueError, match=r"\(n, n\)"):
        interop.stam2d_state_from_numpy(*back[:5], back[5][:-1], 0, 0,
                                        dtype=torch.float64, device=CPU)


def test_init_defaults_to_gpu():
    cfg = ts.Stam2DConfig(n=8)
    if torch.cuda.is_available():
        assert ts.init(cfg).u.is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            ts.init(cfg)
