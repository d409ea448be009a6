"""Port vs JAX: the pieces of the 3-D hypersonic solver, at f64.

The same seeded numpy inputs go through the JAX function and its port:
WENO5 (windowed and slab), the EOS, the Riemann solvers (generic and the
wall pair, with degenerate and non-finite inputs), the boundary padding in
both outflow modes, the cell update in both sponge modes and both wall-flux
forms, the view modes and the outflow metric.  Errors are max |err| over
max |ref| per field, with non-finite values in the same places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.ops import weno as jweno
from fluidsims_tpu.solvers import hypersonic3d as jh
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.ops import weno as tweno
from fluidsims_tpu_torch.solvers import hypersonic3d as th

torch.set_num_threads(1)
CPU = torch.device("cpu")


def close(got, ref, tol, what=""):
    """Non-finite values equal and in the same places; finite ones within
    tol * max |ref|."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    np.testing.assert_array_equal(got[~fin], ref[~fin], err_msg=what)
    if fin.any():
        scale = max(float(np.abs(ref[fin]).max()), 1e-300)
        err = float(np.abs(got[fin] - ref[fin]).max()) / scale
        assert err <= tol, f"{what}: {err:.3e} > {tol:g}"


def tt(a):
    return torch.from_numpy(np.array(a, np.float64))


def rand_prims(rng, shape):
    return [rng.uniform(0.01, 5, shape), rng.normal(0, 3, shape),
            rng.normal(0, 3, shape), rng.normal(0, 3, shape),
            rng.uniform(0.01, 10, shape), rng.uniform(0, 2, shape)]


def both(fields):
    """(JAX PrimT, port PrimT) of the same f64 numpy fields."""
    return (jh.PrimT(*(jnp.asarray(f, jnp.float64) for f in fields)),
            th.PrimT(*(tt(f) for f in fields)))


def cfgs(n=16, **kw):
    return (jh.default_config(n, dtype="float64", **kw),
            th.default_config(n, dtype="float64", **kw))


def test_config_defaults_and_validation_match():
    j, t = jh.Hypersonic3DConfig(), th.Hypersonic3DConfig()
    assert j.asdict() == t.asdict()
    assert interop.hyp3d_config_from_dict(j.asdict()) == t
    assert jh.default_config(32).asdict() == th.default_config(32).asdict()
    for bad in (dict(outflow="open"), dict(nx=0), dict(gamma_floor=1.0),
                dict(cfl=0.0), dict(u_ref=-1.0), dict(R=0.0), dict(sdf_r=0.0)):
        with pytest.raises(ValueError):
            th.Hypersonic3DConfig(**bad)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_weno5_lr_slab_and_windowed(axis):
    rng = np.random.default_rng(axis)
    shape = [7, 8, 9]
    shape[axis] = 17
    f = rng.normal(size=shape)
    f.flat[5] = np.nan
    f.flat[40] = np.inf
    Lj, Rj = jweno.weno5_lr_slab(jnp.asarray(f), axis)
    Lt, Rt = tweno.weno5_lr_slab(tt(f), axis)
    close(Lt, Lj, 1e-13, "L")
    close(Rt, Rj, 1e-13, "R")
    vs = [rng.normal(size=(40,)) for _ in range(5)]
    vs[2][3] = np.nan
    close(tweno.weno5_left(*map(tt, vs)),
          jweno.weno5_left(*map(jnp.asarray, vs)), 1e-13, "left")
    close(tweno.weno5_right(*map(tt, vs)),
          jweno.weno5_right(*map(jnp.asarray, vs)), 1e-13, "right")


def test_weno_reproduces_smooth_polynomial():
    one = [tt(1.0)] * 5
    assert abs(float(tweno.weno5_left(*one)) - 1.0) < 1e-12
    x = [tt(float(k)) for k in range(5)]
    assert abs(float(tweno.weno5_left(*x)) - 2.5) < 1e-10
    assert abs(float(tweno.weno5_right(*x)) - 1.5) < 1e-10


def test_eos_roundtrip_newton_and_evib():
    jc, tc = cfgs()
    rng = np.random.default_rng(1)
    f = rand_prims(rng, (50,))
    f[0][3] = np.nan
    f[4][7] = -1.0
    jq, tq = both(f)
    for a, b in zip(th.prim_to_cons(tc, tq), jh.prim_to_cons(jc, jq)):
        close(a, b, 1e-13, "prim_to_cons")
    for a, b in zip(th.cons_to_prim(tc, th.prim_to_cons(tc, tq)),
                    jh.cons_to_prim(jc, jh.prim_to_cons(jc, jq))):
        close(a, b, 1e-13, "roundtrip")
    T = rng.uniform(1e-3, 2.0, 50)
    T[4] = 0.0
    close(th.evib_eq(tc, tt(T)), jh.evib_eq(jc, jnp.asarray(T)), 1e-13, "evib")
    ev = np.asarray(jh.evib_eq(jc, jnp.asarray(T))) * rng.uniform(0.5, 1.5, 50)
    close(th._tv_newton(tc, tt(ev), tt(T)),
          jh._tv_newton(jc, jnp.asarray(ev), jnp.asarray(T)), 1e-13, "newton")
    Tv = th.tv_from_evib(tc, th.evib_eq(tc, tt(0.5)), tt(0.5))
    assert abs(float(Tv) - 0.5) < 5e-4
    for a, b in zip(th.axis_flux(tc, tq, 2), jh.axis_flux(jc, jq, 2)):
        close(a, b, 1e-13, "axis_flux")
    close(th.soundspeed(tc, tq), jh.soundspeed(jc, jq), 1e-13, "a")


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_hllc_flux_and_wall_flux(axis):
    jc, tc = cfgs()
    rng = np.random.default_rng(10 + axis)
    n = 64
    L, R = rand_prims(rng, (n,)), rand_prims(rng, (n,))
    for k in range(6):         # equal states
        R[k][:4] = L[k][:4]
    for k in (1, 2, 3):        # a zero-velocity pair
        L[k][4] = R[k][4] = 0.0
    L[0][5], R[4][6], L[1][7] = np.nan, np.inf, -np.inf
    (jL, tL), (jR, tR) = both(L), both(R)
    for a, b in zip(th.hllc_flux(tc, tL, tR, axis),
                    jh.hllc_flux(jc, jL, jR, axis)):
        close(a, b, 1e-13, "hllc")
    for a, b in zip(th.hllc_flux(tc, tL, tL, axis), th.axis_flux(tc, tL, axis)):
        fin = torch.isfinite(b)
        assert torch.allclose(a[fin], b[fin], rtol=1e-6, atol=1e-9)
    for left in (True, False):
        for a, b in zip(th.hllc_wall_flux(tc, tL, axis, left),
                        jh.hllc_wall_flux(jc, jL, axis, left)):
            close(a, b, 1e-13, f"wall left={left}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wall_flux_equals_generic_on_mirror_pair(dtype):
    """As tests/test_hypersonic3d.py: the specialised symmetric pair equals
    the generic solver on (q, mirror(q)) bitwise, up to +-0."""
    cfg = th.default_config(16)
    rng = np.random.default_rng(1)
    q = th.PrimT(*(torch.tensor(f, dtype=dtype)
                   for f in rand_prims(rng, (5, 6, 7))))
    for axis in range(3):
        m = th._mirror(q, axis)
        for ref, got in ((th.hllc_flux(cfg, q, m, axis),
                          th.hllc_wall_flux(cfg, q, axis, left=True)),
                         (th.hllc_flux(cfg, m, q, axis),
                          th.hllc_wall_flux(cfg, q, axis, left=False))):
            for a, b in zip(got, ref):
                assert torch.equal(a, b)


def perturbed_prims(cfg_j, seed, u0=0.05):
    """JAX init decoded, u0-seeded, with seeded noise on every field, as
    six f64 numpy arrays and the solid mask."""
    s = jh.init(cfg_j)
    q = jh._decode(cfg_j, s.xi, s.phix, s.phiy, s.phiz, s.lam, s.zet)
    rng = np.random.default_rng(seed)
    solid = np.asarray(s.solid)
    out = []
    for k, f in enumerate(q):
        f = np.array(f, np.float64)
        if k == 1:
            f = np.where(solid, f, u0)
        scale = 0.2 * np.abs(f).max() + 0.05
        f = f + np.where(solid, 0.0, scale * rng.standard_normal(f.shape))
        if k in (0, 4, 5):
            f = np.abs(f) + 1e-3
        out.append(f)
    return out, solid


@pytest.mark.parametrize("outflow", ["transmissive", "characteristic"])
def test_padded_prims_match(outflow):
    jc, tc = cfgs(12, outflow=outflow, sdf_cx=0.12)
    fields, _ = perturbed_prims(jc, 3)
    fields[1][:, :3, -1] = -0.5          # reversed outlet flow on a strip
    jq, tq = both(fields)
    jsp = jnp.asarray(jh.build_solid(jc, pad=jh.HALO))
    tsp = th.solid_pad_of(tc, CPU)
    assert np.array_equal(tsp.numpy(), np.asarray(jsp))
    assert np.asarray(jsp)[:, :, :3].any()   # the sphere crosses the halo
    jp = jax.jit(lambda q: jh._padded_prims(jc, q, jsp))(jq)
    tp = th._padded_prims(tc, tq, tsp)
    for name, a, b in zip(jh.PrimT._fields, tp, jp):
        close(a, b, 1e-14, f"padded {name}")


@pytest.fixture(scope="module")
def core_inputs():
    jc, tc = cfgs(12, sdf_cx=0.12, sponge_n=5, sponge_out_n=4)
    rng = np.random.default_rng(7)
    H = jh.HALO
    shp = (12 + 2 * H,) * 3
    fields = rand_prims(rng, shp)
    mask = jh.build_solid(jc, pad=H)
    return jc, tc, fields, mask


@pytest.mark.parametrize("sponge_mode", ["slab", "dense"])
@pytest.mark.parametrize("boxed", [False, True])
def test_step_core_padded_matches(core_inputs, sponge_mode, boxed):
    jc, tc, fields, mask = core_inputs
    jq, tq = both(fields)
    box = jh.solid_box_from_mask(mask) if boxed else "dense"
    assert th.solid_box_from_mask(torch.from_numpy(mask)) == \
        jh.solid_box_from_mask(mask)
    dt, gain = 2e-4, 0.6
    ref = jax.jit(lambda q: jh.step_core_padded(
        jc, q, jnp.asarray(mask), jnp.float64(dt), jnp.float64(gain),
        solid_box=box, sponge_mode=sponge_mode))(jq)
    got = th.step_core_padded(tc, tq, torch.from_numpy(mask), tt(dt),
                              tt(gain), solid_box=box, sponge_mode=sponge_mode)
    for name, a, b in zip(jh.PrimT._fields, got, ref):
        close(a, b, 1e-12, f"core {name}")


def test_boxed_and_dense_wall_flux_agree_bitwise(core_inputs):
    _, tc, fields, mask = core_inputs
    tq = th.PrimT(*map(tt, fields))
    sp = torch.from_numpy(mask)
    dt, gain = tt(2e-4), tt(0.6)
    dense = th.step_core_padded(tc, tq, sp, dt, gain, solid_box="dense")
    boxed = th.step_core_padded(tc, tq, sp, dt, gain,
                                solid_box=th.solid_box_from_mask(mask))
    for a, b in zip(dense, boxed):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def vis_states():
    jc, tc = cfgs(12)
    fields, solid = perturbed_prims(jc, 11)
    enc = jh._encode(jc, jh.PrimT(*(jnp.asarray(f) for f in fields)))
    js = jh.init(jc)._replace(**dict(zip(
        ("xi", "phix", "phiy", "phiz", "lam", "zet"), enc)))
    ts = interop.hyp3d_state_from_numpy(*(np.asarray(f) for f in js),
                                        dtype=torch.float64, device=CPU)
    return jc, tc, js, ts


@pytest.mark.parametrize("mode", jh.VIS_MODES)
def test_vis_field_matches(vis_states, mode):
    jc, tc, js, ts = vis_states
    assert th.VIS_MODES == jh.VIS_MODES
    got = th.vis_field(tc, ts, mode)
    close(got, jh.vis_field(jc, js, mode), 1e-12, mode)
    assert bool((got[ts.solid] == 0).all())


def test_vis_field_unknown_mode_raises(vis_states):
    _, tc, _, ts = vis_states
    with pytest.raises(ValueError):
        th.vis_field(tc, ts, "nope")


def test_outflow_reflection_metric():
    cfg = th.default_config(12, dtype="float64")
    s = th.init(cfg, CPU)
    assert abs(float(th.outflow_reflection_metric(cfg, s, nprobe=6))) < 1e-12
    lam = s.lam.clone()
    lam[3, 3, -2] = np.log(0.05)
    m2 = float(th.outflow_reflection_metric(cfg, s._replace(lam=lam), 6))
    assert abs(m2 - (0.05 - cfg.inflow_p)) <= 1e-10 * 0.03
    lam3 = s.lam.clone()
    lam3[3, 3, 0] = np.log(0.05)
    assert abs(float(th.outflow_reflection_metric(
        cfg, s._replace(lam=lam3), 6))) < 1e-12


def test_solid_mask_and_init_match():
    jc, tc = cfgs(16)
    assert np.array_equal(th.build_solid(tc, pad=3), jh.build_solid(jc, pad=3))
    js, ts = jh.init(jc), th.init(tc, CPU)
    for name, a, b in zip(jh.Hypersonic3DState._fields, ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    back = interop.hyp3d_state_to_numpy(ts)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(back, js))
