"""Port vs JAX: the flagship device math (ops/limiters, ops/euler2d,
ops/riemann, ops/sdf) on random float64 inputs with degenerate cases.

Inputs are made once with seeded numpy and handed to both packages.  Each
result is held to JAX at |err| / max(|ref|, 1) <= 1e-13 (the scaling of
tests/test_hypersonic2d.py:84-85) over finite entries, with NaN and inf in
the same places.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.ops import euler2d as je
from fluidsims_tpu.ops import limiters as jl
from fluidsims_tpu.ops import riemann as jr
from fluidsims_tpu.ops import sdf as jsdf
from fluidsims_tpu_torch.ops import euler2d as te
from fluidsims_tpu_torch.ops import limiters as tl
from fluidsims_tpu_torch.ops import riemann as tr
from fluidsims_tpu_torch.ops import sdf as tsdf

torch.set_num_threads(1)

GAMMA = 1.1
TOL = 1e-13


def _prims(rng, n):
    """n primitive states: random, then degenerate rows (near-vacuum,
    supersonic either way, stagnant, NaN/inf entries)."""
    rho = rng.uniform(0.05, 20.0, n)
    u = rng.normal(0.0, 15.0, n)
    v = rng.normal(0.0, 15.0, n)
    p = rng.uniform(1e-3, 200.0, n)
    k = n // 8
    rho[:k] = 1e-24 * rng.uniform(0.1, 10, k)          # near vacuum
    p[:k] = 1e-26 * rng.uniform(0.1, 10, k)
    u[k:2 * k] = 60.0 + rng.uniform(0, 5, k)            # supersonic +x
    v[2 * k:3 * k] = -60.0 - rng.uniform(0, 5, k)       # supersonic -y
    u[3 * k:4 * k] = 0.0                                # stagnant
    v[3 * k:4 * k] = 0.0
    rho[4 * k] = np.nan
    p[4 * k + 1] = np.inf
    u[4 * k + 2] = -np.inf
    v[4 * k + 3] = np.nan
    rho[4 * k + 4] = -1.0                               # below the floor
    p[4 * k + 5] = -3.0
    return np.stack([rho, u, v, p])


def _cons_of(P):
    rho, u, v, p = P
    return np.stack([rho, rho * u, rho * v,
                     p / (GAMMA - 1.0) + 0.5 * rho * (u * u + v * v)])


def _inputs(seed=7, n=256):
    rng = np.random.default_rng(seed)
    QL = _prims(rng, n)
    QR = _prims(rng, n)
    # equal left/right states in a block of faces
    QR[:, 5 * n // 8:6 * n // 8] = QL[:, 5 * n // 8:6 * n // 8]
    QC = _prims(rng, n)
    return QL, QR, QC


QL, QR, QC = _inputs()
UL, UR = _cons_of(QL), _cons_of(QR)
with np.errstate(invalid="ignore"):
    DU = UR - UL  # inf - inf entries give NaN on purpose


def jx(a):
    return jnp.asarray(a, jnp.float64)


def tt(a):
    return torch.tensor(np.asarray(a, np.float64))


def assert_match(ref, got, tol=TOL):
    """ref (JAX, array or NamedTuple) vs got (torch): NaN/inf placement
    equal, finite entries within tol of max(|ref|, 1)."""
    if isinstance(ref, tuple):
        assert len(ref) == len(got)
        for r, g in zip(ref, got):
            assert_match(r, g, tol)
        return
    r = np.asarray(ref, np.float64)
    g = got.detach().numpy().astype(np.float64) if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float64)
    assert r.shape == g.shape
    np.testing.assert_array_equal(np.isnan(r), np.isnan(g))
    np.testing.assert_array_equal(np.isposinf(r), np.isposinf(g))
    np.testing.assert_array_equal(np.isneginf(r), np.isneginf(g))
    fin = np.isfinite(r)
    err = np.abs(r[fin] - g[fin]) / np.maximum(np.abs(r[fin]), 1.0)
    assert err.size == 0 or err.max() <= tol, f"max err {err.max():.3e}"


def J(mod_nt, arr):
    return mod_nt(*(jx(a) for a in arr))


def T(mod_nt, arr):
    return mod_nt(*(tt(a) for a in arr))


@pytest.mark.parametrize("name", ["minmod", "minmod3", "mc_limiter"])
def test_limiters(name):
    rng = np.random.default_rng(3)
    a, b, c = rng.normal(0, 1, (3, 512))
    a[:16] = 0.0
    b[16:32] = a[16:32]                  # equal magnitudes
    c[32:48] = -a[32:48]
    a[48], b[49], c[50] = np.nan, np.inf, -np.inf
    args = (a, b) if name == "minmod" else (a, b, c)
    assert_match(getattr(jl, name)(*map(jx, args)), getattr(tl, name)(*map(tt, args)))


def test_cons_prim_roundtrip_and_sound_speed():
    for U in (UL, UR):
        assert_match(je.cons_to_prim(J(je.Cons, U), GAMMA),
                     te.cons_to_prim(T(te.Cons, U), GAMMA))
    for P in (QL, QC):
        assert_match(je.prim_to_cons(J(je.Prim, P), GAMMA),
                     te.prim_to_cons(T(te.Prim, P), GAMMA))
        assert_match(je.sound_speed(J(je.Prim, P), GAMMA),
                     te.sound_speed(T(te.Prim, P), GAMMA))
        assert_match(je.clamp_prim(J(je.Prim, P)), te.clamp_prim(T(te.Prim, P)))
        assert_match(je.wall_ghost(J(je.Prim, P)), te.wall_ghost(T(te.Prim, P)))


@pytest.mark.parametrize("axis", [0, 1])
def test_flux(axis):
    assert_match(je.flux(J(je.Cons, UL), GAMMA, axis),
                 te.flux(T(te.Cons, UL), GAMMA, axis))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_inflow_prim(dtype):
    j = je.inflow_prim(GAMMA, 25.0, getattr(jnp, dtype))
    t = te.inflow_prim(GAMMA, 25.0, getattr(torch, dtype))
    for a, b in zip(j, t):
        assert b.dtype == getattr(torch, dtype) and b.shape == ()
        assert np.asarray(a).tobytes() == b.numpy().tobytes()


def test_cons_helpers():
    a, b = J(je.Cons, UL), J(je.Cons, UR)
    x, y = T(te.Cons, UL), T(te.Cons, UR)
    sel = UL[0] > UR[0]
    assert_match(je.c_add(a, b), te.c_add(x, y))
    assert_match(je.c_sub(a, b), te.c_sub(x, y))
    assert_match(je.c_scale(0.37, a), te.c_scale(0.37, x))
    assert_match(je.c_where(jnp.asarray(sel), a, b),
                 te.c_where(torch.tensor(sel), x, y))
    assert_match(je.p_where(jnp.asarray(sel), J(je.Prim, QL), J(je.Prim, QR)),
                 te.p_where(torch.tensor(sel), T(te.Prim, QL), T(te.Prim, QR)))


def test_reconstruct_and_enforce_positive_faces():
    jm, jc, jp = J(je.Prim, QL), J(je.Prim, QC), J(je.Prim, QR)
    tm, tc, tp = T(te.Prim, QL), T(te.Prim, QC), T(te.Prim, QR)
    assert_match(je.reconstruct_faces(jm, jc, jp), te.reconstruct_faces(tm, tc, tp))
    assert_match(je.enforce_positive_faces(jm, jc, jp),
                 te.enforce_positive_faces(tm, tc, tp))


@pytest.mark.parametrize("half_dt", [0.0, 1e-3, 0.05])
def test_half_step_predict(half_dt):
    dF = J(je.Cons, DU)
    assert_match(
        je.half_step_predict(J(je.Prim, QL), dF, jx(half_dt), GAMMA),
        te.half_step_predict(T(te.Prim, QL), T(te.Cons, DU), tt(half_dt),
                             GAMMA))


@pytest.mark.parametrize("solver", ["hlle", "hllc"])
@pytest.mark.parametrize("axis", [0, 1])
def test_riemann(solver, axis):
    j = getattr(jr, solver)(J(je.Cons, UL), J(je.Cons, UR), GAMMA, axis)
    t = getattr(tr, solver)(T(te.Cons, UL), T(te.Cons, UR), GAMMA, axis)
    assert_match(j, t)


def test_riemann_equal_states_give_physical_flux():
    j = jr.hllc(J(je.Cons, UL), J(je.Cons, UL), GAMMA, 0)
    t = tr.hllc(T(te.Cons, UL), T(te.Cons, UL), GAMMA, 0)
    assert_match(j, t)


def test_sdfs():
    rng = np.random.default_rng(11)
    x, y, z = rng.uniform(-120, 300, (3, 2000))
    Rb, Rn, th = 1024 / 12, 1024 / 24, np.pi / 4
    assert tsdf.spherecone_xb(Rb, Rn, th) == jsdf.spherecone_xb(Rb, Rn, th)
    assert_match(jsdf.sd_sphere_cone_capsule(jx(x), jx(y), Rb, Rn, th),
                 tsdf.sd_sphere_cone_capsule(tt(x), tt(y), Rb, Rn, th))
    assert_match(jsdf.sd_segment(jx(x), jx(y), 1.0, -2.0, 40.0, 70.0),
                 tsdf.sd_segment(tt(x), tt(y), 1.0, -2.0, 40.0, 70.0))
    assert_match(jsdf.sd_circle(jx(x), jx(y), 3.0, -4.0, 50.0),
                 tsdf.sd_circle(tt(x), tt(y), 3.0, -4.0, 50.0))
    assert_match(jsdf.sd_sphere(jx(x), jx(y), jx(z), 3.0, -4.0, 5.0, 50.0),
                 tsdf.sd_sphere(tt(x), tt(y), tt(z), 3.0, -4.0, 5.0, 50.0))
