"""Port vs JAX: the prime-graph layout (solvers/nbody_graph.py), its cell
lists (ops/cell_list.py) and the plain version of its CUDA kernel
(kernels/nbody_cuda.py).

The same seeded numpy inputs, or the same initial state carried over by
interop, go through JAX's functions and the port's.  The graph, the init
layout, the sorted incidence, the cell lists and the ranks in a cell are
held bitwise.  A repulsion is held per body against the size of its terms,
sum_j |w_ij| |d_ij| in float64 (`nbody_cuda.term_scale`): the forces of
the init layouts cancel to far below that scale, so an error relative to
|f_i| would measure cancellation, not the sum.  Bars: 1e-12 (f64) and
5e-4 (f32) of that scale; the other forces 1e-12 / 5e-4 (springs) and
1e-10 / 5e-4 (grid) of their max; whole runs 1e-10 / 5e-4 of the layout's
extent (ROADMAP.md's bars).
"""

import jax
import numpy as np
import pytest
import torch

from fluidsims_tpu.ops import cell_list as jcl
from fluidsims_tpu.solvers import nbody_graph as jng
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.kernels import _build
from fluidsims_tpu_torch.kernels import nbody_cuda as nk
from fluidsims_tpu_torch.ops import cell_list as tcl
from fluidsims_tpu_torch.ops.scalar import rdiv
from fluidsims_tpu_torch.solvers import nbody_graph as tng

torch.set_num_threads(1)
CPU = torch.device("cpu")
REP_TOL = {"float64": 1e-12, "float32": 5e-4}
GRID_TOL = {"float64": 1e-10, "float32": 5e-4}
RUN_TOL = {"float64": 1e-10, "float32": 5e-4}


def both(**kw):
    """(JAX config, port config, JAX init state, port state moved over by
    interop)."""
    jc = jng.GraphLayoutConfig(**kw)
    tc = interop.nbody_config_from_dict(jc.asdict())
    sj = jng.init(jc)
    st = interop.nbody_state_from_numpy(*(np.asarray(f) for f in sj),
                                        dtype=tc.torch_dtype, device=CPU)
    return jc, tc, sj, st


def rel(got, ref) -> float:
    """max |got - ref| / max(max |ref|, 1)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


def body_err(cfg, got, ref, pos, rows=None) -> float:
    """max over targets of |got_i - ref_i|_inf / sum_j |w_ij| |d_ij|, the
    scale taken in float64 on the positions the forces were computed
    from."""
    pos64 = torch.as_tensor(np.asarray(pos, np.float64))
    rows64 = None if rows is None else torch.as_tensor(
        np.asarray(rows, np.float64))
    scale = nk.term_scale(cfg, pos64, rows64).numpy()
    err = np.abs(np.asarray(got, np.float64)
                 - np.asarray(ref, np.float64)).max(-1)
    return float((err / np.maximum(scale, 1e-300)).max())


def brute_repulsion(cfg, pos, rows=None):
    """The float64 double-loop oracle of tests/test_nbody_graph.py (the
    leaf case of apply_repulsion_from_tree, number_fluid2d.c:399-409); a
    target that is a body of pos gets no self term."""
    pos = np.asarray(pos, np.float64)
    tgt = pos if rows is None else np.asarray(rows, np.float64)
    out = np.zeros_like(tgt)
    for i in range(tgt.shape[0]):
        d = tgt[i] - pos
        d2 = (d * d).sum(-1) + cfg.softening
        w = cfg.repulsion / (d2 * np.sqrt(d2))
        w[(d == 0).all(-1)] = 0.0
        out[i] = (w[:, None] * d).sum(0)
    return out


# ------------------------------- exact tables --------------------------------


@pytest.mark.parametrize("max_number", [20, 256, 2048])
def test_edges_incidence_bitwise(max_number):
    np.testing.assert_array_equal(tng.generate_edges(max_number),
                                  jng.generate_edges(max_number))
    assert tng.generate_edges(max_number).dtype == np.int32
    for got, ref in zip(tng._sorted_incidence(max_number),
                        jng._sorted_incidence(max_number)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("max_number", [20, 256, 2048])
@pytest.mark.parametrize("dims", [2, 3])
def test_init_bitwise(max_number, dims):
    jc = jng.GraphLayoutConfig(max_number=max_number, dims=dims)
    tc = tng.GraphLayoutConfig(max_number=max_number, dims=dims)
    for got, ref in zip(tng.init_arrays(tc), jng.init_arrays(jc)):
        np.testing.assert_array_equal(got, ref)
    st, sj = tng.init(tc, CPU), jng.init(jc)
    for got, ref in zip(st, sj):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert st.pos.dtype == torch.float32 and st.edges.dtype == torch.int32


def test_config_matches_jax():
    assert tng.GraphLayoutConfig().asdict() == jng.GraphLayoutConfig().asdict()
    assert tng.GraphLayoutConfig().n_bodies == 1 << 17
    for bad in ({"dims": 4}, {"engine": "bh"}, {"max_number": 1},
                {"grid_res": 2}):
        with pytest.raises(ValueError):
            tng.GraphLayoutConfig(**bad)


def _cids(seed, n, m):
    """Seeded int32 cell ids with many repeats and some empty cells."""
    return np.random.default_rng(seed).integers(0, m, n).astype(np.int32)


@pytest.mark.parametrize("n,m", [(1, 4), (37, 5), (500, 64), (4096, 1024)])
def test_rank_in_cell_bitwise(n, m):
    cid = _cids(n, n, m)
    got = tng._rank_in_cell(torch.from_numpy(cid), n)
    ref = jng._rank_in_cell(jax.numpy.asarray(cid), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n,cap", [(300, 16), (300, 3), (2000, 8)])
def test_cell_list_tables_bitwise(n, cap):
    """build_cell_list, cell_of, overflow_count and neighbor_indices of the
    same positions (with particles on and past the walls), capacity small
    enough to drop some."""
    rng = np.random.default_rng(n + cap)
    pos = rng.uniform(-0.1, 1.1, (n, 2))
    pos[:4] = [[0.0, 0.0], [1.0, 1.0], [0.5, 0.0], [0.999, 0.25]]
    jg = jcl.make_grid(1.0, 0.8, 0.05, cap)
    tg = tcl.make_grid(1.0, 0.8, 0.05, cap)
    assert tuple(tg) == tuple(jg)
    jl = jcl.build_cell_list(jg, jax.numpy.asarray(pos))
    tl = tcl.build_cell_list(tg, torch.from_numpy(pos))
    np.testing.assert_array_equal(tl.cid.numpy(), np.asarray(jl.cid))
    np.testing.assert_array_equal(tl.table.numpy(), np.asarray(jl.table))
    np.testing.assert_array_equal(
        tcl.cell_of(tg, torch.from_numpy(pos)).numpy(),
        np.asarray(jcl.cell_of(jg, jax.numpy.asarray(pos))))
    assert int(tcl.overflow_count(tg, tl)) == int(jcl.overflow_count(jg, jl))
    assert tcl.NEIGHBOR_OFFSETS == jcl.NEIGHBOR_OFFSETS
    for ox, oy in tcl.NEIGHBOR_OFFSETS:
        ti, tv = tcl.neighbor_indices(tg, tl, ox, oy)
        ji, jv = jcl.neighbor_indices(jg, jl, ox, oy)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# --------------------------- the exact repulsion -----------------------------


def _relaxed(max_number, dims, dtype, chunk, steps):
    """(jc, tc, JAX positions) after `steps` JAX steps from init."""
    jc, tc, sj, _ = both(max_number=max_number, dims=dims, dtype=dtype,
                         chunk=chunk)
    if steps:
        sj = jax.jit(lambda st: jng.run(jc, st, steps))(sj)
    return jc, tc, np.asarray(sj.pos)


REP_CASES = [(256, 64, 0), (2048, 256, 5)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("n,chunk,steps", REP_CASES)
@pytest.mark.parametrize("with_rows", [False, True])
def test_repulsion_exact_vs_jax(n, chunk, steps, dims, dtype, with_rows):
    jc, tc, pos = _relaxed(n, dims, dtype, chunk, steps)
    rows = pos[1::3].copy() if with_rows else None
    tpos = torch.from_numpy(pos)
    trows = None if rows is None else torch.from_numpy(rows)
    got = tng._repulsion_exact(tc, tpos, trows)
    ref = jng._repulsion_exact(jc, jax.numpy.asarray(pos),
                               None if rows is None
                               else jax.numpy.asarray(rows))
    assert got.dtype == tpos.dtype
    assert got.shape == (pos.shape[0] if rows is None else rows.shape[0],
                         dims)
    assert body_err(tc, got, ref, pos, rows) <= REP_TOL[dtype]
    # the wrapper on CPU tensors is the plain version, uncounted
    before = dict(nk.LAUNCHES)
    assert torch.equal(nk.repulsion_exact(tc, tpos, trows), got)
    assert dict(nk.LAUNCHES) == before


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("with_rows", [False, True])
def test_repulsion_exact_vs_brute_force(dims, with_rows):
    """The plain version in f64 against the double-loop oracle, on the
    init layout and on seeded bodies at scale 100 with two coincident."""
    jc, tc, pos = _relaxed(256, dims, "float64", 64, 0)
    rng = np.random.default_rng(dims)
    noisy = rng.normal(scale=100.0, size=(300, dims))
    noisy[7] = noisy[3]
    for p in (pos, noisy):
        rows = p[::5].copy() if with_rows else None
        got = tng._repulsion_exact(
            tc, torch.from_numpy(p),
            None if rows is None else torch.from_numpy(rows))
        assert body_err(tc, got, brute_repulsion(tc, p, rows), p,
                        rows) <= 1e-12


def test_chunk_changes_no_sum():
    """cfg.chunk only bounds memory: every chunk gives the same bits."""
    _, tc, pos = _relaxed(300, 2, "float32", 1024, 0)
    tpos = torch.from_numpy(pos)
    ref = tng._repulsion_exact(tc, tpos)
    for chunk in (1, 7, 64, 300, 4096):
        assert torch.equal(
            tng._repulsion_exact(tc.replace(chunk=chunk), tpos), ref)


def test_term_scale():
    cfg = tng.GraphLayoutConfig(max_number=20, dtype="float64")
    pos = torch.tensor(np.random.default_rng(0).normal(size=(20, 2)) * 5)
    d = pos[:, None, :] - pos[None, :, :]
    r2 = (d * d).sum(-1)
    ref = (cfg.repulsion * (r2 + cfg.softening) ** -1.5 * r2.sqrt()).sum(1)
    torch.testing.assert_close(nk.term_scale(cfg, pos), ref, rtol=1e-14,
                               atol=0)
    torch.testing.assert_close(nk.term_scale(cfg, pos, pos[3:9]), ref[3:9],
                               rtol=1e-14, atol=0)


# ------------------------------ other forces ---------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("dims", [2, 3])
def test_spring_forces_vs_jax(dims, dtype):
    jc, tc, pos = _relaxed(2048, dims, dtype, 256, 5)
    tpos = torch.from_numpy(pos)
    edges = tng.generate_edges(2048)
    tol = {"float64": 1e-12, "float32": 5e-4}[dtype]
    ref_static = jng._spring_forces_static(jc, jax.numpy.asarray(pos))
    assert rel(tng._spring_forces_static(tc, tpos), ref_static) <= tol
    ref_edges = jng._spring_forces(jc, jax.numpy.asarray(pos),
                                   jax.numpy.asarray(edges))
    got_edges = tng._spring_forces(tc, tpos, torch.from_numpy(edges))
    assert rel(got_edges, ref_edges) <= tol
    # the two formulations agree, and the root gets no spring force
    assert rel(got_edges, ref_static) <= tol
    assert not got_edges[0].any()


GRID_CASES = [
    # (max_number, dims, grid_res, near_field_max, steps): near field,
    # far field only, 3-D
    (256, 2, 16, 1 << 15, 0),
    (2048, 2, 32, 256, 5),
    (512, 3, 8, 1 << 15, 3),
]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", GRID_CASES)
def test_repulsion_grid_vs_jax(case, dtype):
    n, dims, g, nfm, steps = case
    jc, tc, sj, _ = both(max_number=n, dims=dims, grid_res=g,
                         near_field_max=nfm, engine="grid", dtype=dtype)
    if steps:
        sj = jax.jit(lambda st: jng.run(jc, st, steps))(sj)
    pos = np.asarray(sj.pos)
    rng = np.random.default_rng(n)
    scatter = rng.normal(scale=100.0, size=pos.shape).astype(pos.dtype)
    for p in (pos, scatter):
        got = tng._repulsion_grid(tc, torch.from_numpy(p))
        ref = jng._repulsion_grid(jc, jax.numpy.asarray(p))
        assert rel(got, ref) <= GRID_TOL[dtype]


# -------------------------------- whole runs ---------------------------------


# The layouts buckle out of their symmetric init: a difference of rounding
# grows about 2x a step in 2-D until the layout settles, in JAX against
# itself as much as in the port against JAX (`test_rounding_sets_the_
# horizon`).  Each case runs for as many steps as two JAX runs one ulp
# apart still agree within the bar (measured on these cases: exact 512
# 2-D crosses 5e-4 at step 18 in f32 and 1e-10 at 23-25 in f64; exact 128
# 2-D at 28-29 / 36-43; grid 256 2-D at 19-26 in f32; the 3-D cases not
# within 100 steps but grid 128 f32 at 47).
RUN_CASES = [
    # (engine, max_number, dims, grid_res, steps f32, steps f64)
    ("exact", 512, 2, 32, 12, 20),
    ("exact", 128, 2, 8, 20, 30),
    ("exact", 256, 3, 32, 100, 100),
    ("grid", 256, 2, 16, 20, 20),
    ("grid", 128, 3, 8, 30, 100),
]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", RUN_CASES)
def test_run_vs_jax(case, dtype):
    engine, n, dims, g, steps32, steps64 = case
    steps = steps32 if dtype == "float32" else steps64
    jc, tc, sj, st = both(max_number=n, dims=dims, grid_res=g, engine=engine,
                          dtype=dtype)
    ref = jax.jit(lambda s: jng.run(jc, s, steps))(sj)
    out = tng.run(tc, st, steps)
    pos_ref, vel_ref = np.asarray(ref.pos), np.asarray(ref.vel)
    extent = np.abs(pos_ref).max()
    tol = RUN_TOL[dtype]
    assert np.abs(out.pos.numpy() - pos_ref).max() <= tol * extent
    # a step moves a body by v dt: the same bar, in velocity
    assert np.abs(out.vel.numpy() - vel_ref).max() <= tol * extent / tc.dt
    assert int(out.steps) == steps == int(ref.steps)
    assert out.steps.dtype == torch.int32
    assert torch.equal(out.edges, st.edges)
    # JAX's invariants: finite, root pinned, speed clamp
    assert torch.isfinite(out.pos).all() and torch.isfinite(out.vel).all()
    assert not out.pos[0].any() and not out.vel[0].any()
    speed = torch.linalg.vector_norm(out.vel.double(), dim=-1)
    assert (speed <= tc.max_speed * (1 + 1e-6)).all()


def test_rounding_sets_the_horizon():
    """Why the whole runs stop where they do: JAX's own 2-D exact run from
    an init one ulp away leaves the f32 bar within 30 steps, as the port's
    run does, while both are within it at the 12 steps of test_run_vs_jax."""
    jc, tc, sj, st = both(max_number=512, dtype="float32")
    p = np.asarray(sj.pos).copy()
    p[1:] = np.nextafter(p[1:], np.inf)
    sj_ulp = sj._replace(pos=jax.numpy.asarray(p))
    run = jax.jit(lambda s, k: jng.run(jc, s, k), static_argnums=1)
    for steps, inside in ((12, True), (30, False)):
        ref = np.asarray(run(sj, steps).pos)
        bar = RUN_TOL["float32"] * np.abs(ref).max()
        d_jax = np.abs(np.asarray(run(sj_ulp, steps).pos) - ref).max()
        d_port = np.abs(tng.run(tc, st, steps).pos.numpy() - ref).max()
        assert (d_jax <= bar) == inside and (d_port <= bar) == inside


def test_layout_expands_and_settles():
    """tests/test_nbody_graph.py's dynamics case on the port: 100 steps of
    the exact engine from the 128-body circle."""
    cfg = tng.GraphLayoutConfig(max_number=128, grid_res=8)
    out = tng.run(cfg, tng.init(cfg, CPU), 100)
    pos = out.pos.numpy()
    assert np.isfinite(pos).all()
    np.testing.assert_allclose(pos[0], 0.0, atol=1e-6)
    v = out.vel.numpy()
    assert (np.linalg.norm(v, axis=-1) <= cfg.max_speed + 1e-3).all()
    # contracted from the init circle of radius 20 sqrt(n)
    assert np.sqrt((pos[1:] ** 2).sum(-1)).mean() < 20.0 * np.sqrt(128)


def test_repulsion_hook():
    """step(repulsion=...) takes the given function on every engine, and
    the plain version through the hook gives the default's bits on CPU
    tensors."""
    for engine in ("exact", "grid"):
        cfg = tng.GraphLayoutConfig(max_number=64, engine=engine)
        s = tng.init(cfg, CPU)
        seen = []

        def rep(pos):
            seen.append(pos.shape)
            return torch.zeros_like(pos)

        tng.step(cfg, s, repulsion=rep)
        assert seen == [(64, 2)]
    cfg = tng.GraphLayoutConfig(max_number=64)
    s = tng.init(cfg, CPU)
    plain = tng.run(cfg, s, 3, repulsion=lambda p: nk.repulsion_exact_plain(
        cfg, p))
    default = tng.run(cfg, s, 3)
    for a, b in zip(plain, default):
        assert torch.equal(a, b)


def test_speed_clamp_divides_tensor_by_tensor():
    """The clamp's max_speed / |v| is one correctly rounded division, as
    JAX's weakly typed quotient is (`ops/scalar.rdiv`); PyTorch's
    `80.0 / t` multiplies by a rounded reciprocal and misses JAX's bits on
    some of these speeds.  Velocities far past the clamp then come out of
    a step within 4 ulp of the clamp speed of JAX's, none past it."""
    jc, tc, sj, st = both(max_number=32, dtype="float32")
    rng = np.random.default_rng(3)
    vel = (rng.normal(size=(32, 2)) * 400).astype(np.float32)
    speed = torch.sqrt(torch.from_numpy((vel * vel).sum(-1)))
    ref_q = np.asarray(80.0 / jax.numpy.sqrt(jax.numpy.asarray(
        (vel * vel).sum(-1))))
    np.testing.assert_array_equal(rdiv(80.0, speed).numpy(), ref_q)
    assert ((80.0 / speed).numpy() != ref_q).any()
    sj = sj._replace(vel=jax.numpy.asarray(vel))
    st = st._replace(vel=torch.from_numpy(vel.copy()))
    ref = np.asarray(jng.step(jc, sj).vel)
    out = tng.step(tc, st).vel
    assert np.abs(out.numpy() - ref).max() <= 4 * 80 * 2.0**-23
    speed_out = torch.linalg.vector_norm(out.double(), dim=-1)
    assert (speed_out <= 80 * (1 + 1e-6)).all()


# ------------------------------ wrapper checks -------------------------------


def test_wrapper_checks():
    cfg = tng.GraphLayoutConfig(max_number=16, dims=2)
    pos = tng.init(cfg, CPU).pos
    nk._check(cfg, pos, None)                                    # accepted
    nk._check(cfg, pos, pos[2:5].contiguous())
    with pytest.raises(TypeError, match="pos is"):
        nk._check(cfg, pos.double(), None)
    with pytest.raises(TypeError, match="rows is"):
        nk._check(cfg, pos, pos[:3].double())
    with pytest.raises(ValueError, match=r"\(n, 2\)"):
        nk._check(cfg, torch.zeros(16, 3), None)
    with pytest.raises(ValueError, match=r"\(n, 2\)"):
        nk._check(cfg, pos, torch.zeros(0, 2))
    with pytest.raises(ValueError, match=r"\(n, 2\)"):
        nk._check(cfg, pos.reshape(-1), None)
    with pytest.raises(ValueError, match="contiguous"):
        nk._check(cfg, pos, pos[::2])
    with pytest.raises(ValueError, match="rows on meta"):
        nk._check(cfg, pos, pos.to("meta"))
    with pytest.raises(ValueError, match="float16"):
        nk._check(tng.GraphLayoutConfig(max_number=16, dtype="float16"),
                  pos.half(), None)
    with pytest.raises(ValueError, match="unsupported device"):
        nk.repulsion_exact(cfg, pos.to("meta"))


def test_load_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path / "no-cuda")
    _build.load_library.cache_clear()
    nk.load.cache_clear()
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        nk.load()


# --------------------------------- interop -----------------------------------


def test_interop_round_trip():
    jc, tc, sj, st = both(max_number=100, dims=3, dtype="float64",
                          engine="grid", grid_res=8, chunk=17)
    assert tc.asdict() == jc.asdict()
    back = interop.nbody_state_to_numpy(st)
    assert len(back) == 4
    for got, ref in zip(back, sj):
        np.testing.assert_array_equal(got, np.asarray(ref))
    assert back[2].dtype == np.int32 and back[3].dtype == np.int32
    with pytest.raises(ValueError, match="edges"):
        interop.nbody_state_from_numpy(back[0], back[1][:-1], back[2], 0,
                                       dtype=torch.float64, device=CPU)


def test_interop_carries_a_jax_state():
    """A JAX state after 7 JAX steps, carried over and stepped 8 more times
    by each package, gives the same layout."""
    jc, tc, sj, _ = both(max_number=300, dtype="float64")
    sj = jax.jit(lambda s: jng.run(jc, s, 7))(sj)
    st = interop.nbody_state_from_numpy(*(np.asarray(f) for f in sj),
                                        dtype=torch.float64, device=CPU)
    assert int(st.steps) == 7
    ref = jax.jit(lambda s: jng.run(jc, s, 8))(sj)
    out = tng.run(tc, st, 8)
    assert int(out.steps) == 15
    extent = np.abs(np.asarray(ref.pos)).max()
    assert np.abs(out.pos.numpy() - np.asarray(ref.pos)).max() <= (
        1e-10 * extent)


def test_init_defaults_to_gpu():
    cfg = tng.GraphLayoutConfig(max_number=8)
    if torch.cuda.is_available():
        assert tng.init(cfg).pos.is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tng.init(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            interop.nbody_state_from_numpy(*tng.init_arrays(cfg), 0,
                                           dtype=torch.float32)
