"""Port vs JAX: the sharded hypersonic runners
(fluidsims_tpu_torch/parallel/hypersonic2d_sharded.py,
hypersonic2d_sharded2d.py, hypersonic3d_sharded.py) on gloo ranks.

One spawn per world size (2 and 4) runs every case of this file on CPU
ranks (parallel/launch.spawn of parallel/runners.run_cases; the ranks
import no JAX): each rank shards the same initial state, made by JAX and
carried over by interop, and rank 0 returns the gathered result.  Each is
held to JAX's sharded run on the same world size (conftest.py gives JAX 8
virtual CPU devices) within the JAX test's own tolerance
(tests/test_sharded.py, tests/test_sharded3d.py), and bitwise to the
port's one-device run.
"""

import functools

import numpy as np
import pytest
import torch

from fluidsims_tpu.parallel import hypersonic2d_sharded as jsh
from fluidsims_tpu.parallel import hypersonic2d_sharded2d as jsh2
from fluidsims_tpu.parallel import hypersonic3d_sharded as jsh3
from fluidsims_tpu.parallel.mesh import make_mesh_1d
from fluidsims_tpu.solvers import hypersonic2d as jh2
from fluidsims_tpu.solvers import hypersonic3d as jh3
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.parallel import launch, runners
from fluidsims_tpu_torch.solvers import hypersonic2d as th2

torch.set_num_threads(1)
CPU = torch.device("cpu")
N2, N3 = 5, 4  # steps of tests/test_sharded.py and test_sharded3d.py
KW2 = dict(nx=64, ny=32, geom_x0=64 / 8.0, geom_cy=32 / 2.0,
           geom_Rb=32 / 12.0, geom_Rn=32 / 24.0)
# (runner, world): the cases of the two spawns
CASES = [("hypersonic2d", 2), ("hypersonic2d", 4),
         ("hypersonic2d_mesh2d", 4), ("hypersonic3d", 2),
         ("hypersonic3d", 4)]


@functools.lru_cache(maxsize=None)
def inputs(name: str):
    """(JAX config, port config, JAX initial state, port initial state)."""
    if name == "hypersonic3d":
        jc = jh3.default_config(24)
        tc = interop.hyp3d_config_from_dict(jc.asdict())
        sj = jh3.init(jc)
        st = interop.hyp3d_state_from_numpy(
            *(np.asarray(f) for f in sj), dtype=tc.torch_dtype, device=CPU)
        return jc, tc, sj, st
    jc = jh2.Hypersonic2DConfig(**KW2)
    tc = th2.Hypersonic2DConfig(**KW2)
    sj = jh2.init(jc)
    st = interop.state_from_numpy([np.asarray(f) for f in sj.U],
                                  np.asarray(sj.mask), np.asarray(sj.t),
                                  dtype=tc.torch_dtype, device=CPU)
    return jc, tc, sj, st


def steps(name: str) -> int:
    return N3 if name == "hypersonic3d" else N2


@pytest.fixture(scope="module")
def ranks():
    """{(runner, world): the gathered result as numpy}, from one spawn of
    each world size."""
    out = {}
    for world in (2, 4):
        cases = [dict(name=n, config=inputs(n)[1].asdict(),
                      state=inputs(n)[3], steps=steps(n), keep=True,
                      mesh2d=(2, 2) if n.endswith("mesh2d") else None)
                 for n, w in CASES if w == world]
        res = launch.spawn(runners.run_cases, world, "gloo",
                           args=(cases, CPU), timeout=300)
        for case, got in zip(cases, res[0]):
            out[(case["name"], world)] = got["state"]
    return out


@functools.lru_cache(maxsize=None)
def jax_sharded(name: str, world: int):
    jc, _, sj, _ = inputs(name)
    if name == "hypersonic3d":
        mesh = make_mesh_1d(world, axis="z")
        return jsh3.make_sharded_run(jc, mesh, N3)(jsh3.shard_state(sj, mesh))
    if name == "hypersonic2d_mesh2d":
        mesh = jsh2.make_mesh_2d(2, 2)
        return jsh2.make_sharded_run(jc, mesh, N2)(jsh2.shard_state(sj, mesh))
    mesh = make_mesh_1d(world)
    return jsh.make_sharded_run(jc, mesh, N2)(jsh.shard_state(sj, mesh))


def _fields(name, state):
    if name == "hypersonic3d":
        return [np.asarray(f) for f in state[:6]] + [np.asarray(state.t),
                                                     np.asarray(state.dtau)]
    return [np.asarray(f) for f in state.U] + [np.asarray(state.t)]


@pytest.mark.parametrize("name,world", CASES)
def test_sharded_matches_jax_sharded(ranks, name, world):
    got, ref = ranks[(name, world)], jax_sharded(name, world)
    if name == "hypersonic3d":  # tests/test_sharded3d.py:31-35
        for a, b in zip(got[:6], ref[:6]):
            np.testing.assert_allclose(a, np.asarray(b), rtol=3e-6,
                                       atol=3e-6)
        np.testing.assert_allclose(float(got.t), float(ref.t), rtol=1e-6)
        np.testing.assert_allclose(float(got.dtau), float(ref.dtau),
                                   rtol=1e-6)
    elif name == "hypersonic2d":  # tests/test_sharded.py:36-40
        for a, b in zip(got.U, ref.U):
            np.testing.assert_allclose(a, np.asarray(b), rtol=2e-6,
                                       atol=2e-6)
        np.testing.assert_allclose(float(got.t), float(ref.t), rtol=1e-6)
    else:  # tests/test_sharded.py:74-79
        for a, b in zip(got.U, ref.U):
            b = np.asarray(b)
            assert (np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max() < 1e-5
        np.testing.assert_allclose(float(got.t), float(ref.t), rtol=1e-10)
    if name == "hypersonic3d":
        np.testing.assert_array_equal(got.solid, np.asarray(ref.solid))
    else:
        np.testing.assert_array_equal(got.mask, np.asarray(ref.mask))


@pytest.mark.parametrize("name,world", CASES)
def test_sharded_bitwise_to_port_dense(ranks, name, world):
    _, tc, _, st = inputs(name)
    dense = runners.run_dense(name, tc, st, steps(name))
    for a, b in zip(_fields(name, ranks[(name, world)]),
                    _fields(name, launch.to_numpy(dense))):
        np.testing.assert_array_equal(a, b)


def test_rejects_bad_splits():
    """Indivisible grids and slabs thinner than the halo raise, as in
    JAX (tests/test_sharded.py:43-47, tests/test_sharded3d.py:38-43)."""
    from fluidsims_tpu_torch.parallel import (hypersonic2d_sharded as sh,
                                              hypersonic2d_sharded2d as sh2,
                                              hypersonic3d_sharded as sh3)
    from fluidsims_tpu_torch.parallel.mesh import Mesh
    from fluidsims_tpu_torch.solvers import hypersonic3d as th3

    def mesh(n, axis):
        return Mesh((axis,), (n,), 0, CPU, "gloo")

    with pytest.raises(ValueError):
        sh.make_sharded_run(th2.Hypersonic2DConfig(**{**KW2, "nx": 60}),
                            mesh(8, "x"), 1)
    with pytest.raises(ValueError):
        sh2.make_sharded_run(th2.Hypersonic2DConfig(**KW2),
                             Mesh(("y", "x"), (3, 2), 0, CPU, "gloo"), 1)
    with pytest.raises(ValueError):
        sh3.make_sharded_run(th3.default_config(18), mesh(4, "z"), 1)
    with pytest.raises(ValueError):  # slab thinner than 2 * halo
        sh3.make_sharded_run(th3.default_config(16), mesh(4, "z"), 1)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("col", [0, 2, -1])
def test_inflow_column_of_the_plain_wavespeed(dtype, col):
    """p1's plain version with the inflow at column `col` (0: the one
    device's column, the default; HALO = 2: rank 0's extended slab; -1:
    none): the fluid cells of that column, and only they, take the inflow
    state in place, and the max wavespeed is then JAX's max_wavespeed of
    the same fields."""
    from fluidsims_tpu.ops.euler2d import Cons as JCons
    from fluidsims_tpu_torch.kernels import hypersonic2d_cuda as hk
    from fluidsims_tpu_torch.ops.euler2d import Cons

    kw = {**KW2, "dtype": dtype}
    jc, tc = jh2.Hypersonic2DConfig(**kw), th2.Hypersonic2DConfig(**kw)
    s = th2.init(tc, CPU)
    rng = np.random.default_rng(11)
    mask = s.mask.clone()
    mask[3:6, col] = True  # solid cells in the inflow column stay
    U = Cons(*(f * (1 + 0.1 * torch.tensor(rng.uniform(-1, 1, f.shape),
                                           dtype=f.dtype)) for f in s.U))
    want = Cons(*(f.clone() for f in U))
    if col >= 0:
        for f, v in zip(want, th2.inflow_cons(tc, CPU)):
            f[:, col] = torch.where(mask[:, col], f[:, col], v)
    got = Cons(*(f.clone() for f in U))
    w = hk.inflow_wavespeed(tc, got, mask, col)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(w, th2.max_wavespeed(tc, want, mask))
    ref = float(jh2.max_wavespeed(
        jc, JCons(*(np.asarray(f) for f in want)), np.asarray(mask)))
    assert abs(float(w) - ref) <= (1e-6 if dtype == "float32" else 1e-12) \
        * ref
    if col == 0:
        default = Cons(*(f.clone() for f in U))
        assert torch.equal(hk.inflow_wavespeed(tc, default, mask), w)
        assert all(torch.equal(a, b) for a, b in zip(default, want))
    for bad in (-2, tc.nx):
        with pytest.raises(ValueError):
            hk.inflow_wavespeed(tc, got, mask, bad)
