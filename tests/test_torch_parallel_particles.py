"""Port vs JAX: the sharded particle runners
(fluidsims_tpu_torch/parallel/flip_sharded.py, mpm_sharded.py,
nbody_sharded.py) on gloo ranks.

One spawn per world size (2 and 4) runs every case of this file on CPU
ranks (parallel/launch.spawn of parallel/runners.run_cases; the ranks
import no JAX): each rank shards the same initial state, made by JAX and
carried over by interop, and rank 0 returns the gathered result.  Each is
held to JAX's sharded run on the same world size with the configurations
and bars of tests/test_sharded_particles.py (FLIP pos atol 3e-5, vel atol
3e-4, the rasters apart by at most 4 particles; MPM pos atol 3e-5, Jp rtol
2e-4) and tests/test_nbody_graph.py:128-141 (n-body pos atol 2e-5 x the
layout's extent); and to the port's one-device run: FLIP and MPM within
the same bars (the partial P2G grids and their sum reassociate the
one-device sums), n-body bitwise (every body's sums stay on one rank).
"""

import functools

import numpy as np
import pytest
import torch

from fluidsims_tpu.parallel import flip_sharded as jfsh
from fluidsims_tpu.parallel import mpm_sharded as jmsh
from fluidsims_tpu.parallel import nbody_sharded as jnsh
from fluidsims_tpu.parallel.mesh import make_mesh_1d
from fluidsims_tpu.solvers import flip_apic as jfa
from fluidsims_tpu.solvers import mpm as jmpm
from fluidsims_tpu.solvers import nbody_graph as jng
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.parallel import flip_sharded as fsh
from fluidsims_tpu_torch.parallel import launch, runners

torch.set_num_threads(1)
CPU = torch.device("cpu")
# label -> (runner, JAX config, steps), as tests/test_sharded_particles.py
# and tests/test_nbody_graph.py
CONFIGS = {
    "flip": ("flip", lambda: jfa.FlipApicConfig(particles=4096, grid=32,
                                                jacobi=8), 5),
    "flip_scatter": ("flip", lambda: jfa.FlipApicConfig(
        particles=1024, grid=24, jacobi=8, engine="scatter"), 3),
    "mpm": ("mpm", lambda: jmpm.MPMConfig(n=4096, gx=48, gy=48), 5),
    "nbody": ("nbody", lambda: jng.GraphLayoutConfig(max_number=2048,
                                                     chunk=256), 5),
}
LABELS = list(CONFIGS)
_SOLVERS = {"flip": (jfa, jfsh, "flip"), "mpm": (jmpm, jmsh, "mpm"),
            "nbody": (jng, jnsh, "nbody")}


@functools.lru_cache(maxsize=None)
def inputs(label: str):
    """(runner, JAX config, port config, JAX initial state, port initial
    state)."""
    name, make, _ = CONFIGS[label]
    jmod, _, pre = _SOLVERS[name]
    jc = make()
    tc = getattr(interop, f"{pre}_config_from_dict")(jc.asdict())
    sj = jmod.init(jc)
    st = getattr(interop, f"{pre}_state_from_numpy")(
        *(np.asarray(f) for f in sj), dtype=tc.torch_dtype, device=CPU)
    return name, jc, tc, sj, st


def steps(label: str) -> int:
    return CONFIGS[label][2]


@pytest.fixture(scope="module")
def ranks():
    """{(label, world): the gathered result as numpy}, from one spawn of
    each world size."""
    out = {}
    for world in (2, 4):
        cases = [dict(name=inputs(lb)[0], config=inputs(lb)[2].asdict(),
                      state=inputs(lb)[4], steps=steps(lb), keep=True)
                 for lb in LABELS]
        res = launch.spawn(runners.run_cases, world, "gloo",
                           args=(cases, CPU), timeout=300)
        for lb, got in zip(LABELS, res[0]):
            out[(lb, world)] = got["state"]
    return out


@functools.lru_cache(maxsize=None)
def jax_sharded(label: str, world: int):
    name, jc, _, sj, _ = inputs(label)
    _, jsh, _ = _SOLVERS[name]
    mesh = make_mesh_1d(world, axis="b" if name == "nbody" else "p")
    out = jsh.make_sharded_run(jc, mesh, steps(label))(
        jsh.shard_state(sj, mesh))
    return type(out)(*(np.asarray(f) for f in out))


def _check(name, got, ref, n_particles):
    """The bars of tests/test_sharded_particles.py and
    tests/test_nbody_graph.py."""
    if name == "flip":
        np.testing.assert_allclose(got.pos, ref.pos, atol=3e-5)
        np.testing.assert_allclose(got.vel, ref.vel, atol=3e-4)
        assert np.abs(got.density - ref.density).sum() <= 4
        assert int(got.density.sum()) == n_particles
    elif name == "mpm":
        np.testing.assert_allclose(got.pos, ref.pos, atol=3e-5)
        np.testing.assert_allclose(got.Jp, ref.Jp, rtol=2e-4)
    else:
        scale = float(np.abs(ref.pos).max())
        np.testing.assert_allclose(got.pos, ref.pos, atol=2e-5 * scale)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("label", LABELS)
def test_sharded_matches_jax_sharded(ranks, label, world):
    name = inputs(label)[0]
    got = ranks[(label, world)]
    _check(name, got, jax_sharded(label, world), got.pos.shape[0])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("label", LABELS)
def test_sharded_matches_port_dense(ranks, label, world):
    name, _, tc, _, st = inputs(label)
    got = ranks[(label, world)]
    dense = launch.to_numpy(runners.run_dense(name, tc, st, steps(label)))
    if name == "nbody":
        for a, b in zip(got, dense):
            np.testing.assert_array_equal(a, b)
        return
    perm = fsh.interleave_perm(got.pos.shape[0], world)
    ref = type(dense)(*(f[perm] if f.shape[:1] == perm.shape else f
                        for f in dense))
    _check(name, got, ref, got.pos.shape[0])


def test_interleave_perm():
    """tests/test_sharded_particles.py's case, and JAX's permutation."""
    perm = fsh.interleave_perm(12, 4)
    assert list(perm[:3]) == [0, 4, 8] and list(perm[3:6]) == [1, 5, 9]
    assert sorted(perm) == list(range(12))
    np.testing.assert_array_equal(perm, jfsh.interleave_perm(12, 4))


def test_rejects_indivisible_and_other_engines():
    """Particle counts that do not split over the ranks raise, as in JAX,
    and the n-body runner takes only the exact engine."""
    from fluidsims_tpu_torch.parallel import mpm_sharded as msh
    from fluidsims_tpu_torch.parallel import nbody_sharded as nsh
    from fluidsims_tpu_torch.parallel.mesh import Mesh
    from fluidsims_tpu_torch.solvers import flip_apic as tfa
    from fluidsims_tpu_torch.solvers import mpm as tmpm
    from fluidsims_tpu_torch.solvers import nbody_graph as tng

    def mesh(n, axis):
        return Mesh((axis,), (n,), 0, CPU, "gloo")

    with pytest.raises(ValueError):
        fsh.make_sharded_run(tfa.FlipApicConfig(particles=1001, grid=16),
                             mesh(4, "p"), 1)
    with pytest.raises(ValueError):
        msh.make_sharded_run(tmpm.MPMConfig(n=1001), mesh(4, "p"), 1)
    with pytest.raises(ValueError):
        nsh.make_sharded_run(tng.GraphLayoutConfig(max_number=1001),
                             mesh(4, "b"), 1)
    with pytest.raises(ValueError):
        nsh.make_sharded_run(tng.GraphLayoutConfig(max_number=1024,
                                                   engine="grid"),
                             mesh(4, "b"), 1)
