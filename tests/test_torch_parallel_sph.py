"""Port vs JAX: the multi-device SPH runners
(fluidsims_tpu_torch/parallel/sph_sharded.py, sph_spatial.py) on gloo
ranks.

One spawn per world size (2 and 4) runs every case of this file on CPU
ranks (parallel/launch.spawn of parallel/runners.run_cases; the ranks
import no JAX, and take the SPH kernels' plain versions over the same
receiver ranges and windows as the kernels).  Each rank starts from the
same initial state, made by JAX and carried over by interop, and rank 0
returns the gathered result.

* sph_sharded (n = 16,384 with rain, 3 steps): held to JAX's sharded run
  at the same world size, positions at the bar of
  tests/test_sharded_particles.py (atol 1e-6) and tau equal; velocities at
  atol 2e-5, the bar that tests/test_torch_sph.py holds the port's 'cuda'
  engine to JAX's Pallas engine with (JAX's 1e-6 holds its sharded run to
  its own single-chip run, whose pair sums take the same order; the
  port's take another).  And bitwise to the port's one-device 'cuda' run:
  a receiver's sums do not depend on the range of receivers it is
  launched with.
* sph_spatial (n = 16,384 without rain, 5 steps): held to JAX's spatial
  run and to the port's one-device run, by particle id, at JAX's bars
  (positions atol 1e-5, t rtol 1e-6; the one-device run's velocities at
  1e-4 too), with no particle lost.
* migration: sph_spatial on a stirred pool (n = 4,096, seeded velocity
  noise, 10 steps) moves more than 50 particles between ranks, loses none,
  keeps every particle in the box and stays within 1e-5 of the one-device
  run.
* float64 (3 steps): sph_sharded with rain at n = 4,097 (ranges of
  sorted positions of unequal lengths: D divides neither the particles
  nor the 17 x 17 cells) bitwise to the one-device run, sph_spatial at
  n = 4,096 within 1e-12.

JAX's runs take its Pallas pair kernels, which leave out the particles
past a cell's K slots; the port keeps every pair.  So no cell of these
runs may pass K: the one-device runs are checked at every step with
`overflow_count` of the 'torch' engine, whose K is JAX's.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.parallel import sph_sharded as jssh
from fluidsims_tpu.parallel import sph_spatial as jssp
from fluidsims_tpu.parallel.mesh import make_mesh_1d
from fluidsims_tpu.solvers import sph as js
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.parallel import launch, runners
from fluidsims_tpu_torch.parallel import sph_sharded as ssh
from fluidsims_tpu_torch.parallel import sph_spatial as ssp
from fluidsims_tpu_torch.parallel.mesh import Mesh
from fluidsims_tpu_torch.solvers import sph as ts

torch.set_num_threads(1)
CPU = torch.device("cpu")
# label -> (runner, JAX config, steps, seed of a stirred velocity or None)
CONFIGS = {
    "sharded": ("sph", lambda: js.SPHConfig(n=16384, rain=True, dtau=1e-2),
                3, None),
    "spatial": ("sph_spatial", lambda: js.SPHConfig(n=16384, rain=False,
                                                    dtau=1e-2), 5, None),
    "migrate": ("sph_spatial", lambda: js.SPHConfig(n=4096, rain=False,
                                                    dtau=1e-2), 10, 11),
    "sharded_f64": ("sph", lambda: js.SPHConfig(
        n=4097, rain=True, dtau=1e-2, dtype="float64"), 3, None),
    "spatial_f64": ("sph_spatial", lambda: js.SPHConfig(
        n=4096, rain=False, dtau=1e-2, dtype="float64"), 3, None),
}
LABELS = list(CONFIGS)


@functools.lru_cache(maxsize=None)
def inputs(label: str):
    """(runner, JAX config, port config, JAX initial state, port initial
    state)."""
    name, make, _, stir = CONFIGS[label]
    jc = make()
    tc = interop.sph_config_from_dict(jc.asdict())
    sj = js.init(jc)
    if stir is not None:
        rng = np.random.default_rng(stir)
        sj = sj._replace(vel=jnp.asarray(
            0.5 * rng.standard_normal((jc.n, 2)), jnp.float32))
    st = interop.sph_state_from_numpy(*(np.asarray(f) for f in sj),
                                      dtype=tc.torch_dtype, device=CPU)
    return name, jc, tc, sj, st


def steps(label: str) -> int:
    return CONFIGS[label][2]


@pytest.fixture(scope="module")
def ranks():
    """{(label, world): (the gathered result as numpy, what rank 0
    reported)}, from one spawn of each world size."""
    out = {}
    for world in (2, 4):
        cases = [dict(name=inputs(lb)[0], config=inputs(lb)[2].asdict(),
                      state=inputs(lb)[4], steps=steps(lb), keep=True)
                 for lb in LABELS]
        res = launch.spawn(runners.run_cases, world, "gloo",
                           args=(cases, CPU), timeout=300)
        for lb, got in zip(LABELS, res[0]):
            out[(lb, world)] = got
    return out


@functools.lru_cache(maxsize=None)
def dense(label: str):
    """The port's one-device 'cuda' run (the kernels' plain versions),
    stepped one step at a time: (final state as numpy, the most particles
    past the 'torch' engine's K at any step)."""
    name, _, tc, _, st = inputs(label)
    cfg = tc.replace(engine="cuda")
    past = int(ts.overflow_count(tc.replace(engine="torch"), st))
    for _ in range(steps(label)):
        st = ts.step(cfg, st)
        past = max(past, int(ts.overflow_count(tc.replace(engine="torch"),
                                               st)))
    return launch.to_numpy(st), past


@functools.lru_cache(maxsize=None)
def jax_run(label: str, world: int):
    _, jc, _, sj, _ = inputs(label)
    mesh = make_mesh_1d(world, axis="c")
    if label == "sharded":
        out = jssh.make_sharded_run(jc, mesh, steps(label), interpret=True)(
            jssh.shard_state(sj, mesh))
        return type(out)(*(np.asarray(f) for f in out))
    out = jssp.make_sharded_run(jc, mesh, steps(label))(
        jssp.shard_state(sj, jc, mesh))
    pos, vel = jssp.gather_state(out, jc.n)
    return pos, vel, float(out.t), int(out.lost)


@pytest.mark.parametrize("label", ["sharded", "spatial"])
def test_no_cell_past_k(label):
    """JAX's Pallas sums equal the port's exact ones only where no cell
    holds more than K particles."""
    assert dense(label)[1] == 0
    _, jc, _, sj, _ = inputs(label)
    assert int(js.overflow_count(jc.replace(engine="xla"), sj)) == 0


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_matches_jax_sharded(ranks, world):
    got = ranks[("sharded", world)]["state"]
    ref = jax_run("sharded", world)
    np.testing.assert_allclose(got.pos, ref.pos, atol=1e-6)
    np.testing.assert_allclose(got.vel, ref.vel, atol=2e-5)
    np.testing.assert_array_equal(got.tau, ref.tau)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_bitwise_to_port_dense(ranks, world):
    got = ranks[("sharded", world)]["state"]
    for a, b in zip(got, dense("sharded")[0]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_spatial_matches_jax_spatial(ranks, world):
    res = ranks[("spatial", world)]
    got = res["state"]
    pos, _, t, lost = jax_run("spatial", world)
    assert res["lost"] == 0 and lost == 0
    assert not np.isnan(got.pos).any()
    np.testing.assert_allclose(got.pos, pos, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got.t), t, rtol=1e-6)


@pytest.mark.parametrize("label", ["spatial", "migrate"])
@pytest.mark.parametrize("world", [2, 4])
def test_spatial_matches_port_dense(ranks, world, label):
    got = ranks[(label, world)]["state"]
    ref = dense(label)[0]
    np.testing.assert_allclose(got.pos, ref.pos, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.vel, ref.vel, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.t, ref.t)
    np.testing.assert_array_equal(got.step_idx, ref.step_idx)


@pytest.mark.parametrize("world", [2, 4])
def test_spatial_migrates_and_loses_nothing(ranks, world):
    """The stirred pool's particles change ranks; none is lost, every one
    stays in the box; the halo is one cell column a side."""
    res = ranks[("migrate", world)]
    assert res["lost"] == 0 and res["moved"] > 50
    pos = res["state"].pos
    assert not np.isnan(pos).any()
    assert (pos >= 0).all() and (pos <= 1).all()
    halo, receivers = res["receivers"]
    assert 0 < halo < receivers


@pytest.mark.parametrize("world", [2, 4])
def test_float64(ranks, world):
    for a, b in zip(ranks[("sharded_f64", world)]["state"],
                    dense("sharded_f64")[0]):
        np.testing.assert_array_equal(a, b)
    res, ref = ranks[("spatial_f64", world)], dense("spatial_f64")[0]
    assert res["lost"] == 0 and res["state"].pos.dtype == np.float64
    np.testing.assert_allclose(res["state"].pos, ref.pos, rtol=0, atol=1e-12)
    np.testing.assert_allclose(res["state"].vel, ref.vel, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(res["state"].t, ref.t)


def test_rejections():
    """What JAX rejects (rain and XSPH for the spatial runner, XSPH for
    both, n >= 2^24) and column counts that the ranks do not divide;
    sph_sharded cuts the particles, so it takes any rank count."""
    def mesh(n):
        return Mesh(("c",), (n,), 0, CPU, "gloo")

    with pytest.raises(ValueError, match="rain"):
        ssp.make_sharded_run(ts.SPHConfig(n=16384, rain=True), mesh(4), 1)
    for mod in (ssh, ssp):
        with pytest.raises(ValueError, match="XSPH"):
            mod.make_sharded_run(ts.SPHConfig(n=16384, rain=False,
                                              use_xsph=True), mesh(4), 1)
    with pytest.raises(ValueError, match="2\\^24"):
        ssp.make_sharded_run(ts.SPHConfig(n=1 << 24, rain=False), mesh(4), 1)
    # 16,384 particles: 32 x 32 cells
    assert ssh.make_sharded_run(ts.SPHConfig(n=16384), mesh(3), 1).stats == {
        "receivers": 0, "halo": 0}
    with pytest.raises(ValueError, match="not divisible"):
        ssp.make_sharded_run(ts.SPHConfig(n=16384, rain=False), mesh(3), 1)
    with pytest.raises(ValueError, match="not divisible"):
        ssp.shard_state(ts.init(ts.SPHConfig(n=16384, rain=False), CPU),
                        ts.SPHConfig(n=16384, rain=False), mesh(5))


def test_spatial_shard_state_splits_by_column():
    """The owner buffers of a 4-rank mesh hold each particle once, in its
    column's slab, then empty rows; the capacity is owner_cap's."""
    cfg = ts.SPHConfig(n=4096, rain=False)
    st = ts.init(cfg, CPU)
    g = cfg.grid()
    col = torch.clamp(torch.floor(st.pos[:, 0] / g.cell), 0, g.Gx - 1)
    seen = []
    for r in range(4):
        s = ssp.shard_state(st, cfg, Mesh(("c",), (4,), r, CPU, "gloo"))
        live = s.ids >= 0
        k = int(live.sum())
        assert bool(live[:k].all()) and not bool(live[k:].any())
        ids = s.ids[:k].long()
        assert torch.equal(s.pos[:k], st.pos[ids])
        assert bool(((col[ids] // (g.Gx // 4)) == r).all())
        assert s.pos.shape[0] == 4 * 4096 // 4 and int(s.lost) == 0
        seen.append(ids)
    assert torch.equal(torch.sort(torch.cat(seen)).values,
                       torch.arange(cfg.n))
