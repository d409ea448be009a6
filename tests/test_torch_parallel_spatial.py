"""Port vs JAX: the spatially sharded FLIP/APIC and MLS-MPM runners
(fluidsims_tpu_torch/parallel/flip_spatial.py, mpm_spatial.py) and what
they share with sph_spatial.py (spatial_common.py), on gloo ranks.

One spawn per world size (2 and 4) runs every runner case of this file on
CPU ranks (parallel/launch.spawn of parallel/runners.run_cases; the ranks
import no JAX); each rank starts from the same initial state, made by JAX
and carried over by interop, and rank 0 returns the state gathered by
particle id.  At JAX's configurations (4,096 particles on 32^2 with 8
Jacobi sweeps; 4,096 on 48^2) each run is held to JAX's spatial run at the
same world size and to the port's one-device 'dense' engine, at the bars
of tests/test_sharded_particles.py:200-303 (FLIP positions atol 2e-5,
velocities 2e-4, the affine matrices 2e-2 and the raster equal; MPM
positions 2e-6, velocities, F and Jp 2e-4), with no particle lost.  Longer
runs move more than 50 particles between ranks, lose none and keep every
particle inside the walls: FLIP as JAX's test runs it (40 steps); MPM at
JAX's dt 4e-4 with the block given a drift of 1 in x, so that 30 steps
carry it across the slab edges (JAX's test takes 300 without the drift),
and held to the one-device run at the bars above.

spatial_common: `compact` against JAX's on the same rows; `migrate` (with
a migration buffer too small, so that rows drop and are counted, and with
one large enough) and the slab halo's fill and reduce, on the ranks of the
same spawns, against JAX's inside shard_map on as many CPU devices.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from fluidsims_tpu.parallel import flip_spatial as jfsp
from fluidsims_tpu.parallel import mpm_spatial as jmsp
from fluidsims_tpu.parallel import spatial_common as jsc
from fluidsims_tpu.parallel.mesh import make_mesh_1d
from fluidsims_tpu.solvers import flip_apic as jfa
from fluidsims_tpu.solvers import mpm as jmpm
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.parallel import flip_spatial as fsp
from fluidsims_tpu_torch.parallel import launch, runners
from fluidsims_tpu_torch.parallel import mpm_spatial as msp
from fluidsims_tpu_torch.parallel import spatial_common as sc
from fluidsims_tpu_torch.parallel.mesh import Mesh
from tests import parallel_ranks

torch.set_num_threads(1)
CPU = torch.device("cpu")
# label -> (runner, JAX config, steps, x drift added to the initial
# velocity), as tests/test_sharded_particles.py
CONFIGS = {
    "flip": ("flip_spatial", lambda: jfa.FlipApicConfig(
        particles=4096, grid=32, jacobi=8, engine="dense"), 5, 0.0),
    "mpm": ("mpm_spatial", lambda: jmpm.MPMConfig(n=4096, gx=48, gy=48,
                                                  engine="dense"), 5, 0.0),
    "flip_migrate": ("flip_spatial", lambda: jfa.FlipApicConfig(
        particles=4096, grid=32, jacobi=8, engine="dense"), 40, 0.0),
    "mpm_migrate": ("mpm_spatial", lambda: jmpm.MPMConfig(
        n=4096, gx=48, gy=48, dt=4.0e-4, engine="dense"), 30, 1.0),
}
LABELS = list(CONFIGS)
_SOLVERS = {"flip_spatial": (jfa, jfsp, "flip"),
            "mpm_spatial": (jmpm, jmsp, "mpm")}


@functools.lru_cache(maxsize=None)
def inputs(label: str):
    """(runner, JAX config, port config, JAX initial state, port initial
    state)."""
    name, make, _, drift = CONFIGS[label]
    jmod, _, pre = _SOLVERS[name]
    jc = make()
    tc = getattr(interop, f"{pre}_config_from_dict")(jc.asdict())
    sj = jmod.init(jc)
    sj = sj._replace(vel=sj.vel + jnp.asarray([drift, 0.0], sj.vel.dtype))
    st = getattr(interop, f"{pre}_state_from_numpy")(
        *(np.asarray(f) for f in sj), dtype=tc.torch_dtype, device=CPU)
    return name, jc, tc, sj, st


def steps(label: str) -> int:
    return CONFIGS[label][2]


@pytest.fixture(scope="module")
def spawned():
    """{world: each rank's (run_cases' results, spatial_ops' results)},
    from one spawn of each world size."""
    out = {}
    for world in (2, 4):
        cases = [dict(name=inputs(lb)[0], config=inputs(lb)[2].asdict(),
                      state=inputs(lb)[4], steps=steps(lb), keep=True)
                 for lb in LABELS]
        ops = (*spatial_inputs(world), MIG_CAPS, P_CAP, W, H)
        out[world] = launch.spawn(parallel_ranks.spatial_family, world,
                                  "gloo", args=(cases, ops), timeout=300)
    return out


@pytest.fixture(scope="module")
def ranks(spawned):
    """{(label, world): what rank 0 reported, with the gathered
    state}."""
    return {(lb, world): got for world, res in spawned.items()
            for lb, got in zip(LABELS, res[0][0])}


@functools.lru_cache(maxsize=None)
def jax_spatial(label: str, world: int):
    name, jc, _, sj, _ = inputs(label)
    _, jsp, _ = _SOLVERS[name]
    mesh = make_mesh_1d(world, axis="x")
    out = jsp.make_sharded_run(jc, mesh, steps(label))(
        jsp.shard_state(sj, jc, mesh))
    got = jsp.gather_state(out, sj.pos.shape[0])
    density = np.asarray(out.density) if name == "flip_spatial" else None
    return got, density, int(out.lost)


@functools.lru_cache(maxsize=None)
def port_dense(label: str):
    name, _, tc, _, st = inputs(label)
    return launch.to_numpy(runners.run_dense(name, tc, st, steps(label)))


def _check(name, got, ref, density_ref=None):
    """The bars of tests/test_sharded_particles.py; `ref` (pos, vel, ...)
    in particle order."""
    assert not np.isnan(got.pos).any()
    if name == "flip_spatial":
        np.testing.assert_allclose(got.pos, ref[0], rtol=0, atol=2e-5)
        np.testing.assert_allclose(got.vel, ref[1], rtol=0, atol=2e-4)
        np.testing.assert_allclose(got.affine_x, ref[2], rtol=0, atol=2e-2)
        np.testing.assert_allclose(got.affine_y, ref[3], rtol=0, atol=2e-2)
        np.testing.assert_array_equal(got.density, density_ref)
    else:
        np.testing.assert_allclose(got.pos, ref.pos, rtol=0, atol=2e-6)
        np.testing.assert_allclose(got.vel, ref.vel, rtol=0, atol=2e-4)
        np.testing.assert_allclose(got.F, ref.F, rtol=0, atol=2e-4)
        np.testing.assert_allclose(got.Jp, ref.Jp, rtol=0, atol=2e-4)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("label", ["flip", "mpm"])
def test_spatial_matches_jax_spatial(ranks, label, world):
    res = ranks[(label, world)]
    ref, density, lost = jax_spatial(label, world)
    assert res["lost"] == 0 and lost == 0
    _check(inputs(label)[0], res["state"], ref, density)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("label", ["flip", "mpm"])
def test_spatial_matches_port_dense(ranks, label, world):
    ref = port_dense(label)
    _check(inputs(label)[0], ranks[(label, world)]["state"], ref,
           getattr(ref, "density", None))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("label", ["flip_migrate", "mpm_migrate"])
def test_spatial_migrates_and_loses_nothing(ranks, label, world):
    res = ranks[(label, world)]
    assert res["lost"] == 0 and res["moved"] > 50
    pos = res["state"].pos
    assert not np.isnan(pos).any()
    if label == "flip_migrate":
        assert (pos >= 0.009).all() and (pos <= 0.991).all()
        assert int(res["state"].density.sum()) == pos.shape[0]
    else:
        dx = inputs(label)[2].dx
        assert (pos[:, 0] >= 2.0 * dx - 1e-6).all()
        assert (pos[:, 0] <= (48 - 3.0) * dx + 1e-6).all()
        _check("mpm_spatial", res["state"], port_dense(label))


@pytest.mark.parametrize("world", [1, 4])
def test_shard_state_splits_by_base_column(world):
    """Every particle in one owner buffer, in its base column's slab, in
    index order, then empty rows; FLIP's raster starts at zero."""
    for label, mod in (("flip", fsp), ("mpm", msp)):
        _, _, tc, _, st = inputs(label)
        n = st.pos.shape[0]
        seen = []
        for r in range(world):
            s = mod.shard_state(st, tc, Mesh(("x",), (world,), r, CPU,
                                             "gloo"))
            live = s.ids >= 0
            k = int(live.sum())
            assert bool(live[:k].all()) and not bool(live[k:].any())
            ids = s.ids[:k].long()
            assert torch.equal(s.pos[:k], st.pos[ids])
            W = (tc.grid if label == "flip" else tc.gx) // world
            assert bool((mod._base_col(tc, s.pos[:k, 0]) // W == r).all())
            assert s.pos.shape[0] == sc.owner_cap(n, world, 4.0)
            seen.append(ids)
        assert torch.equal(torch.sort(torch.cat(seen)).values,
                           torch.arange(n))


def test_rejections():
    """A grid that the ranks do not divide, a slab narrower than the halo
    plus one, and ids past the float payload's integers."""
    def mesh(n):
        return Mesh(("x",), (n,), 0, CPU, "gloo")

    with pytest.raises(ValueError, match="not divisible"):
        fsp.make_sharded_run(inputs("flip")[2], mesh(3), 1)
    with pytest.raises(ValueError, match="halo"):
        fsp.make_sharded_run(inputs("flip")[2], mesh(16), 1)
    with pytest.raises(ValueError, match="not divisible"):
        msp.make_sharded_run(inputs("mpm")[2], mesh(5), 1)
    with pytest.raises(ValueError, match="halo"):
        msp.make_sharded_run(inputs("mpm")[2], mesh(24), 1)
    with pytest.raises(ValueError, match="2\\^24"):
        fsp.make_sharded_run(inputs("flip")[2].replace(particles=1 << 24),
                             mesh(2), 1)
    with pytest.raises(ValueError, match="2\\^24"):
        msp.make_sharded_run(inputs("mpm")[2].replace(n=1 << 24), mesh(2), 1)


# ------------------------------ spatial_common -------------------------------


@pytest.mark.parametrize("cap", [3, 10, 40])
def test_compact_matches_jax(cap):
    rng = np.random.default_rng(cap)
    vals = rng.standard_normal((24, 3)).astype(np.float32)
    keep = rng.random(24) < 0.6
    fill = np.array([9.0, 8.0, -1.0], np.float32)
    buf, dropped = sc.compact(torch.from_numpy(vals), torch.from_numpy(keep),
                              cap, torch.from_numpy(fill))
    jbuf, jdropped = jsc.compact(jnp.asarray(vals), jnp.asarray(keep), cap,
                                 jnp.asarray(fill))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    assert int(dropped) == int(jdropped) == max(int(keep.sum()) - cap, 0)
    assert sc.owner_cap(1000, 4, 4.0) == jsc.owner_cap(1000, 4, 4.0) == 1000


ROWS, P_CAP, W, H = 24, 24, 4, 2
MIG_CAPS = (3, 24)


def spatial_inputs(world: int):
    """Each rank's payload (x, y, v, id: unique ids, some rows empty),
    owners up to two slabs away (clipped to the mesh), and a (3, W + 2H)
    grid."""
    rng = np.random.default_rng(world)
    payloads, owners, grids = [], [], []
    for r in range(world):
        p = rng.standard_normal((ROWS, 4)).astype(np.float32)
        p[:, 3] = r * ROWS + np.arange(ROWS)
        p[rng.random(ROWS) < 0.25, 3] = -1.0
        payloads.append(p)
        owners.append(np.clip(r + rng.integers(-2, 3, ROWS), 0,
                              world - 1).astype(np.int64))
        grids.append(rng.standard_normal((3, W + 2 * H)).astype(np.float32))
    return payloads, owners, grids


@functools.lru_cache(maxsize=None)
def jax_spatial_ops(world: int):
    payloads, owners, grids = spatial_inputs(world)
    mesh = make_mesh_1d(world, axis="x")
    fill = jnp.asarray([2.0, 2.0, 0.0, -1.0], jnp.float32)

    def body(payload, owner, grid):
        d = lax.axis_index("x")
        out = []
        for cap in MIG_CAPS:
            final, ids, lost = jsc.migrate(
                payload, owner, payload[:, -1] >= 0, axis="x", d=d,
                n_dev=world, mig_cap=cap, p_cap=P_CAP, fill_row=fill)
            out += [final, ids, lost[None]]
        halo_fill, halo_reduce = jsc.make_halo_ops("x", world, d, W, H)
        return (*out, halo_fill(grid, -7.0), halo_reduce(grid))

    n_out = 3 * len(MIG_CAPS) + 2
    f = jax.shard_map(body, mesh=mesh, in_specs=(P("x"),) * 3,
                      out_specs=(P("x"),) * n_out, check_vma=False)
    res = [np.asarray(a) for a in f(
        jnp.asarray(np.concatenate(payloads)),
        jnp.asarray(np.concatenate(owners).astype(np.int32)),
        jnp.asarray(np.concatenate(grids)))]
    return [[np.split(a, world)[r] for a in res] for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_migrate_and_halo_match_jax(spawned, world):
    lost_any = 0
    for r, (_, got) in enumerate(spawned[world]):
        ref = jax_spatial_ops(world)[r]
        for k, cap in enumerate(MIG_CAPS):
            final, ids, lost = got["migrate"][cap]
            jfinal, jids, jlost = ref[3 * k:3 * k + 3]
            np.testing.assert_array_equal(final, jfinal)
            np.testing.assert_array_equal(ids, jids)
            assert int(lost) == int(jlost[0])
            lost_any += int(lost) * (cap == MIG_CAPS[0])
        np.testing.assert_array_equal(got["fill"], ref[-2])
        np.testing.assert_array_equal(got["reduce"], ref[-1])
    assert lost_any > 0   # the small buffer dropped rows, counted alike
