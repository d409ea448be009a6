"""Port vs JAX: the sharded periodic and τ-clock runners
(fluidsims_tpu_torch/parallel/periodic_sharded.py: Gray–Scott and LBM;
tau_sharded.py: Burgers and shallow water; mhd_sharded.py) on gloo ranks.

One spawn per world size (2 and 4) runs every case of this file on CPU
ranks (tests/parallel_ranks.family; the ranks import no JAX): each rank
shards the same initial state, made by JAX and carried over by interop,
and rank 0 returns the gathered result.  Each is held to JAX's sharded run
on the same world size with the configurations of
tests/test_periodic_sharded.py: Gray–Scott and LBM in float32 within its
rtol 1e-6 / atol 1e-7; Burgers, shallow water and MHD, which JAX's test
holds bitwise to JAX's own dense run, in float64 within rtol 1e-10 / atol
1e-12 (in float32 the two frameworks' roundings part by more than JAX's
bars after 7 MUSCL steps, in the one-device runs alike); and every runner,
in float32 and float64, bitwise to the port's one-device plain run.

The 'cuda' engine's composition (halo = block_k around a K-step launch,
then the one-step launches of the remainder) runs here with the K-step
kernels' tile models (tests/oracles/gs_tiles.py, lbm_tiles.py) as the
local K-step: their windows, tile rule and periodic wrap on a slab of
nx / world + 2K columns must leave the cropped columns bitwise those of
the one-device run.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from fluidsims_tpu.parallel import mhd_sharded as jmsh
from fluidsims_tpu.parallel import tau_sharded as jtau
from fluidsims_tpu.parallel.mesh import make_mesh_1d
from fluidsims_tpu.parallel.periodic_sharded import (
    make_sharded_periodic_run, shard_arrays)
from fluidsims_tpu.solvers import burgers as jbg
from fluidsims_tpu.solvers import gray_scott as jgs
from fluidsims_tpu.solvers import lbm as jlbm
from fluidsims_tpu.solvers import mhd as jmhd
from fluidsims_tpu.solvers import shallow_water as jsw
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.parallel import launch, runners
from tests import parallel_ranks
from tests.oracles import gs_tiles, lbm_tiles

torch.set_num_threads(1)
CPU = torch.device("cpu")
N = 7  # tests/test_periodic_sharded.py N_STEPS
# label -> (runner, JAX config)
CONFIGS = {
    "gray_scott": ("gray_scott", lambda: jgs.GrayScottConfig(nx=64, ny=32)),
    "lbm": ("lbm", lambda: jlbm.LBMConfig(nx=64, ny=32, obstacle=False,
                                          drive=1e-4)),
    "burgers": ("burgers", lambda: jbg.BurgersConfig(
        nx=64, ny=32, muscl=False, visc_substeps=2)),
    "burgers_muscl": ("burgers", lambda: jbg.BurgersConfig(
        nx=64, ny=32, muscl=True, visc_substeps=2)),
    "shallow_water": ("shallow_water",
                      lambda: jsw.ShallowWaterConfig(nx=64, ny=32)),
    "mhd": ("mhd", lambda: jmhd.MHDConfig(nx=64, ny=44, problem="orszag-tang",
                                          stable_hll=True)),
}
# float64 twins of the τ-clock and MHD cases, which are held to JAX
for _lb in ("burgers", "burgers_muscl", "shallow_water", "mhd"):
    CONFIGS[_lb + "_f64"] = (CONFIGS[_lb][0], functools.partial(
        lambda make: dataclasses.replace(make(), dtype="float64"),
        CONFIGS[_lb][1]))
LABELS = list(CONFIGS)
JAX_LABELS = ["gray_scott", "lbm", "burgers_f64", "burgers_muscl_f64",
              "shallow_water_f64", "mhd_f64"]
# K-step compositions: label -> (runner, JAX config, K, steps); Gray–Scott
# as tests/test_periodic_sharded.py's communication-avoiding case
KSTEP = {
    "gray_scott_k4": ("gray_scott",
                      lambda: jgs.GrayScottConfig(nx=480, ny=32), 4, 12),
    "lbm_k3": ("lbm", lambda: jlbm.LBMConfig(nx=64, ny=32, obstacle=False,
                                              drive=1e-4), 3, N),
}
_INTEROP = {"gray_scott": "gs", "lbm": "lbm", "burgers": "burgers",
            "shallow_water": "sw", "mhd": "mhd"}


@functools.lru_cache(maxsize=None)
def inputs(label: str):
    """(runner, JAX config, port config, JAX initial state, port initial
    state)."""
    name, make = (CONFIGS[label] if label in CONFIGS else KSTEP[label][:2])
    jc = make()
    pre = _INTEROP[name]
    tc = getattr(interop, f"{pre}_config_from_dict")(jc.asdict())
    sj = {"gray_scott": jgs, "lbm": jlbm, "burgers": jbg,
          "shallow_water": jsw, "mhd": jmhd}[name].init(jc)
    if name == "mhd":
        st = interop.mhd_state_from_numpy([np.asarray(f) for f in sj.U],
                                          np.asarray(sj.t),
                                          dtype=tc.torch_dtype, device=CPU)
    else:
        st = getattr(interop, f"{pre}_state_from_numpy")(
            *(np.asarray(f) for f in sj), dtype=tc.torch_dtype, device=CPU)
    return name, jc, tc, sj, st


@pytest.fixture(scope="module")
def ranks():
    """{(label, world): the gathered result as numpy}, from one spawn of
    each world size."""
    out = {}
    for world in (2, 4):
        cases = [dict(name=inputs(lb)[0], config=inputs(lb)[2].asdict(),
                      state=inputs(lb)[4], steps=N, keep=True)
                 for lb in LABELS]
        kcases = [(inputs(lb)[0], inputs(lb)[2].asdict(), inputs(lb)[4], k, n)
                  for lb, (_, _, k, n) in KSTEP.items()]
        res, kres = launch.spawn(parallel_ranks.family, world, "gloo",
                                 args=(cases, kcases), timeout=300)[0]
        for lb, got in zip(LABELS, res):
            out[(lb, world)] = got["state"]
        for lb, got in zip(KSTEP, kres):
            out[(lb, world)] = got
    return out


def _local_jax(make_cfg, n_dev, halo, k):
    """JAX's local body of tests/test_periodic_sharded.py for a slab of
    nx / n_dev + 2 halo columns: k one-device steps."""
    jc = make_cfg()
    nxl = jc.nx // n_dev + 2 * halo
    if isinstance(jc, jgs.GrayScottConfig):
        ce = jgs.GrayScottConfig(nx=nxl, ny=jc.ny, dx=jc.dx, dt=jc.dt,
                                 Du=jc.Du, Dv=jc.Dv, feed=jc.feed,
                                 kill=jc.kill)

        def local(ext):
            st = jgs.GrayScottState(u=ext[0], v=ext[1])
            for _ in range(k):
                st = jgs.step(ce, st)
            return (st.u, st.v)
        return local
    ce = jlbm.LBMConfig(nx=nxl, ny=jc.ny, tau=jc.tau, drive=jc.drive,
                        obstacle=False)

    def local(ext):
        f, solid = ext
        out = jlbm.step(ce, jlbm.LBMState(f=f, solid=solid > 0.5))
        return (out.f, out.solid.astype(f.dtype))
    return local


@functools.lru_cache(maxsize=None)
def jax_sharded(label: str, world: int):
    """JAX's sharded run of `label` on `world` devices, as numpy leaves in
    the port state's order."""
    mesh = make_mesh_1d(world)
    if label in KSTEP:
        _, make, k, n = KSTEP[label]
        if make().nx == 480:  # Gray–Scott: n / k supersteps of halo k
            sj = inputs(label)[3]
            run = make_sharded_periodic_run(_local_jax(make, world, k, k),
                                            mesh, halo=k, n_steps=n // k)
            return [np.asarray(a) for a in run(shard_arrays((sj.u, sj.v),
                                                            mesh))]
        label = "lbm"
    name, jc, _, sj, _ = inputs(label)
    if name == "gray_scott":
        run = make_sharded_periodic_run(
            _local_jax(CONFIGS[label][1], world, 1, 1), mesh, 1, N)
        return [np.asarray(a) for a in run(shard_arrays((sj.u, sj.v), mesh))]
    if name == "lbm":
        run = make_sharded_periodic_run(
            _local_jax(CONFIGS[label][1], world, 1, 1), mesh, 1, N)
        f, solid = run(shard_arrays((sj.f, sj.solid.astype(sj.f.dtype)),
                                    mesh))
        return [np.asarray(f), np.asarray(solid) > 0.5]
    if name == "burgers":
        out = jtau.make_sharded_burgers_run(jc, mesh, N)(
            jtau.shard_burgers(sj, mesh))
    elif name == "shallow_water":
        out = jtau.make_sharded_shallow_water_run(jc, mesh, N)(
            jtau.shard_shallow_water(sj, mesh))
    else:
        out = jmsh.make_sharded_run(jc, mesh, N)(jmsh.shard_state(sj, mesh))
        return [np.asarray(f) for f in out.U] + [np.asarray(out.t)]
    return [np.asarray(f) for f in out]


def _leaves(name, state):
    if name == "mhd":
        return [np.asarray(f) for f in state.U] + [np.asarray(state.t)]
    return [np.asarray(f) for f in state]


# Bars of the port's sharded runs against JAX's (see the module docstring):
# (rtol, atol).
BARS = {"gray_scott": (1e-6, 1e-7), "lbm": (1e-6, 1e-7),
        "burgers": (1e-10, 1e-12), "shallow_water": (1e-10, 1e-12),
        "mhd": (1e-10, 1e-12)}


def _close(name, got, ref):
    rtol, atol = BARS[name]
    for a, b in zip(got, ref):
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("label", JAX_LABELS)
def test_sharded_matches_jax_sharded(ranks, label, world):
    name = inputs(label)[0]
    _close(name, _leaves(name, ranks[(label, world)]),
           jax_sharded(label, world))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("label", LABELS)
def test_sharded_bitwise_to_port_dense(ranks, label, world):
    name, _, tc, _, st = inputs(label)
    dense = launch.to_numpy(runners.run_dense(name, tc, st, N))
    for a, b in zip(_leaves(name, ranks[(label, world)]),
                    _leaves(name, dense)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("label", list(KSTEP))
def test_kstep_composition(ranks, label, world):
    """The K-step tile model as each rank's superstep: bitwise to the
    port's one-device run, and within JAX's bars of JAX's sharded run."""
    name, _, tc, _, st = inputs(label)
    _, _, k, n = KSTEP[label]
    got = ranks[(label, world)]
    dense = launch.to_numpy(runners.run_dense(name, tc, st, n))
    for a, b in zip(got, dense):
        np.testing.assert_array_equal(a, b)
    _close(name, list(got), jax_sharded(label, world))


@pytest.mark.parametrize("itemsize", [4, 8])
def test_kernel_tile_rules_take_the_slab_widths(itemsize):
    """The K-step kernels' tile rules (read from the sources by the tile
    models) give a tile for the slabs of chip_smoke.py's sharded runs at
    world 1, 2 and 4: Gray–Scott 2048^2 at K = 16, LBM 2048x1024 at K =
    8, each slab nx / world + 2K columns wide."""
    for world in (1, 2, 4):
        t = gs_tiles.kernel_tile(2048, 2048 // world + 32, 16, itemsize)
        assert 16 <= t["tile_x"] <= 2048 // world + 32 and t["tiles"] >= 1
        tx, ty = lbm_tiles.kernel_tile(1024, 2048 // world + 16, 8, itemsize)
        assert 1 <= tx <= 2048 // world + 16 and 1 <= ty <= 1024


def test_rejects_indivisible_and_thin_slabs():
    """Indivisible grids and slabs thinner than the halo raise, as in
    JAX's runners."""
    from fluidsims_tpu_torch.parallel import mhd_sharded as msh
    from fluidsims_tpu_torch.parallel import periodic_sharded as psh
    from fluidsims_tpu_torch.parallel import tau_sharded as tsh
    from fluidsims_tpu_torch.parallel.mesh import Mesh
    from fluidsims_tpu_torch.solvers import burgers as tbg
    from fluidsims_tpu_torch.solvers import gray_scott as tgs
    from fluidsims_tpu_torch.solvers import lbm as tlbm
    from fluidsims_tpu_torch.solvers import mhd as tmhd
    from fluidsims_tpu_torch.solvers import shallow_water as tsw

    m8 = Mesh(("x",), (8,), 0, CPU, "gloo")
    with pytest.raises(ValueError):
        psh.make_sharded_gray_scott_run(tgs.GrayScottConfig(nx=60), m8, 1)
    with pytest.raises(ValueError):
        psh.make_sharded_lbm_run(tlbm.LBMConfig(nx=60, ny=32), m8, 1)
    with pytest.raises(ValueError):
        tsh.make_sharded_burgers_run(tbg.BurgersConfig(nx=60, ny=8), m8, 1)
    with pytest.raises(ValueError):  # slab of 2 < halo 2 + 2 substeps
        tsh.make_sharded_burgers_run(
            tbg.BurgersConfig(nx=16, ny=8, muscl=True, visc_substeps=2),
            m8, 1)
    with pytest.raises(ValueError):
        tsh.make_sharded_shallow_water_run(
            tsw.ShallowWaterConfig(nx=60, ny=8), m8, 1)
    with pytest.raises(ValueError):
        msh.make_sharded_run(tmhd.MHDConfig(nx=60, ny=8), m8, 1)
