"""The mesh, its collectives and the rank driver of the port's sharded
runners (fluidsims_tpu_torch/parallel/mesh.py, halo.py, launch.py), and
every runner at world 1 in this process.

The collectives run on gloo ranks spawned once per world size (2 and 4;
tests/parallel_ranks.collectives): ppermute with zeros where no pair sends
(JAX's ppermute), the open halo exchange with edge replication and with
fills, the periodic ring, pmax, psum of a tuple, shard and gather, and a
2x2 mesh's exchanges along each axis.  launch.spawn raises when a rank
fails and refuses 'nccl' with more ranks than GPUs.  At world 1 (a gloo
process group of one, in this process) every runner equals the port's
one-device run bitwise.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fluidsims_tpu_torch.parallel import launch, runners
from fluidsims_tpu_torch.parallel.mesh import Mesh, make_mesh_1d
from tests import parallel_ranks

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def collectives():
    return {w: launch.spawn(parallel_ranks.collectives, w, "gloo",
                            args=(w,), timeout=120) for w in (2, 4)}


def _f(r):
    return np.arange(12, dtype=np.float64).reshape(3, 4) + 100 * r


@pytest.mark.parametrize("world", [2, 4])
def test_ppermute_zeros_where_no_pair_sends(collectives, world):
    for r, got in enumerate(collectives[world]):
        want = _f(r - 1) if r > 0 else np.zeros((3, 4))
        np.testing.assert_array_equal(got["shift_right"], want)
        b = (_f(r + 1).astype(np.int64) % 3 == 0) if r < world - 1 else \
            np.zeros((3, 4), bool)
        np.testing.assert_array_equal(got["bool_left"], b)
        assert got["bool_left"].dtype == bool


@pytest.mark.parametrize("world", [2, 4])
def test_open_halo_replicates_or_fills_the_edges(collectives, world):
    for r, got in enumerate(collectives[world]):
        f = _f(r)
        left = _f(r - 1)[:, -2:] if r > 0 else np.repeat(f[:, :1], 2, 1)
        right = _f(r + 1)[:, :2] if r < world - 1 else \
            np.repeat(f[:, -1:], 2, 1)
        np.testing.assert_array_equal(got["halo"],
                                      np.concatenate([left, f, right], 1))
        lf = _f(r - 1)[:, -1:] if r > 0 else np.full((3, 1), -1.0)
        rf = _f(r + 1)[:, :1] if r < world - 1 else np.full((3, 1), -2.0)
        np.testing.assert_array_equal(got["halo_fill"],
                                      np.concatenate([lf, f, rf], 1))


@pytest.mark.parametrize("world", [2, 4])
def test_ring_pmax_psum_shard_gather(collectives, world):
    for r, got in enumerate(collectives[world]):
        f = _f(r)
        ring = np.concatenate([_f((r - 1) % world)[:, -1:], f,
                               _f((r + 1) % world)[:, :1]], 1)
        np.testing.assert_array_equal(got["ring"], ring)
        assert float(got["pmax"]) == world - 1
        total = sum(_f(q) for q in range(world))
        np.testing.assert_array_equal(got["psum"][0], total)
        np.testing.assert_array_equal(got["psum"][1], 2 * total)
        np.testing.assert_array_equal(
            got["gathered"], np.arange(8 * world).reshape(2, 4 * world))


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_import_no_jax(collectives, world):
    for got in collectives[world]:
        assert got["jax_modules"] == []


def test_mesh_2d_exchanges_and_blocks(collectives):
    g = np.arange(24).reshape(4, 6)
    for r, got in enumerate(collectives[4]):
        iy, ix = got["mesh2d"]
        assert (iy, ix) == (r // 2, r % 2)
        # y: (0 -> 1) moves rank (0, ix)'s block down to (1, ix)
        want = _f(r - 2) if iy == 1 else np.zeros((3, 4))
        np.testing.assert_array_equal(got["y_down"], want)
        want = _f(r + 1) if ix == 0 else np.zeros((3, 4))
        np.testing.assert_array_equal(got["x_left"], want)
        np.testing.assert_array_equal(
            got["block"], g[2 * iy:2 * iy + 2, 3 * ix:3 * ix + 3])
        np.testing.assert_array_equal(got["unblock"], g)


def test_spawn_raises_on_a_failed_rank():
    with pytest.raises(RuntimeError, match="fails on purpose"):
        launch.spawn(parallel_ranks.failing, 2, "gloo", args=(1,),
                     timeout=120)


def test_spawn_refuses_nccl_beyond_the_gpus_and_bad_arguments():
    gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="nccl"):
        launch.spawn(parallel_ranks.failing, gpus + 1, "nccl", args=(0,))
    with pytest.raises(ValueError):
        launch.spawn(parallel_ranks.failing, 0, "gloo", args=(0,))
    with pytest.raises(ValueError):
        launch.spawn(parallel_ranks.failing, 2, "mpi", args=(0,))


def test_mesh_coordinates_and_checks():
    m = Mesh(("y", "x"), (2, 3), 4, CPU, "gloo")
    assert (m.axis_index("y"), m.axis_index("x")) == (1, 1)
    assert m.rank_at("x", 2) == 5 and m.rank_at("y", 0) == 1
    assert m.size == 6 and m.axis_size("x") == 3
    with pytest.raises(ValueError):
        Mesh(("x",), (2,), 2, CPU, "gloo")
    with pytest.raises(ValueError):
        Mesh(("x", "x"), (2, 2), 0, CPU, "gloo")
    with pytest.raises(RuntimeError if not dist.is_initialized()
                       else ValueError):
        make_mesh_1d(7)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo process group of one rank, in this process."""
    path = tmp_path_factory.mktemp("rdv") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


# runner -> (config fields, steps): the sizes of the CPU tests above
WORLD1 = {
    "hypersonic2d": (dict(nx=64, ny=32, geom_x0=8.0, geom_cy=16.0,
                          geom_Rb=32 / 12.0, geom_Rn=32 / 24.0), 5),
    "hypersonic2d_mesh2d": (dict(nx=64, ny=32, geom_x0=8.0, geom_cy=16.0,
                                 geom_Rb=32 / 12.0, geom_Rn=32 / 24.0), 5),
    "hypersonic3d": (dict(nx=24, ny=24, nz=24, dx=1 / 24, dy=1 / 24,
                          dz=1 / 24), 4),
    "gray_scott": (dict(nx=64, ny=32), 7),
    "lbm": (dict(nx=64, ny=32, obstacle=True, drive=1e-4), 7),
    "burgers": (dict(nx=64, ny=32, muscl=True, visc_substeps=2), 7),
    "shallow_water": (dict(nx=64, ny=32, dtype="float64"), 7),
    "mhd": (dict(nx=64, ny=44, problem="orszag-tang", stable_hll=True), 7),
    "flip": (dict(particles=4096, grid=32, jacobi=8), 5),
    "mpm": (dict(n=4096, gx=48, gy=48, material="mud"), 5),
    "nbody": (dict(max_number=2048, chunk=256, dims=3), 5),
}


@pytest.mark.parametrize("name", sorted(WORLD1))
def test_world1_in_process_bitwise_to_dense(world1, name):
    fields, n = WORLD1[name]
    case = dict(name=name, config=fields, steps=n, dense=True)
    if name.endswith("mesh2d"):
        case["mesh2d"] = (1, 1)
    [res] = runners.run_cases([case], CPU)
    assert res["world"] == 1 and res["bitwise"], res
    assert res["max_rel_err"] == 0.0


def test_make_mesh_1d_on_the_group(world1):
    m = make_mesh_1d(axis="z", device="cpu")
    assert (m.axes, m.shape, m.rank, m.backend) == (("z",), (1,), 0, "gloo")
    with pytest.raises(ValueError):
        make_mesh_1d(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # the default device is the GPU
            make_mesh_1d()
