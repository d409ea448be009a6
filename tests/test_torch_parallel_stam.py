"""Port vs JAX: the sharded 2-D stable fluids
(fluidsims_tpu_torch/parallel/stam2d_sharded.py: x-slabs, the Jacobi
rounds on #9 over a rectangular slab, the advection on #10 over a column
window with its clamp count) on gloo ranks, with the cases and bars of
tests/stam_sharded_cases.py; the 3-D runner's are in
tests/test_torch_parallel_stam3d.py.

n = 32 at dt = 0.05 (calm) x 3 steps, halo_k 1, 3, 4, float32 and
float64: within JAX's bars of JAX's sharded run, bitwise to the port's
one-device plain run, ovf 0.  JAX's clamp case (dt = 1, advect_halo = 2,
1 step, float64): ovf > 0 and equal to JAX's.  The sharded solve alone
bitwise the one-device solve.  The runners' validation errors.
"""

import numpy as np
import pytest
import torch

from fluidsims_tpu_torch.parallel import launch, runners
from fluidsims_tpu_torch.solvers import stam2d as ts2
from fluidsims_tpu_torch.solvers import stam3d as ts3
from tests import stam_sharded_cases as sc

torch.set_num_threads(1)
CPU = torch.device("cpu")
LABELS = sc.labels("stam2d")
SOLVES = sc.solve_inputs(2)


@pytest.fixture(scope="module")
def ranks():
    return sc.run_ranks(LABELS, SOLVES)


@pytest.mark.parametrize("label, world", sc.params(LABELS))
def test_sharded_matches_jax_sharded(ranks, label, world):
    sc.assert_matches_jax(ranks[0][(label, world)]["state"], label, world)


@pytest.mark.parametrize("label, world", sc.params(sc.labels("stam2d",
                                                             calm=True)))
def test_sharded_bitwise_to_port_dense(ranks, label, world):
    """Bitwise the port's one-device run (the 'torch' engine, which the
    solver picks for CPU tensors), and no clamp."""
    _, _, tc, _, st = sc.inputs(label)
    got = ranks[0][(label, world)]["state"]
    dense = launch.to_numpy(runners.run_dense("stam2d", tc, st,
                                              sc.CASES[label][2]))
    for a, b in zip(got, dense):
        np.testing.assert_array_equal(a, b)
    assert int(got.ovf) == 0


@pytest.mark.parametrize("world", sc.WORLDS)
def test_clamp_count_matches_jax(ranks, world):
    """Every clamped back-trace counted once per field advected, summed
    over the ranks: ovf > 0 and equal to JAX's."""
    got = ranks[0][("stam2d_clamp", world)]["state"]
    assert int(got.ovf) > 0
    assert int(got.ovf) == int(sc.jax_sharded("stam2d_clamp", world)[-1])


@pytest.mark.parametrize("world", sc.WORLDS)
@pytest.mark.parametrize("i", range(len(SOLVES)))
def test_sharded_solve_bitwise(ranks, i, world):
    """The sharded Jacobi solve alone (40 sweeps in rounds of halo_k) is
    bitwise the one-device solve."""
    np.testing.assert_array_equal(ranks[1][(i, world)],
                                  sc.one_device_solve(SOLVES[i]))


def test_rejects_bad_configs():
    """JAX's validation errors: 2-D n % D and halos outside [1, n/D]; 3-D
    odd jacobi_iters, advect_k < 1, advect_k + 1 > Zp/D and halo_k
    outside [1, Zp/D]."""
    from fluidsims_tpu_torch.parallel import stam2d_sharded as s2s
    from fluidsims_tpu_torch.parallel import stam3d_sharded as s3s
    from fluidsims_tpu_torch.parallel.mesh import Mesh

    m4 = Mesh(("x",), (4,), 0, CPU, "gloo")
    bad2 = [(dict(n=30), {}), (dict(n=32), dict(halo_k=0)),
            (dict(n=32), dict(halo_k=9)), (dict(n=32), dict(advect_halo=9)),
            (dict(n=32), dict(advect_halo=0))]
    for fields, opts in bad2:
        with pytest.raises(ValueError):
            s2s.make_sharded_run(ts2.Stam2DConfig(**fields), m4, 1, **opts)
    s2s.make_sharded_run(ts2.Stam2DConfig(n=32), m4, 1, halo_k=8,
                         advect_halo=8)
    # n = 16: Zp = 20, B = 5 at world 4
    bad3 = [(dict(n=16, jacobi_iters=11), {}), (dict(n=16, advect_k=0), {}),
            (dict(n=16, advect_k=5), {}), (dict(n=16), dict(halo_k=6)),
            (dict(n=16), dict(halo_k=0))]
    for fields, opts in bad3:
        with pytest.raises(ValueError):
            s3s.make_sharded_run(ts3.Stam3DConfig(**fields), m4, 1, **opts)
    s3s.make_sharded_run(ts3.Stam3DConfig(n=16, advect_k=4), m4, 1,
                         halo_k=5)
    assert s3s.padded_z(192, 4) == 196 and s3s.padded_z(11, 4) == 16
