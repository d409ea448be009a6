"""Port vs JAX: the sharded 3-D stable fluids
(fluidsims_tpu_torch/parallel/stam3d_sharded.py: z-slabs padded to
padded_z, the Jacobi sweeps on #11 over a window of the slab with the
ring's parity from the global sweep index, the dense-shift advection,
set_bnd, projection and source in torch ops) on gloo ranks, with the
cases and bars of tests/stam_sharded_cases.py.

n = 16, advect_k = 2 x 3 steps, halo_k 1, 2, 4, float32 and float64, and
n = 11 at world 4 (the top face on another rank than its neighbour, a
rank of padding): within JAX's bars of JAX's sharded run and bitwise to
the port's one-device 'torch' run at the same advect_k.  The sharded
solve alone (12 sweeps, halo_k 1-4) bitwise the one-device solve.
"""

import numpy as np
import pytest
import torch

from fluidsims_tpu_torch.parallel import launch, runners
from tests import stam_sharded_cases as sc

torch.set_num_threads(1)
LABELS = sc.labels("stam3d")
SOLVES = sc.solve_inputs(3)


@pytest.fixture(scope="module")
def ranks():
    return sc.run_ranks(LABELS, SOLVES)


@pytest.mark.parametrize("label, world", sc.params(LABELS))
def test_sharded_matches_jax_sharded(ranks, label, world):
    sc.assert_matches_jax(ranks[0][(label, world)]["state"], label, world)


@pytest.mark.parametrize("label, world", sc.params(LABELS))
def test_sharded_bitwise_to_port_dense(ranks, label, world):
    """Bitwise the port's one-device 'torch' run (runners.run_dense)."""
    _, _, tc, _, st = sc.inputs(label)
    dense = launch.to_numpy(runners.run_dense("stam3d", tc, st,
                                              sc.CASES[label][2]))
    for a, b in zip(ranks[0][(label, world)]["state"], dense):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", sc.WORLDS)
@pytest.mark.parametrize("i", range(len(SOLVES)))
def test_sharded_solve_bitwise(ranks, i, world):
    """The sharded Jacobi solve alone is bitwise the one-device solve."""
    np.testing.assert_array_equal(ranks[1][(i, world)],
                                  sc.one_device_solve(SOLVES[i]))
