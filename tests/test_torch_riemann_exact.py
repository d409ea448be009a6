"""Port: the exact-Riemann (shock tube) gates of tests/test_riemann_exact.py.

Each solver runs through its entry point on CPU tensors (the plain PyTorch
versions) in the JAX gate's configuration, for its steps, and is held to
the exact Riemann solution (tests/oracles/riemann_exact.py,
tests/oracles/swe_riemann_exact.py) over its window with its bars
(tests/analytic_gates.py).  One more test holds the port's Sod end state
to JAX's at the same config, at the f64 bar of tests/test_hypersonic2d.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fluidsims_tpu.ops import euler2d as je2
from fluidsims_tpu.solvers import hypersonic2d as jh2
from tests import analytic_gates as ag

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def sod():
    return ag.sod_2d(CPU)


def test_sod_shock_tube_matches_exact(sod):
    sod.check()


def test_sod_end_state_matches_jax(sod):
    import jax.numpy as jnp

    cfg = jh2.Hypersonic2DConfig(**dataclasses.asdict(ag.tube_config(600)))
    left, right = ag.SOD
    sel = (jnp.arange(cfg.nx) < cfg.nx // 2)[None, :]

    def f(a, b):
        return jnp.where(sel, a, b).repeat(cfg.ny, 0).astype(jnp.float64)

    U = je2.prim_to_cons(je2.Prim(f(left[0], right[0]), f(left[1], right[1]),
                                  jnp.zeros((cfg.ny, cfg.nx), jnp.float64),
                                  f(left[2], right[2])), cfg.gamma)
    s = jh2.run(cfg, jh2.Hypersonic2DState(
        U=U, mask=jh2.build_mask(cfg), t=jnp.asarray(0.0, jnp.float64)),
        sod.steps)
    for got, ref in zip(sod.state.U, s.U):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                                   atol=1e-10)
    np.testing.assert_allclose(float(sod.state.t), float(s.t), rtol=1e-10)


def test_double_rarefaction_positivity_and_symmetry():
    ag.double_rarefaction(CPU).check()


def test_sod_shock_tube_3d_weno_matches_exact():
    ag.sod_3d(CPU).check()


def test_mhd_hydro_limit_matches_exact_euler():
    ag.mhd_hydro_limit(CPU).check()


def test_shallow_water_dam_break_matches_exact():
    ag.dam_break(CPU).check()
