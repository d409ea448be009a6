"""Port vs JAX: ops/shift.py.

The same seeded numpy arrays go through both packages' four shift
functions, for both signs of every offset and for |d| >= n where the JAX
module allows it (the wrapped shifts); the clamped shifts refuse
|d| >= n in both.  Shifts move values, so the results are bitwise equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.ops import shift as jsh
from fluidsims_tpu_torch.ops import shift as tsh

torch.set_num_threads(1)


def arrays(shape, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape)
    return jnp.asarray(a), torch.tensor(a)


@pytest.mark.parametrize("axis", [0, 1, -1, 2])
@pytest.mark.parametrize("d", [-12, -7, -3, -1, 0, 1, 2, 6, 7, 15])
def test_axis_wrapped_matches_jax(d, axis):
    ja, ta = arrays((7, 6, 5), seed=(d + 20 * axis) % 1000)
    np.testing.assert_array_equal(
        np.asarray(jsh.shift_axis_wrapped(ja, d, axis)),
        tsh.shift_axis_wrapped(ta, d, axis).numpy())


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("d", [-4, -2, -1, 0, 1, 3, 4])
def test_axis_clamped_matches_jax(d, axis):
    ja, ta = arrays((6, 5, 5), seed=(d + 30 * axis) % 1000)
    np.testing.assert_array_equal(
        np.asarray(jsh.shift_axis_clamped(ja, d, axis)),
        tsh.shift_axis_clamped(ta, d, axis).numpy())


@pytest.mark.parametrize("d", [-5, 5, 9])
def test_axis_clamped_refuses_large_shift(d):
    ja, ta = arrays((5, 4))
    with pytest.raises(ValueError):
        jsh.shift_axis_clamped(ja, d, 0)
    with pytest.raises(ValueError):
        tsh.shift_axis_clamped(ta, d, 0)


@pytest.mark.parametrize("dy, dx", [(0, 1), (0, -1), (1, 0), (-1, 0), (-2, 3),
                                    (5, -9), (-11, 13)])
def test_2d_shifts_match_jax(dy, dx):
    ja, ta = arrays((3, 9, 11), seed=(dy * 7 + dx) % 1000)
    np.testing.assert_array_equal(np.asarray(jsh.shift_wrapped(ja, dy, dx)),
                                  tsh.shift_wrapped(ta, dy, dx).numpy())
    if abs(dy) < 9 and abs(dx) < 11:
        np.testing.assert_array_equal(
            np.asarray(jsh.shift_clamped(ja, dy, dx)),
            tsh.shift_clamped(ta, dy, dx).numpy())


def test_wrapped_bool_and_zero_shift():
    m = np.random.default_rng(1).random((6, 7)) > 0.5
    np.testing.assert_array_equal(
        np.asarray(jsh.shift_axis_wrapped(jnp.asarray(m), -1, 0)),
        tsh.shift_axis_wrapped(torch.tensor(m), -1, 0).numpy())
    t = torch.zeros(4, 4)
    assert tsh.shift_axis_wrapped(t, 4, 0) is t
    assert tsh.shift_axis_clamped(t, 0, 1) is t
