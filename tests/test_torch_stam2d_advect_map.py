"""The stam2d advection kernel's launch, on the CPU.

The kernel (fluidsims_tpu_torch/csrc/stam2d_advect.cu) gives each thread
one cell.  It cannot run here, so tests/oracles/stam2d_advect_map.py
rebuilds the launch from the source's block shape and checks: every cell
is written exactly once at ragged and aligned n (and at other block
shapes), and the kernel's arithmetic applied thread by thread is bitwise
equal to
advect_plain, one field and the velocity pair, f32 and f64, and within
test_torch_stam2d.py's bars of JAX's exact (xla) advection.
"""

import jax
import numpy as np
import pytest
import torch

from fluidsims_tpu.solvers import stam2d as js
from fluidsims_tpu_torch.kernels import stam2d_cuda as s2k
from fluidsims_tpu_torch.solvers import stam2d as ts
from oracles import stam2d_advect_map as am

torch.set_num_threads(1)
SIZES = [1, 2, 3, 5, 37, 129, 200, 512]


@pytest.mark.parametrize("block", [am.BLOCK, (16, 16), (64, 4), (128, 2),
                                   (32, 1)])
@pytest.mark.parametrize("n", SIZES)
def test_map_covers_each_cell_once(n, block):
    j, i = am.launch_map(n, block)
    hits = np.zeros((n, n), np.int64)
    np.add.at(hits, (j, i), 1)
    assert (hits == 1).all()


def fields(n, dtype, seed):
    """q in [0, 1) and velocities whose back-traces leave the grid."""
    rng = np.random.default_rng(seed)
    q, u, v = (rng.random((n, n)).astype(dtype) for _ in range(3))
    return q, (2.0 * (2.0 * u - 1.0)).astype(dtype), \
        (2.0 * (2.0 * v - 1.0)).astype(dtype)


def map_of(cfg, qs, uu, vv):
    m = ts.metric(cfg, torch.from_numpy(uu))
    return am.advect_map(qs, uu, vv, m.eta.numpy(), m.xp.numpy(),
                         m.yp.numpy(), cfg.dt, cfg.eta_min, ts._deta(cfg))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 37, 200])
def test_map_is_advect_plain_bitwise(n, dtype):
    cfg = ts.Stam2DConfig(n=n, dtype=np.dtype(dtype).name)
    q, uu, vv = fields(n, dtype, n)
    for qs in ((q,), (uu, vv)):
        got = map_of(cfg, qs, uu, vv)
        ref = s2k.advect_plain(cfg, tuple(map(torch.from_numpy, qs)),
                               torch.from_numpy(uu), torch.from_numpy(vv))
        for a, b in zip(got, ref):
            assert np.array_equal(a.view(np.uint8), b.numpy().view(np.uint8))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [3, 37])
def test_map_is_jax_exact_advection(n, dtype):
    jc = js.Stam2DConfig(n=n, dtype=np.dtype(dtype).name)
    cfg = ts.Stam2DConfig(n=n, dtype=np.dtype(dtype).name)
    q, uu, vv = fields(n, dtype, 100 + n)
    (got,) = map_of(cfg, (q,), uu, vv)
    ref = np.asarray(jax.jit(lambda q, u, v: js._advect(jc, q, u, v))(
        q, uu, vv))
    assert ref.dtype == got.dtype
    # XLA's CPU code rounds some of the chain's steps otherwise than torch's
    # one op at a time, so JAX is held at test_torch_stam2d.py's
    # test_advect_matches_jax bars, not bitwise
    bar = 1e-12 if dtype == np.float64 else 1e-5
    assert np.abs(got.astype(np.float64) - ref).max() <= bar
