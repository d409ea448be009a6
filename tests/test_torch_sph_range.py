"""The SPH pair kernels' receiver range and window of cell columns, on the
CPU (kernels/sph_cuda.py: `density` and `forces` over sorted positions
[lo, hi); `binning`, `density` and `forces` over a `Window`).

The kernels cannot run here; their plain versions, which the wrappers
take for CPU tensors, can.  Over a range, the plain versions give the
whole run's rows bitwise (each receiver's pairs are the same list in the
same order) and JAX's exact density (fluidsims_tpu/solvers/sph.py::
_exact_density) on those receivers within 1e-12 (f64) / 1e-5 (f32) of the
largest value.  Over a window of whole cell columns, with the particles
that lie in it, the receivers whose 3x3 cells lie in the window get the
whole grid's density and forces bitwise (the particles keep their order,
so each such receiver's pair list is the same) and JAX's exact density
within the same bars.  The bin over a window takes a particle's column
less the window's first before it clamps, as csrc/sph.cuh cell_of does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.solvers import sph as js
from fluidsims_tpu_torch.kernels import sph_cuda as sk
from fluidsims_tpu_torch.solvers import sph as ts

torch.set_num_threads(1)
TOL = {"float32": 1e-5, "float64": 1e-12}
N = 2048          # a 12 x 12 grid of cells
RANGES = [(0, N), (7, 1500), (333, 334), (1000, 1000), (1, N - 1)]


def pool(dtype: str, seed: int = 5):
    """(JAX config, port config, pos, vel) as numpy arrays: init plus
    seeded noise, velocities seeded."""
    jc = js.SPHConfig(n=N, seed=seed, dtype=dtype, rain=False)
    tc = ts.SPHConfig(n=N, seed=seed, dtype=dtype, rain=False)
    rng = np.random.default_rng(seed)
    pos = np.asarray(js.init(jc).pos, np.float64)
    pos = np.clip(pos + 0.3 * jc.h * rng.standard_normal((N, 2)), 0, 1)
    vel = 0.5 * rng.standard_normal((N, 2))
    dt = np.dtype(dtype)
    return jc, tc, pos.astype(dt), vel.astype(dt)


def jax_rp(jc, pos) -> np.ndarray:
    """JAX's exact (rho, p / rho^2) in particle order."""
    _, rho, press = js._exact_density(jc, jnp.asarray(pos))
    rho, press = np.asarray(rho), np.asarray(press)
    return np.stack([rho, press / np.maximum(rho, 1e-30) ** 2], -1)


def rel_cols(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return max(float(np.abs(got[:, c] - ref[:, c]).max()
                     / np.abs(ref[:, c]).max()) for c in (0, 1))


@pytest.mark.parametrize("lo, hi", RANGES)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_range_rows_are_the_whole_runs(dtype, lo, hi):
    jc, tc, pos, vel = pool(dtype)
    b = sk.binning(tc, torch.tensor(pos), torch.tensor(vel))
    full = sk.density(tc, b)
    rp = sk.density(tc, b, lo, hi)
    assert rp.shape == (hi - lo, 2) and torch.equal(rp, full[lo:hi])
    dt = torch.tensor(2e-3, dtype=tc.torch_dtype)
    fp, fv = sk.forces(tc, b, full, dt)
    p, v = sk.forces(tc, b, full, dt, lo, hi)
    mine = b.order.long()[lo:hi]
    assert torch.equal(p[mine], fp[mine]) and torch.equal(v[mine], fv[mine])
    if hi > lo:
        ref = jax_rp(jc, pos)[b.order.long().numpy()[lo:hi]]
        assert rel_cols(rp.numpy(), ref) <= TOL[dtype]


# (gx0, gw): a window at the left wall, one inside, one at the right wall
WINDOWS = [(0, 4), (3, 5), (8, 4)]


@pytest.mark.parametrize("gx0, gw", WINDOWS)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_window_inside_is_the_whole_grid(dtype, gx0, gw):
    jc, tc, pos, vel = pool(dtype)
    g = tc.grid()
    assert (g.Gx, g.Gy) == (12, 12)
    col = np.clip(np.floor(pos[:, 0] / g.cell), 0, g.Gx - 1)
    keep = np.nonzero((col >= gx0) & (col < gx0 + gw))[0]
    win = sk.Window(gx0, gw)
    bw = sk.binning(tc, torch.tensor(pos[keep]), torch.tensor(vel[keep]),
                    win)
    assert bw.starts.shape == (gw * g.Gy + 1,) and int(bw.starts[-1]) == (
        len(keep))
    gcid = sk.window_cid(tc, torch.tensor(pos[keep]))
    assert torch.equal(bw.cid.long(),
                       (gcid // g.Gx) * gw + gcid % g.Gx - gx0)

    # receivers whose 3x3 cells lie in the window: at a wall, its edge
    # column is inside too
    lo_in = gx0 + 1 if gx0 > 0 else 0
    hi_in = gx0 + gw - 1 if gx0 + gw < g.Gx else g.Gx
    inner = torch.tensor((col[keep] >= lo_in) & (col[keep] < hi_in))
    assert inner.sum() > 50
    b = sk.binning(tc, torch.tensor(pos), torch.tensor(vel))
    rank_of = torch.empty(N, dtype=torch.long)
    rank_of[b.order.long()] = torch.arange(N)
    full = sk.density(tc, b)
    ids = torch.tensor(keep)[bw.order.long()]       # local sorted -> id
    rp = sk.density(tc, bw, win=win)
    sorted_inner = inner[bw.order.long()]
    assert torch.equal(rp[sorted_inner], full[rank_of[ids[sorted_inner]]])
    ref = jax_rp(jc, pos)[ids[sorted_inner].numpy()]
    assert rel_cols(rp[sorted_inner].numpy(), ref) <= TOL[dtype]

    dt = torch.tensor(2e-3, dtype=tc.torch_dtype)
    fp, fv = sk.forces(tc, b, full, dt)
    p, v = sk.forces(tc, bw, full[rank_of[ids]], dt, win=win)
    idx = torch.tensor(keep)[inner]
    assert torch.equal(p[inner], fp[idx]) and torch.equal(v[inner], fv[idx])


def test_window_and_range_checks():
    _, tc, pos, vel = pool("float64")
    b = sk.binning(tc, torch.tensor(pos), torch.tensor(vel))
    for lo, hi in ((-1, 5), (5, 4), (0, N + 1)):
        with pytest.raises(ValueError):
            sk.density(tc, b, lo, hi)
    for win, k in ((sk.Window(10, 4), N), (sk.Window(-1, 4), N),
                   (sk.Window(0, 4), 0)):
        with pytest.raises(ValueError):
            sk.binning(tc, torch.tensor(pos[:k]), torch.tensor(vel[:k]), win)
    assert sk.full_window(tc) == sk.Window(0, 12)
    assert sk._window_params(tc, sk.full_window(tc), N) is sk._params(tc)
    p = sk._window_params(tc, sk.Window(3, 5), 100)
    assert (p.n, p.gx0, p.Gx, p.Gy) == (100, 3, 5, 12)
    p = sk._window_params(tc, sk.full_window(tc), 100)
    assert (p.n, p.gx0, p.Gx) == (100, 0, 12)
    assert sk._params(tc).gx0 == 0 and sk._params(tc).n == N
