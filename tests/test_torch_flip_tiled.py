"""The tiling of the port's FLIP grid-phase kernel, on the CPU.

The kernel (fluidsims_tpu_torch/csrc/flip_grid.cu) runs the Jacobi sweeps
in phases of h on tiles in shared memory, the tile and a halo of the
phase's sweeps (one more in the last phase, for the projection), one grid
sync between two phases; normalize and divergence are fused into the
first phase, the projection into the last.  The kernel cannot run here, so
a plain torch model of that tiling (tests/oracles/flip_tiles.py) is held
to the plain grid phase (solvers/flip_apic.py::_grid_phase) bit for bit,
the sign of zero included, at n = 16, 37 and 64 and jacobi 0, 1, 7 and 48
(fewer sweeps than h, none, several phases), with the kernel's tile and h
and with a small tile and h, f32 and f64, on P2G grids with empty cells
and a band of zero velocity (whose divergence is -0, turned +0 by the first
sweep's additions of p = 0); the same model with a halo one cell short is
not bitwise.  The model is held to JAX's grid phase under jax.jit at the
JAX suite's bars (f64 1e-12, f32 1e-5 relative to each output's max), and
the source's tiles fit the shared memory of a block.
"""

import jax
import numpy as np
import pytest
import torch

from fluidsims_tpu.solvers import flip_apic as jf
from fluidsims_tpu_torch.solvers import flip_apic as tf
from tests.oracles import flip_tiles

torch.set_num_threads(1)

# the H100's shared memory a block (227 KB)
SMEM_MAX = 232448


def p2g_grids(n: int, dtype: str, seed: int):
    """(config, mass, mom_u, mom_v): the plain P2G of 4 n^2 seeded
    particles (the first eight on the walls and corners), then a block of
    empty cells and three rows of zero velocity (-0 in u), so that the
    divergence is -0 there."""
    cfg = tf.FlipApicConfig(particles=4 * n * n, grid=n, dtype=dtype)
    rng = np.random.default_rng(seed)
    pos = rng.random((cfg.particles, 2))
    pos[:8] = [[0, 0], [1, 1], [0, 1], [1, 0], [0.01, 0.99], [0.99, 0.01],
               [0.5, 0], [1, 0.5]]
    parts = [torch.tensor(a, dtype=cfg.torch_dtype) for a in
             (pos, *(rng.standard_normal((cfg.particles, 2))
                     for _ in range(3)))]
    mass, u, v = (g.clone() for g in tf._p2g(cfg, *parts))
    mass[n // 2:n // 2 + 3, 2:6] = 0.0
    mass[3:6], u[3:6], v[3:6] = 0.0, -0.0, 0.0
    return cfg, mass, u, v


def bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    it = torch.int32 if a.element_size() == 4 else torch.int64
    return torch.equal(a.contiguous().view(it), b.contiguous().view(it))


@pytest.mark.parametrize("shape", ["kernel", (8, 5, 3)])
@pytest.mark.parametrize("jacobi", [0, 1, 7, 48])
@pytest.mark.parametrize("n", [16, 37, 64])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tiled_grid_phase_is_the_plain_one_bitwise(dtype, n, jacobi, shape):
    cfg, mass, u, v = p2g_grids(n, dtype, 100 + n)
    cfg = cfg.replace(jacobi=jacobi)
    got = flip_tiles.grid_phase_tiled(cfg, mass, u, v,
                                      None if shape == "kernel" else shape)
    ref = tf._grid_phase(cfg, mass, u, v)
    assert all(bits(a, b) for a, b in zip(got, ref))


def test_the_grids_hold_a_negative_zero_divergence():
    """The inputs reach the sign-of-zero case the kernel must keep: the
    divergence is -0 in cells where the first sweep turns p to +0."""
    cfg, mass, u, v = p2g_grids(37, "float32", 137)
    u_prev, v_prev, _, _ = tf._grid_phase(cfg.replace(jacobi=0), mass, u, v)
    d = -0.5 * (36) * (u_prev[1:-1, 2:] - u_prev[1:-1, :-2]
                       + v_prev[2:, 1:-1] - v_prev[:-2, 1:-1])
    assert bool(((d == 0) & torch.signbit(d)).any())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_halo_one_short_is_not_enough(dtype):
    """A sweep reads its four neighbours: each phase's halo must be its
    sweeps (and one more for the projection)."""
    cfg, mass, u, v = p2g_grids(37, dtype, 137)
    cfg = cfg.replace(jacobi=7)
    got = flip_tiles.grid_phase_tiled(cfg, mass, u, v, (8, 5, 3), short=1)
    ref = tf._grid_phase(cfg, mass, u, v)
    assert not all(bits(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("jacobi, h, want", [(48, 8, 5), (7, 8, 0),
                                             (0, 8, 0), (1, 3, 0),
                                             (9, 8, 1), (16, 8, 1)])
def test_grid_syncs_a_launch(jacobi, h, want):
    """max(ceil(jacobi / h), 1) - 1 grid syncs: 5 at 48 sweeps and h = 8
    (the first design made jacobi + 2 = 50)."""
    assert flip_tiles.phases(jacobi, h) - 1 == want


@pytest.mark.parametrize("dtype, bar", [("float32", 1e-5),
                                        ("float64", 1e-12)])
def test_model_matches_jax_grid_phase(dtype, bar):
    """The model on the JAX P2G grids of seeded particles against JAX's
    grid phase under jit, at tests/test_torch_flip.py's bars, 48 and 5
    sweeps."""
    n = 32
    rng = np.random.default_rng(n + 1)
    npd = np.float32 if dtype == "float32" else np.float64
    pos = (0.01 + 0.98 * rng.random((4 * n * n, 2))).astype(npd)
    vel, ax, ay = (rng.standard_normal((4 * n * n, 2)).astype(npd)
                   for _ in range(3))
    for jac in (48, 5):
        jc = jf.FlipApicConfig(grid=n, jacobi=jac, dtype=dtype)
        tc = tf.FlipApicConfig(grid=n, jacobi=jac, dtype=dtype)
        grids = [np.asarray(g) for g in jax.jit(
            lambda *a: jf._p2g(jc, *a))(pos, vel, ax, ay)]
        ref = jax.jit(lambda *g: jf._grid_phase(jc, *g))(*grids)
        got = flip_tiles.grid_phase_tiled(
            tc, *(torch.tensor(g) for g in grids))
        for g, r in zip(got, ref):
            r = np.asarray(r, np.float64)
            err = np.abs(g.numpy().astype(np.float64) - r).max()
            assert err <= bar * max(np.abs(r).max(), 1.0), err


@pytest.mark.parametrize("n", [16, 128, 256, 257, 512, 2048])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_kernel_tiles_fit_shared_memory(n, itemsize):
    """The source's tiles and h, as the model reads them: the windows of
    a block (tile and a halo of h + 1) fit 227 KB at every grid, the
    threads a block are whole warps, and the 128^2 grid of the main path
    gives at least 64 tiles (most SMs a block)."""
    assert flip_tiles.smem_bytes(n, itemsize) <= SMEM_MAX
    assert flip_tiles.SWEEPS >= 1
    for _, _, threads in (flip_tiles.SMALL, flip_tiles.LARGE):
        assert threads % 32 == 0 and 32 <= threads <= 1024
    tx, ty, _ = flip_tiles.kernel_shape(128)
    assert -(-128 // tx) * -(-128 // ty) >= 64
