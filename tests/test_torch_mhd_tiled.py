"""The tiling of the port's GLM-MHD K-step kernel, on the CPU.

The kernel (fluidsims_tpu_torch/csrc/mhd_multistep.cu) steps the grid a
tile at a time from the tile and a halo of 2 staged in shared memory, its
indices clamped to the grid (edge-copy boundaries, as shift_clamped), the
face bands tested on global coordinates, each step's wavespeed max taken
from the bits the step before wrote.  The kernel cannot run here, so a
plain torch model of that tiling (tests/oracles/mhd_tiles.py: each tile's
clamped window stepped by the plain step_core) is held to the plain step
bit for bit on even and ragged grids (64x48, 37x23, and one smaller than
a tile), with the kernel's tile of each dtype and with small tiles, for
Brio–Wu and Orszag–Tang, both flux signs, f32 and f64; 8 steps of the
model equal 8 plain steps bit for bit, also with a NaN cell; the same model
with a halo of 1 is not bitwise.  The model is held to JAX's interpreted
Pallas kernel #8 (f32, 10 steps at k = 4, the JAX suite's bar) and to
JAX's XLA step (f64, 4 steps, 1e-12), from the same numpy-built state, on
the grid tests/test_torch_mhd.py uses against them (40x28).
"""

import jax
import numpy as np
import pytest
import torch

from fluidsims_tpu.kernels import mhd_resident_pallas as jmp
from fluidsims_tpu.solvers import mhd as jm
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.solvers import mhd as tm
from tests.oracles import mhd_tiles

torch.set_num_threads(1)
CPU = torch.device("cpu")


def noisy(cfg, seed=5, nan=False):
    """init() plus seeded noise on rho, mx, my and By; with `nan`, one NaN
    cell."""
    s = tm.init(cfg, CPU)
    rng = np.random.default_rng(seed)
    U = s.U

    def nz(f, amp):
        return f + torch.tensor(amp * rng.standard_normal(tuple(f.shape)),
                                dtype=f.dtype)

    rho = U.rho * (1.0 + 0.02 * torch.tensor(
        rng.uniform(-1, 1, tuple(U.rho.shape)), dtype=U.rho.dtype))
    U = U._replace(rho=rho, mx=nz(U.mx, 0.02), my=nz(U.my, 0.02),
                   By=nz(U.By, 0.02))
    if nan:
        U.rho[cfg.ny // 2, cfg.nx // 3] = float("nan")
    return s._replace(U=U)


def bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    it = torch.int32 if a.element_size() == 4 else torch.int64
    return torch.equal(a.contiguous().view(it), b.contiguous().view(it))


def same(a, b) -> bool:
    return all(bits(x, y) for x, y in zip([*a.U, a.t], [*b.U, b.t]))


@pytest.mark.parametrize("tile", ["kernel", (8, 4)])
@pytest.mark.parametrize("nx, ny", [(64, 48), (37, 23), (13, 9)])
@pytest.mark.parametrize("problem, stable", [("briowu", False),
                                             ("briowu", True),
                                             ("orszag-tang", False),
                                             ("orszag-tang", True)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tiled_step_is_the_plain_step_bitwise(dtype, problem, stable, nx, ny,
                                               tile):
    cfg = tm.MHDConfig(nx=nx, ny=ny, dtype=dtype, problem=problem,
                       stable_hll=stable)
    s = noisy(cfg)
    got = mhd_tiles.tiled_step(cfg, s, None if tile == "kernel" else tile)
    assert same(got, tm.step(cfg, s))


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_eight_tiled_steps_are_eight_plain_steps(dtype, nan):
    """K = 8 steps of the model, each with the max of the bits the step
    before wrote, equal 8 plain steps bit for bit (with a NaN cell: every
    cell reverts, t turns NaN)."""
    cfg = tm.MHDConfig(nx=37, ny=23, dtype=dtype, problem="orszag-tang")
    s = noisy(cfg, nan=nan)
    plain = s
    for _ in range(8):
        plain = tm.step(cfg, plain)
    assert same(mhd_tiles.tiled_run(cfg, s, 8, (8, 4)), plain)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_halo_of_one_is_not_enough(dtype):
    """A face reads two cells on each side: a halo of 1 changes cells
    next to the tile edges."""
    cfg = tm.MHDConfig(nx=37, ny=23, dtype=dtype, problem="orszag-tang")
    s = noisy(cfg)
    assert not same(mhd_tiles.tiled_step(cfg, s, (8, 4), halo=1),
                    tm.step(cfg, s))


def test_kernel_tiles_fit_the_sweep():
    """The sources' tiles, as the model reads them: the halo is 2, and a
    float tile's x and y faces each fill two rounds of 128 threads."""
    assert mhd_tiles.HALO == 2
    tx, ty = mhd_tiles.TILE["float32"]
    assert ty * (tx + 1) <= 256 and tx * (ty + 1) <= 256


def both(**kw):
    jc = jm.MHDConfig(**kw)
    tc = interop.mhd_config_from_dict(jc.asdict())
    return jc, tc, jm.init(jc), tm.init(tc, CPU)


@pytest.mark.parametrize("problem", ["briowu", "orszag-tang"])
def test_model_matches_pallas_interpret_f32(problem):
    """10 steps of the model against run_multistep(k=4) of TPU kernel #8
    in interpret mode, at tests/test_mhd_stam3d.py:292-310's bar and on
    tests/test_torch_mhd.py's 40x28 grid (ragged for the kernel's tiles)."""
    jc, tc, sj, st = both(nx=40, ny=28, problem=problem, block_k=4)
    a = jmp.run_multistep(jc, sj, 10, k=4, interpret=True)
    b = mhd_tiles.tiled_run(tc, st, 10)
    assert float(a.t) == float(b.t)
    for name, x, y in zip(tm.FIELDS, a.U, b.U):
        x = np.asarray(x)
        d = np.abs(x - y.numpy()).max() / max(np.abs(x).max(), 1e-3)
        assert d < 5e-5, (name, d)


@pytest.mark.parametrize("stable", [False, True])
@pytest.mark.parametrize("problem", ["briowu", "orszag-tang"])
def test_model_matches_jax_step_f64(problem, stable):
    jc, tc, a, b = both(nx=40, ny=28, dtype="float64", problem=problem,
                        stable_hll=stable)
    step = jax.jit(lambda s: jm.step(jc, s))
    for _ in range(4):
        a, b = step(a), mhd_tiles.tiled_step(tc, b)
    for x, y in zip([*a.U, a.t], [*b.U, b.t]):
        x = np.asarray(x, np.float64)
        assert np.abs(x - y.numpy()).max() / max(np.abs(x).max(), 1.0) <= 1e-12
