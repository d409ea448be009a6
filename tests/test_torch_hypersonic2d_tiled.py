"""The tiling of the port's 2-D hypersonic step kernel, on the CPU.

The kernel (fluidsims_tpu_torch/csrc/hypersonic2d_step.cu) steps one tile
a block from the tile and a halo of 2 staged in shared memory, with the
boundary conditions resolved by index arithmetic.  The kernel cannot run
here, so a plain torch model of that tiling (tests/oracles/
hypersonic_tiles.py: the sources' tile, each tile's window stepped by the
plain core) is held to the plain step bit for bit, solid cells included,
on f64 and f32 states with the capsule crossing tile edges, ragged grids
and a grid smaller than one tile, with a NaN cell on a tile corner; the
same model with one cell less of halo is not.  One case holds the model to
JAX's pad_bc + step_core_padded (f64, 1e-12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.ops.euler2d import Cons as JCons
from fluidsims_tpu.solvers import hypersonic2d as jh2
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.kernels import hypersonic2d_cuda as hk
from fluidsims_tpu_torch.solvers import hypersonic2d as th2
from tests.oracles import hypersonic_tiles as tiles

torch.set_num_threads(1)
CPU = torch.device("cpu")


def body_kw(nx, ny, dtype):
    """A capsule whose nose lies left of the first tile edge in x and
    whose axis is a tile edge in y, so that on grids of more than one
    tile it crosses a tile edge; as large as the grid allows."""
    TX, TY = tiles.TILE_2D[dtype]
    r = max(1.5, min(ny, nx) / 5.0)
    x0 = TX - r if nx > TX + r else nx / 3.0
    cy = float(TY * max(1, round(ny / (2 * TY)))) if ny > TY else ny / 2.0
    return dict(nx=nx, ny=ny, geom_x0=x0, geom_cy=cy, geom_Rb=r,
                geom_Rn=r / 2.0, dtype=dtype)


def noisy_state(kw, seed=3):
    """init + seeded noise in the fluid cells' conserved fields, and one
    NaN cell on a tile corner (the fluid cell nearest to (TY, TX))."""
    cfg = th2.Hypersonic2DConfig(**kw)
    TX, TY = tiles.TILE_2D[cfg.dtype]
    s = th2.init(cfg, CPU)
    rng = np.random.default_rng(seed)
    mask = s.mask.numpy()
    U = [f.numpy().astype(np.float64) for f in s.U]
    for k, amp in enumerate((0.2, 0.5, 0.5, 0.2)):
        noise = amp * rng.standard_normal(U[k].shape)
        new = U[k] * (1.0 + noise) if k in (0, 3) else U[k] + noise
        U[k] = np.where(mask, U[k], new)
    fy, fx = np.nonzero(~mask)
    at = np.argmin((fy - min(TY, mask.shape[0] - 1)) ** 2
                   + (fx - min(TX, mask.shape[1] - 1)) ** 2)
    U[0][fy[at], fx[at]] = np.nan
    st = interop.state_from_numpy(U, mask, 0.0, dtype=cfg.torch_dtype,
                                  device=CPU)
    return cfg, st


def bits(t):
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def bitwise(a, b) -> bool:
    return all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def dt_of(cfg, st):
    from fluidsims_tpu_torch.core.clock import cfl_dt
    return cfl_dt(hk.inflow_wavespeed_plain(cfg, st.U, st.mask), cfg.cfl,
                  dx=1.0, nu_max=cfg.nu_max)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_tile_is_the_sources(dtype):
    TX, TY = tiles.TILE_2D[dtype]
    assert TX * TY % 32 == 0 and TX * TY <= 1024
    assert tiles.HALO_2D == th2.PAD == 2


# (nx, ny) per dtype: several tiles with ragged edges, one narrower than a
# tile in x, and smaller than one tile
GRIDS = {d: [(200, 75), (3 * tx + 5, 2 * ty + 3), (tx - 3, 2 * ty + 1),
             (min(7, tx - 1), min(5, ty - 1))]
         for d, (tx, ty) in tiles.TILE_2D.items()}
CASES = [(d, nx, ny) for d, grids in GRIDS.items() for nx, ny in grids]


@pytest.mark.parametrize("dtype,nx,ny", CASES)
def test_tiled_model_is_the_plain_step_bitwise(dtype, nx, ny):
    cfg, st = noisy_state(body_kw(nx, ny, dtype))
    dt = dt_of(cfg, st)
    ref = hk.step_core_plain(cfg, st.U, st.mask, dt)
    got = tiles.tiled_step_2d(cfg, st.U, st.mask, dt)
    assert bitwise(got, ref)
    assert int((~torch.isfinite(ref.rho)).sum()) >= 1  # the NaN cell spreads
    TX, TY = tiles.TILE_2D[dtype]
    if nx > TX or ny > TY:
        # the capsule crosses a tile edge: solid cells in two tiles
        ys, xs = torch.nonzero(st.mask, as_tuple=True)
        assert len(set(zip((ys // TY).tolist(), (xs // TX).tolist()))) >= 2


@pytest.mark.parametrize("dtype,nx,ny",
                         [c for c in CASES if (c[1], c[2]) in
                          GRIDS[c[0]][:2]])
def test_one_cell_less_of_halo_is_not(dtype, nx, ny):
    cfg, st = noisy_state(body_kw(nx, ny, dtype))
    dt = dt_of(cfg, st)
    ref = hk.step_core_plain(cfg, st.U, st.mask, dt)
    short = tiles.tiled_step_2d(cfg, st.U, st.mask, dt,
                                halo=tiles.HALO_2D - 1)
    assert not bitwise(short, ref)


def test_tiled_model_matches_jax_f64():
    kw = body_kw(*GRIDS["float64"][1], "float64")
    cfg, st = noisy_state(kw)
    dt = dt_of(cfg, st)
    jcfg = jh2.Hypersonic2DConfig(**kw)
    jU = JCons(*(jnp.asarray(f.numpy()) for f in st.U))
    Up, Mp = jh2.pad_bc(jcfg, jU, jnp.asarray(st.mask.numpy()))
    ref = jh2.step_core_padded(jcfg, Up, Mp, jnp.float64(float(dt)))
    got = tiles.tiled_step_2d(cfg, st.U, st.mask, dt)
    for a, b in zip(got, ref):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(b)
        assert (np.abs(a[fin] - b[fin]) / np.maximum(np.abs(b[fin]), 1.0)
                ).max() <= 1e-12
