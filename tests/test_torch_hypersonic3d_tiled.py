"""The tiling of the port's 3-D hypersonic step kernel, on the CPU.

The kernel (fluidsims_tpu_torch/csrc/hypersonic3d_step.cu) steps one tile
a block from the halo-3 padded primitives, staged axis by axis in shared
memory with a halo of 3 along that axis.  The kernel cannot run here, so
a plain torch model of that tiling (tests/oracles/hypersonic_tiles.py:
the sources' tile, each tile's window of the padded prims, clamped to the
padded grid as the kernel's staging clamps it, stepped by the plain core
with the tile's first global x) is held to the plain step bit for bit,
solid cells included, on f64 and f32 states with the sphere crossing tile
edges, ragged grids and a grid smaller than one tile, both outflow modes
and x0 = 0 and 5, with a NaN, a negative-pressure and an infinite-velocity
cell; the same model with one cell less of halo is not.  One case holds
the model to JAX's step_core_padded (f64, 1e-12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.solvers import hypersonic3d as jh
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.kernels import hypersonic3d_cuda as hk
from fluidsims_tpu_torch.solvers import hypersonic3d as th
from tests.oracles import hypersonic_tiles as tiles

torch.set_num_threads(1)
CPU = torch.device("cpu")
TX, TY, TZ = tiles.TILE_3D


def config(nz, ny, nx, dtype, outflow="transmissive"):
    return th.Hypersonic3DConfig(nx=nx, ny=ny, nz=nz, dx=1.0 / nx,
                                 dy=1.0 / ny, dz=1.0 / nz, outflow=outflow,
                                 dtype=dtype)


def padded_inputs(cfg, seed=11):
    """The padded prims of init (u0 = 0.05 in the fluid) plus seeded noise
    on every log field, with a NaN at a tile corner, a negative pressure
    and an infinite velocity; the padded mask; the CFL dt; gain 0.6."""
    s = th.init(cfg, CPU)
    rng = np.random.default_rng(seed)
    fl = ~s.solid.numpy()
    f = [x.numpy().astype(np.float64) for x in s[:6]]
    f[1][fl] = np.arcsinh(0.05 / cfg.u_ref)
    for k, amp in enumerate((0.3, 0.05, 0.05, 0.05, 0.3, 0.3)):
        f[k] = f[k] + np.where(fl, amp * rng.standard_normal(f[k].shape), 0.0)
    s = interop.hyp3d_state_from_numpy(*f, s.solid.numpy(), cfg.t0,
                                       cfg.dtau0, dtype=cfg.torch_dtype,
                                       device=CPU)
    sp = th.solid_pad_of(cfg, CPU)
    q = th._decode(cfg, *s[:6])
    qp = th.PrimT(*(x.clone() for x in th._padded_prims(cfg, q, sp)))
    nz, ny, nx = cfg.nz, cfg.ny, cfg.nx
    qp.r[3 + min(TZ, nz - 1), 3 + min(TY, ny - 1), 3 + min(TX, nx - 1)] = \
        float("nan")
    qp.p[3 + nz // 2, 3 + ny // 7, 3 + (3 * nx) // 4] = -0.5
    qp.u[3 + (3 * nz) // 4, 3 + ny // 3, 3 + nx - 2] = float("inf")
    dt = torch.div(torch.full((), cfg.cfl, dtype=cfg.torch_dtype),
                   hk.wavespeed_plain(cfg, q, s.solid))
    return qp, sp, dt, torch.full((), 0.6, dtype=cfg.torch_dtype)


def bits(t):
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def bitwise(a, b) -> bool:
    return all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def test_tile_is_the_sources():
    assert (TX * TY * TZ) % 32 == 0
    assert tiles.HALO_3D == th.HALO == 3


# (nz, ny, nx): several tiles with ragged edges; ragged in every axis; one
# smaller than a tile in every axis
GRIDS = [(2 * TZ + 1, 3 * TY + 2, 2 * TX + 3), (TZ + 1, TY + 3, TX + 5),
         (max(TZ - 1, 2), max(TY - 1, 2), max(TX - 1, 2))]


@pytest.mark.parametrize("x0", [0, 5])
@pytest.mark.parametrize("outflow", ["transmissive", "characteristic"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("grid", GRIDS)
def test_tiled_model_is_the_plain_step_bitwise(grid, dtype, outflow, x0):
    cfg = config(*grid, dtype, outflow)
    qp, sp, dt, gain = padded_inputs(cfg)
    ref = hk.step_core_plain(cfg, qp, sp, dt, gain, x0)
    got = tiles.tiled_step_3d(cfg, qp, sp, dt, gain, x0)
    assert bitwise(got, ref)
    if grid == GRIDS[0]:
        # the sphere crosses a tile edge: solid cells in two tiles
        zs, ys, xs = torch.nonzero(sp[3:-3, 3:-3, 3:-3], as_tuple=True)
        assert len(set(zip((zs // TZ).tolist(), (ys // TY).tolist(),
                           (xs // TX).tolist()))) >= 2


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_one_cell_less_of_halo_is_not(dtype):
    cfg = config(*GRIDS[0], dtype)
    qp, sp, dt, gain = padded_inputs(cfg)
    ref = hk.step_core_plain(cfg, qp, sp, dt, gain)
    short = tiles.tiled_step_3d(cfg, qp, sp, dt, gain,
                                halo=tiles.HALO_3D - 1)
    assert not bitwise(short, ref)


def test_tiled_model_matches_jax_f64():
    cfg = config(*GRIDS[1], "float64")
    qp, sp, dt, gain = padded_inputs(cfg)
    jcfg = jh.Hypersonic3DConfig(**{k: getattr(cfg, k) for k in (
        "nx", "ny", "nz", "dx", "dy", "dz", "outflow", "dtype")})
    ref = jh.step_core_padded(jcfg, jh.PrimT(*(jnp.asarray(f.numpy())
                                                for f in qp)),
                              jnp.asarray(sp.numpy()),
                              jnp.float64(float(dt)), jnp.float64(0.6))
    got = tiles.tiled_step_3d(cfg, qp, sp, dt, gain)
    for a, b in zip(got, ref):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(b)
        assert np.abs(a[fin] - b[fin]).max() <= 1e-12 * np.abs(b[fin]).max()
