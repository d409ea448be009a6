"""The 3-D masked max wavespeed on the shapes that its kernel
(fluidsims_tpu_torch/csrc/hypersonic3d_wavespeed.cu) treats apart, on the
CPU.

The kernel takes whole 16-byte vectors (4 cells f32, 2 f64) where the
five fields and the mask start at the same place inside one, the cells
before the first vector and after the last one at a time, and every cell
one at a time where the tensors start at different places (views at odd
offsets).  It cannot run here, so its plain version (the wrapper on CPU
tensors) is held bitwise to JAX's masked max on those shapes: grids whose
cell count is no multiple of 4, and the fields and mask as views that
start 1, 2 or 3 cells into larger buffers, f32 and f64.  The scratch that
the wrapper hands the kernel is kept per grid shape, dtype, device and
stream, and starts zeroed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.solvers import hypersonic3d as jh
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.kernels import hypersonic3d_cuda as hk
from fluidsims_tpu_torch.solvers import hypersonic3d as th

torch.set_num_threads(1)
CPU = torch.device("cpu")
GRIDS = [(9, 13, 19), (3, 7, 5), (17, 31, 33)]
# cells into a larger buffer of r, u, v, w, p and the mask
OFFSETS = [None, (1, 1, 1, 1, 1, 1), (0, 1, 2, 3, 1, 2), (3, 3, 3, 3, 3, 3)]


def fields_of(shape, dtype, seed):
    """Seeded r, u, v, w, p, ev with a NaN velocity and an infinite
    pressure."""
    rng = np.random.default_rng(seed)
    f = [rng.uniform(0.01, 2, shape), rng.normal(0, 50, shape),
         rng.normal(0, 5, shape), rng.normal(0, 5, shape),
         rng.uniform(0.01, 3, shape), rng.uniform(0, 1, shape)]
    f[2].flat[f[2].size // 3] = np.nan
    f[4].flat[f[4].size // 2] = np.inf
    return [x.astype(dtype) for x in f]


def view_at(x: torch.Tensor, offset: int | None) -> torch.Tensor:
    """x as a contiguous view that starts `offset` elements into a larger
    buffer (x itself for None)."""
    if offset is None:
        return x
    buf = torch.empty(x.numel() + 8, dtype=x.dtype)
    out = buf[offset:offset + x.numel()].view(x.shape)
    out.copy_(x)
    return out


def jax_masked_max(cfg, fields, solid):
    q1 = jh.PrimT(*(jnp.asarray(f) for f in fields))
    a1 = jh.soundspeed(cfg, q1)
    ssum = (jnp.abs(q1.u) + a1) / cfg.dx + (jnp.abs(q1.v) + a1) / cfg.dy \
        + (jnp.abs(q1.w) + a1) / cfg.dz
    return jnp.max(jnp.where(jnp.isfinite(ssum) & ~jnp.asarray(solid), ssum,
                             0.0))


@pytest.mark.parametrize("offsets", OFFSETS)
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ragged_grids_and_views_match_jax_bitwise(dtype, grid, offsets):
    nz, ny, nx = grid
    cfg = jh.Hypersonic3DConfig(nx=nx, ny=ny, nz=nz, dx=1.0 / nx,
                                dy=1.0 / ny, dz=1.0 / nz, dtype=dtype)
    assert (nz * ny * nx) % 4
    fields = fields_of(grid, dtype, seed=nz * ny * nx)
    solid = np.asarray(jh.build_solid(cfg))
    offs = offsets or (None,) * 6
    q1 = th.PrimT(*(view_at(torch.from_numpy(f), o)
                    for f, o in zip(fields, offs[:5] + (None,))))
    tsolid = view_at(torch.from_numpy(solid), offs[5])
    assert all(f.is_contiguous() for f in q1) and tsolid.is_contiguous()
    got = hk.wavespeed(interop.hyp3d_config_from_dict(cfg.asdict()), q1,
                       tsolid)
    ref = jax_masked_max(cfg, fields, solid)
    assert got.shape == () and got.dtype == getattr(torch, dtype)
    assert got.numpy().tobytes() == np.asarray(ref).tobytes()


def test_scratch_is_kept_per_grid_shape_and_dtype():
    """Two words, zeroed, one pair for each grid shape, dtype, device and
    stream: launches of one shape on one stream share it, and no other
    launch touches it."""
    a = th.Hypersonic3DConfig(nx=16, ny=16, nz=16)
    b = th.Hypersonic3DConfig(nx=16, ny=16, nz=17)
    c = a.replace(dtype="float64")
    sa = hk._wavespeed_scratch(a, CPU, 0)
    assert sa.shape == (2,) and sa.dtype == torch.int64
    assert not bool(sa.any())
    assert hk._wavespeed_scratch(a, CPU, 0) is sa
    others = [hk._wavespeed_scratch(b, CPU, 0),
              hk._wavespeed_scratch(c, CPU, 0),
              hk._wavespeed_scratch(a, CPU, 1)]
    assert all(o is not sa for o in others)
    assert len({o.data_ptr() for o in others + [sa]}) == 4
