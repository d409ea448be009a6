"""The 3-D step's prologue (decode, halo padding and wall state) through
its kernel wrapper, `kernels.hypersonic3d_cuda.pad`, and the step's `pad`
hook, on the CPU.

The wrapper's CPU route is the plain prologue, `_padded_prims` of
`_decode`, bitwise, on odd non-cubic grids and on the sharded runner's
extended z-slab with the padded mask that runner builds, f32 and f64,
both outflow modes, and counts no launch.  The kernel itself is held to
the plain prologue bitwise on a GPU by chip_smoke.py (phase 8).
"""

import functools

import numpy as np
import pytest
import torch

from fluidsims_tpu_torch.kernels import hypersonic3d_cuda as hk
from fluidsims_tpu_torch.solvers import hypersonic3d as th
from fluidsims_tpu_torch.solvers import th3cs

torch.set_num_threads(1)
CPU = torch.device("cpu")
H = th.HALO

# (nz, ny, nx): odd and non-cubic, the sphere cut by the grid; the
# narrowest the periodic halo allows
GRIDS = ((7, 9, 11), (3, 5, 4))


def cfg_of(nz, ny, nx, **kw):
    return th.Hypersonic3DConfig(nx=nx, ny=ny, nz=nz, dx=1.0 / nx,
                                 dy=1.0 / ny, dz=1.0 / nz, **kw)


def noisy_state(cfg, seed=7):
    """init with seeded noise on every field of the fluid cells and a
    mean +x velocity of 0.05, so the outlet sees flow both ways, and a NaN
    and an infinite velocity in its last column."""
    s = th.init(cfg, CPU)
    rng = np.random.default_rng(seed)
    fl = ~s.solid.numpy()
    f = [x.numpy().astype(np.float64) for x in s[:6]]
    f[1][fl] = np.arcsinh(0.05 / cfg.u_ref)
    for k, amp in enumerate((0.3, 0.05, 0.05, 0.05, 0.3, 0.3)):
        f[k] = f[k] + np.where(fl, amp * rng.standard_normal(f[k].shape), 0.0)
    f[0][0, 1, -1] = np.nan
    f[1][-1, 0, -1] = np.inf
    t = [torch.tensor(x, dtype=cfg.torch_dtype) for x in f]
    return th.Hypersonic3DState(*t, solid=s.solid, t=s.t, dtau=s.dtau)


def plain(cfg, s, sp):
    return th._padded_prims(cfg, th._decode(cfg, *s[:6]), sp)


def assert_bitwise(got, want):
    for name, a, b in zip(th.PrimT._fields, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        it = torch.int32 if a.element_size() == 4 else torch.int64
        assert torch.equal(a.view(it), b.view(it)), name


def slab(cfg, s, ranks, rank):
    """Rank `rank`'s extended z-slab of `s` and its padded mask, as
    parallel/hypersonic3d_sharded builds them: HALO slices from each ring
    neighbour, the mask from 2 * HALO, wrapped in y, False x pads."""
    from dataclasses import replace

    nzl = cfg.nz // ranks

    def ring(f, h):
        return f[torch.arange(rank * nzl - h, (rank + 1) * nzl + h) % cfg.nz]

    sp = ring(s.solid, 2 * H)
    sp = torch.cat([sp[:, -H:], sp, sp[:, :H]], dim=1)
    zf = torch.zeros((sp.shape[0], sp.shape[1], H), dtype=torch.bool)
    sp = torch.cat([zf, sp, zf], dim=2)
    st = th.Hypersonic3DState(*(ring(f, H) for f in s[:6]),
                              solid=ring(s.solid, H), t=s.t, dtau=s.dtau)
    return replace(cfg, nz=nzl + 2 * H), st, sp


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("outflow", ["transmissive", "characteristic"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cpu_route_is_the_plain_prologue_bitwise(dtype, outflow, grid):
    cfg = cfg_of(*grid, outflow=outflow, dtype=dtype, sdf_r=0.3)
    s = noisy_state(cfg)
    sp = th.solid_pad_of(cfg, CPU)
    hk.reset_launches()
    got = hk.pad(cfg, s, sp)
    assert hk.LAUNCHES == {"step": 0, "wavespeed": 0, "pad": 0}
    assert got.r.shape == (grid[0] + 2 * H, grid[1] + 2 * H, grid[2] + 2 * H)
    assert_bitwise(got, plain(cfg, s, sp))
    assert_bitwise(hk.pad_plain(cfg, s, sp), plain(cfg, s, sp))


@pytest.mark.parametrize("outflow", ["transmissive", "characteristic"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cpu_route_on_the_sharded_runners_z_slab(dtype, outflow):
    cfg = th.default_config(16, outflow=outflow, dtype=dtype)
    s = noisy_state(cfg, seed=11)
    cfg_ext, st, sp = slab(cfg, s, ranks=2, rank=1)
    assert st.xi.shape == (8 + 2 * H, 16, 16)
    assert bool(sp.any()) and not bool(sp[:, :, :H].any())
    hk.reset_launches()
    got = hk.pad(cfg_ext, st, sp)
    assert hk.LAUNCHES["pad"] == 0
    assert_bitwise(got, plain(cfg_ext, st, sp))


def test_the_padding_wraps_and_resolves_each_boundary():
    """What the plain prologue (and so the kernel) computes at a cell of
    each kind: y/z wrap, the inflow columns, the transmissive ghost and
    the wall state."""
    cfg = cfg_of(5, 6, 7, dtype="float64", sdf_r=0.3)
    s = noisy_state(cfg)
    sp = th.solid_pad_of(cfg, CPU)
    qp = hk.pad(cfg, s, sp)
    q = th._decode(cfg, *s[:6])
    infl = th.inflow_values(cfg)
    fl = ~sp
    # interior, wrapped in y and z
    for (zp, yp, xp), (z, y, x) in (((0, 1, 4), (2, 4, 1)),
                                    ((7, 8, 9), (4, 5, 6)),
                                    ((4, 2, 3), (1, 5, 0))):
        if bool(fl[zp, yp, xp]):
            for a, b in zip(qp, q):
                assert a[zp, yp, xp].item() == b[z, y, x].item() or (
                    np.isnan(a[zp, yp, xp].item())
                    and np.isnan(b[z, y, x].item()))
    for k, v in enumerate(infl):
        col = qp[k][:, :, :H][fl[:, :, :H]]
        assert bool((col == torch.tensor(v, dtype=torch.float64)).all())
    # the three ghosts of a transmissive row are one column
    for k in range(6):
        g = qp[k][:, :, -H:]
        same = (g == g[:, :, :1]) | (g.isnan() & g[:, :, :1].isnan())
        assert bool(same[fl[:, :, -H:]].all())
    # wall cells: no velocity, the wall e_vib, p kept
    assert bool((qp.u[sp] == 0).all()) and bool((qp.v[sp] == 0).all())
    ev_w = th.evib_eq(cfg, torch.tensor(cfg.Twall, dtype=torch.float64))
    assert bool((qp.ev[sp] == ev_w).all())


def test_step_pad_hook_default_and_plain_agree_on_cpu():
    cfg = cfg_of(8, 9, 10, dtype="float64")
    s = noisy_state(cfg)
    s = s._replace(xi=torch.nan_to_num(s.xi), phix=torch.nan_to_num(
        s.phix, posinf=0.0))
    calls = []

    def recording(st, sp):
        calls.append(sp.shape)
        return hk.pad_plain(cfg, st, sp)

    hk.reset_launches()
    a = th.step(cfg, s)
    b = th.step(cfg, s, pad=recording)
    c = th.run(cfg, s, 1, pad=functools.partial(hk.pad_plain, cfg))
    assert calls == [(14, 15, 16)]
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert hk.LAUNCHES == {"step": 0, "wavespeed": 0, "pad": 0}


def test_launches_stay_zero_over_a_cpu_run():
    cfg = th.default_config(12)
    hk.reset_launches()
    out = th.run(cfg, th.init(cfg, CPU), 3)
    assert bool(torch.isfinite(out.xi).all())
    assert hk.LAUNCHES == {"step": 0, "wavespeed": 0, "pad": 0}


def test_th3cs_torch_engine_passes_the_plain_pad():
    cfg = th.default_config(8)
    hooks = th3cs._hooks(cfg, "torch")
    assert set(hooks) == {"core", "wavespeed", "pad"}
    assert hooks["pad"].func is hk.pad_plain and hooks["pad"].args == (cfg,)
    assert th3cs._hooks(cfg, "cuda") == {}


def test_pad_refuses_a_device_it_has_no_route_for():
    cfg = cfg_of(4, 4, 4)
    m = torch.zeros((10, 10, 10), dtype=torch.bool, device="meta")
    s = th.Hypersonic3DState(*(torch.zeros((4, 4, 4), device="meta")
                               for _ in range(6)), solid=m[:4, :4, :4],
                             t=torch.zeros((), device="meta"),
                             dtau=torch.zeros((), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        hk.pad(cfg, s, m)
