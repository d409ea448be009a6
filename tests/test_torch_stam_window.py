"""The Stam kernels' shapes of the sharded runners, modelled on the CPU:
#9 (csrc/stam2d_lin_solve.cu) on (ny, nx) fields, #10
(csrc/stam2d_advect.cu) over a column window with its clamp count, #11
(csrc/stam3d_jacobi.cu) over a z-slab, and the runners' compositions of
them at one rank in process.

* #9: the kernel's tile model (tests/test_torch_stam2d.py
  `tiled_lin_solve`, the tile clipped to each axis) on rectangular fields,
  and on the x-slab runner's round slabs (an edge rank's n / D + kb
  columns, an inner rank's n / D + 2 kb), bitwise the plain solve.
* #10: `advect_plain` over a window of the whole field is bitwise the
  whole-field default; windows of the columns are the default's columns
  when nothing clamps; with 2 exchanged columns the gathered fields and
  the clamp count equal JAX's parallel/stam2d_sharded.py::_advect_sharded
  under shard_map on its virtual CPU devices.
* #11: `jacobi_plain` over a slab of W = n + 2 slices at z_off = 0 is
  today's sweep; over other slabs it writes exactly the global interior
  slices among the slab's inner ones, with the whole volume's bits.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

from fluidsims_tpu.parallel import stam2d_sharded as jsh2
from fluidsims_tpu.parallel.mesh import make_mesh_1d
from fluidsims_tpu.solvers import stam2d as js2
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.kernels import stam2d_cuda as s2k
from fluidsims_tpu_torch.kernels import stam3d_cuda as s3k
from fluidsims_tpu_torch.ops.scalar import div
from fluidsims_tpu_torch.parallel import stam2d_sharded as s2s
from fluidsims_tpu_torch.parallel import stam3d_sharded as s3s
from fluidsims_tpu_torch.parallel.mesh import Mesh
from fluidsims_tpu_torch.solvers import stam2d as ts2
from fluidsims_tpu_torch.solvers import stam3d as ts3
from tests.test_torch_stam2d import SOLVE_TILE, tiled_lin_solve

torch.set_num_threads(1)
CPU = torch.device("cpu")
DTYPES = {"float32": torch.float32, "float64": torch.float64}
ONE = Mesh(("x",), (1,), 0, CPU, "gloo")   # one rank: no collective runs


def fields(shape, dtype, seed, k=2):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.random(shape), dtype=DTYPES[dtype])
            for _ in range(k)]


# ------------------------------ #9, (ny, nx) ---------------------------------


def kernel_tile(ny: int, nx: int) -> tuple:
    """The solve kernel's tile on an (ny, nx) field: kSolveTileX x
    kSolveTileY, each clipped to its axis, and kSolveSweeps."""
    return (min(SOLVE_TILE[0], nx), min(SOLVE_TILE[1], ny), SOLVE_TILE[2])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ny, nx", [(32, 12), (32, 20), (9, 65), (65, 9),
                                    (1, 7)])
@pytest.mark.parametrize("iters", [1, 8, 9, 40])
def test_tiled_solve_model_rectangular(dtype, ny, nx, iters):
    """The tile model on (ny, nx) fields, with the kernel's tile and with a
    small one that walks many tiles, is bitwise the plain solve."""
    x, b = fields((ny, nx), dtype, ny * 100 + nx)
    ref = ts2._lin_solve(x, b, 0.26, 2.04, iters)
    assert torch.equal(tiled_lin_solve(x, b, 0.26, 2.04, iters,
                                       kernel_tile(ny, nx)), ref)
    assert torch.equal(tiled_lin_solve(x, b, 0.26, 2.04, iters, (5, 3, 3)),
                       ref)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("world, kb", [(2, 8), (4, 3), (4, 8), (8, 1)])
def test_solve_round_slabs(dtype, world, kb):
    """One round of the x-slab runner: each rank's columns of the global
    field, extended by kb columns on each side that has a neighbour, swept
    kb times by the tile model (the kernel's tile at the slab's width) and
    cropped, give the global field's kb sweeps bitwise."""
    n = 32
    x, b = fields((n, n), dtype, world * 10 + kb)
    ref = ts2._lin_solve(x, b, 1.0, 4.0, kb)
    nl = n // world
    for r in range(world):
        lo, hi = kb * (r > 0), kb * (r < world - 1)
        cols = slice(r * nl - lo, (r + 1) * nl + hi)
        xs, bs = x[:, cols].contiguous(), b[:, cols].contiguous()
        got = tiled_lin_solve(xs, bs, 1.0, 4.0, kb,
                              kernel_tile(n, xs.shape[1]))
        assert torch.equal(got[:, lo:got.shape[1] - hi],
                           ref[:, r * nl:(r + 1) * nl])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("halo_k", [1, 3, 8, 19])
def test_sharded_solve_one_rank(dtype, halo_k):
    """The runner's rounds at one rank (no exchange) are the whole solve."""
    x, b = fields((19, 19), dtype, halo_k)
    assert torch.equal(
        s2s._lin_solve_sharded(x, b, 0.26, 2.04, 40, halo_k, ONE, "x"),
        ts2._lin_solve(x, b, 0.26, 2.04, 40))


def test_wrapper_takes_rectangles():
    x, b = fields((7, 12), "float32", 0)
    assert s2k._shape({"x": x, "b": b}) == (7, 12)
    with pytest.raises(ValueError, match="\\(n, n\\)"):
        s2k._check(x=x, b=b)
    with pytest.raises(ValueError, match="shape"):
        s2k._shape({"x": x, "b": b[:, :-1]})
    assert torch.equal(s2k.lin_solve(x, b, 1.0, 4.0, 5),
                       ts2._lin_solve(x, b, 1.0, 4.0, 5))


# --------------------------- #10, a column window ----------------------------


def velocity(n, dtype, seed, scale):
    """(uu, vv) uniform in [-scale, scale)."""
    u, v = (scale * (2.0 * f - 1.0) for f in fields((n, n), dtype, seed))
    return u, v


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [17, 32])
@pytest.mark.parametrize("h", [1, 3])
def test_window_of_whole_field_is_default(dtype, n, h):
    """A window of all n columns on the fields' zero-padded slabs is the
    whole-field default bitwise, at back-traces past the edge, and counts
    nothing (the clamp [1 - h, n + h - 1] holds [0, n])."""
    cfg = ts2.Stam2DConfig(n=n, dtype=dtype)
    q, q2 = fields((n, n), dtype, n + 1)
    uu, vv = velocity(n, dtype, n, 2.0)
    for qs in ((q,), (q, q2)):
        ovf = torch.zeros((), dtype=torch.int32)
        got = s2k.advect_plain(cfg, tuple(F.pad(f, (h, h)) for f in qs),
                               uu, vv, s2k.Window(0, h), ovf)
        for a, b in zip(got, s2k.advect_plain(cfg, qs, uu, vv)):
            assert torch.equal(a, b)
        assert int(ovf) == 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("world", [2, 4])
def test_window_columns_are_default_columns(dtype, world):
    """Windows of n / D columns at the runner's default halo (16, or n /
    D) on calm velocities: each is the default's columns bitwise, count
    0."""
    n = 32
    cfg = ts2.Stam2DConfig(n=n, dtype=dtype)
    q, q2 = fields((n, n), dtype, 3)
    uu, vv = velocity(n, dtype, 4, 0.05)
    ref = s2k.advect_plain(cfg, (q, q2), uu, vv)
    nl = n // world
    h = min(16, nl)
    qp = [F.pad(f, (h, h)) for f in (q, q2)]
    for r in range(world):
        c = slice(r * nl, (r + 1) * nl)
        ovf = torch.zeros((), dtype=torch.int32)
        got = s2k.advect_plain(
            cfg, tuple(f[:, r * nl:(r + 1) * nl + 2 * h].contiguous()
                       for f in qp),
            uu[:, c].contiguous(), vv[:, c].contiguous(),
            s2k.Window(r * nl, h), ovf)
        for a, b in zip(got, ref):
            assert torch.equal(a, b[:, c])
        assert int(ovf) == 0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("pair", [False, True])
def test_window_matches_jax_advect_sharded(world, pair):
    """With 2 exchanged columns at dt = 1 on JAX's init swirl (float64):
    every rank's window, on the zero-filled slab, within 1e-12 of JAX's
    _advect_sharded under shard_map, and the clamp count summed over the
    ranks JAX's (per field: the pair counts each cell twice)."""
    n, h = 32, 2
    jc = js2.Stam2DConfig(n=n, dtype="float64")
    sj = js2.init(jc)
    cfg = interop.stam2d_config_from_dict(jc.asdict())
    st = interop.stam2d_state_from_numpy(*(np.asarray(f) for f in sj),
                                         dtype=torch.float64, device=CPU)
    mesh = make_mesh_1d(world)
    nl = n // world
    eta, xp, yp = jsh2._metric(jc)
    fs = P(None, "x")
    body = jax.shard_map(
        lambda q, u, v, el, xl, ea, ya: (lambda out: (
            out[0], jax.lax.psum(out[1], "x")))(jsh2._advect_sharded(
                jc, q, u, v, h, jax.lax.axis_index("x") * nl, el, xl, ea,
                ya, "x", world)),
        mesh=mesh, in_specs=(fs,) * 3 + (P("x"), P("x"), P(), P()),
        out_specs=(fs, P()), check_vma=False)
    jq, jcount = jax.jit(body)(sj.d, sj.u, sj.v, eta, xp, eta, yp)
    qs = (st.d, st.u) if pair else (st.d,)
    slabs = [F.pad(f, (h, h)) for f in qs]
    ovf = torch.zeros((), dtype=torch.int32)
    for r in range(world):
        c = slice(r * nl, (r + 1) * nl)
        got = s2k.advect_plain(
            cfg, tuple(f[:, r * nl:(r + 1) * nl + 2 * h].contiguous()
                       for f in slabs),
            st.u[:, c].contiguous(), st.v[:, c].contiguous(),
            s2k.Window(r * nl, h), ovf)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(jq)[:, c],
                                   rtol=0, atol=1e-12)
    assert int(jcount) > 0
    assert int(ovf) == int(jcount) * len(qs)


def test_advect_wrapper_window_on_cpu_counts():
    """The wrapper takes the plain version for CPU tensors, window and
    count included."""
    n = 16
    cfg = ts2.Stam2DConfig(n=n, dtype="float64")
    q, = fields((n, n), "float64", 1, k=1)
    uu, vv = velocity(n, "float64", 2, 20.0)
    a, b = torch.zeros((), dtype=torch.int32), torch.zeros((),
                                                         dtype=torch.int32)
    got = s2k.advect(cfg, (F.pad(q[:, :8], (1, 1)),), uu[:, :8].contiguous(),
                     vv[:, :8].contiguous(), s2k.Window(0, 1), a)
    ref = s2k.advect_plain(cfg, (F.pad(q[:, :8], (1, 1)),),
                           uu[:, :8].contiguous(), vv[:, :8].contiguous(),
                           s2k.Window(0, 1), b)
    assert torch.equal(got[0], ref[0]) and int(a) == int(b) > 0
    assert s2k.LAUNCHES["advect"] == 0


# ------------------------------ #11, a z-slab --------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_jacobi_plain_whole_volume_is_today(dtype):
    """W = n + 2 slices at z_off = 0: the interior sweep, ring untouched."""
    x, x0, w0 = fields((11, 11, 11), dtype, 5, k=3)
    out = w0.clone()
    s3k.jacobi_plain(x, x0, out, 0.37, 3.22)
    assert torch.equal(out, ts3._set_interior(w0, div(
        ts3._interior(x0) + 0.37 * ts3._sum6(x), 3.22)))
    assert torch.equal(s3k.jacobi_plain(x, x0, w0.clone(), 0.37, 3.22, 0),
                       out)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("z_off, w", [(-3, 7), (-1, 5), (0, 5), (4, 6),
                                      (7, 6), (9, 6), (8, 9), (-2, 17)])
def test_jacobi_plain_slab(dtype, z_off, w):
    """A window of w slices from global slice z_off of an (n+2)^3 volume
    (zero past its ends, as the runner's exchange fills them): the sweep
    writes the slab's inner slices that lie in the global interior [1, n],
    with the whole volume's bits, and leaves every other cell as it was."""
    n = 9
    Np = n + 2
    x, x0, o = fields((Np, Np, Np), dtype, 7, k=3)
    whole = o.clone()
    s3k.jacobi_plain(x, x0, whole, 0.5, 4.0)

    def window(t):
        out = torch.zeros((w, Np, Np), dtype=t.dtype)
        for k in range(w):
            if 0 <= z_off + k < Np:
                out[k] = t[z_off + k]
        return out

    xw, x0w, ow = window(x), window(x0), window(o)
    keep = ow.clone()
    s3k.jacobi_plain(xw, x0w, ow, 0.5, 4.0, z_off)
    for k in range(w):
        g = z_off + k
        if 1 <= k <= w - 2 and 1 <= g <= n:
            assert torch.equal(ow[k], whole[g])
        else:
            assert torch.equal(ow[k], keep[k])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("halo_k", [1, 2, 3, 4, 5, 11])
def test_sharded_solve_one_rank_3d(dtype, halo_k):
    """The runner's rounds at one rank: the window of kb zero slices a
    side, the ring's parity from the global sweep index (odd round widths
    start rounds on odd sweeps), bitwise the one-device solve."""
    n = 9
    cfg = ts3.Stam3DConfig(n=n, jacobi_iters=12)
    x, b = fields((n + 2,) * 3, dtype, halo_k)
    got = s3s._lin_solve_sharded(x, b, 1.0, 6.0, 12, halo_k, n + 2, 0, ONE,
                                 "x")
    assert torch.equal(got, ts3._lin_solve(cfg, x, b, 1.0, 6.0))


def test_jacobi_wrapper_checks_slabs():
    x, x0, o = fields((5, 11, 11), "float32", 1, k=3)
    assert s3k._check_slab(x=x, x0=x0, out=o) == (5, 9)
    with pytest.raises(ValueError, match="W, n\\+2"):
        s3k._check_slab(x=x[:, :, :-1])
    with pytest.raises(ValueError, match="shape"):
        s3k._check_slab(x=x, x0=x0[:-1])
    assert s3k.jacobi(x, x0, o, 1.0, 6.0, -1) is o
    assert s3k.LAUNCHES["jacobi"] == 0
