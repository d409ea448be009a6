"""CUDA kernels of the 2-D stable-fluids step, with their wrappers and plain
PyTorch versions, and the 'cuda' engine's step built on them.

* `lin_solve(x, b, a, c, iters)` — csrc/stam2d_lin_solve.cu, which
  replaces the TPU kernel fluidsims_tpu/kernels/stam2d_pallas.py::
  _lin_solve_kernel: the whole Jacobi solve, `iters` sweeps of
  x <- (b + a * sum4(x)) / c on an (ny, nx) field with a zero ring, in one
  cooperative launch, several sweeps a grid sync on tiles in shared
  memory (`solve_launch` reports the tile and the sweeps a sync); x is not
  written.  Plain version: `lin_solve_plain` (solvers/stam2d.py::
  _lin_solve).  The one-device step solves (n, n) fields; the x-slab
  runner (parallel/stam2d_sharded.py) its slab and exchanged columns.
* `advect(cfg, qs, uu, vv, window, ovf)` — csrc/stam2d_advect.cu, which
  replaces stam2d_pallas.py::_advect_kernel: the exact bilinear back-trace
  of one or two fields by one velocity, in new tensors; over a `Window`
  of columns (the x-slab runner's) the back-trace's column is clamped to
  the exchanged slab and the clamped cells are added to a device int32,
  once per field.  Plain version: `advect_plain` (solvers/stam2d.py::
  _advect_fields; over a window JAX's parallel/stam2d_sharded.py::
  _advect_sharded).
* `make_step_cuda(cfg)` — the 'cuda' engine's frame step:
  solvers/stam2d.py::_step on the two kernels, 5 solves and 2 advection
  launches a step.

Both kernels are bitwise equal to their plain versions (same operation
order, the library built with -fmad=false, true divisions), and the plain
versions are the 'torch' engine's functions.

The wrappers take the plain version for CPU tensors only.  For CUDA
tensors they check device, dtype, shape and contiguity, launch on the
current stream, count the launch in `LAUNCHES`, and raise if the launch
fails; nothing falls back.  The solve's grid is asked of the card once
per (ny, nx, dtype, device) (`solve_launch`), and its scratch field and
slot words are kept per (ny, nx, dtype, device, stream)
(`_common.tile_scratch`, which says why that is safe).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.scalar import div
from ..solvers import stam2d as s2
from . import _build
from ._common import (LaunchCounter, TileLaunch, check_tensors, on_cpu,
                      raise_if, tile_launch, tile_scratch)
from ._common import grid_syncs as _grid_syncs

__all__ = ["LAUNCHES", "reset_launches", "lin_solve", "lin_solve_plain",
           "Window", "advect", "advect_plain", "make_step_cuda", "load",
           "solve_launch", "solve_grid_syncs"]

LAUNCHES = LaunchCounter("lin_solve", "advect")
reset_launches = LAUNCHES.reset

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with typed entry
    points."""
    lib = _build.load_library()
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fst_stam2d_lin_solve_grid_{sfx}")
        fn.argtypes = [I, I, I, ctypes.POINTER(TileLaunch)]
        fn.restype = I
        fn = getattr(lib, f"fst_stam2d_lin_solve_{sfx}")
        fn.argtypes = [P] * 5 + [I, I, D, D, I, I, I, P]
        fn.restype = I
        fn = getattr(lib, f"fst_stam2d_advect_{sfx}")
        fn.argtypes = [P] * 11 + [I, I, I, I, D, D, D, I, P]
        fn.restype = I
    lib.fst_cuda_error_string.argtypes = [I]
    lib.fst_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _shape(fields: dict, square: bool = False) -> tuple:
    """(ny, nx) of the fields; raises unless all lie on one device with
    one dtype that has a kernel, and are 2-D, nonempty (and square where
    asked), equal and contiguous."""
    ref = next(iter(fields.values()))
    if ref.dtype not in _SUFFIX:
        raise TypeError(f"no kernel for dtype {ref.dtype}")
    shape = tuple(ref.shape)
    if len(shape) != 2 or min(shape) < 1 or (square
                                             and shape[0] != shape[1]):
        raise ValueError(f"fields must be {'(n, n)' if square else '(ny, nx)'}"
                         f", got {shape}")
    check_tensors(fields, shape, ref.dtype, ref.device)
    return shape


def _check(**fields) -> int:
    """n of the (n, n) fields, checked as `_shape` checks them."""
    return _shape(fields, square=True)[0]


def _raise_if(code: int, lib, what: str) -> None:
    raise_if(code, lib, f"stam2d {what}")


# ------------------------------- Jacobi solve --------------------------------


@functools.lru_cache(maxsize=None)
def solve_launch(ny: int, dtype: torch.dtype, index: int,
                 nx: int | None = None) -> TileLaunch:
    """The launch of a solve on an (ny, nx) field (nx = ny where not given)
    on device `index`, as the library computes it: blocks, threads a
    block, the tile (csrc/stam2d_lin_solve.cu kSolveTileX x kSolveTileY,
    each clipped to its axis), the halo (= the sweeps a grid sync,
    kSolveSweeps) and the dynamic shared memory a block.  A solve of
    `iters` sweeps makes ceil(iters / halo) - 1 grid syncs."""
    return tile_launch(load(), f"fst_stam2d_lin_solve_grid_{_SUFFIX[dtype]}",
                       ny, ny if nx is None else nx, index)


def _scratch(ny: int, nx: int, dtype: torch.dtype,
             device: torch.device) -> tuple:
    """(scratch field, slot words) of solves on an (ny, nx) field on the
    device's current stream."""
    stream = torch.cuda.current_stream(device).cuda_stream
    return tile_scratch(("lin_solve", ny, nx), ny * nx, dtype, device,
                        stream)


def solve_grid_syncs(ny: int, dtype: torch.dtype, device: torch.device,
                     nx: int | None = None) -> int:
    """The grid syncs that the last solve on an (ny, nx) field (nx = ny
    where not given) of `dtype` on the device's current stream made, as
    the kernel counted them."""
    return _grid_syncs(_scratch(ny, ny if nx is None else nx, dtype,
                                device)[1])


def lin_solve_plain(x, b, a: float, c: float, iters: int):
    """Plain PyTorch version of the solve kernel: `iters` sweeps from x,
    in a new tensor."""
    return s2._lin_solve(x, b, a, c, iters)


def lin_solve(x, b, a: float, c: float, iters: int):
    """`iters` Jacobi sweeps from x into a new tensor: the kernel on CUDA
    tensors, the plain version on CPU tensors.  x is not written."""
    if iters < 1:
        raise ValueError(f"iters={iters}: a solve takes at least one sweep")
    if on_cpu(x):
        return lin_solve_plain(x, b, a, c, iters)
    ny, nx = _shape({"x": x, "b": b})
    dev = x.device
    lib = load()
    shape = solve_launch(ny, x.dtype, dev.index, nx)
    out = torch.empty_like(x)
    scratch, words = _scratch(ny, nx, x.dtype, dev)
    code = getattr(lib, f"fst_stam2d_lin_solve_{_SUFFIX[x.dtype]}")(
        x.data_ptr(), b.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        words.data_ptr(), ny, nx, float(a), float(c), iters, shape.grid,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_if(code, lib, "lin_solve kernel launch")
    LAUNCHES["lin_solve"] += 1
    return out


# -------------------------------- advection ----------------------------------


class Window(NamedTuple):
    """The columns an advection writes, as the x-slab runner gives them:
    `n_loc` (the velocity's columns) from global column `col_off`, its
    fields read from their exchanged slab of n_loc + 2 h columns (zero
    past the domain edges)."""
    col_off: int
    h: int


def _window_plain(cfg, qs, uu, vv, win: Window, ovf):
    """JAX's fluidsims_tpu/parallel/stam2d_sharded.py::_advect_sharded in
    the expressions of solvers/stam2d.py::_backtrace_coords: the column
    i0 clamped to the slab, s1 clipped to [0, 1], the clamped cells added
    to ovf once per field.  Unclamped, each cell has the whole field's
    bits."""
    n, n_loc = cfg.n, uu.shape[-1]
    m = s2.metric(cfg, uu)
    cols = slice(win.col_off, win.col_off + n_loc)
    deta = s2._deta(cfg)
    bx = m.eta[None, cols] - cfg.dt * uu / m.xp[None, cols]
    by = m.eta[:, None] - cfg.dt * vv / m.yp[:, None]
    sarr = torch.clamp(div(bx - cfg.eta_min, deta) + 0.5, 0.5, n + 0.5)
    tarr = torch.clamp(div(by - cfg.eta_min, deta) + 0.5, 0.5, n + 0.5)
    i0 = torch.floor(sarr).to(torch.int32)
    j0 = torch.floor(tarr).to(torch.int32)
    lo = win.col_off + 1 - win.h
    i0c = torch.clamp(i0, lo, lo + n_loc + 2 * win.h - 2)
    if ovf is not None:
        ovf.add_((i0c != i0).sum() * len(qs))
    s1 = torch.clamp(sarr - i0c, 0.0, 1.0)
    t1 = tarr - j0
    return tuple(s2._bilinear(F.pad(q, (0, 0, 1, 1)), i0c - lo, j0, s1, t1)
                 for q in qs)


def advect_plain(cfg, qs, uu, vv, window: Window | None = None, ovf=None):
    """Plain PyTorch version of the advection kernel: the 'torch' engine's
    exact gather of each field of qs (one or two); over a window, the
    x-slab runner's clamped gather, which adds its clamps to `ovf` (a 0-d
    int32 tensor, in place) where given."""
    qs = tuple(qs)
    if window is None:
        return s2._advect_fields(cfg, qs, uu, vv)
    return _window_plain(cfg, qs, uu, vv, window, ovf)


def _window_shape(cfg, qs: tuple, fields: dict, win: Window, ovf) -> int:
    """n_loc of a windowed launch; raises unless the velocity is (n, n_loc)
    and each field its (n, n_loc + 2 h) slab, all on one device with one
    dtype, the window inside the grid, and ovf one int32 on that device."""
    ny, n_loc = _shape(fields)
    col_off, h = win
    shape = (cfg.n, n_loc + 2 * h)
    if ny != cfg.n or not (h >= 1 and 0 <= col_off
                           and col_off + n_loc <= cfg.n):
        raise ValueError(f"velocity {(ny, n_loc)} and window {win} do not "
                         f"fit n={cfg.n}")
    check_tensors({f"q{k}": q for k, q in enumerate(qs)}, shape,
                  fields["uu"].dtype, fields["uu"].device)
    if ovf is not None and (ovf.dtype != torch.int32 or ovf.numel() != 1
                            or ovf.device != fields["uu"].device):
        raise ValueError("ovf must be one int32 on the fields' device")
    return n_loc


def advect(cfg, qs, uu, vv, window: Window | None = None, ovf=None) -> tuple:
    """The fields of qs (one or two) advected by one back-trace of (uu,
    vv), as new tensors: the kernel on CUDA tensors, the plain version on
    CPU tensors.  Without a window the fields and the velocity are (n, n);
    over a window the velocity is (n, n_loc) and each field its (n, n_loc
    + 2 h) slab, and the clamped cells are added to `ovf` (a 0-d int32
    tensor on the fields' device, in place) where given."""
    qs = tuple(qs)
    if len(qs) not in (1, 2):
        raise ValueError(f"advect takes 1 or 2 fields, got {len(qs)}")
    if on_cpu(uu):
        return advect_plain(cfg, qs, uu, vv, window, ovf)
    m = s2.metric(cfg, uu)
    fields = {"uu": uu, "vv": vv}
    if window is None:
        n_loc = _check(**fields, **{f"q{k}": q for k, q in enumerate(qs)})
        if n_loc != cfg.n:
            raise ValueError(f"fields hold n={n_loc}, config says n={cfg.n}")
        col_off = h = 0
        eta_x, xp = m.eta, m.xp
    else:
        n_loc = _window_shape(cfg, qs, fields, window, ovf)
        col_off, h = window
        eta_x = m.eta[col_off:col_off + n_loc]
        xp = m.xp[col_off:col_off + n_loc]
    outs = tuple(torch.empty_like(uu) for _ in qs)
    qb, outb = (qs[1].data_ptr(), outs[1].data_ptr()) if len(qs) == 2 \
        else (None, None)
    lib = load()
    with torch.cuda.device(uu.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"fst_stam2d_advect_{_SUFFIX[uu.dtype]}")(
            qs[0].data_ptr(), qb, uu.data_ptr(), vv.data_ptr(),
            eta_x.data_ptr(), xp.data_ptr(), m.eta.data_ptr(),
            m.yp.data_ptr(), outs[0].data_ptr(), outb,
            None if ovf is None else ovf.data_ptr(), cfg.n, n_loc, col_off,
            h, float(cfg.dt), float(cfg.eta_min), s2._deta(cfg),
            uu.device.index, stream)
    _raise_if(code, lib, "advect kernel launch")
    LAUNCHES["advect"] += 1
    return outs


def make_step_cuda(cfg):
    """Frame step state -> state on the two kernels: solvers/stam2d.py::
    _step with `lin_solve` (5 a step, jacobi_iters sweeps each) and
    `advect` (the velocity pair and the density, 2 a step)."""
    iters = cfg.jacobi_iters
    return lambda s: s2._step(
        cfg, s,
        lambda x, b, a, c: lin_solve(x, b, a, c, iters),
        lambda q, uu, vv: advect(cfg, (q,), uu, vv)[0],
        lambda qa, qb, uu, vv: advect(cfg, (qa, qb), uu, vv))
