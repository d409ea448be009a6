"""CUDA kernels of the 2-D stable-fluids step, with their wrappers and plain
PyTorch versions, and the 'cuda' engine's step built on them.

* `lin_solve(x, b, a, c, iters)` — csrc/stam2d_lin_solve.cu, which
  replaces the TPU kernel fluidsims_tpu/kernels/stam2d_pallas.py::
  _lin_solve_kernel: the whole Jacobi solve, `iters` sweeps of
  x <- (b + a * sum4(x)) / c on a zero ring, in one cooperative launch,
  several sweeps a grid sync on tiles in shared memory (`solve_launch`
  reports the tile and the sweeps a sync); x is not written.  Plain
  version: `lin_solve_plain` (solvers/stam2d.py::_lin_solve).
* `advect(cfg, qs, uu, vv)` — csrc/stam2d_advect.cu, which replaces
  stam2d_pallas.py::_advect_kernel: the exact bilinear back-trace of one
  or two fields by one velocity, in new tensors.  Plain version:
  `advect_plain` (solvers/stam2d.py::_advect_fields).
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
per (n, dtype, device) (`solve_launch`), and its scratch field and slot
words are kept per (n, dtype, device, stream) (`_common.tile_scratch`,
which says why that is safe).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..solvers import stam2d as s2
from . import _build
from ._common import (LaunchCounter, TileLaunch, check_tensors, on_cpu,
                      raise_if, tile_launch, tile_scratch)
from ._common import grid_syncs as _grid_syncs

__all__ = ["LAUNCHES", "reset_launches", "lin_solve", "lin_solve_plain",
           "advect", "advect_plain", "make_step_cuda", "load", "solve_launch",
           "solve_grid_syncs"]

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
        fn.argtypes = [I, I, ctypes.POINTER(TileLaunch)]
        fn.restype = I
        fn = getattr(lib, f"fst_stam2d_lin_solve_{sfx}")
        fn.argtypes = [P] * 5 + [I, D, D, I, I, I, P]
        fn.restype = I
        fn = getattr(lib, f"fst_stam2d_advect_{sfx}")
        fn.argtypes = [P] * 9 + [I, D, D, D, I, P]
        fn.restype = I
    lib.fst_cuda_error_string.argtypes = [I]
    lib.fst_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(**fields) -> int:
    """n of the (n, n) fields; raises unless all lie on one device with one
    dtype that has a kernel, and are square, equal and contiguous."""
    ref = next(iter(fields.values()))
    if ref.dtype not in _SUFFIX:
        raise TypeError(f"no kernel for dtype {ref.dtype}")
    shape = tuple(ref.shape)
    if len(shape) != 2 or shape[0] != shape[1] or shape[0] < 1:
        raise ValueError(f"fields must be (n, n), got {shape}")
    check_tensors(fields, shape, ref.dtype, ref.device)
    return shape[0]


def _raise_if(code: int, lib, what: str) -> None:
    raise_if(code, lib, f"stam2d {what}")


# ------------------------------- Jacobi solve --------------------------------


@functools.lru_cache(maxsize=None)
def solve_launch(n: int, dtype: torch.dtype, index: int) -> TileLaunch:
    """The launch of a solve on an (n, n) field on device `index`, as the
    library computes it: blocks, threads a block, the tile (csrc/
    stam2d_lin_solve.cu kSolveTileX x kSolveTileY clipped to the field),
    the halo (= the sweeps a grid sync, kSolveSweeps) and the dynamic
    shared memory a block.  A solve of `iters` sweeps makes
    ceil(iters / halo) - 1 grid syncs."""
    return tile_launch(load(), f"fst_stam2d_lin_solve_grid_{_SUFFIX[dtype]}",
                       n, index)


def _scratch(n: int, dtype: torch.dtype, device: torch.device) -> tuple:
    """(scratch field, slot words) of solves on the device's current
    stream."""
    stream = torch.cuda.current_stream(device).cuda_stream
    return tile_scratch("lin_solve", n * n, dtype, device, stream)


def solve_grid_syncs(n: int, dtype: torch.dtype,
                     device: torch.device) -> int:
    """The grid syncs that the last solve on an (n, n) field of `dtype` on
    the device's current stream made, as the kernel counted them."""
    return _grid_syncs(_scratch(n, dtype, device)[1])


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
    n = _check(x=x, b=b)
    dev = x.device
    lib = load()
    shape = solve_launch(n, x.dtype, dev.index)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch, words = tile_scratch("lin_solve", n * n, x.dtype, dev, stream)
    code = getattr(lib, f"fst_stam2d_lin_solve_{_SUFFIX[x.dtype]}")(
        x.data_ptr(), b.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        words.data_ptr(), n, float(a), float(c), iters, shape.grid,
        dev.index, stream)
    _raise_if(code, lib, "lin_solve kernel launch")
    LAUNCHES["lin_solve"] += 1
    return out


# -------------------------------- advection ----------------------------------


def advect_plain(cfg, qs, uu, vv) -> tuple:
    """Plain PyTorch version of the advection kernel: the 'torch' engine's
    exact gather of each field of qs (one or two)."""
    return s2._advect_fields(cfg, tuple(qs), uu, vv)


def advect(cfg, qs, uu, vv) -> tuple:
    """The fields of qs (one or two) advected by one back-trace of (uu,
    vv), as new tensors: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    qs = tuple(qs)
    if len(qs) not in (1, 2):
        raise ValueError(f"advect takes 1 or 2 fields, got {len(qs)}")
    if on_cpu(uu):
        return advect_plain(cfg, qs, uu, vv)
    n = _check(uu=uu, vv=vv, **{f"q{k}": q for k, q in enumerate(qs)})
    if n != cfg.n:
        raise ValueError(f"fields hold n={n}, config says n={cfg.n}")
    m = s2.metric(cfg, uu)
    outs = tuple(torch.empty_like(q) for q in qs)
    qb, outb = (qs[1].data_ptr(), outs[1].data_ptr()) if len(qs) == 2 \
        else (None, None)
    lib = load()
    with torch.cuda.device(uu.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"fst_stam2d_advect_{_SUFFIX[uu.dtype]}")(
            qs[0].data_ptr(), qb, uu.data_ptr(), vv.data_ptr(),
            m.eta.data_ptr(), m.xp.data_ptr(), m.yp.data_ptr(),
            outs[0].data_ptr(), outb, n, float(cfg.dt), float(cfg.eta_min),
            s2._deta(cfg), uu.device.index, stream)
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
