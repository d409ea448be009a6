"""CUDA kernels of the 3-D stable-fluids step, with their wrappers and plain
PyTorch versions, and the 'cuda' engine's step built on them.

* `jacobi(x, x0, out, a, c, z_off)` — csrc/stam3d_jacobi.cu, which
  replaces the TPU kernel fluidsims_tpu/kernels/stam3d_pallas.py::
  _jacobi_kernel: one sweep, out's interior = (x0 + a * sum6(x)) / c,
  out's ring untouched; on a z-slab of W slices from global slice z_off
  (the z-slab runner's, parallel/stam3d_sharded.py) the slab's inner
  slices that lie in the global interior.  Plain version:
  `jacobi_plain`.
* `advect(cfg, q0, u, v, w)` — csrc/stam3d_advect.cu, which replaces
  stam3d_pallas.py::_advect_kernel: the exact trilinear gather of the
  backtrace, q0's ring passed through, in a new volume.  Plain version:
  `advect_plain` (solvers/stam3d.py::_advect_gather).
* `set_bnd(u, v, w, d)` — csrc/stam3d_set_bnd.cu, which replaces
  stam3d_pallas.py::_set_bnd_kernel: the reflective faces of the four
  fields, in place, all 12 (axis, field) pairs in one launch, a thread both
  walls of its axis (`set_bnd_launch` reports the blocks, threads and the
  block's extent).  Plain version: `set_bnd_plain`.
* `lin_solve(cfg, x, x0, a, c)` — the reference's Jacobi ping-pong
  (js_cuda3d.cu:297-313) over `jacobi` sweeps, between a copy of x and a
  scratch volume with a zero ring; `make_step_cuda(cfg)` — the 'cuda'
  engine's frame step: solvers/stam3d.py::_step on these three kernels.

All three kernels are bitwise equal to their plain versions (same
operation order, the library built with -fmad=false, true divisions), and
the plain versions to the 'torch' engine's functions.

The wrappers take the plain version for CPU tensors only.  For CUDA
tensors they check device, dtype, shape and contiguity, launch on the
current stream, count the launch in `LAUNCHES`, and raise if the launch
fails; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.scalar import div
from ..solvers import stam3d as s3
from . import _build
from ._common import (LaunchCounter, TileLaunch, check_tensors, on_cpu,
                      tile_launch)

__all__ = ["LAUNCHES", "reset_launches", "jacobi", "jacobi_plain", "advect",
           "advect_plain", "set_bnd", "set_bnd_plain", "lin_solve",
           "make_step_cuda", "load", "set_bnd_launch"]

LAUNCHES = LaunchCounter("jacobi", "advect", "set_bnd")
reset_launches = LAUNCHES.reset

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# (x, y, z) face signs of u, v, w, d: each velocity component reflects on
# its own axis' faces
_SIGNS = ((-1, 1, 1), (1, -1, 1), (1, 1, -1), (1, 1, 1))


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with typed entry
    points."""
    lib = _build.load_library()
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for sfx in _SUFFIX.values():
        for name, argtypes in (("jacobi", [P, P, P, I, I, I, D, D]),
                               ("advect", [P] * 5 + [I, D]),
                               ("set_bnd", [P] * 4 + [I])):
            fn = getattr(lib, f"fst_stam3d_{name}_{sfx}")
            fn.argtypes = argtypes + [I, P]
            fn.restype = ctypes.c_int
    lib.fst_stam3d_set_bnd_blocks.argtypes = [I, ctypes.POINTER(TileLaunch)]
    lib.fst_stam3d_set_bnd_blocks.restype = ctypes.c_int
    lib.fst_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fst_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_slab(**fields) -> tuple:
    """(W, n) of the (W, n+2, n+2) slabs; raises unless all lie on one
    device with one dtype that has a kernel, and are equal and
    contiguous."""
    ref = next(iter(fields.values()))
    if ref.dtype not in _SUFFIX:
        raise TypeError(f"no kernel for dtype {ref.dtype}")
    shape = tuple(ref.shape)
    if len(shape) != 3 or shape[1] != shape[2] or shape[1] < 3 or (
            shape[0] < 1):
        raise ValueError(f"fields must be (W, n+2, n+2), got {shape}")
    check_tensors(fields, shape, ref.dtype, ref.device)
    return shape[0], shape[1] - 2


def _check(**fields) -> int:
    """n of the (n+2)^3 volumes, checked as `_check_slab` checks slabs."""
    shape = tuple(next(iter(fields.values())).shape)
    if len(shape) != 3 or len(set(shape)) != 1 or shape[0] < 3:
        raise ValueError(f"fields must be (n+2, n+2, n+2), got {shape}")
    return _check_slab(**fields)[1]


def _launch(name: str, ref: torch.Tensor, *args) -> None:
    lib = load()
    fn = getattr(lib, f"fst_stam3d_{name}_{_SUFFIX[ref.dtype]}")
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(*args, ref.device.index or 0, stream)
    if code != 0:
        raise RuntimeError(
            f"stam3d {name} kernel launch failed: CUDA error {code} "
            f"({lib.fst_cuda_error_string(code).decode()})")
    LAUNCHES[name] += 1


# ------------------------------- Jacobi sweep --------------------------------


def _swept(w: int, n: int, z_off: int) -> slice:
    """The slices a sweep writes on a slab of w slices from global slice
    z_off: the slab's inner ones in the global interior [1, n]."""
    return slice(max(1, 1 - z_off), max(1, min(w - 2, n - z_off) + 1))


def jacobi_plain(x, x0, out, a: float, c: float, z_off: int = 0):
    """Plain PyTorch version of the Jacobi kernel: out's interior =
    (x0 + a * sum6(x)) / c, in place, on the slices `_swept` names (the
    whole interior of an (n+2)^3 volume at z_off = 0); returns out."""
    k = _swept(x.shape[0], x.shape[1] - 2, z_off)
    if k.stop > k.start:
        out[k, 1:-1, 1:-1] = div(
            x0[k, 1:-1, 1:-1] + a * s3._sum6(x[k.start - 1:k.stop + 1]), c)
    return out


def jacobi(x, x0, out, a: float, c: float, z_off: int = 0):
    """One Jacobi sweep into out's interior: the kernel on CUDA tensors,
    the plain version on CPU tensors.  x, x0 and out are (n+2)^3 volumes,
    or z-slabs of W slices of (n+2)^2 from global slice z_off, of which
    the sweep writes the inner slices in the global interior.  out must
    not be x."""
    if out.data_ptr() == x.data_ptr():
        raise ValueError("jacobi: out must be another buffer than x")
    if on_cpu(x):
        return jacobi_plain(x, x0, out, a, c, z_off)
    w, n = _check_slab(x=x, x0=x0, out=out)
    _launch("jacobi", x, x.data_ptr(), x0.data_ptr(), out.data_ptr(), n, w,
            int(z_off), float(a), float(c))
    return out


def lin_solve(cfg, x, x0, a: float, c: float):
    """solvers/stam3d.py::_lin_solve on `jacobi` sweeps: sweep `it` reads
    the previous result and writes the scratch (zero ring) for even `it`,
    a copy of x (x's ring) for odd `it`.  x itself is not written."""
    scratch = torch.zeros_like(x)
    xb = x.clone() if cfg.jacobi_iters > 1 else None
    cur = x
    for it in range(cfg.jacobi_iters):
        cur = jacobi(cur, x0, scratch if it % 2 == 0 else xb, a, c)
    return cur


# -------------------------------- advection ----------------------------------


def advect_plain(cfg, q0, u, v, w):
    """Plain PyTorch version of the advection kernel: the exact gather
    (the 'torch' engine's advection at advect_k = 0)."""
    return s3._advect_gather(cfg, q0, u, v, w)


def advect(cfg, q0, u, v, w):
    """q0 advected by (u, v, w) in a new volume: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if on_cpu(q0):
        return advect_plain(cfg, q0, u, v, w)
    n = _check(q0=q0, u=u, v=v, w=w)
    if n != cfg.n:
        raise ValueError(f"fields hold n={n}, config says n={cfg.n}")
    out = torch.empty_like(q0)
    _launch("advect", q0, q0.data_ptr(), u.data_ptr(), v.data_ptr(),
            w.data_ptr(), out.data_ptr(), n, float(cfg.dt))
    return out


# --------------------------------- set_bnd -----------------------------------


def set_bnd_plain(u, v, w, d):
    """Plain PyTorch version of the set_bnd kernel, in place: every face's
    interior cells from the interior neighbour, negated on a velocity
    component's own axis."""
    I = slice(1, -1)
    for f, (sx, sy, sz) in zip((u, v, w, d), _SIGNS):
        for dst, src, sign in (((I, I, 0), (I, I, 1), sx),
                               ((I, I, -1), (I, I, -2), sx),
                               ((I, 0, I), (I, 1, I), sy),
                               ((I, -1, I), (I, -2, I), sy),
                               ((0, I, I), (1, I, I), sz),
                               ((-1, I, I), (-2, I, I), sz)):
            f[dst] = -f[src] if sign < 0 else f[src]
    return u, v, w, d


@functools.lru_cache(maxsize=None)
def set_bnd_launch(n: int) -> TileLaunch:
    """set_bnd's launch on (n+2)^3 volumes, as the library computes it:
    blocks (grid), threads a block, and the block's extent along a face
    row (tile_x) and across rows (tile_y)."""
    return tile_launch(load(), "fst_stam3d_set_bnd_blocks", n)


def set_bnd(u, v, w, d):
    """The reflective faces of u, v, w, d, in place: the kernel on CUDA
    tensors, the plain version on CPU tensors.  Returns the four."""
    if on_cpu(u):
        return set_bnd_plain(u, v, w, d)
    n = _check(u=u, v=v, w=w, d=d)
    _launch("set_bnd", u, u.data_ptr(), v.data_ptr(), w.data_ptr(),
            d.data_ptr(), n)
    return u, v, w, d


def make_step_cuda(cfg):
    """Frame step state -> state on the three kernels: solvers/stam3d.py::
    _step with `lin_solve` (jacobi_iters sweeps a solve, 6 solves a step),
    `advect` (4 a step) and `set_bnd` (6 a step).  set_bnd writes only
    buffers the step has just made, never a tensor of the state it was
    given."""
    return lambda s: s3._step(cfg, s, lin_solve, advect, set_bnd)
