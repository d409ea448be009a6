"""CUDA kernels of the flagship 2-D hypersonic step, with their wrappers
and plain PyTorch versions.

* `step_core(cfg, U, mask, dt) -> Cons` — csrc/hypersonic2d_step.cu, which
  replaces the TPU kernel fluidsims_tpu/kernels/hypersonic2d_pallas.py::
  _band_kernel: one block a tile, each face solved once from the tile
  staged in shared memory (`step_launch` reports a launch's blocks,
  threads, tile, halo and shared memory).  Plain version:
  `step_core_plain` (pad_bc + step_core_padded of the solver).
* `inflow_wavespeed(cfg, U, mask, inflow_col=0) -> 0-d tensor` — csrc/
  hypersonic2d_wavespeed.cu: writes the inflow column (`inflow_col`, -1
  for none) into `U` in place and returns the max wavespeed, on the
  device.  Plain version: `inflow_wavespeed_plain` (apply_inflow_ +
  max_wavespeed).

The wrappers take the plain version for CPU tensors only.  For CUDA
tensors they check device, dtype, shape and contiguity, launch on the
current stream, count the launch in `LAUNCHES`, and raise if the launch
fails; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.euler2d import Cons
from ..solvers import hypersonic2d as h2
from . import _build
from ._common import LaunchCounter, TileLaunch, on_cpu, tile_launch

__all__ = ["LAUNCHES", "reset_launches", "step_core", "step_core_plain",
           "step_launch", "inflow_wavespeed", "inflow_wavespeed_plain",
           "load"]

LAUNCHES = LaunchCounter("step", "wavespeed")
reset_launches = LAUNCHES.reset

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


class _Params(ctypes.Structure):
    """Mirror of fst::Hyp2DParams (csrc/euler2d.cuh)."""

    _fields_ = [
        ("ny", ctypes.c_int),
        ("nx", ctypes.c_int),
        ("gamma", ctypes.c_double),
        ("gm1", ctypes.c_double),
        ("visc_rho", ctypes.c_double),
        ("visc_nu", ctypes.c_double),
        ("visc_e", ctypes.c_double),
        ("infl", ctypes.c_double * 4),
    ]


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with typed entry
    points."""
    lib = _build.load_library()
    P = ctypes.c_void_p
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fst_hyp2d_step_{sfx}")
        fn.argtypes = [P] * 10 + [ctypes.POINTER(_Params), ctypes.c_int, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"fst_hyp2d_step_launch_{sfx}")
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(TileLaunch)]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"fst_hyp2d_inflow_wavespeed_{sfx}")
        fn.argtypes = [P] * 6 + [ctypes.POINTER(_Params), ctypes.c_int,
                                 ctypes.c_int, P]
        fn.restype = ctypes.c_int
    lib.fst_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fst_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _params(cfg) -> _Params:
    # The inflow state is formed by the plain code in the config dtype on
    # the CPU; its values are exact in double.
    infl = [float(v) for v in h2.inflow_cons(cfg, torch.device("cpu"))]
    return _Params(cfg.ny, cfg.nx, cfg.gamma, cfg.gamma - 1.0, cfg.visc_rho,
                   cfg.visc_nu, cfg.visc_e, (ctypes.c_double * 4)(*infl))


def step_launch(ny: int, nx: int, dtype: torch.dtype) -> TileLaunch:
    """The launch of a step on an (ny, nx) grid, as the library computes
    it: blocks (one a tile), threads a block, the tile of `dtype` (csrc/
    hypersonic2d_step.cu Geo<T>), the halo and the dynamic shared memory
    a block."""
    return tile_launch(load(), f"fst_hyp2d_step_launch_{_SUFFIX[dtype]}",
                       ny, nx)


def _check(cfg, U: Cons, mask: torch.Tensor, *scalars: torch.Tensor) -> None:
    dev = mask.device
    shape = (cfg.ny, cfg.nx)
    if cfg.torch_dtype not in _SUFFIX:
        raise TypeError(f"no kernel for dtype {cfg.torch_dtype}")
    if mask.dtype != torch.bool or tuple(mask.shape) != shape:
        raise ValueError(f"mask must be bool {shape}, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    for name, f in zip(Cons._fields, U):
        if f.device != dev:
            raise ValueError(f"U.{name} on {f.device}, mask on {dev}")
        if f.dtype != cfg.torch_dtype:
            raise TypeError(f"U.{name} is {f.dtype}, config says "
                            f"{cfg.torch_dtype}")
        if tuple(f.shape) != shape:
            raise ValueError(f"U.{name} has shape {tuple(f.shape)}, "
                             f"config says {shape}")
        if not f.is_contiguous():
            raise ValueError(f"U.{name} must be contiguous")
    for s in scalars:
        if s.device != dev or s.dtype != cfg.torch_dtype or s.numel() != 1:
            raise ValueError(f"dt must be a one-element {cfg.torch_dtype} "
                             f"tensor on {dev}, got {s.dtype} "
                             f"{tuple(s.shape)} on {s.device}")


def _raise_on_error(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {code} "
            f"({lib.fst_cuda_error_string(code).decode()})")


def step_core_plain(cfg, U: Cons, mask, dt) -> Cons:
    """Plain PyTorch version of the step kernel."""
    Up, Mp = h2.pad_bc(cfg, U, mask)
    return h2.step_core_padded(cfg, Up, Mp, dt)


def step_core(cfg, U: Cons, mask, dt) -> Cons:
    """pad_bc + step_core_padded: the step kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if on_cpu(mask):
        return step_core_plain(cfg, U, mask, dt)
    _check(cfg, U, mask, dt)
    lib = load()
    out = Cons(*(torch.empty_like(f) for f in U))
    fn = getattr(lib, f"fst_hyp2d_step_{_SUFFIX[cfg.torch_dtype]}")
    params = _params(cfg)
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(*(f.data_ptr() for f in U), mask.data_ptr(), dt.data_ptr(),
                  *(f.data_ptr() for f in out), ctypes.byref(params),
                  mask.device.index or 0, stream)
    _raise_on_error(lib, code, "hypersonic2d step")
    LAUNCHES["step"] += 1
    return out


def inflow_wavespeed_plain(cfg, U: Cons, mask,
                           inflow_col: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the wavespeed kernel (inflow in place)."""
    h2.apply_inflow_(cfg, U, mask, inflow_col)
    return h2.max_wavespeed(cfg, U, mask)


def inflow_wavespeed(cfg, U: Cons, mask, inflow_col: int = 0) -> torch.Tensor:
    """Write the inflow state into the fluid cells of column `inflow_col`
    of `U` (in place; -1: no column) and return the max wavespeed as a 0-d
    tensor on U's device: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if not -1 <= inflow_col < cfg.nx:
        raise ValueError(f"inflow_col={inflow_col}: want -1 (none) or a "
                         f"column in [0, {cfg.nx})")
    if on_cpu(mask):
        return inflow_wavespeed_plain(cfg, U, mask, inflow_col)
    _check(cfg, U, mask)
    lib = load()
    out = torch.empty((), dtype=cfg.torch_dtype, device=mask.device)
    fn = getattr(lib, f"fst_hyp2d_inflow_wavespeed_{_SUFFIX[cfg.torch_dtype]}")
    params = _params(cfg)
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(*(f.data_ptr() for f in U), mask.data_ptr(), out.data_ptr(),
                  ctypes.byref(params), inflow_col, mask.device.index or 0,
                  stream)
    _raise_on_error(lib, code, "hypersonic2d wavespeed")
    LAUNCHES["wavespeed"] += 1
    return out
