"""CUDA kernels of the D2Q9 LBM step, with their wrappers and plain
PyTorch versions, and the 'cuda' engine's run built on them.

* `lbm_step(cfg, s, drive) -> LBMState` — csrc/lbm_step.cu, which replaces
  the TPU kernel fluidsims_tpu/kernels/lbm_pallas.py::_kernel: one step,
  in push form.  Plain version: `lbm_step_plain` (the solver's torch
  `step`, pull form).
* `lbm_multistep(cfg, s, k, drive) -> LBMState` — csrc/lbm_multistep.cu,
  which replaces lbm_pallas.py::_ms_kernel: k steps in one launch on
  tiles in shared memory (`launch_shape` reports the tile), bitwise equal
  to k launches of the one-step kernel.  Plain version:
  `lbm_multistep_plain` (k torch steps).
* `run_kernels(cfg, s, n, drive)` — the 'cuda' engine: `n // k` K-step
  launches then `n % k` one-step launches (k = cfg.block_k); with k = 1
  the one-step kernel every step.

`drive` reaches the kernels as a launch argument: a Python number, or a
0-d tensor (read on the host at every launch, which waits for the
device).  The solid mask goes in as its bool bytes (uint8 0/1).

The wrappers take the plain version for CPU tensors only.  For CUDA
tensors they check device, dtype, shape and contiguity, launch on the
current stream, count the launch in `LAUNCHES`, and raise if the launch
fails; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.stepper import run_split
from ..solvers import lbm
from . import _build
from ._common import LaunchCounter, TileLaunch, on_cpu, tile_launch

__all__ = ["LAUNCHES", "MAX_BLOCK_K", "reset_launches", "lbm_step",
           "lbm_step_plain", "lbm_multistep", "lbm_multistep_plain",
           "run_kernels", "load", "launch_shape"]

LAUNCHES = LaunchCounter("step", "multistep")
reset_launches = LAUNCHES.reset

# The K-step kernel's bound on k (csrc/lbm_multistep.cu kLbmMaxK): a tile
# of 24^2 at f64 with its halo of 16 in 227 KB of shared memory.
MAX_BLOCK_K = 16

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


class _Params(ctypes.Structure):
    """Mirror of fst::LBMParams (csrc/lbm.cuh)."""

    _fields_ = [("ny", ctypes.c_int), ("nx", ctypes.c_int),
                ("k", ctypes.c_int), ("omega", ctypes.c_double),
                ("drive", ctypes.c_double), ("w", ctypes.c_double * 9)]


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with typed entry
    points."""
    lib = _build.load_library()
    P = ctypes.c_void_p
    for sfx in _SUFFIX.values():
        for name in ("step", "multistep"):
            fn = getattr(lib, f"fst_lbm_{name}_{sfx}")
            fn.argtypes = [P] * 3 + [ctypes.POINTER(_Params), ctypes.c_int, P]
            fn.restype = ctypes.c_int
        fn = getattr(lib, f"fst_lbm_multistep_shape_{sfx}")
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(TileLaunch)]
        fn.restype = ctypes.c_int
    lib.fst_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fst_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def launch_shape(cfg, k: int) -> TileLaunch:
    """The K-step launch of k steps at cfg's grid and dtype, as the library
    computes it: blocks, threads a block, the tile (the largest square
    whose window fits the shared memory, evened out over the grid), the
    halo (k) and the dynamic shared memory a block."""
    if cfg.torch_dtype not in _SUFFIX:
        raise TypeError(f"no kernel for dtype {cfg.torch_dtype}")
    return tile_launch(load(), f"fst_lbm_multistep_shape_"
                       f"{_SUFFIX[cfg.torch_dtype]}", cfg.ny, cfg.nx, k)


def _drive(cfg, drive) -> float:
    return float(cfg.drive if drive is None else drive)


def _params(cfg, k: int, drive: float) -> _Params:
    return _Params(cfg.ny, cfg.nx, k, 1.0 / cfg.tau, drive,
                   (ctypes.c_double * 9)(*(float(w) for w in lbm.W)))


def _check(cfg, s) -> None:
    shape = (cfg.ny, cfg.nx)
    if cfg.torch_dtype not in _SUFFIX:
        raise TypeError(f"no kernel for dtype {cfg.torch_dtype}")
    if s.f.dtype != cfg.torch_dtype:
        raise TypeError(f"f is {s.f.dtype}, config says {cfg.torch_dtype}")
    if tuple(s.f.shape) != (9, *shape):
        raise ValueError(f"f has shape {tuple(s.f.shape)}, config says "
                         f"{(9, *shape)}")
    if s.solid.dtype != torch.bool or tuple(s.solid.shape) != shape:
        raise ValueError(f"solid must be bool {shape}, got {s.solid.dtype} "
                         f"{tuple(s.solid.shape)}")
    if s.solid.device != s.f.device:
        raise ValueError(f"solid on {s.solid.device}, f on {s.f.device}")
    if not (s.f.is_contiguous() and s.solid.is_contiguous()):
        raise ValueError("f and solid must be contiguous")


def _launch(name: str, cfg, s, params: _Params):
    lib = load()
    out = torch.empty_like(s.f)
    fn = getattr(lib, f"fst_lbm_{name}_{_SUFFIX[cfg.torch_dtype]}")
    dev = s.f.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(s.f.data_ptr(), s.solid.data_ptr(), out.data_ptr(),
                  ctypes.byref(params), dev.index or 0, stream)
    if code != 0:
        raise RuntimeError(
            f"lbm {name} kernel launch failed: CUDA error {code} "
            f"({lib.fst_cuda_error_string(code).decode()})")
    LAUNCHES[name] += 1
    return lbm.LBMState(f=out, solid=s.solid)


def lbm_step_plain(cfg, s, drive=None):
    """Plain PyTorch version of the one-step kernel."""
    return lbm.step(cfg, s, drive=drive)


def lbm_multistep_plain(cfg, s, k: int, drive=None):
    """Plain PyTorch version of the K-step kernel: k torch steps."""
    for _ in range(k):
        s = lbm.step(cfg, s, drive=drive)
    return s


def lbm_step(cfg, s, drive=None):
    """One step: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if on_cpu(s.f):
        return lbm_step_plain(cfg, s, drive=drive)
    _check(cfg, s)
    return _launch("step", cfg, s, _params(cfg, 1, _drive(cfg, drive)))


def lbm_multistep(cfg, s, k: int, drive=None):
    """k steps in one launch: the kernel on CUDA tensors, the plain version
    on CPU tensors.  1 <= k <= MAX_BLOCK_K."""
    if not 1 <= k <= MAX_BLOCK_K:
        raise ValueError(f"k={k}: the K-step kernel takes 1 <= k <= "
                         f"{MAX_BLOCK_K}")
    if on_cpu(s.f):
        return lbm_multistep_plain(cfg, s, k, drive=drive)
    _check(cfg, s)
    return _launch("multistep", cfg, s, _params(cfg, k, _drive(cfg, drive)))


def run_kernels(cfg, s, n_steps: int, drive=None):
    """The 'cuda' engine: core.stepper.run_split of n_steps over the K-step
    and the one-step wrapper, k = cfg.block_k."""
    return run_split(
        lambda st: lbm_multistep(cfg, st, cfg.block_k, drive=drive),
        lambda st: lbm_step(cfg, st, drive=drive), cfg.block_k, s, n_steps)
