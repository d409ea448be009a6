"""CUDA kernel of the GLM-MHD K-step, with its wrapper and plain PyTorch
version, and the 'cuda' engine's run built on it.

* `mhd_multistep(cfg, s, k) -> MHDState` — csrc/mhd_multistep.cu, which
  replaces the TPU kernel fluidsims_tpu/kernels/mhd_resident_pallas.py::
  make_multistep_pallas.kernel: k steps of `step_core` (default hooks) in
  one cooperative launch over tiles in shared memory, one grid sync a
  step, the wavespeed max of each step an exact grid-wide max, no padded
  copy.  Plain version: `mhd_multistep_plain` (k torch steps).
* `run_kernels(cfg, s, n)` — the 'cuda' engine: `n // k` launches of k =
  cfg.block_k steps then `n % k` launches of one step.

`LAUNCHES` counts the kernel's launches by what they run: "multistep" for
k > 1, "step" for k = 1.  The wrapper takes the plain version for CPU
tensors only; for CUDA tensors it checks, launches on the current stream,
counts, and raises if the launch fails; nothing falls back.

A call allocates only the state and the clock it returns.  The launch's
grid is asked of the card once per (config, device) (`launch_shape`), and
its scratch (the state's other buffer of the ping-pong) and slot words are
kept per (shape, dtype, device, stream) (`_common.tile_scratch`, which says
why that is safe).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.stepper import run_split
from ..solvers import mhd
from . import _build
from ._common import (LaunchCounter, TileLaunch, check_tensors, on_cpu,
                      raise_if, tile_launch, tile_scratch)
from ._common import grid_syncs as _grid_syncs

__all__ = ["LAUNCHES", "MAX_BLOCK_K", "reset_launches", "mhd_multistep",
           "mhd_multistep_plain", "run_kernels", "load", "launch_shape",
           "grid_syncs"]

LAUNCHES = LaunchCounter("step", "multistep")
reset_launches = LAUNCHES.reset

# Steps a launch at most: the kernel has no limit of its own; this keeps
# one launch short.
MAX_BLOCK_K = 1024

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_PTRS7 = ctypes.c_void_p * 7


class _Params(ctypes.Structure):
    """Mirror of fst::MHDParams (csrc/mhd_multistep.cu)."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("ny", "nx", "k", "stable")] + [
        (name, ctypes.c_double) for name in
        ("gamma", "gm1", "cfl_min", "dx", "dy", "min_dxdy", "neg_alpha")]


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with typed entry
    points."""
    lib = _build.load_library()
    P, I = ctypes.c_void_p, ctypes.c_int
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fst_mhd_multistep_grid_{sfx}")
        fn.argtypes = [ctypes.POINTER(_Params), I, ctypes.POINTER(TileLaunch)]
        fn.restype = I
        fn = getattr(lib, f"fst_mhd_multistep_{sfx}")
        fn.argtypes = [_PTRS7, P, _PTRS7, P, P, P, ctypes.POINTER(_Params),
                       I, I, I, P]
        fn.restype = I
    lib.fst_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fst_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _params(cfg, k: int) -> _Params:
    """The constants of `step_core` (dx = 1/nx, dy = 1/ny), as Python
    forms them; one struct per (config, k)."""
    dx, dy = 1.0 / cfg.nx, 1.0 / cfg.ny
    return _Params(cfg.ny, cfg.nx, k, int(cfg.stable_hll), cfg.gamma,
                   cfg.gamma - 1.0, cfg.cfl * min(dx, dy), dx, dy,
                   min(dx, dy), -mhd.GLM_ALPHA)


@functools.lru_cache(maxsize=None)
def launch_shape(cfg, index: int) -> TileLaunch:
    """The launch of this config on device `index`, as the library
    computes it: resident blocks (at most one a tile) and threads a block,
    the tile (csrc/mhd_multistep.cu's tile of the dtype, clipped to the
    grid), the halo (2) and the dynamic shared memory a block."""
    sfx = _SUFFIX[cfg.torch_dtype]
    return tile_launch(load(), f"fst_mhd_multistep_grid_{sfx}",
                       ctypes.byref(_params(cfg, 1)), index)


@functools.lru_cache(maxsize=None)
def _launch_plan(cfg, k: int, index: int) -> tuple:
    """(entry point, byref of the params, blocks, threads a block) of a
    launch on device `index`, formed once per (config, k, device)."""
    shape = launch_shape(cfg, index)
    fn = getattr(load(), f"fst_mhd_multistep_{_SUFFIX[cfg.torch_dtype]}")
    return fn, ctypes.byref(_params(cfg, k)), shape.grid, shape.threads


def _scratch(cfg, device: torch.device) -> tuple:
    """(scratch, slot words) of launches of this config on the device's
    current stream: the state's other buffer, 7 fields."""
    stream = torch.cuda.current_stream(device).cuda_stream
    return tile_scratch("mhd", 7 * cfg.ny * cfg.nx, cfg.torch_dtype, device,
                        stream)


def grid_syncs(cfg, device: torch.device) -> int:
    """The grid syncs that the last launch of a config of this shape on the
    device's current stream made, as the kernel counted them."""
    return _grid_syncs(_scratch(cfg, device)[1])


def _check(cfg, s) -> None:
    if cfg.torch_dtype not in _SUFFIX:
        raise TypeError(f"no kernel for dtype {cfg.torch_dtype}")
    dev = s.t.device
    check_tensors(dict(zip(mhd.FIELDS, s.U)), (cfg.ny, cfg.nx),
                  cfg.torch_dtype, dev)
    check_tensors({"t": s.t}, (), cfg.torch_dtype, dev)


def mhd_multistep_plain(cfg, s, k: int):
    """Plain PyTorch version of the kernel: k torch steps."""
    for _ in range(k):
        s = mhd.step(cfg, s)
    return s


def mhd_multistep(cfg, s, k: int):
    """k steps in one launch: the kernel on CUDA tensors, the plain version
    on CPU tensors.  1 <= k <= MAX_BLOCK_K."""
    if not 1 <= k <= MAX_BLOCK_K:
        raise ValueError(f"k={k}: the kernel takes 1 <= k <= {MAX_BLOCK_K}")
    if on_cpu(s.t):
        return mhd_multistep_plain(cfg, s, k)
    _check(cfg, s)
    dev, dt = s.t.device, cfg.torch_dtype
    fn, params, grid, threads = _launch_plan(cfg, k, dev.index)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch, words = tile_scratch("mhd", 7 * cfg.ny * cfg.nx, dt, dev, stream)
    out = torch.empty((7, cfg.ny, cfg.nx), dtype=dt, device=dev)
    t_out = torch.empty((), dtype=dt, device=dev)
    fields = out.unbind(0)
    code = fn(_PTRS7(*(f.data_ptr() for f in s.U)), s.t.data_ptr(),
              _PTRS7(*(f.data_ptr() for f in fields)), t_out.data_ptr(),
              scratch.data_ptr(), words.data_ptr(), params, grid, threads,
              dev.index, stream)
    raise_if(code, load(), "mhd multistep kernel launch")
    LAUNCHES["multistep" if k > 1 else "step"] += 1
    return mhd.MHDState(U=mhd.ConsM(*fields), t=t_out)


def run_kernels(cfg, s, n_steps: int):
    """The 'cuda' engine: core.stepper.run_split of n_steps over launches
    of k = cfg.block_k steps and of one step."""
    return run_split(lambda st: mhd_multistep(cfg, st, cfg.block_k),
                     lambda st: mhd_multistep(cfg, st, 1),
                     cfg.block_k, s, n_steps)
