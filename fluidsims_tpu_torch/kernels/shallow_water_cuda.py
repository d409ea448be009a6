"""CUDA kernel of the shallow-water K-step, with its wrapper and plain
PyTorch version, and the 'cuda' engine's run built on it.

* `sw_multistep(cfg, s, k) -> ShallowWaterState` — csrc/
  shallow_water_multistep.cu, which replaces the TPU kernel fluidsims_tpu/
  kernels/resident_multistep.py::make_resident_multistep.kernel as
  instantiated for shallow water: k whole τ-clock steps in one cooperative
  launch, the CFL max of each step an exact grid-wide max.  Plain version:
  `sw_multistep_plain` (k torch steps).
* `run_kernels(cfg, s, n)` — the 'cuda' engine: `n // k` launches of k =
  cfg.block_k steps then `n % k` launches of one step.

`LAUNCHES` counts the kernel's launches by what they run: "multistep" for
k > 1, "step" for k = 1.  The wrapper takes the plain version for CPU
tensors only; for CUDA tensors it checks, launches on the current stream,
counts, and raises if the launch fails; nothing falls back.

A call allocates only the state and the clock it returns.  The launch's
grid and threads a block are asked of the card once per (config, device)
(`launch_shape`), and its scratch (the state ping-pong copy) and slot
words are kept per (shape, dtype, device, stream)
(`_common.tile_scratch`, which says why that is safe).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.stepper import run_split
from ..solvers import shallow_water as sw
from . import _build
from ._common import (LaunchCounter, TileLaunch, check_tensors, on_cpu,
                      raise_if, tile_launch, tile_scratch)
from ._common import grid_syncs as _grid_syncs

__all__ = ["LAUNCHES", "MAX_BLOCK_K", "reset_launches", "sw_multistep",
           "sw_multistep_plain", "run_kernels", "load", "halo",
           "launch_shape", "grid_syncs"]

LAUNCHES = LaunchCounter("step", "multistep")
reset_launches = LAUNCHES.reset

# Steps a launch at most: the kernel has no limit of its own; this keeps
# one launch short.
MAX_BLOCK_K = 1024

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


class _Params(ctypes.Structure):
    """Mirror of fst::SWParams (csrc/shallow_water_multistep.cu)."""

    _fields_ = [(name, ctypes.c_int) for name in ("ny", "nx", "k", "visc")] + [
        (name, ctypes.c_double) for name in
        ("g", "half_g", "cfl_min", "dtau", "inv_dx", "inv_dy", "inv_dx2",
         "inv_dy2", "nu")]


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with typed entry
    points."""
    lib = _build.load_library()
    P, I = ctypes.c_void_p, ctypes.c_int
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fst_sw_multistep_grid_{sfx}")
        fn.argtypes = [ctypes.POINTER(_Params), I, ctypes.POINTER(TileLaunch)]
        fn.restype = I
        fn = getattr(lib, f"fst_sw_multistep_{sfx}")
        fn.argtypes = [P] * 12 + [ctypes.POINTER(_Params), I, I, I, P]
        fn.restype = I
    lib.fst_cuda_error_string.argtypes = [I]
    lib.fst_cuda_error_string.restype = ctypes.c_char_p
    return lib


def halo(cfg) -> int:
    """Cells of halo of the kernel's tiles: 1 for the HLL faces on both
    sides of a cell, plus 1 for the viscosity's Laplacian when nu > 0."""
    return 1 + int(cfg.nu > 0.0)


@functools.lru_cache(maxsize=None)
def _params(cfg, k: int) -> _Params:
    """The constants of `step_fields`, as Python forms them; one struct
    per (config, k)."""
    inv_dx, inv_dy = 1.0 / cfg.dx, 1.0 / cfg.dy
    return _Params(cfg.ny, cfg.nx, k, int(cfg.nu > 0.0), cfg.g,
                   0.5 * cfg.g, cfg.cfl * min(cfg.dx, cfg.dy), cfg.dtau,
                   inv_dx, inv_dy, inv_dx * inv_dx, inv_dy * inv_dy, cfg.nu)


@functools.lru_cache(maxsize=None)
def launch_shape(cfg, index: int) -> TileLaunch:
    """The launch of this config on device `index`, as the library
    computes it: blocks and threads a block (512 when every tile then gets
    its own resident block, else 256: csrc/tiles.cuh tile_grid), the tile
    (kTileX x kTileY clipped to the grid), the halo (`halo`'s) and the
    dynamic shared memory a block."""
    return tile_launch(load(),
                       f"fst_sw_multistep_grid_{_SUFFIX[cfg.torch_dtype]}",
                       ctypes.byref(_params(cfg, 1)), index)


@functools.lru_cache(maxsize=None)
def _launch_plan(cfg, k: int, index: int) -> tuple:
    """(entry point, byref of the params, blocks, threads a block) of a
    launch on device `index`: what a call needs of the config, formed once
    per (config, k, device)."""
    shape = launch_shape(cfg, index)
    fn = getattr(load(), f"fst_sw_multistep_{_SUFFIX[cfg.torch_dtype]}")
    return fn, ctypes.byref(_params(cfg, k)), shape.grid, shape.threads


def _scratch(cfg, device: torch.device) -> tuple:
    """(state ping-pong copy, slot words) of launches of this config on
    the device's current stream."""
    stream = torch.cuda.current_stream(device).cuda_stream
    return tile_scratch("sw", 3 * cfg.ny * cfg.nx, cfg.torch_dtype, device,
                        stream)


def grid_syncs(cfg, device: torch.device) -> int:
    """The grid syncs that the last launch of a config of this shape on the
    device's current stream made, as the kernel counted them."""
    return _grid_syncs(_scratch(cfg, device)[1])


def _check(cfg, s) -> None:
    if cfg.torch_dtype not in _SUFFIX:
        raise TypeError(f"no kernel for dtype {cfg.torch_dtype}")
    dev = s.sigma.device
    check_tensors({"sigma": s.sigma, "u": s.u, "v": s.v}, (cfg.ny, cfg.nx),
                  cfg.torch_dtype, dev)
    check_tensors({"t": s.t, "tau": s.tau}, (), cfg.torch_dtype, dev)


def sw_multistep_plain(cfg, s, k: int):
    """Plain PyTorch version of the kernel: k torch steps."""
    for _ in range(k):
        s = sw.step(cfg, s)
    return s


def sw_multistep(cfg, s, k: int):
    """k steps in one launch: the kernel on CUDA tensors, the plain version
    on CPU tensors.  1 <= k <= MAX_BLOCK_K."""
    if not 1 <= k <= MAX_BLOCK_K:
        raise ValueError(f"k={k}: the kernel takes 1 <= k <= {MAX_BLOCK_K}")
    if on_cpu(s.sigma):
        return sw_multistep_plain(cfg, s, k)
    _check(cfg, s)
    dev, dt = s.sigma.device, cfg.torch_dtype
    fn, params, grid, threads = _launch_plan(cfg, k, dev.index)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch, words = tile_scratch("sw", 3 * cfg.ny * cfg.nx, dt, dev, stream)
    sig, u, v = torch.empty((3, cfg.ny, cfg.nx), dtype=dt,
                            device=dev).unbind(0)
    t, tau = torch.empty(2, dtype=dt, device=dev).unbind(0)
    code = fn(s.sigma.data_ptr(), s.u.data_ptr(), s.v.data_ptr(),
              s.t.data_ptr(), s.tau.data_ptr(), sig.data_ptr(), u.data_ptr(),
              v.data_ptr(), t.data_ptr(), tau.data_ptr(), scratch.data_ptr(),
              words.data_ptr(), params, grid, threads, dev.index, stream)
    raise_if(code, load(), "shallow-water multistep kernel launch")
    LAUNCHES["multistep" if k > 1 else "step"] += 1
    return sw.ShallowWaterState(sigma=sig, u=u, v=v, t=t, tau=tau)


def run_kernels(cfg, s, n_steps: int):
    """The 'cuda' engine: core.stepper.run_split of n_steps over launches
    of k = cfg.block_k steps and of one step."""
    return run_split(lambda st: sw_multistep(cfg, st, cfg.block_k),
                     lambda st: sw_multistep(cfg, st, 1),
                     cfg.block_k, s, n_steps)
