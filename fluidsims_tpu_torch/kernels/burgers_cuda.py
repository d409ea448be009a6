"""CUDA kernel of the Burgers K-step, with its wrapper and plain PyTorch
version, and the 'cuda' engine's run built on it.

* `burgers_multistep(cfg, s, k) -> BurgersState` — csrc/
  burgers_multistep.cu, which replaces the TPU kernel fluidsims_tpu/
  kernels/resident_multistep.py::make_resident_multistep.kernel as
  instantiated for Burgers: k whole τ-clock steps in one cooperative
  launch, the CFL max of each step an exact grid-wide max.  Plain version:
  `burgers_multistep_plain` (k torch steps).
* `run_kernels(cfg, s, n)` — the 'cuda' engine: `n // k` launches of k =
  cfg.block_k steps then `n % k` launches of one step; with k = 1 one step
  a launch.

`LAUNCHES` counts the kernel's launches by what they run: "multistep" for
k > 1, "step" for k = 1.  The wrapper takes the plain version for CPU
tensors only.  For CUDA tensors it checks device, dtype, shape and
contiguity, launches on the current stream, counts the launch, and raises
if the launch fails (a refused cooperative launch included); nothing falls
back.

A call allocates only the state and the clock it returns.  The launch's
grid and threads a block are asked of the card once per (config, device)
(`launch_shape`), and its scratch (the phi ping-pong field pair, with more
than one pass the (u, v) pairs between passes) and slot words are kept per
(shape, passes, dtype, device, stream) (`_common.tile_scratch`, which says
why that is safe).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.stepper import run_split
from ..solvers import burgers as bg
from . import _build
from ._common import (LaunchCounter, TileLaunch, check_tensors, on_cpu,
                      raise_if, tile_launch, tile_scratch)
from ._common import grid_syncs as _grid_syncs

__all__ = ["LAUNCHES", "MAX_BLOCK_K", "reset_launches", "burgers_multistep",
           "burgers_multistep_plain", "run_kernels", "load", "plan",
           "launch_shape", "grid_syncs"]

LAUNCHES = LaunchCounter("step", "multistep")
reset_launches = LAUNCHES.reset

# Steps a launch at most: the kernel has no limit of its own; this keeps
# one launch short.
MAX_BLOCK_K = 1024

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# Cells of halo a pass holds at most (csrc/burgers_multistep.cu): it bounds
# a window in shared memory; more viscosity substeps take more passes.
MAX_HALO = 8


class _Params(ctypes.Structure):
    """Mirror of fst::BurgersParams (csrc/burgers_multistep.cu)."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("ny", "nx", "k", "muscl", "one_d", "visc_substeps", "first",
                 "per_pass")] + [
        (name, ctypes.c_double) for name in
        ("u0", "dx", "dy", "inv_dy", "cfl", "dtau", "inv_dx2", "inv_dy2",
         "nu")]


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with typed entry
    points."""
    lib = _build.load_library()
    P, I = ctypes.c_void_p, ctypes.c_int
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fst_burgers_multistep_grid_{sfx}")
        fn.argtypes = [ctypes.POINTER(_Params), I, ctypes.POINTER(TileLaunch)]
        fn.restype = I
        fn = getattr(lib, f"fst_burgers_multistep_{sfx}")
        fn.argtypes = [P] * 10 + [ctypes.POINTER(_Params), I, I, I, P]
        fn.restype = I
    lib.fst_cuda_error_string.argtypes = [I]
    lib.fst_cuda_error_string.restype = ctypes.c_char_p
    return lib


def plan(cfg) -> tuple[int, int, tuple[int, ...]]:
    """(reach, halo, viscosity substeps of each pass) of the kernel's
    tiles.  A face flux reads 2 cells on each side with MUSCL and 1
    without (reach); a tile's first pass runs the convective update and
    up to MAX_HALO - reach substeps on a window of halo = reach + its
    substeps; each later pass up to MAX_HALO substeps."""
    reach = 2 if cfg.muscl else 1
    first = min(cfg.visc_substeps, MAX_HALO - reach)
    rest = cfg.visc_substeps - first
    later = tuple(min(MAX_HALO, rest - i) for i in range(0, rest, MAX_HALO))
    return reach, reach + first, (first, *later)


@functools.lru_cache(maxsize=None)
def _params(cfg, k: int) -> _Params:
    """The constants of `step_fields`, as Python forms them, and the
    passes of `plan`; one struct per (config, k)."""
    one_d = cfg.colehopf
    inv_dy = 0.0 if (one_d or cfg.ny <= 1) else 1.0 / cfg.dy
    inv_dy2 = 0.0 if one_d else 1.0 / (cfg.dy * cfg.dy)
    _, _, passes = plan(cfg)
    return _Params(cfg.ny, cfg.nx, k, int(cfg.muscl), int(one_d),
                   cfg.visc_substeps, passes[0], MAX_HALO, cfg.u0, cfg.dx,
                   cfg.dy, inv_dy, cfg.cfl, cfg.dtau, 1.0 / (cfg.dx * cfg.dx),
                   inv_dy2, cfg.nu)


@functools.lru_cache(maxsize=None)
def launch_shape(cfg, index: int) -> TileLaunch:
    """The launch of this config on device `index`, as the library
    computes it: blocks and threads a block (512 when every tile then gets
    its own resident block, else 256: csrc/tiles.cuh tile_grid), the tile
    (kTileX x kTileY clipped to the grid), the halo (`plan`'s) and the
    dynamic shared memory a block."""
    sfx = _SUFFIX[cfg.torch_dtype]
    return tile_launch(load(), f"fst_burgers_multistep_grid_{sfx}",
                       ctypes.byref(_params(cfg, 1)), index)


@functools.lru_cache(maxsize=None)
def _launch_plan(cfg, k: int, index: int) -> tuple:
    """(entry point, byref of the params, blocks, threads a block, scratch
    elements) of a launch on device `index`: what a call needs of the
    config, formed once per (config, k, device)."""
    shape = launch_shape(cfg, index)
    fn = getattr(load(), f"fst_burgers_multistep_{_SUFFIX[cfg.torch_dtype]}")
    return (fn, ctypes.byref(_params(cfg, k)), shape.grid, shape.threads,
            _scratch_fields(cfg) * cfg.ny * cfg.nx)


def _scratch_fields(cfg) -> int:
    """phi ping-pong (2), and with more than one pass two (u, v) pairs
    between passes."""
    return 2 if len(plan(cfg)[2]) == 1 else 6


def _scratch(cfg, device: torch.device) -> tuple:
    """(scratch, slot words) of launches of this config on the device's
    current stream."""
    stream = torch.cuda.current_stream(device).cuda_stream
    return tile_scratch("burgers", _scratch_fields(cfg) * cfg.ny * cfg.nx,
                        cfg.torch_dtype, device, stream)


def grid_syncs(cfg, device: torch.device) -> int:
    """The grid syncs that the last launch of a config of this shape on the
    device's current stream made, as the kernel counted them."""
    return _grid_syncs(_scratch(cfg, device)[1])


def _check(cfg, s) -> None:
    if cfg.torch_dtype not in _SUFFIX:
        raise TypeError(f"no kernel for dtype {cfg.torch_dtype}")
    dev = s.phi_u.device
    check_tensors({"phi_u": s.phi_u, "phi_v": s.phi_v}, (cfg.ny, cfg.nx),
                  cfg.torch_dtype, dev)
    check_tensors({"t": s.t, "tau": s.tau}, (), cfg.torch_dtype, dev)


def burgers_multistep_plain(cfg, s, k: int):
    """Plain PyTorch version of the kernel: k torch steps."""
    for _ in range(k):
        s = bg.step(cfg, s)
    return s


def burgers_multistep(cfg, s, k: int):
    """k steps in one launch: the kernel on CUDA tensors, the plain version
    on CPU tensors.  1 <= k <= MAX_BLOCK_K."""
    if not 1 <= k <= MAX_BLOCK_K:
        raise ValueError(f"k={k}: the kernel takes 1 <= k <= {MAX_BLOCK_K}")
    if on_cpu(s.phi_u):
        return burgers_multistep_plain(cfg, s, k)
    _check(cfg, s)
    dev, dt = s.phi_u.device, cfg.torch_dtype
    fn, params, grid, threads, numel = _launch_plan(cfg, k, dev.index)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch, words = tile_scratch("burgers", numel, dt, dev, stream)
    pu, pv = torch.empty((2, cfg.ny, cfg.nx), dtype=dt, device=dev).unbind(0)
    t, tau = torch.empty(2, dtype=dt, device=dev).unbind(0)
    code = fn(s.phi_u.data_ptr(), s.phi_v.data_ptr(), s.t.data_ptr(),
              s.tau.data_ptr(), pu.data_ptr(), pv.data_ptr(), t.data_ptr(),
              tau.data_ptr(), scratch.data_ptr(), words.data_ptr(), params,
              grid, threads, dev.index, stream)
    raise_if(code, load(), "burgers multistep kernel launch")
    LAUNCHES["multistep" if k > 1 else "step"] += 1
    return bg.BurgersState(phi_u=pu, phi_v=pv, t=t, tau=tau)


def run_kernels(cfg, s, n_steps: int):
    """The 'cuda' engine: core.stepper.run_split of n_steps over launches
    of k = cfg.block_k steps and of one step."""
    return run_split(lambda st: burgers_multistep(cfg, st, cfg.block_k),
                     lambda st: burgers_multistep(cfg, st, 1),
                     cfg.block_k, s, n_steps)
