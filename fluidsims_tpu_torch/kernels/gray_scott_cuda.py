"""CUDA kernels of the Gray–Scott step, with their wrappers and plain
PyTorch versions, and the 'cuda' engine's run built on them.

* `gs_step(cfg, s, feed, kill) -> GrayScottState` — csrc/
  gray_scott_step.cu, which replaces the TPU kernel fluidsims_tpu/kernels/
  gray_scott_pallas.py::_kernel: one step.  Plain version: `gs_step_plain`
  (the solver's torch `step`).
* `gs_multistep(cfg, s, k, feed, kill) -> GrayScottState` — csrc/
  gray_scott_multistep.cu, which replaces gray_scott_pallas.py::_ms_kernel:
  k steps in one launch on tiles in shared memory (f64: one copy of u and
  v stepped in place; f32: two copies ping-ponged; `launch_shape` reports
  the tile), bitwise equal to k launches of the one-step kernel.
  Plain version: `gs_multistep_plain`
  (k torch steps).
* `run_kernels(cfg, s, n, feed, kill)` — the 'cuda' engine: `n // k`
  K-step launches then `n % k` one-step launches (k = cfg.block_k); with
  k = 1 the one-step kernel every step.

`feed`/`kill` reach the kernels as launch arguments: Python numbers, or
0-d tensors (read on the host at every launch, which waits for the
device).  The kernels get `feed` and `feed + kill` formed exactly as
`step` forms them, in double for Python numbers and in the tensors' dtype
for tensors.

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
from ..solvers import gray_scott as gs
from . import _build
from ._common import LaunchCounter, on_cpu, tile_launch

__all__ = ["LAUNCHES", "MAX_BLOCK_K", "reset_launches", "gs_step",
           "gs_step_plain", "gs_multistep", "gs_multistep_plain",
           "run_kernels", "load", "GSLaunch", "launch_shape"]

LAUNCHES = LaunchCounter("step", "multistep")
reset_launches = LAUNCHES.reset

# The K-step kernel's bound on k (csrc/gray_scott_multistep.cu kGsMaxK):
# at k = 32 a window of 90^2 f64 still holds a 26^2 tile.
MAX_BLOCK_K = 32

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


class _Params(ctypes.Structure):
    """Mirror of fst::GSParams (csrc/gray_scott.cuh)."""

    _fields_ = [("ny", ctypes.c_int), ("nx", ctypes.c_int),
                ("k", ctypes.c_int)] + [
        (name, ctypes.c_double)
        for name in ("inv_dx2", "Du", "Dv", "dt", "feed", "fk")]


class GSLaunch(ctypes.Structure):
    """Mirror of fst::GSLaunch (csrc/gray_scott_multistep.cu): what the
    K-step kernel's grid query reports of a launch: blocks, threads a
    block, the tile, the halo (k), dynamic shared memory a block, the rows
    and columns of an item, the copies of the window (1: stepped in place,
    2: ping-ponged), the blocks an SM the occupancy query allows and the
    waves of the grid."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("grid", "threads", "tile_x", "tile_y", "halo", "smem_bytes",
                 "rows", "cols", "copies", "blocks_per_sm", "waves")]

    def asdict(self) -> dict:
        return {name: getattr(self, name) for name, _ in self._fields_}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with typed entry
    points."""
    lib = _build.load_library()
    P = ctypes.c_void_p
    for sfx in _SUFFIX.values():
        for name in ("step", "multistep"):
            fn = getattr(lib, f"fst_gs_{name}_{sfx}")
            fn.argtypes = [P] * 4 + [ctypes.POINTER(_Params), ctypes.c_int, P]
            fn.restype = ctypes.c_int
        fn = getattr(lib, f"fst_gs_multistep_shape_{sfx}")
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(GSLaunch)]
        fn.restype = ctypes.c_int
    lib.fst_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fst_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch_shape(cfg, k: int, device=None) -> GSLaunch:
    """The K-step launch of k steps at cfg's grid and dtype on `device` (a
    CUDA device, default the current one), as the library computes it:
    the tile (the square whose window fits the shared memory, and in place
    the threads, at the least cost in waves, evened out over the grid),
    the strip an item, the copies, the occupancy and the waves."""
    if cfg.torch_dtype not in _SUFFIX:
        raise TypeError(f"no kernel for dtype {cfg.torch_dtype}")
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return tile_launch(load(), f"fst_gs_multistep_shape_"
                       f"{_SUFFIX[cfg.torch_dtype]}", cfg.ny, cfg.nx, k,
                       index, kind=GSLaunch)


def _scalars(cfg, feed, kill) -> tuple[float, float]:
    """(feed, feed + kill) as `step` forms them, as Python floats."""
    feed = cfg.feed if feed is None else feed
    kill = cfg.kill if kill is None else kill
    return float(feed), float(feed + kill)


def _params(cfg, k: int, scalars: tuple[float, float]) -> _Params:
    return _Params(cfg.ny, cfg.nx, k, 1.0 / (cfg.dx * cfg.dx), cfg.Du, cfg.Dv,
                   cfg.dt, *scalars)


def _check(cfg, s) -> None:
    shape = (cfg.ny, cfg.nx)
    if cfg.torch_dtype not in _SUFFIX:
        raise TypeError(f"no kernel for dtype {cfg.torch_dtype}")
    for name, f in zip(gs.GrayScottState._fields, s):
        if f.device != s.u.device:
            raise ValueError(f"{name} on {f.device}, u on {s.u.device}")
        if f.dtype != cfg.torch_dtype:
            raise TypeError(f"{name} is {f.dtype}, config says "
                            f"{cfg.torch_dtype}")
        if tuple(f.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(f.shape)}, config "
                             f"says {shape}")
        if not f.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(name: str, cfg, s, params: _Params):
    lib = load()
    out = gs.GrayScottState(torch.empty_like(s.u), torch.empty_like(s.v))
    fn = getattr(lib, f"fst_gs_{name}_{_SUFFIX[cfg.torch_dtype]}")
    dev = s.u.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(s.u.data_ptr(), s.v.data_ptr(), out.u.data_ptr(),
                  out.v.data_ptr(), ctypes.byref(params), dev.index or 0,
                  stream)
    if code != 0:
        raise RuntimeError(
            f"gray_scott {name} kernel launch failed: CUDA error {code} "
            f"({lib.fst_cuda_error_string(code).decode()})")
    LAUNCHES[name] += 1
    return out


def gs_step_plain(cfg, s, feed=None, kill=None):
    """Plain PyTorch version of the one-step kernel."""
    return gs.step(cfg, s, feed=feed, kill=kill)


def gs_multistep_plain(cfg, s, k: int, feed=None, kill=None):
    """Plain PyTorch version of the K-step kernel: k torch steps."""
    for _ in range(k):
        s = gs.step(cfg, s, feed=feed, kill=kill)
    return s


def gs_step(cfg, s, feed=None, kill=None):
    """One step: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if on_cpu(s.u):
        return gs_step_plain(cfg, s, feed=feed, kill=kill)
    _check(cfg, s)
    return _launch("step", cfg, s, _params(cfg, 1, _scalars(cfg, feed, kill)))


def gs_multistep(cfg, s, k: int, feed=None, kill=None):
    """k steps in one launch: the kernel on CUDA tensors, the plain version
    on CPU tensors.  1 <= k <= MAX_BLOCK_K."""
    if not 1 <= k <= MAX_BLOCK_K:
        raise ValueError(f"k={k}: the K-step kernel takes 1 <= k <= "
                         f"{MAX_BLOCK_K}")
    if on_cpu(s.u):
        return gs_multistep_plain(cfg, s, k, feed=feed, kill=kill)
    _check(cfg, s)
    return _launch("multistep", cfg, s,
                   _params(cfg, k, _scalars(cfg, feed, kill)))


def run_kernels(cfg, s, n_steps: int, feed=None, kill=None):
    """The 'cuda' engine: core.stepper.run_split of n_steps over the K-step
    and the one-step wrapper, k = cfg.block_k."""
    return run_split(
        lambda st: gs_multistep(cfg, st, cfg.block_k, feed=feed, kill=kill),
        lambda st: gs_step(cfg, st, feed=feed, kill=kill),
        cfg.block_k, s, n_steps)
