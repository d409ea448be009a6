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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.stepper import run_split
from ..solvers import shallow_water as sw
from . import _build
from ._common import GRID_MAX_WORDS, LaunchCounter, check_tensors, on_cpu

__all__ = ["LAUNCHES", "MAX_BLOCK_K", "reset_launches", "sw_multistep",
           "sw_multistep_plain", "run_kernels", "load"]

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
    P = ctypes.c_void_p
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fst_sw_multistep_{sfx}")
        fn.argtypes = [P] * 12 + [ctypes.POINTER(_Params), ctypes.c_int, P]
        fn.restype = ctypes.c_int
    lib.fst_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fst_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _params(cfg, k: int) -> _Params:
    """The constants of `step_fields`, as Python forms them."""
    inv_dx, inv_dy = 1.0 / cfg.dx, 1.0 / cfg.dy
    return _Params(cfg.ny, cfg.nx, k, int(cfg.nu > 0.0), cfg.g, 0.5 * cfg.g,
                   cfg.cfl * min(cfg.dx, cfg.dy), cfg.dtau, inv_dx, inv_dy,
                   inv_dx * inv_dx, inv_dy * inv_dy, cfg.nu)


def _scratch_fields(cfg) -> int:
    """state ping-pong (3), depth by step parity (2), and with viscosity
    the updated velocities (2)."""
    return 7 if cfg.nu > 0.0 else 5


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
    lib = load()
    dev, dt = s.sigma.device, cfg.torch_dtype
    cells = cfg.nx * cfg.ny
    out = torch.empty((3, cfg.ny, cfg.nx), dtype=dt, device=dev)
    clock = torch.empty(2, dtype=dt, device=dev)
    scratch = torch.empty(_scratch_fields(cfg) * cells, dtype=dt, device=dev)
    slots = torch.empty(GRID_MAX_WORDS, dtype=torch.int64, device=dev)
    params = _params(cfg, k)
    fn = getattr(lib, f"fst_sw_multistep_{_SUFFIX[dt]}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(s.sigma.data_ptr(), s.u.data_ptr(), s.v.data_ptr(),
                  s.t.data_ptr(), s.tau.data_ptr(), out[0].data_ptr(),
                  out[1].data_ptr(), out[2].data_ptr(), clock[0].data_ptr(),
                  clock[1].data_ptr(), scratch.data_ptr(), slots.data_ptr(),
                  ctypes.byref(params), dev.index or 0, stream)
    if code != 0:
        raise RuntimeError(
            f"shallow-water multistep kernel launch failed: CUDA error "
            f"{code} ({lib.fst_cuda_error_string(code).decode()})")
    LAUNCHES["multistep" if k > 1 else "step"] += 1
    return sw.ShallowWaterState(sigma=out[0], u=out[1], v=out[2], t=clock[0],
                                tau=clock[1])


def run_kernels(cfg, s, n_steps: int):
    """The 'cuda' engine: core.stepper.run_split of n_steps over launches
    of k = cfg.block_k steps and of one step."""
    return run_split(lambda st: sw_multistep(cfg, st, cfg.block_k),
                     lambda st: sw_multistep(cfg, st, 1),
                     cfg.block_k, s, n_steps)
