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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.stepper import run_split
from ..solvers import burgers as bg
from . import _build
from ._common import GRID_MAX_WORDS, LaunchCounter, check_tensors, on_cpu

__all__ = ["LAUNCHES", "MAX_BLOCK_K", "reset_launches", "burgers_multistep",
           "burgers_multistep_plain", "run_kernels", "load"]

LAUNCHES = LaunchCounter("step", "multistep")
reset_launches = LAUNCHES.reset

# Steps a launch at most: the kernel has no limit of its own; this keeps
# one launch short.
MAX_BLOCK_K = 1024

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


class _Params(ctypes.Structure):
    """Mirror of fst::BurgersParams (csrc/burgers_multistep.cu)."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("ny", "nx", "k", "muscl", "one_d", "visc_substeps")] + [
        (name, ctypes.c_double) for name in
        ("u0", "dx", "dy", "inv_dy", "cfl", "dtau", "inv_dx2", "inv_dy2",
         "nu")]


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with typed entry
    points."""
    lib = _build.load_library()
    P = ctypes.c_void_p
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fst_burgers_multistep_{sfx}")
        fn.argtypes = [P] * 10 + [ctypes.POINTER(_Params), ctypes.c_int, P]
        fn.restype = ctypes.c_int
    lib.fst_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fst_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _params(cfg, k: int) -> _Params:
    """The constants of `step_fields`, as Python forms them."""
    one_d = cfg.colehopf
    inv_dy = 0.0 if (one_d or cfg.ny <= 1) else 1.0 / cfg.dy
    inv_dy2 = 0.0 if one_d else 1.0 / (cfg.dy * cfg.dy)
    return _Params(cfg.ny, cfg.nx, k, int(cfg.muscl), int(one_d),
                   cfg.visc_substeps, cfg.u0, cfg.dx, cfg.dy, inv_dy, cfg.cfl,
                   cfg.dtau, 1.0 / (cfg.dx * cfg.dx), inv_dy2, cfg.nu)


def _scratch_fields(cfg) -> int:
    """phi ping-pong (2), decoded u0, v0 (2), one or two (u, v) pairs for
    the convective update and the viscosity substeps."""
    return 6 if cfg.visc_substeps == 1 else 8


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
    lib = load()
    dev, dt = s.phi_u.device, cfg.torch_dtype
    cells = cfg.nx * cfg.ny
    out = torch.empty((2, cfg.ny, cfg.nx), dtype=dt, device=dev)
    clock = torch.empty(2, dtype=dt, device=dev)
    scratch = torch.empty(_scratch_fields(cfg) * cells, dtype=dt, device=dev)
    slots = torch.empty(GRID_MAX_WORDS, dtype=torch.int64, device=dev)
    params = _params(cfg, k)
    fn = getattr(lib, f"fst_burgers_multistep_{_SUFFIX[dt]}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(s.phi_u.data_ptr(), s.phi_v.data_ptr(), s.t.data_ptr(),
                  s.tau.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                  clock[0].data_ptr(), clock[1].data_ptr(),
                  scratch.data_ptr(), slots.data_ptr(), ctypes.byref(params),
                  dev.index or 0, stream)
    if code != 0:
        raise RuntimeError(
            f"burgers multistep kernel launch failed: CUDA error {code} "
            f"({lib.fst_cuda_error_string(code).decode()})")
    LAUNCHES["multistep" if k > 1 else "step"] += 1
    return bg.BurgersState(phi_u=out[0], phi_v=out[1], t=clock[0],
                           tau=clock[1])


def run_kernels(cfg, s, n_steps: int):
    """The 'cuda' engine: core.stepper.run_split of n_steps over launches
    of k = cfg.block_k steps and of one step."""
    return run_split(lambda st: burgers_multistep(cfg, st, cfg.block_k),
                     lambda st: burgers_multistep(cfg, st, 1),
                     cfg.block_k, s, n_steps)
