"""CUDA kernel of the GLM-MHD K-step, with its wrapper and plain PyTorch
version, and the 'cuda' engine's run built on it.

* `mhd_multistep(cfg, s, k) -> MHDState` — csrc/mhd_multistep.cu, which
  replaces the TPU kernel fluidsims_tpu/kernels/mhd_resident_pallas.py::
  make_multistep_pallas.kernel: k steps of `step_core` (default hooks) in
  one cooperative launch, the wavespeed max of each step an exact
  grid-wide max, no padded copy.  Plain version: `mhd_multistep_plain`
  (k torch steps).
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
from ..solvers import mhd
from . import _build
from ._common import GRID_MAX_WORDS, LaunchCounter, check_tensors, on_cpu

__all__ = ["LAUNCHES", "MAX_BLOCK_K", "reset_launches", "mhd_multistep",
           "mhd_multistep_plain", "run_kernels", "load"]

LAUNCHES = LaunchCounter("step", "multistep")
reset_launches = LAUNCHES.reset

# Steps a launch at most: the kernel has no limit of its own; this keeps
# one launch short.
MAX_BLOCK_K = 1024

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_SCRATCH_FIELDS = 21  # state ping-pong, Fx and Fy: 7 fields each
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
    P = ctypes.c_void_p
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fst_mhd_multistep_{sfx}")
        fn.argtypes = [_PTRS7, P, _PTRS7, P, P, P, ctypes.POINTER(_Params),
                       ctypes.c_int, P]
        fn.restype = ctypes.c_int
    lib.fst_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fst_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _params(cfg, k: int) -> _Params:
    """The constants of `step_core` (dx = 1/nx, dy = 1/ny), as Python
    forms them."""
    dx, dy = 1.0 / cfg.nx, 1.0 / cfg.ny
    return _Params(cfg.ny, cfg.nx, k, int(cfg.stable_hll), cfg.gamma,
                   cfg.gamma - 1.0, cfg.cfl * min(dx, dy), dx, dy,
                   min(dx, dy), -mhd.GLM_ALPHA)


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
    lib = load()
    dev, dt = s.t.device, cfg.torch_dtype
    cells = cfg.nx * cfg.ny
    out = torch.empty((7, cfg.ny, cfg.nx), dtype=dt, device=dev)
    t_out = torch.empty((), dtype=dt, device=dev)
    scratch = torch.empty(_SCRATCH_FIELDS * cells, dtype=dt, device=dev)
    slots = torch.empty(GRID_MAX_WORDS, dtype=torch.int64, device=dev)
    params = _params(cfg, k)
    fields = out.unbind(0)
    fn = getattr(lib, f"fst_mhd_multistep_{_SUFFIX[dt]}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(_PTRS7(*(f.data_ptr() for f in s.U)), s.t.data_ptr(),
                  _PTRS7(*(f.data_ptr() for f in fields)), t_out.data_ptr(),
                  scratch.data_ptr(), slots.data_ptr(), ctypes.byref(params),
                  dev.index or 0, stream)
    if code != 0:
        raise RuntimeError(
            f"mhd multistep kernel launch failed: CUDA error {code} "
            f"({lib.fst_cuda_error_string(code).decode()})")
    LAUNCHES["multistep" if k > 1 else "step"] += 1
    return mhd.MHDState(U=mhd.ConsM(*fields), t=t_out)


def run_kernels(cfg, s, n_steps: int):
    """The 'cuda' engine: core.stepper.run_split of n_steps over launches
    of k = cfg.block_k steps and of one step."""
    return run_split(lambda st: mhd_multistep(cfg, st, cfg.block_k),
                     lambda st: mhd_multistep(cfg, st, 1),
                     cfg.block_k, s, n_steps)
