"""ctypes binding to the native CPU 2-D hypersonic solver (port of
fluidsims_tpu.solvers.hypersonic2d_cpu_native) — the auto-vectorizable C
build of the CPU reference pair (behavioral spec tau_hypersonic.c +
tau_hypersonic_simd.c, which keeps bit-for-bit math order with the scalar
file).  The C solver mirrors solvers/hypersonic2d_cpu.py's arithmetic and
face-update order, so the two implementations agree to the last bit.

The source is the port's own copy,
fluidsims_tpu_torch/native/hypersonic2d_cpu.c, built at first use into
build/fluidsims_tpu_torch/ (core/native.py): first with -O3 -march=native
-ffp-contract=off (the explicit AVX2 compute_dt kernels), then, where that
fails, portable -O3.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..core.native import load_c
from .hypersonic2d_cpu import HypersonicCPUConfig

__all__ = ["native_available", "HypersonicCPUNative"]

_FLAG_SETS = (("-O3", "-march=native", "-ffp-contract=off"), ("-O3",))


@functools.lru_cache(maxsize=None)
def _load():
    """The typed library, or None where no C compiler can build it."""
    lib = load_c("hypersonic2d_cpu", _FLAG_SETS, ("-lm",))
    if lib is None:
        return None
    dbl_p = ctypes.POINTER(ctypes.c_double)
    u8_p = ctypes.POINTER(ctypes.c_uint8)
    lib.h2_create.restype = ctypes.c_void_p
    lib.h2_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_double,
                              ctypes.c_double, ctypes.c_double]
    lib.h2_destroy.argtypes = [ctypes.c_void_p]
    lib.h2_get.argtypes = [ctypes.c_void_p, dbl_p, u8_p, dbl_p]
    lib.h2_set.argtypes = [ctypes.c_void_p, dbl_p, ctypes.c_double]
    lib.h2_step.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def native_available() -> bool:
    return _load() is not None


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class HypersonicCPUNative:
    """Same interface shape as HypersonicCPU: .U, .mask, .t, .step()."""

    def __init__(self, cfg: HypersonicCPUConfig):
        lib = _load()
        if lib is None:
            raise RuntimeError("native hypersonic2d_cpu library unavailable "
                               "(no C compiler built "
                               "native/hypersonic2d_cpu.c)")
        self._lib = lib
        self.cfg = cfg
        self._h = lib.h2_create(cfg.w, cfg.h, cfg.gamma, cfg.cfl, cfg.mach)
        if not self._h:
            raise RuntimeError("h2_create failed")

    @property
    def state(self):
        cfg = self.cfg
        U = np.empty((cfg.h, cfg.w, 4), np.float64)
        mask = np.empty((cfg.h, cfg.w), np.uint8)
        t = np.zeros(1, np.float64)
        self._lib.h2_get(
            self._h, _dp(U),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _dp(t))
        return U, mask.astype(bool), float(t[0])

    @property
    def U(self):
        return self.state[0]

    @property
    def mask(self):
        return self.state[1]

    @property
    def t(self):
        return self.state[2]

    def set_state(self, U: np.ndarray, t: float = 0.0) -> None:
        U = np.ascontiguousarray(U, np.float64)
        self._lib.h2_set(self._h, _dp(U), float(t))

    def step(self, n: int = 1) -> None:
        self._lib.h2_step(self._h, int(n))

    def close(self) -> None:
        if self._h:
            self._lib.h2_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
