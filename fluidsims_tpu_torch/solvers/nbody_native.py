"""ctypes binding to the native threaded Barnes–Hut engine (port of
fluidsims_tpu.solvers.nbody_native): the host-side counterpart of
nbody_graph.py, the reference's pthread worker pool + quadtree/octree
(number_fluid2d.c:44-79, :244-354; number_fluid3d.c:255-382) in C.

The source is the port's own copy, fluidsims_tpu_torch/native/nbody_bh.c.
It is built with the system C compiler (cc, gcc or clang: -O2 -shared
-fPIC -lpthread -lm) at first use into build/fluidsims_tpu_torch/ beside
the package, named by a hash of the source, the compiler and the flags
(core/native.py), and loaded with ctypes.  The engine runs on the host in
float64 and touches no device; `run_native` hands its result back as the port's state on the
caller's device.  `theta` is the multipole-acceptance knob (0 = exact
pairwise, the reference uses 0.75).
"""

from __future__ import annotations

import ctypes
import functools
import os
from pathlib import Path

import numpy as np
import torch

from ..core.native import COMPILERS, load_c
from ..core.native import source_path as native_source
from .nbody_graph import GraphLayoutConfig, GraphLayoutState

__all__ = ["native_available", "run_native", "BHEngine", "source_path"]


def source_path() -> Path:
    return native_source("nbody_bh")


@functools.lru_cache(maxsize=None)
def _load():
    """The typed library, or None where no C compiler can build it."""
    lib = load_c("nbody_bh", (("-O2",),), ("-lpthread", "-lm"))
    if lib is None:
        return None
    dbl_p = ctypes.POINTER(ctypes.c_double)
    i32_p = ctypes.POINTER(ctypes.c_int32)
    lib.bh_create.restype = ctypes.c_void_p
    lib.bh_create.argtypes = [ctypes.c_int, ctypes.c_int, i32_p,
                              ctypes.c_int, dbl_p, ctypes.c_int]
    lib.bh_destroy.argtypes = [ctypes.c_void_p]
    lib.bh_set_state.argtypes = [ctypes.c_void_p, dbl_p, dbl_p]
    lib.bh_get_state.argtypes = [ctypes.c_void_p, dbl_p, dbl_p]
    lib.bh_run.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def native_available() -> bool:
    return _load() is not None


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class BHEngine:
    """Owns a native simulation: persistent worker pool + tree buffers."""

    def __init__(self, cfg: GraphLayoutConfig, edges: np.ndarray,
                 n_threads: int | None = None, theta: float = 0.75):
        if n_threads is None:
            n_threads = max(1, os.cpu_count() or 1)
        lib = _load()
        if lib is None:
            raise RuntimeError("native nbody_bh library unavailable (no C "
                               f"compiler among {COMPILERS} built "
                               f"{source_path()})")
        self._lib = lib
        self.cfg = cfg
        self.n = cfg.n_bodies
        self.dims = cfg.dims
        edges = np.ascontiguousarray(edges, np.int32)
        params = np.asarray([
            cfg.link_length, cfg.spring_k, cfg.softening, cfg.repulsion,
            cfg.damping, cfg.dt, cfg.max_speed, theta,
        ], np.float64)
        self._h = lib.bh_create(
            cfg.dims, self.n,
            edges.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(edges), _dp(params), n_threads)
        if not self._h:
            raise RuntimeError("bh_create failed")

    def set_state(self, pos: np.ndarray, vel: np.ndarray) -> None:
        pos = np.ascontiguousarray(pos, np.float64)
        vel = np.ascontiguousarray(vel, np.float64)
        if not pos.shape == (self.n, self.dims) == vel.shape:
            raise ValueError(f"pos and vel must be {(self.n, self.dims)}, "
                             f"got {pos.shape} and {vel.shape}")
        self._lib.bh_set_state(self._h, _dp(pos), _dp(vel))

    def get_state(self):
        pos = np.empty((self.n, self.dims), np.float64)
        vel = np.empty((self.n, self.dims), np.float64)
        self._lib.bh_get_state(self._h, _dp(pos), _dp(vel))
        return pos, vel

    def run(self, n_steps: int) -> None:
        self._lib.bh_run(self._h, int(n_steps))

    def close(self) -> None:
        if self._h:
            self._lib.bh_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_native(cfg: GraphLayoutConfig, s: GraphLayoutState, n_steps: int,
               n_threads: int | None = None,
               theta: float = 0.75) -> GraphLayoutState:
    """Advance a GraphLayoutState with the native engine (float64 on the
    host); the result is in the config's dtype on s.pos' device.
    n_threads defaults to the machine's CPU count."""
    with BHEngine(cfg, s.edges.cpu().numpy(), n_threads, theta) as eng:
        eng.set_state(s.pos.detach().cpu().numpy().astype(np.float64),
                      s.vel.detach().cpu().numpy().astype(np.float64))
        eng.run(n_steps)
        pos, vel = eng.get_state()
    dev, dt = s.pos.device, cfg.torch_dtype
    return GraphLayoutState(
        pos=torch.tensor(pos, dtype=dt, device=dev),
        vel=torch.tensor(vel, dtype=dt, device=dev),
        edges=s.edges, steps=s.steps + n_steps,
    )
