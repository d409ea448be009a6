"""CUDA kernel of the prime-graph layout's exact repulsion, with its
wrapper and plain PyTorch version.

* `repulsion_exact(cfg, pos, rows=None) -> (nt, dims)` — csrc/
  nbody_repulsion.cu: the all-pairs sum over every body of `pos` for each
  target (the rows of `rows`, or `pos` itself), several targets a thread,
  sources staged through shared memory a tile at a time as one vector
  each, fused multiply-adds, the repulsion factor applied once to a
  target's sum, one launch (`repulsion_launch` reports its shape).  The
  JAX package computes this as plain XLA (fluidsims_tpu/solvers/
  nbody_graph.py::_repulsion_exact); no Pallas kernel is replaced.  Plain
  version: `repulsion_exact_plain` (solvers/nbody_graph._repulsion_exact,
  chunked by `cfg.chunk`, which the kernel does not need).
* `term_scale(cfg, pos, rows=None)` — sum_j |w_ij| |d_ij| for each
  target, the scale against which the checks measure a force's error (the
  forces of the init layouts cancel to far below the size of their
  terms); plain PyTorch, in pos' dtype.

The wrapper takes the plain version for CPU tensors only.  For CUDA
tensors it checks device, dtype, shape and contiguity, launches on the
current stream, counts the launch in `LAUNCHES`, and raises if the launch
fails; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..solvers import nbody_graph as ng
from . import _build
from ._common import LaunchCounter, on_cpu, raise_if

__all__ = ["LAUNCHES", "reset_launches", "repulsion_exact",
           "repulsion_exact_plain", "repulsion_launch", "term_scale", "load"]

LAUNCHES = LaunchCounter("repulsion")
reset_launches = LAUNCHES.reset

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with typed entry
    points."""
    lib = _build.load_library()
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fst_nbody_repulsion_{sfx}")
        fn.argtypes = [P, I, P, I, I, D, D, P, I, P]
        fn.restype = ctypes.c_int
    lib.fst_nbody_repulsion_launch.argtypes = [I, I, P]
    lib.fst_nbody_repulsion_launch.restype = ctypes.c_int
    lib.fst_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fst_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(cfg, pos: torch.Tensor, rows: torch.Tensor | None) -> None:
    """Raise unless pos (and rows) are contiguous (n, cfg.dims) tensors of
    the config's dtype on one device, with at least one body."""
    dtype = cfg.torch_dtype
    for name, x in (("pos", pos), ("rows", rows)):
        if x is None:
            continue
        if x.device != pos.device:
            raise ValueError(f"{name} on {x.device}, pos on {pos.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} is {x.dtype}, config says {dtype}")
        if x.dim() != 2 or x.shape[1] != cfg.dims or x.shape[0] < 1:
            raise ValueError(f"{name} must be (n, {cfg.dims}) with n >= 1, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


_LAUNCH_FIELDS = ("threads", "targets", "blocks", "unroll")


def repulsion_launch(nt: int, dtype: torch.dtype) -> dict:
    """The kernel's launch for nt targets, as the library computes it:
    threads a block (= sources a tile), targets a thread, blocks and
    sources a step of a full tile's loop."""
    lib = load()
    shape = (ctypes.c_int * len(_LAUNCH_FIELDS))()
    raise_if(lib.fst_nbody_repulsion_launch(nt, int(dtype == torch.float64),
                                            shape),
             lib, "nbody repulsion launch query")
    return dict(zip(_LAUNCH_FIELDS, shape))


def repulsion_exact_plain(cfg, pos: torch.Tensor,
                          rows: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    return ng._repulsion_exact(cfg, pos, rows)


def repulsion_exact(cfg, pos: torch.Tensor,
                    rows: torch.Tensor | None = None) -> torch.Tensor:
    """The exact repulsion on each target (`rows`, or every body of
    `pos`) from every body of `pos`: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if on_cpu(pos):
        return repulsion_exact_plain(cfg, pos, rows)
    _check(cfg, pos, rows)
    targets = pos if rows is None else rows
    lib = load()
    out = torch.empty_like(targets)
    fn = getattr(lib, f"fst_nbody_repulsion_{_SUFFIX[pos.dtype]}")
    dev = pos.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(targets.data_ptr(), targets.shape[0], pos.data_ptr(),
                  pos.shape[0], cfg.dims, float(cfg.softening),
                  float(cfg.repulsion), out.data_ptr(), dev.index or 0,
                  stream)
    raise_if(code, lib, "nbody repulsion kernel launch")
    LAUNCHES["repulsion"] += 1
    return out


def term_scale(cfg, pos: torch.Tensor,
               rows: torch.Tensor | None = None) -> torch.Tensor:
    """sum_j |w_ij| |d_ij| for each target of `rows` (or `pos`), with the
    kernel's w_ij = repulsion * (|d_ij|^2 + softening)^(-3/2), in pos'
    dtype, chunked by cfg.chunk: the scale of a target's force error."""
    targets = pos if rows is None else rows
    CH = max(1, min(cfg.chunk, targets.shape[0]))
    out = torch.empty(targets.shape[0], dtype=pos.dtype, device=pos.device)
    for a in range(0, targets.shape[0], CH):
        pc = targets[a:a + CH]
        d2 = sum((pc[:, k, None] - pos[None, :, k]) ** 2
                 for k in range(pos.shape[1]))
        w = cfg.repulsion * torch.rsqrt(d2 + cfg.softening) ** 3
        out[a:a + CH] = torch.sum(w * torch.sqrt(d2), dim=1)
    return out
