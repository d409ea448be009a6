"""CUDA kernels of the MLS-MPM step, with their wrappers and plain PyTorch
versions, and the 'cuda' engine's step built on them.

* `p2g(cfg, pos, vel, F, Jp)` — csrc/mpm_p2g.cu, which replaces the TPU
  kernel fluidsims_tpu/kernels/mpm_pallas.py::_p2g_kernel: the quadratic
  B-spline transfer of mass and of momentum plus the stress force over
  each particle's 3x3 nodes into three (Gy, Gx) grids, which the launch
  zeroes itself; out-of-grid targets are skipped.  Two designs
  (csrc/p2g_tiles.cuh), picked from the particles: "atomic" (one thread a
  particle, an atomicAdd a target and field, after a memset) below 2^18
  particles, "tiled" from there (one cooperative launch bins the
  particles by tile, sorts each chunk by cell in shared memory and adds
  each run of a cell's particles once); `_p2g` forces one, for checks;
  `p2g_launch` reports the design, tile, chunk, blocks, threads, shared
  memory and grid syncs, `p2g_stats` what the last launch counted.  Plain
  version: `p2g_plain` (solvers/mpm.py::_p2g, `index_add_`).
* `g2p(cfg, pos, F, Jp, mass, mom_x, mom_y)` — csrc/mpm_g2p.cu, which
  replaces both mpm_pallas.py::_grid_kernel and ::_g2p_kernel: the
  velocities of the nodes a block's particles gather formed from the P2G
  sums (normalize, gravity, the sticky bands) once into a window in
  shared memory, or where each is gathered for a block whose particles
  spread wide, then per particle the velocity and C, the F, Jp and
  position updates; no node velocity reaches device memory.  Plain
  version: `g2p_plain`
  (solvers/mpm.py::_grid_g2p: `_g2p` of `grid_update_plain`, which is
  solvers/mpm.py::_grid_update).
* `make_step_cuda(cfg)` — the 'cuda' engine's step: solvers/mpm.py::_step
  on the two kernels, one launch of each a step and no other device
  work.

The plain versions are the 'scatter' engine's functions, so that engine is
their composition.  The G2P is bitwise equal to its plain version for
equal grids (the grid update's operations at each node in the same order,
true divisions, the library built with -fmad=false); P2G's adds land in
no fixed order and it calls CUDA's exp and log, so it matches its plain
version to rounding.  Every constant the kernels take (inv_dx, the stress
scale, gravity*dt, the clip bounds) is formed in Python doubles as JAX
forms it and rounded once to the dtype.

The wrappers take the plain version for CPU tensors only, uncounted.  For
CUDA tensors they check device, dtype, shape and contiguity, launch on the
current stream, count the launch in `LAUNCHES`, and raise if the launch
fails; nothing falls back.  The P2G's launch is asked of the card once per
(np, grid, dtype, device), and its int32 scratch (tile counts, the index
array, the chunks) and slot words are kept per (np, grid, dtype, design,
device, stream) (`_common.tile_scratch`, which says why that is safe).
Nothing writes the tensors it is given.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..solvers import mpm
from . import _build
from ._common import (P2G_DESIGNS, LaunchCounter, P2GLaunch,
                      check_tensors, on_cpu, tile_launch, tile_scratch)
from ._common import grid_syncs as _grid_syncs

__all__ = ["LAUNCHES", "reset_launches", "p2g", "p2g_plain",
           "grid_update_plain", "g2p", "g2p_plain", "make_step_cuda", "load",
           "p2g_launch", "p2g_stats"]

LAUNCHES = LaunchCounter("p2g", "g2p")
reset_launches = LAUNCHES.reset

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _consts_struct(ctype):
    """ctypes twin of csrc/mpm.cuh's MPMConsts<T>."""
    names = ("inv_dx", "dx", "pm", "fe_lo", "fe_hi", "hardening", "mu0",
             "lambda0", "stress_c", "c4", "dt", "x_lo", "x_hi", "y_hi",
             "gdt")
    return type(f"MPMConsts_{ctype.__name__}", (ctypes.Structure,), {
        "_fields_": [("gx", ctypes.c_int), ("gy", ctypes.c_int),
                     ("material", ctypes.c_int)]
        + [(name, ctype) for name in names]})


_CONSTS = {torch.float32: _consts_struct(ctypes.c_float),
           torch.float64: _consts_struct(ctypes.c_double)}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with typed entry
    points."""
    lib = _build.load_library()
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for dtype, sfx in _SUFFIX.items():
        C = ctypes.POINTER(_CONSTS[dtype])
        fn = getattr(lib, f"fst_mpm_p2g_blocks_{sfx}")
        fn.argtypes = [L, I, I, I, I, ctypes.POINTER(P2GLaunch)]
        fn.restype = I
        fn = getattr(lib, f"fst_mpm_p2g_{sfx}")
        fn.argtypes = [P] * 9 + [L, C, I, I, I, P]
        fn.restype = I
        fn = getattr(lib, f"fst_mpm_g2p_{sfx}")
        fn.argtypes = [P] * 10 + [L, C, I, P]
        fn.restype = I
    lib.fst_cuda_error_string.argtypes = [I]
    lib.fst_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def consts(cfg: mpm.MPMConfig, dtype: torch.dtype):
    """The kernels' MPMConsts for cfg: each constant a Python double formed
    as JAX forms it, rounded to the dtype by ctypes."""
    dx = cfg.dx
    inv_dx = 1.0 / dx
    return _CONSTS[dtype](
        gx=cfg.gx, gy=cfg.gy, material=mpm.MATERIALS[cfg.material],
        inv_dx=inv_dx, dx=dx, pm=cfg.particle_mass,
        fe_lo=1.0 - cfg.critical_compression,
        fe_hi=1.0 + cfg.critical_stretch, hardening=cfg.hardening,
        mu0=cfg.mu0, lambda0=cfg.lambda0,
        stress_c=-4.0 * inv_dx * inv_dx * cfg.dt * cfg.volume,
        c4=4.0 * inv_dx, dt=cfg.dt, x_lo=2.0 * dx,
        x_hi=(cfg.gx - 3.0) * dx, y_hi=(cfg.gy - 3.0) * dx,
        gdt=cfg.gravity * cfg.dt)


def _dtype_of(ref: torch.Tensor) -> torch.dtype:
    if ref.dtype not in _SUFFIX:
        raise TypeError(f"no kernel for dtype {ref.dtype}")
    return ref.dtype


def _check_particles(pos, F, Jp, **pairs) -> int:
    """np of the particle fields: pos and every other (np, 2) field, F
    (np, 2, 2) and Jp (np,); raises unless all lie on pos' device with one
    dtype that has a kernel, and are contiguous."""
    shape = tuple(pos.shape)
    if len(shape) != 2 or shape[1] != 2 or shape[0] < 1:
        raise ValueError(f"pos must be (np, 2), got {shape}")
    dtype, dev = _dtype_of(pos), pos.device
    check_tensors({"pos": pos, **pairs}, shape, dtype, dev)
    check_tensors({"F": F}, (shape[0], 2, 2), dtype, dev)
    check_tensors({"Jp": Jp}, (shape[0],), dtype, dev)
    return shape[0]


def _check_grids(cfg, ref, **fields) -> None:
    """Raise unless every field is a contiguous (Gy, Gx) grid of cfg's
    shape, on ref's device with its dtype."""
    check_tensors(fields, (cfg.gy, cfg.gx), _dtype_of(ref), ref.device)


def _raise_if(code: int, lib, what: str) -> None:
    if code != 0:
        raise RuntimeError(
            f"mpm {what} failed: CUDA error {code} "
            f"({lib.fst_cuda_error_string(code).decode()})")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ------------------------------------ P2G ------------------------------------


def p2g_plain(cfg, pos, vel, F, Jp):
    """Plain PyTorch version of the P2G kernel: (mass, mom_x, mom_y)."""
    return mpm._p2g(cfg, pos, vel, F, Jp)


@functools.lru_cache(maxsize=None)
def p2g_launch(n_p: int, gx: int, gy: int, dtype: torch.dtype, index: int,
               design: str | None = None) -> P2GLaunch:
    """The P2G's launch for n_p particles on a (gy, gx) grid on device
    `index`, as the library computes it: the design (`design`, or the one
    the particles pick: "atomic" or "tiled"), blocks, threads a block, the
    tile of base nodes, particles a chunk, dynamic shared memory a block,
    grid syncs a launch and scratch words."""
    return tile_launch(load(), f"fst_mpm_p2g_blocks_{_SUFFIX[dtype]}", n_p,
                       gx, gy, -1 if design is None else P2G_DESIGNS[design],
                       index, kind=P2GLaunch)


def _p2g_scratch(n_p: int, gx: int, gy: int, dtype: torch.dtype,
                 shape: P2GLaunch, device: torch.device,
                 stream: int) -> tuple:
    # One scratch a launch shape, not a size: a tiled launch leaves its tile
    # counts at 0 for the next launch on the scratch, and another shape of
    # the same size keeps other words there (csrc/p2g_tiles.cuh p2g_layout).
    return tile_scratch(("mpm_p2g", n_p, gx, gy, dtype, shape.design),
                        shape.scratch_ints, torch.int32, device, stream)


def p2g_stats(cfg, n_p: int, dtype: torch.dtype, device: torch.device,
              design: str | None = None) -> dict:
    """What the last P2G launch of `design` for n_p particles on cfg's grid
    on the device's current stream counted: its grid syncs and, tiled, its
    chunks and the most particles in one tile (waits for the launch)."""
    shape = p2g_launch(n_p, cfg.gx, cfg.gy, dtype, device.index, design)
    scratch, words = _p2g_scratch(n_p, cfg.gx, cfg.gy, dtype, shape, device,
                                  _stream(device))
    out = {"design": shape.asdict()["design"],
           "grid_syncs": _grid_syncs(words)}
    if shape.scratch_ints:
        out.update(chunks=int(scratch[0]), most_in_tile=int(scratch[1]))
    return out


def p2g(cfg, pos, vel, F, Jp):
    """(mass, mom_x, mom_y), each (Gy, Gx), of the particles' transfer:
    the kernel on CUDA tensors (the design the particles pick), the plain
    version on CPU tensors."""
    if on_cpu(pos):
        return p2g_plain(cfg, pos, vel, F, Jp)
    return _p2g(cfg, pos, vel, F, Jp, design=None)


def _p2g(cfg, pos, vel, F, Jp, *, design):
    """`p2g` on CUDA tensors in `design` ("atomic" or "tiled"; None: the
    one the particles pick), so that checks can hold each design to the
    plain version."""
    n_p = _check_particles(pos, F, Jp, vel=vel)
    dev = pos.device
    shape = p2g_launch(n_p, cfg.gx, cfg.gy, pos.dtype, dev.index, design)
    stream = _stream(dev)
    scratch, words = _p2g_scratch(n_p, cfg.gx, cfg.gy, pos.dtype, shape, dev,
                                  stream)
    grids = torch.empty((3, cfg.gy, cfg.gx), dtype=pos.dtype, device=dev)
    lib = load()
    code = getattr(lib, f"fst_mpm_p2g_{_SUFFIX[pos.dtype]}")(
        pos.data_ptr(), vel.data_ptr(), F.data_ptr(), Jp.data_ptr(),
        grids[0].data_ptr(), grids[1].data_ptr(), grids[2].data_ptr(),
        scratch.data_ptr(), words.data_ptr(), n_p,
        ctypes.byref(consts(cfg, pos.dtype)), shape.design, shape.grid,
        dev.index, stream)
    _raise_if(code, lib, "p2g kernel launch")
    LAUNCHES["p2g"] += 1
    return grids[0], grids[1], grids[2]


# ------------------------------ grid update + G2P ----------------------------


def grid_update_plain(cfg, mass, mom_x, mom_y):
    """The node velocities (gu, gv) of the P2G grids, plain PyTorch: the
    grid update that `g2p` makes at the nodes it gathers."""
    return mpm._grid_update(cfg, mass, mom_x, mom_y)


def g2p_plain(cfg, pos, F, Jp, mass, mom_x, mom_y):
    """Plain PyTorch version of the G2P kernel: (pos, vel, F, Jp) of the
    G2P on `grid_update_plain`'s node velocities."""
    return mpm._grid_g2p(cfg, pos, F, Jp, mass, mom_x, mom_y)


def g2p(cfg, pos, F, Jp, mass, mom_x, mom_y):
    """The particles' new (pos, vel, F, Jp) from the P2G grids (mass,
    mom_x, mom_y), the grid update made at the nodes the particles
    gather: the kernel on CUDA tensors, the plain version on CPU tensors.
    The outputs are views of one fresh buffer, each contiguous."""
    if on_cpu(pos):
        return g2p_plain(cfg, pos, F, Jp, mass, mom_x, mom_y)
    n_p = _check_particles(pos, F, Jp)
    _check_grids(cfg, pos, mass=mass, mom_x=mom_x, mom_y=mom_y)
    dev = pos.device
    buf = torch.empty(9 * n_p, dtype=pos.dtype, device=dev)
    out = (buf[:2 * n_p].view(n_p, 2), buf[2 * n_p:4 * n_p].view(n_p, 2),
           buf[4 * n_p:8 * n_p].view(n_p, 2, 2), buf[8 * n_p:])
    lib = load()
    code = getattr(lib, f"fst_mpm_g2p_{_SUFFIX[pos.dtype]}")(
        pos.data_ptr(), F.data_ptr(), Jp.data_ptr(), mass.data_ptr(),
        mom_x.data_ptr(), mom_y.data_ptr(), *(o.data_ptr() for o in out),
        n_p, ctypes.byref(consts(cfg, pos.dtype)), dev.index, _stream(dev))
    _raise_if(code, lib, "g2p kernel launch")
    LAUNCHES["g2p"] += 1
    return out


def make_step_cuda(cfg):
    """Step (state, grid_reduce) -> state on the two kernels:
    solvers/mpm.py::_step with `p2g` and `g2p`, one launch of each."""
    return lambda s, grid_reduce=None: mpm._step(
        cfg, s, functools.partial(p2g, cfg), functools.partial(g2p, cfg),
        grid_reduce)
