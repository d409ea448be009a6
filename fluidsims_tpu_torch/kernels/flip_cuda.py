"""CUDA kernels of the FLIP/APIC step, with their wrappers and plain PyTorch
versions, and the 'cuda' engine's step built on them.

* `p2g(cfg, pos, vel, ax, ay, apic)` — csrc/flip_p2g.cu, which replaces the
  TPU kernel fluidsims_tpu/kernels/flip_pallas.py::_p2g_kernel: the
  hat-weight transfer of mass and APIC momentum over each particle's 3x3
  nodes into three (n, n) grids, which the launch zeroes itself.  Two
  designs (csrc/p2g_tiles.cuh), picked from the particles: "atomic" (one
  thread a particle, an atomicAdd a target and field, after a memset)
  below 2^18 particles, "tiled" from there (one cooperative launch bins
  the particles by tile, sorts each chunk by cell in shared memory and
  adds each run of a cell's particles once); `_p2g` forces one, for checks;
  `p2g_launch` reports the design, tile, chunk, blocks, threads, shared
  memory and grid syncs, `p2g_stats` what the last launch counted.  Plain
  version: `p2g_plain` (solvers/flip_apic.py::_p2g, `index_add_`).
* `grid_phase(cfg, mass, u, v)` — csrc/flip_grid.cu, which replaces
  flip_pallas.py::_grid_kernel: normalize, gravity, wall clamps,
  divergence, every Jacobi sweep and the projection in one cooperative
  launch, several sweeps a grid sync on tiles in shared memory
  (`grid_launch` reports the tile and the sweeps a sync, `grid_syncs`
  the syncs the last launch made).  Plain version: `grid_phase_plain`
  (solvers/flip_apic.py::_grid_phase).
* `g2p(cfg, pos, vel, u_prev, v_prev, u_proj, v_proj, flip)` —
  csrc/flip_g2p.cu, which replaces flip_pallas.py::_g2p_kernel: per
  particle the samples (each node of the projected field loaded once, from
  a window about the particle's cell), the FLIP/PIC blend, the APIC affine
  matrix, the advection with restitution walls and the density raster
  (adds grouped by cell within a warp); `g2p_launch` reports its blocks
  and threads.  Plain version: `g2p_plain` (solvers/flip_apic.py::_g2p).
* `make_step_cuda(cfg)` — the 'cuda' engine's step: solvers/flip_apic.py::
  _step on the three kernels, one launch of each a step; around them only
  the memset of the raster.

The plain versions are the 'scatter' engine's functions, so that engine is
their composition.  The grid phase and G2P are bitwise equal to their
plain versions for equal inputs (same operation order, true divisions,
the library built with -fmad=false); P2G's adds land in no fixed order,
so it matches its plain version to rounding.  The blend factors flip and
apic are launch arguments: an override runs the same kernels.

The wrappers take the plain version for CPU tensors only, uncounted.  For
CUDA tensors they check device, dtype, shape and contiguity, launch on the
current stream, count the launch in `LAUNCHES`, and raise if the launch
fails; nothing falls back.  The grid phase's launch is asked of the card
once per (n, dtype, device), and its scratch (divergence and the pressure
ping-pong, 3 (n, n) fields) and slot words are kept per (n, dtype,
device, stream) (`_common.tile_scratch`, which says why that is safe); the
P2G's launch once per (np, n, dtype, device), its int32 scratch (tile
counts, the index array, the chunks) and slot words per (np, n, dtype,
design, device, stream).  Nothing writes the tensors it is given.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..solvers import flip_apic as fa
from . import _build
from ._common import (P2G_DESIGNS, LaunchCounter, P2GLaunch, TileLaunch,
                      check_tensors, on_cpu, tile_launch, tile_scratch)
from ._common import grid_syncs as _grid_syncs

__all__ = ["LAUNCHES", "reset_launches", "p2g", "p2g_plain", "grid_phase",
           "grid_phase_plain", "g2p", "g2p_plain", "make_step_cuda", "load",
           "grid_launch", "grid_syncs", "p2g_launch", "p2g_stats",
           "g2p_launch"]

LAUNCHES = LaunchCounter("p2g", "grid", "g2p")
reset_launches = LAUNCHES.reset

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with typed entry
    points."""
    lib = _build.load_library()
    P, I, L, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_double
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fst_flip_p2g_blocks_{sfx}")
        fn.argtypes = [L, I, I, I, ctypes.POINTER(P2GLaunch)]
        fn.restype = I
        fn = getattr(lib, f"fst_flip_p2g_{sfx}")
        fn.argtypes = [P] * 9 + [L, I, D, I, I, I, P]
        fn.restype = I
        fn = getattr(lib, f"fst_flip_grid_blocks_{sfx}")
        fn.argtypes = [I, I, ctypes.POINTER(TileLaunch)]
        fn.restype = I
        fn = getattr(lib, f"fst_flip_grid_{sfx}")
        fn.argtypes = [P] * 9 + [I, I, D, I, I, P]
        fn.restype = I
        fn = getattr(lib, f"fst_flip_g2p_{sfx}")
        fn.argtypes = [P] * 11 + [L, I, D, D, I, P]
        fn.restype = I
        fn = getattr(lib, f"fst_flip_g2p_blocks_{sfx}")
        fn.argtypes = [L, ctypes.POINTER(TileLaunch)]
        fn.restype = I
    lib.fst_cuda_error_string.argtypes = [I]
    lib.fst_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _dtype_of(ref: torch.Tensor) -> torch.dtype:
    if ref.dtype not in _SUFFIX:
        raise TypeError(f"no kernel for dtype {ref.dtype}")
    return ref.dtype


def _check_particles(**fields) -> int:
    """np of the (np, 2) particle fields; raises unless all lie on one
    device with one dtype that has a kernel, and are equal and
    contiguous."""
    ref = next(iter(fields.values()))
    shape = tuple(ref.shape)
    if len(shape) != 2 or shape[1] != 2 or shape[0] < 1:
        raise ValueError(f"particle fields must be (np, 2), got {shape}")
    check_tensors(fields, shape, _dtype_of(ref), ref.device)
    return shape[0]


def _check_grids(cfg, **fields) -> None:
    """Raise unless every field is a contiguous (n, n) grid of cfg's n, on
    the first field's device with its dtype."""
    ref = next(iter(fields.values()))
    check_tensors(fields, (cfg.grid, cfg.grid), _dtype_of(ref), ref.device)


def _raise_if(code: int, lib, what: str) -> None:
    if code != 0:
        raise RuntimeError(
            f"flip {what} failed: CUDA error {code} "
            f"({lib.fst_cuda_error_string(code).decode()})")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ------------------------------------ P2G ------------------------------------


def p2g_plain(cfg, pos, vel, ax, ay, apic=None):
    """Plain PyTorch version of the P2G kernel: (mass, mom_u, mom_v)."""
    return fa._p2g(cfg, pos, vel, ax, ay, apic)


@functools.lru_cache(maxsize=None)
def p2g_launch(n_p: int, n: int, dtype: torch.dtype, index: int,
               design: str | None = None) -> P2GLaunch:
    """The P2G's launch for n_p particles on an (n, n) grid on device
    `index`, as the library computes it: the design (`design`, or the one
    the particles pick: "atomic" or "tiled"), blocks, threads a block, the
    tile of base nodes, particles a chunk, dynamic shared memory a block,
    grid syncs a launch and scratch words."""
    return tile_launch(load(), f"fst_flip_p2g_blocks_{_SUFFIX[dtype]}", n_p,
                       n, -1 if design is None else P2G_DESIGNS[design],
                       index, kind=P2GLaunch)


def _p2g_scratch(n_p: int, n: int, dtype: torch.dtype, shape: P2GLaunch,
                 device: torch.device, stream: int) -> tuple:
    # One scratch a launch shape, not a size: a tiled launch leaves its tile
    # counts at 0 for the next launch on the scratch, and another shape of
    # the same size keeps other words there (csrc/p2g_tiles.cuh p2g_layout).
    return tile_scratch(("flip_p2g", n_p, n, dtype, shape.design),
                        shape.scratch_ints, torch.int32, device, stream)


def p2g_stats(cfg, n_p: int, dtype: torch.dtype, device: torch.device,
              design: str | None = None) -> dict:
    """What the last P2G launch of `design` for n_p particles on cfg's grid
    on the device's current stream counted: its grid syncs and, tiled, its
    chunks and the most particles in one tile (waits for the launch)."""
    shape = p2g_launch(n_p, cfg.grid, dtype, device.index, design)
    scratch, words = _p2g_scratch(n_p, cfg.grid, dtype, shape, device,
                                  _stream(device))
    out = {"design": shape.asdict()["design"],
           "grid_syncs": _grid_syncs(words)}
    if shape.scratch_ints:
        out.update(chunks=int(scratch[0]), most_in_tile=int(scratch[1]))
    return out


def p2g(cfg, pos, vel, ax, ay, apic=None):
    """(mass, mom_u, mom_v), each (n, n), of the particles' hat-weighted
    transfer: the kernel on CUDA tensors (the design the particles pick),
    the plain version on CPU tensors.  `apic` overrides cfg.apic."""
    if on_cpu(pos):
        return p2g_plain(cfg, pos, vel, ax, ay, apic)
    return _p2g(cfg, pos, vel, ax, ay, apic, design=None)


def _p2g(cfg, pos, vel, ax, ay, apic=None, *, design):
    """`p2g` on CUDA tensors in `design` ("atomic" or "tiled"; None: the
    one the particles pick), so that checks can hold each design to the
    plain version."""
    n_p = _check_particles(pos=pos, vel=vel, affine_x=ax, affine_y=ay)
    n = cfg.grid
    apic = float(cfg.apic if apic is None else apic)
    dev = pos.device
    shape = p2g_launch(n_p, n, pos.dtype, dev.index, design)
    stream = _stream(dev)
    scratch, words = _p2g_scratch(n_p, n, pos.dtype, shape, dev, stream)
    grids = torch.empty((3, n, n), dtype=pos.dtype, device=dev)
    lib = load()
    code = getattr(lib, f"fst_flip_p2g_{_SUFFIX[pos.dtype]}")(
        pos.data_ptr(), vel.data_ptr(), ax.data_ptr(), ay.data_ptr(),
        grids[0].data_ptr(), grids[1].data_ptr(), grids[2].data_ptr(),
        scratch.data_ptr(), words.data_ptr(), n_p, n, apic, shape.design,
        shape.grid, dev.index, stream)
    _raise_if(code, lib, "p2g kernel launch")
    LAUNCHES["p2g"] += 1
    return grids[0], grids[1], grids[2]


# --------------------------------- grid phase --------------------------------


@functools.lru_cache(maxsize=None)
def grid_launch(n: int, dtype: torch.dtype, index: int) -> TileLaunch:
    """The grid phase's launch on an (n, n) grid on device `index`, as the
    library computes it: blocks, threads a block, the tile (csrc/
    flip_grid.cu, picked from n), the halo (= the sweeps a grid sync, h)
    and the dynamic shared memory a block.  A launch of `jacobi` sweeps
    makes max(ceil(jacobi / h), 1) - 1 grid syncs."""
    return tile_launch(load(), f"fst_flip_grid_blocks_{_SUFFIX[dtype]}", n,
                       index)


def _scratch(n: int, dtype: torch.dtype, device: torch.device) -> tuple:
    """(scratch of 3 (n, n) fields, slot words) of grid-phase launches on
    the device's current stream."""
    return tile_scratch("flip_grid", 3 * n * n, dtype, device,
                        _stream(device))


def grid_syncs(n: int, dtype: torch.dtype, device: torch.device) -> int:
    """The grid syncs that the last grid-phase launch on an (n, n) grid of
    `dtype` on the device's current stream made, as the kernel counted
    them."""
    return _grid_syncs(_scratch(n, dtype, device)[1])


def grid_phase_plain(cfg, mass, u, v):
    """Plain PyTorch version of the grid-phase kernel: (u_prev, v_prev,
    u_proj, v_proj)."""
    return fa._grid_phase(cfg, mass, u, v)


def grid_phase(cfg, mass, u, v):
    """(u_prev, v_prev, u_proj, v_proj) from the P2G grids: the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if on_cpu(mass):
        return grid_phase_plain(cfg, mass, u, v)
    _check_grids(cfg, mass=mass, mom_u=u, mom_v=v)
    n, dev = cfg.grid, mass.device
    lib = load()
    shape = grid_launch(n, mass.dtype, dev.index)
    out = torch.empty((4, n, n), dtype=mass.dtype, device=dev)
    scratch, words = _scratch(n, mass.dtype, dev)
    code = getattr(lib, f"fst_flip_grid_{_SUFFIX[mass.dtype]}")(
        mass.data_ptr(), u.data_ptr(), v.data_ptr(),
        *(out[k].data_ptr() for k in range(4)), scratch.data_ptr(),
        words.data_ptr(), n, max(cfg.jacobi, 0),
        float(cfg.gravity * cfg.dt),
        shape.grid, dev.index, _stream(dev))
    _raise_if(code, lib, "grid phase kernel launch")
    LAUNCHES["grid"] += 1
    return out[0], out[1], out[2], out[3]


# ------------------------------------ G2P ------------------------------------


@functools.lru_cache(maxsize=None)
def g2p_launch(n_p: int, dtype: torch.dtype) -> TileLaunch:
    """The G2P's launch for n_p particles of `dtype`, as the library
    computes it: blocks (grid) and threads a block."""
    return tile_launch(load(), f"fst_flip_g2p_blocks_{_SUFFIX[dtype]}", n_p)


def _pair_aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on an (x, y)
    pair's boundary: the kernel reads a pair as one vector."""
    return t if t.data_ptr() % (2 * t.element_size()) == 0 else t.clone()


def g2p_plain(cfg, pos, vel, u_prev, v_prev, u_proj, v_proj, flip=None):
    """Plain PyTorch version of the G2P kernel: (pos, vel, affine_x,
    affine_y, density)."""
    return fa._g2p(cfg, pos, vel, u_prev, v_prev, u_proj, v_proj, flip)


def g2p(cfg, pos, vel, u_prev, v_prev, u_proj, v_proj, flip=None):
    """The particles' new (pos, vel, affine_x, affine_y) and the density
    raster (n, n) int32: the kernel on CUDA tensors, the plain version on
    CPU tensors.  `flip` overrides cfg.flip."""
    if on_cpu(pos):
        return g2p_plain(cfg, pos, vel, u_prev, v_prev, u_proj, v_proj, flip)
    n_p = _check_particles(pos=pos, vel=vel)
    _check_grids(cfg, u_prev=u_prev, v_prev=v_prev, u_proj=u_proj,
                 v_proj=v_proj)
    if u_prev.dtype != pos.dtype or u_prev.device != pos.device:
        raise TypeError(f"grids are {u_prev.dtype} on {u_prev.device}, "
                        f"particles {pos.dtype} on {pos.device}")
    n, dev = cfg.grid, pos.device
    flip = float(cfg.flip if flip is None else flip)
    pos, vel = _pair_aligned(pos), _pair_aligned(vel)
    parts = torch.empty((4, n_p, 2), dtype=pos.dtype, device=dev)
    density = torch.zeros((n, n), dtype=torch.int32, device=dev)
    lib = load()
    code = getattr(lib, f"fst_flip_g2p_{_SUFFIX[pos.dtype]}")(
        pos.data_ptr(), vel.data_ptr(), u_prev.data_ptr(), v_prev.data_ptr(),
        u_proj.data_ptr(), v_proj.data_ptr(),
        *(parts[k].data_ptr() for k in range(4)), density.data_ptr(), n_p, n,
        flip, float(cfg.dt), dev.index, _stream(dev))
    _raise_if(code, lib, "g2p kernel launch")
    LAUNCHES["g2p"] += 1
    return parts[0], parts[1], parts[2], parts[3], density


def make_step_cuda(cfg):
    """Step (state, grid_reduce, flip, apic) -> state on the three kernels:
    solvers/flip_apic.py::_step with `p2g`, `grid_phase` and `g2p`, one
    launch of each."""
    return lambda s, grid_reduce=None, flip=None, apic=None: fa._step(
        cfg, s, functools.partial(p2g, cfg),
        functools.partial(grid_phase, cfg), functools.partial(g2p, cfg),
        grid_reduce, flip, apic)
