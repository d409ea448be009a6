"""CUDA kernels of the 3-D hypersonic step, with their wrappers and plain
PyTorch versions.

* `step_core(cfg, qp, solid_pad, dt, gain, x0=0) -> PrimT` —
  csrc/hypersonic3d_step.cu, which replaces the TPU kernel
  fluidsims_tpu/kernels/hypersonic3d_pallas.py::_band_kernel: one block a
  tile, each face reconstructed and solved once from the tile staged in
  shared memory axis by axis (`step_launch` reports a launch's blocks,
  threads, tile, halo and shared memory).  Plain version:
  `step_core_plain` (step_core_padded of the solver: dense wall fluxes,
  slab sponges).
* `wavespeed(cfg, q1, solid) -> 0-d tensor` — csrc/
  hypersonic3d_wavespeed.cu: the masked max over fluid cells of
  (|u|+a)/dx + (|v|+a)/dy + (|w|+a)/dz, on the device, in one launch:
  16-byte loads, warp reductions, the blocks' maxima met in one word of a
  two-word scratch that `_wavespeed_scratch` keeps per device, stream and
  grid shape, and taken by the last block to finish (the kernel leaves
  both words at 0 for the next launch on it).  Plain version:
  `wavespeed_plain` (max_wavespeed of the solver).
* `pad(cfg, s, solid_pad) -> PrimT` — csrc/hypersonic3d_pad.cu: the
  step's prologue in one launch, the six encoded fields of `s` to the six
  halo-3 padded, boundary-resolved primitives that `step_core` reads,
  one thread a padded cell along x; the inflow state comes from
  `_params(cfg)`, so no value is copied from the host.  Plain version:
  `pad_plain` (`_padded_prims(cfg, _decode(...), solid_pad)` of the
  solver), bitwise the kernel's.

The wrappers take the plain version for CPU tensors only.  For CUDA
tensors they check device, dtype, shape and contiguity, launch on the
current stream, count the launch in `LAUNCHES`, and raise if the launch
fails; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..solvers import hypersonic3d as h3
from ..solvers.hypersonic3d import HALO, PrimT
from . import _build
from ._common import LaunchCounter, check_tensors, on_cpu, tile_scratch

__all__ = ["LAUNCHES", "reset_launches", "step_core", "step_core_plain",
           "step_launch", "Tile3Launch", "wavespeed", "wavespeed_plain",
           "pad", "pad_plain", "load"]

LAUNCHES = LaunchCounter("step", "wavespeed", "pad")
reset_launches = LAUNCHES.reset

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


class _Params(ctypes.Structure):
    """Mirror of fst::Hyp3DParams (csrc/hypersonic3d.cuh)."""

    _fields_ = [
        ("nz", ctypes.c_int),
        ("ny", ctypes.c_int),
        ("nx", ctypes.c_int),
        ("nx_global", ctypes.c_int),
        ("x0", ctypes.c_int),
        ("sponge_n", ctypes.c_int),
        ("sponge_out_n", ctypes.c_int),
        ("gamma", ctypes.c_double),
        ("gm1", ctypes.c_double),
        ("R", ctypes.c_double),
        ("theta_v", ctypes.c_double),
        ("R_theta_v", ctypes.c_double),
        ("tau_vib", ctypes.c_double),
        ("inv_d", ctypes.c_double * 3),
        ("d", ctypes.c_double * 3),
        ("infl", ctypes.c_double * 6),
        ("sponge_strength", ctypes.c_double),
        ("sponge_out_strength", ctypes.c_double),
        ("tgt_r", ctypes.c_double),
        ("tgt_p", ctypes.c_double),
        ("tgt_ev", ctypes.c_double),
    ]


class _PadParams(ctypes.Structure):
    """Mirror of fst::Hyp3DPadParams (csrc/hypersonic3d_pad.cu)."""

    _fields_ = [
        ("u_ref", ctypes.c_double),
        ("p_amb", ctypes.c_double),
        ("wall_div", ctypes.c_double),
        ("Twall", ctypes.c_double),
        ("characteristic", ctypes.c_int),
    ]


class Tile3Launch(ctypes.Structure):
    """Mirror of fst::Tile3Launch (csrc/hypersonic3d_step.cu): what the
    step's launch query reports, as the launch computes it."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("grid", "threads", "tile_x", "tile_y", "tile_z", "halo",
                 "smem_bytes")]

    def asdict(self) -> dict:
        return {name: getattr(self, name) for name, _ in self._fields_}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with typed entry
    points."""
    lib = _build.load_library()
    P = ctypes.c_void_p
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fst_hyp3d_step_{sfx}")
        fn.argtypes = [P] * 15 + [ctypes.POINTER(_Params), ctypes.c_int, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"fst_hyp3d_step_launch_{sfx}")
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(Tile3Launch)]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"fst_hyp3d_wavespeed_{sfx}")
        fn.argtypes = [P] * 8 + [ctypes.POINTER(_Params), ctypes.c_int, P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"fst_hyp3d_pad_{sfx}")
        fn.argtypes = [P] * 13 + [ctypes.POINTER(_Params),
                                  ctypes.POINTER(_PadParams), ctypes.c_int, P]
        fn.restype = ctypes.c_int
    lib.fst_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fst_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _params(cfg, x0: int = 0) -> _Params:
    """Every constant in double, formed from the config as the plain code
    forms it; the kernel rounds each to T once."""
    tgtT = max(cfg.inflow_p, h3.RHO_P_FLOOR) / (
        max(cfg.inflow_r, h3.RHO_P_FLOOR) * cfg.R)
    D3 = ctypes.c_double * 3
    return _Params(
        cfg.nz, cfg.ny, cfg.nx, cfg.nx, x0, cfg.sponge_n, cfg.sponge_out_n,
        cfg.gamma_floor, cfg.gamma_floor - 1.0, cfg.R, cfg.theta_v,
        cfg.R * cfg.theta_v, max(cfg.tau_vib, h3.TAU_VIB_MIN),
        D3(1.0 / cfg.dx, 1.0 / cfg.dy, 1.0 / cfg.dz),
        D3(cfg.dx, cfg.dy, cfg.dz),
        (ctypes.c_double * 6)(*h3.inflow_values(cfg)),
        cfg.sponge_strength, cfg.sponge_out_strength,
        max(cfg.inflow_r, h3.RHO_P_FLOOR), max(cfg.inflow_p, h3.RHO_P_FLOOR),
        h3.evib_eq_py(cfg, tgtT))


@functools.lru_cache(maxsize=None)
def _pad_params(cfg) -> _PadParams:
    """The prologue's constants beyond `_params`, in double, formed as the
    plain code forms them."""
    return _PadParams(
        cfg.u_ref, max(cfg.inflow_p, h3.RHO_P_FLOOR),
        cfg.R * max(cfg.Twall, h3.NEWTON_TEMP_FLOOR), cfg.Twall,
        int(cfg.outflow == "characteristic"))


def step_launch(nz: int, ny: int, nx: int,
                dtype: torch.dtype) -> Tile3Launch:
    """The launch of a step on an (nz, ny, nx) window, as the library
    computes it: blocks (one a tile), threads a block, the tile (csrc/
    hypersonic3d_step.cu kTX x kTY x kTZ), the halo along the staged axis
    and the dynamic shared memory a block."""
    lib = load()
    out = Tile3Launch()
    code = getattr(lib, f"fst_hyp3d_step_launch_{_SUFFIX[dtype]}")(
        nz, ny, nx, ctypes.byref(out))
    _raise_on_error(lib, code, "hypersonic3d step (launch query)")
    return out


def _check_fields(cfg, q: PrimT, mask: torch.Tensor, shape, what: str,
                  scalars=()) -> None:
    dev = mask.device
    if cfg.torch_dtype not in _SUFFIX:
        raise TypeError(f"no kernel for dtype {cfg.torch_dtype}")
    if mask.dtype != torch.bool or tuple(mask.shape) != shape:
        raise ValueError(f"{what} mask must be bool {shape}, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if not mask.is_contiguous():
        raise ValueError(f"{what} mask must be contiguous")
    for name, f in zip(PrimT._fields, q):
        if f.device != dev:
            raise ValueError(f"{what}.{name} on {f.device}, mask on {dev}")
        if f.dtype != cfg.torch_dtype:
            raise TypeError(f"{what}.{name} is {f.dtype}, config says "
                            f"{cfg.torch_dtype}")
        if tuple(f.shape) != shape:
            raise ValueError(f"{what}.{name} has shape {tuple(f.shape)}, "
                             f"config says {shape}")
        if not f.is_contiguous():
            raise ValueError(f"{what}.{name} must be contiguous")
    for name, s in scalars:
        if s.device != dev or s.dtype != cfg.torch_dtype or s.numel() != 1:
            raise ValueError(f"{name} must be a one-element {cfg.torch_dtype} "
                             f"tensor on {dev}, got {s.dtype} "
                             f"{tuple(s.shape)} on {s.device}")


def _padded_shape(cfg):
    return (cfg.nz + 2 * HALO, cfg.ny + 2 * HALO, cfg.nx + 2 * HALO)


def _raise_on_error(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {code} "
            f"({lib.fst_cuda_error_string(code).decode()})")


def step_core_plain(cfg, qp: PrimT, solid_pad, dt, gain, x0: int = 0) -> PrimT:
    """Plain PyTorch version of the step kernel."""
    return h3.step_core_padded(cfg, qp, solid_pad, dt, gain, x0=x0,
                               solid_box="dense", sponge_mode="slab")


def step_core(cfg, qp: PrimT, solid_pad, dt, gain, x0: int = 0) -> PrimT:
    """step_core_padded on halo-3 padded prims: the step kernel on CUDA
    tensors, the plain version on CPU tensors.  `dt` and `gain` are 0-d
    tensors; the kernel reads them from device memory."""
    if on_cpu(solid_pad):
        return step_core_plain(cfg, qp, solid_pad, dt, gain, x0)
    _check_fields(cfg, qp, solid_pad, _padded_shape(cfg), "qp",
                  (("dt", dt), ("gain", gain)))
    lib = load()
    shape = (cfg.nz, cfg.ny, cfg.nx)
    out = PrimT(*(torch.empty(shape, dtype=cfg.torch_dtype,
                              device=solid_pad.device) for _ in range(6)))
    fn = getattr(lib, f"fst_hyp3d_step_{_SUFFIX[cfg.torch_dtype]}")
    params = _params(cfg, x0)
    with torch.cuda.device(solid_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(*(f.data_ptr() for f in qp), solid_pad.data_ptr(),
                  dt.data_ptr(), gain.data_ptr(),
                  *(f.data_ptr() for f in out), ctypes.byref(params),
                  solid_pad.device.index or 0, stream)
    _raise_on_error(lib, code, "hypersonic3d step")
    LAUNCHES["step"] += 1
    return out


def wavespeed_plain(cfg, q1: PrimT, solid) -> torch.Tensor:
    """Plain PyTorch version of the wavespeed kernel."""
    return h3.max_wavespeed(cfg, q1, solid)


def _wavespeed_scratch(cfg, device: torch.device, stream: int) -> torch.Tensor:
    """The two words (the max bits so far, the blocks done) of the
    wavespeed launches of cfg's grid and dtype on one stream: zeroed when
    made, and left at 0 by each launch for the next."""
    return tile_scratch(("hyp3d_wavespeed", cfg.nz, cfg.ny, cfg.nx,
                         cfg.torch_dtype), 2, torch.int64, device, stream)[0]


def wavespeed(cfg, q1: PrimT, solid) -> torch.Tensor:
    """The masked max wavespeed of `q1` as a 0-d tensor on its device: the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if on_cpu(solid):
        return wavespeed_plain(cfg, q1, solid)
    _check_fields(cfg, q1, solid, (cfg.nz, cfg.ny, cfg.nx), "q1")
    lib = load()
    out = torch.empty((), dtype=cfg.torch_dtype, device=solid.device)
    fn = getattr(lib, f"fst_hyp3d_wavespeed_{_SUFFIX[cfg.torch_dtype]}")
    params = _params(cfg)
    with torch.cuda.device(solid.device):
        stream = torch.cuda.current_stream().cuda_stream
        scratch = _wavespeed_scratch(cfg, solid.device, stream)
        code = fn(*(f.data_ptr() for f in q1[:5]), solid.data_ptr(),
                  out.data_ptr(), scratch.data_ptr(), ctypes.byref(params),
                  solid.device.index or 0, stream)
    _raise_on_error(lib, code, "hypersonic3d wavespeed")
    LAUNCHES["wavespeed"] += 1
    return out


def pad_plain(cfg, s, solid_pad) -> PrimT:
    """Plain PyTorch version of the prologue kernel."""
    return h3._padded_prims(cfg, h3._decode(cfg, *s[:6]), solid_pad)


def pad(cfg, s, solid_pad) -> PrimT:
    """The halo-3 padded, boundary-resolved primitives of the state `s`
    (its six encoded fields) on the padded mask `solid_pad`: the prologue
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if on_cpu(solid_pad):
        return pad_plain(cfg, s, solid_pad)
    if cfg.torch_dtype not in _SUFFIX:
        raise TypeError(f"no kernel for dtype {cfg.torch_dtype}")
    shape = _padded_shape(cfg)
    if solid_pad.dtype != torch.bool or tuple(solid_pad.shape) != shape:
        raise ValueError(f"solid_pad must be bool {shape}, got "
                         f"{solid_pad.dtype} {tuple(solid_pad.shape)}")
    if not solid_pad.is_contiguous():
        raise ValueError("solid_pad must be contiguous")
    if cfg.nz < HALO or cfg.ny < HALO:
        raise ValueError(f"the periodic halo needs nz, ny >= {HALO}, got "
                         f"{cfg.nz}, {cfg.ny}")
    dev = solid_pad.device
    check_tensors(dict(zip(h3.Hypersonic3DState._fields, s[:6])),
                  (cfg.nz, cfg.ny, cfg.nx), cfg.torch_dtype, dev)
    lib = load()
    # one allocation for the six fields: the wrapper's host time is the
    # device's idle time where a frame begins with a step
    out = PrimT(*torch.empty((6, *shape), dtype=cfg.torch_dtype,
                             device=dev).unbind(0))
    fn = getattr(lib, f"fst_hyp3d_pad_{_SUFFIX[cfg.torch_dtype]}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(*(f.data_ptr() for f in s[:6]), solid_pad.data_ptr(),
                  *(f.data_ptr() for f in out), ctypes.byref(_params(cfg)),
                  ctypes.byref(_pad_params(cfg)), dev.index or 0, stream)
    _raise_on_error(lib, code, "hypersonic3d pad")
    LAUNCHES["pad"] += 1
    return out
