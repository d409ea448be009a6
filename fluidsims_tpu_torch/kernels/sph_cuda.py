"""CUDA kernels of the SPH substep, with their wrappers and plain PyTorch
versions, and the 'cuda' engine built on them.

* `binning(cfg, pos, vel) -> Binned` — csrc/sph_bin.cu, which replaces the
  TPU kernel fluidsims_tpu/ops/rank_pallas.py::_kernel: each particle's
  rank in its cell, and the particles sorted by (cell, particle index).
  Plain version: `binning_plain` (one packed-key sort).
* `density(cfg, b) -> rp` — csrc/sph_density.cu, which replaces
  fluidsims_tpu/kernels/sph_pallas.py::_density_kernel: (rho, p / rho^2)
  per sorted position.  Plain version: `density_plain`.
* `forces(cfg, b, rp, dt) -> (pos, vel)` — csrc/sph_forces.cu, which
  replaces sph_pallas.py::_forces_kernel: pair forces, gravity and the
  integrate, back in particle order.  Plain version: `forces_plain`.

The plain versions compute each kernel's function on the cell-dense layout
(ops/cell_dense.py) with the arithmetic of the TPU kernels, term by term,
so a kernel and its plain version differ only in the order of their sums.

The wrappers take the plain version for CPU tensors only.  For CUDA
tensors they check device, dtype, shape and contiguity, launch on the
current stream, count the launch in `LAUNCHES`, and raise if the launch
fails; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ..ops import cell_dense as cd
from ..solvers import sph as sph_mod
from . import _build

__all__ = ["LAUNCHES", "reset_launches", "Binned", "binning", "binning_plain",
           "density", "density_plain", "forces", "forces_plain",
           "make_step_cuda", "load"]

# Launches of each kernel since the last reset_launches(): one per wrapper
# call that launched on the GPU.
LAUNCHES = {"bin": 0, "density": 0, "forces": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Binned(NamedTuple):
    """What the bin kernel gives the pair kernels."""

    cid: torch.Tensor     # (n,) int32 flat cell id, particle order
    rank: torch.Tensor    # (n,) int32 rank in the cell, particle order
    ok: torch.Tensor      # (n,) bool rank < K: stored, particle order
    starts: torch.Tensor  # (M + 1,) int32 first sorted position of each cell
    order: torch.Tensor   # (n,) int32 particle index at each sorted position
    fields: torch.Tensor  # (n, 4) (x, y, vx, vy) at each sorted position


class _Params(ctypes.Structure):
    """Mirror of fst::SPHParams (csrc/sph.cuh)."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("n", "Gx", "Gy", "K", "use_visc", "use_grav", "gamma_is_one")
                ] + [(name, ctypes.c_double) for name in
                     ("cell", "inv_h", "alpha", "alpha_q", "mass", "inv_rho0",
                      "c0sq_rho0", "gamma_eos", "four_h2", "two_h",
                      "visc_coef", "eps_h2", "gravity", "box_x", "box_y")]


@functools.lru_cache(maxsize=None)
def _params(cfg) -> _Params:
    """The kernels' constants, formed from Python floats as the TPU kernels
    form them; the plain versions read the same values."""
    g = cfg.grid()
    h = cfg.h
    alpha = 10.0 / (7.0 * math.pi * h * h)
    return _Params(
        n=cfg.n, Gx=g.Gx, Gy=g.Gy, K=g.K, use_visc=int(cfg.use_visc),
        use_grav=int(cfg.use_grav), gamma_is_one=int(cfg.gamma_eos == 1.0),
        cell=g.cell, inv_h=1.0 / h, alpha=alpha, alpha_q=alpha * 0.25,
        mass=cfg.mass, inv_rho0=1.0 / cfg.rho0,
        c0sq_rho0=(cfg.c0 ** 2) * cfg.rho0, gamma_eos=cfg.gamma_eos,
        four_h2=(2.0 * h) ** 2, two_h=2.0 * h,
        visc_coef=-cfg.visc_alpha * cfg.c0 * h, eps_h2=0.01 * (h * h),
        gravity=cfg.gravity, box_x=cfg.box_x, box_y=cfg.box_y)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with typed entry
    points."""
    lib = _build.load_library()
    P = ctypes.c_void_p
    tail = [ctypes.POINTER(_Params)]
    for sfx in _SUFFIX.values():
        for name, argtypes in (
                ("bin", [P, P] + tail + [P] * 8),
                ("density", [P, P] + tail + [P]),
                ("forces", [P] * 5 + tail + [P, P])):
            fn = getattr(lib, f"fst_sph_{name}_{sfx}")
            fn.argtypes = argtypes + [ctypes.c_int, P]
            fn.restype = ctypes.c_int
    lib.fst_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fst_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}; use cpu or cuda")
    return False


def _check(cfg, **tensors) -> None:
    """Each argument is (tensor, dtype or None for cfg's, shape)."""
    dev = None
    for name, (t, dtype, shape) in tensors.items():
        dtype = dtype or cfg.torch_dtype
        dev = dev or t.device
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _binned_specs(cfg, b: Binned) -> dict:
    g = cfg.grid()
    n = cfg.n
    i32 = torch.int32
    return {"cid": (b.cid, i32, (n,)), "rank": (b.rank, i32, (n,)),
            "ok": (b.ok, torch.bool, (n,)),
            "starts": (b.starts, i32, (g.Gx * g.Gy + 1,)),
            "order": (b.order, i32, (n,)), "fields": (b.fields, None, (n, 4))}


def _launch(name: str, dtype, device, *args) -> None:
    lib = load()
    fn = getattr(lib, f"fst_sph_{name}_{_SUFFIX[dtype]}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(*args, device.index or 0, stream)
    if code != 0:
        raise RuntimeError(
            f"sph {name} kernel launch failed: CUDA error {code} "
            f"({lib.fst_cuda_error_string(code).decode()})")
    LAUNCHES[name] += 1


# ------------------------------- binning ------------------------------------


def binning_plain(cfg, pos, vel) -> Binned:
    """Plain PyTorch version of the bin kernel."""
    g = cfg.grid()
    cid = cd._cid(g, pos)
    order, _, slot = cd.sort_by_cell(g, pos, cid)
    starts = torch.zeros(g.Gx * g.Gy + 1, dtype=torch.int64, device=pos.device)
    starts[1:] = torch.cumsum(torch.bincount(cid, minlength=g.Gx * g.Gy), 0)
    rank = torch.empty_like(slot)
    rank[order] = slot
    i32 = torch.int32
    return Binned(cid=cid.to(i32), rank=rank.to(i32), ok=rank < g.K,
                  starts=starts.to(i32), order=order.to(i32),
                  fields=torch.cat([pos, vel], 1)[order])


def binning(cfg, pos, vel) -> Binned:
    """Rank-in-cell binning: the kernel on CUDA tensors, the plain version
    on CPU tensors."""
    if _on_cpu(pos):
        return binning_plain(cfg, pos, vel)
    n = cfg.n
    _check(cfg, pos=(pos, None, (n, 2)), vel=(vel, None, (n, 2)))
    g = cfg.grid()
    M = g.Gx * g.Gy
    i32 = {"dtype": torch.int32, "device": pos.device}
    out = Binned(cid=torch.empty(n, **i32), rank=torch.empty(n, **i32),
                 ok=torch.empty(n, dtype=torch.bool, device=pos.device),
                 starts=torch.empty(M + 1, **i32),
                 order=torch.empty(n, **i32),
                 fields=torch.empty((n, 4), dtype=pos.dtype, device=pos.device))
    counts = torch.empty(M, **i32)
    bucket = torch.empty(n, **i32)
    _launch("bin", pos.dtype, pos.device, pos.data_ptr(), vel.data_ptr(),
            ctypes.byref(_params(cfg)), out.cid.data_ptr(), counts.data_ptr(),
            out.starts.data_ptr(), bucket.data_ptr(), out.order.data_ptr(),
            out.rank.data_ptr(), out.ok.data_ptr(), out.fields.data_ptr())
    return out


# --------------------- plain pair passes on the dense layout -----------------


def _dense_slots(cfg, b: Binned):
    """Dense slot (cell * K + rank) of each sorted position, M*K where the
    rank is >= K (not stored), and the stored mask."""
    g = cfg.grid()
    M, K = g.Gx * g.Gy, g.K
    sc = b.cid[b.order.long()].long()
    starts = b.starts.long()
    rank = torch.arange(cfg.n, device=sc.device) - starts[sc]
    ok = rank < K
    return torch.where(ok, sc * K + rank, M * K), ok


def _to_dense(cfg, slot, x):
    """(n, c) in sorted order -> (Gy, Gx, K, c); empty slots zero."""
    g = cfg.grid()
    M, K = g.Gx * g.Gy, g.K
    d = torch.zeros((M * K + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    d[slot] = x   # not stored: into the spare slot M*K, dropped below
    return d[:M * K].reshape(g.Gy, g.Gx, K, x.shape[1])


def _from_dense(cfg, slot, ok, d):
    """(Gy, Gx, K, c) -> (n, c) in sorted order; not stored: zero."""
    g = cfg.grid()
    flat = d.reshape(g.Gx * g.Gy * g.K, d.shape[-1])
    vals = flat[slot.clamp(max=flat.shape[0] - 1)]
    return torch.where(ok[:, None], vals, torch.zeros((), dtype=d.dtype,
                                                      device=d.device))


def _pairs(cfg, dense, occ, oy, ox):
    """Centre-slot x neighbour-slot geometry of one 3x3 offset:
    (neighbour dense block, neighbour occupancy (.., 1, K), dx, dy, r2)."""
    nb = cd.shift_cells(dense, oy, ox)
    nocc = cd.shift_cells(occ, oy, ox)[..., None, :]
    dx = dense[..., :, None, 0] - nb[..., None, :, 0]
    dy = dense[..., :, None, 1] - nb[..., None, :, 1]
    return nb, nocc, dx, dy, dx * dx + dy * dy


def density_plain(cfg, b: Binned) -> torch.Tensor:
    """Plain PyTorch version of the density kernel:
    (rho, p / rho^2) per sorted position, (n, 2); (0, 0) where not stored."""
    p = _params(cfg)
    slot, ok = _dense_slots(cfg, b)
    occ = _to_dense(cfg, slot, ok[:, None])[..., 0]
    dpos = _to_dense(cfg, slot, b.fields[:, :2])
    zero = torch.zeros((), dtype=dpos.dtype, device=dpos.device)

    rho = torch.zeros(dpos.shape[:3], dtype=dpos.dtype, device=dpos.device)
    for ox, oy in cd.NEIGHBOR_OFFSETS_2D:
        _, nocc, _, _, r2 = _pairs(cfg, dpos, occ, oy, ox)
        q = torch.sqrt(r2) * p.inv_h
        q2 = q * q
        t = 2.0 - q
        w = torch.where(q < 1.0, p.alpha * (1.0 - 1.5 * q2 + 0.75 * q2 * q),
                        torch.where(q < 2.0, p.alpha_q * t * t * t, zero))
        rho = rho + torch.sum(torch.where(nocc, w, zero), dim=-1)
    rho = p.mass * rho

    rho = torch.exp(torch.log(torch.clamp(rho, min=1e-6)))
    ratio = rho * p.inv_rho0
    powed = ratio if p.gamma_is_one else torch.exp(p.gamma_eos * torch.log(ratio))
    press = torch.clamp(p.c0sq_rho0 * (powed - 1.0)
                        / torch.full((), p.gamma_eos, dtype=rho.dtype,
                                     device=rho.device), min=0.0)
    rs = torch.clamp(rho, min=1e-30)
    return _from_dense(cfg, slot, ok, torch.stack([rho, press / (rs * rs)], -1))


def forces_plain(cfg, b: Binned, rp, dt):
    """Plain PyTorch version of the forces + integrate kernel: (pos, vel)
    in particle order."""
    p = _params(cfg)
    K = p.K
    slot, ok = _dense_slots(cfg, b)
    occ = _to_dense(cfg, slot, ok[:, None])[..., 0]
    dst = _to_dense(cfg, slot, b.fields)
    drp = _to_dense(cfg, slot, rp)
    zero = torch.zeros((), dtype=dst.dtype, device=dst.device)
    not_self = ~torch.eye(K, dtype=torch.bool, device=dst.device)

    rho_i = torch.clamp(drp[..., 0], min=1e-30)[..., :, None]
    pt_i = drp[..., 1][..., :, None]
    ax = torch.zeros(dst.shape[:3], dtype=dst.dtype, device=dst.device)
    ay = torch.zeros_like(ax)
    for ox, oy in cd.NEIGHBOR_OFFSETS_2D:
        nb, nocc, dx, dy, r2 = _pairs(cfg, dst, occ, oy, ox)
        nrp = cd.shift_cells(drp, oy, ox)
        valid = nocc & (r2 < p.four_h2) & (r2 > 1e-16)
        if ox == 0 and oy == 0:
            valid = valid & not_self
        r2s = torch.clamp(r2, min=1e-30)
        inv_r = 1.0 / torch.sqrt(r2s)
        r = r2s * inv_r
        q = r * p.inv_h
        t = 2.0 - q
        dwdq = torch.where(q < 1.0, p.alpha * (-3.0 * q + 2.25 * q * q),
                           p.alpha * (-0.75 * (t * t)))
        scale = torch.where((r > 1e-8) & (r < p.two_h),
                            dwdq * p.inv_h * inv_r, zero)
        common = -p.mass * (pt_i + nrp[..., None, :, 1])
        if p.use_visc:
            dot = ((dst[..., :, None, 2] - nb[..., None, :, 2]) * dx
                   + (dst[..., :, None, 3] - nb[..., None, :, 3]) * dy)
            rho_bar = 0.5 * (rho_i + torch.clamp(nrp[..., None, :, 0], min=1e-30))
            pi = torch.where(dot < 0.0,
                             p.visc_coef * dot / ((r2 + p.eps_h2) * rho_bar),
                             zero)
            common = common - p.mass * pi
        c = torch.where(valid, common * scale, zero)
        ax = ax + torch.sum(c * dx, dim=-1)
        ay = ay + torch.sum(c * dy, dim=-1)

    acc = _from_dense(cfg, slot, ok, torch.stack([ax, ay], -1))
    if p.use_grav:
        acc = acc - torch.tensor([0.0, p.gravity], dtype=acc.dtype,
                                 device=acc.device)
    pos_s, vel_s = sph_mod._integrate(cfg, b.fields[:, :2], b.fields[:, 2:],
                                      acc, dt)
    order = b.order.long()
    pos, vel = torch.empty_like(pos_s), torch.empty_like(vel_s)
    pos[order] = pos_s
    vel[order] = vel_s
    return pos, vel


# ------------------------------ pair kernels --------------------------------


def density(cfg, b: Binned) -> torch.Tensor:
    """(rho, p / rho^2) per sorted position: the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if _on_cpu(b.fields):
        return density_plain(cfg, b)
    _check(cfg, **_binned_specs(cfg, b))
    rp = torch.empty((cfg.n, 2), dtype=b.fields.dtype, device=b.fields.device)
    _launch("density", rp.dtype, rp.device, b.fields.data_ptr(),
            b.starts.data_ptr(), ctypes.byref(_params(cfg)), rp.data_ptr())
    return rp


def forces(cfg, b: Binned, rp, dt):
    """Pair forces, gravity and the integrate from the sorted state, `rp`
    and the 0-d `dt`, returned as (pos, vel) in particle order: the kernel
    on CUDA tensors, the plain version on CPU tensors."""
    if _on_cpu(b.fields):
        return forces_plain(cfg, b, rp, dt)
    n = cfg.n
    _check(cfg, rp=(rp, None, (n, 2)), dt=(dt, None, ()),
           **_binned_specs(cfg, b))
    pos = torch.empty((n, 2), dtype=rp.dtype, device=rp.device)
    vel = torch.empty_like(pos)
    _launch("forces", rp.dtype, rp.device, b.fields.data_ptr(), rp.data_ptr(),
            b.starts.data_ptr(), b.order.data_ptr(), dt.data_ptr(),
            ctypes.byref(_params(cfg)), pos.data_ptr(), vel.data_ptr())
    return pos, vel


def make_step_cuda(cfg):
    """Frame step (state, dtau=None) -> state on the three kernels: per
    substep bin -> density -> forces + integrate (which also integrates the
    particles past a cell's K slots with gravity alone), then rain and the
    τ bookkeeping, as fluidsims_tpu/kernels/sph_pallas.py::make_step_pallas
    does.  No value is read back to the host."""
    if cfg.use_xsph:
        raise ValueError("the cuda SPH engine does not implement XSPH")

    def substep(pos, vel, dt_sub):
        b = binning(cfg, pos, vel)
        return forces(cfg, b, density(cfg, b), dt_sub)

    def step(st, dtau=None):
        return sph_mod._advance(cfg, st, dtau, substep)

    return step
