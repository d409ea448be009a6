"""CUDA kernels of the SPH substep, with their wrappers and plain PyTorch
versions, and the 'cuda' engine built on them.

* `binning(cfg, pos, vel) -> Binned` — csrc/sph_bin.cu, which replaces the
  TPU kernel fluidsims_tpu/ops/rank_pallas.py::_kernel: each particle's
  rank in its cell, and the particles sorted by (cell, particle index), in
  a cooperative launch and a plain one (`bin_launch` reports them,
  `bin_grid_syncs` the syncs the first counted; the scratch kept per
  launch shape and stream, as `_common.tile_scratch` says).  Plain
  version: `binning_plain` (one packed-key sort).
* `density(cfg, b) -> rp` — csrc/sph_density.cu, which replaces
  fluidsims_tpu/kernels/sph_pallas.py::_density_kernel: (rho, p / rho^2)
  per sorted position; the forces kernel's blocks, with positions alone
  staged and lanes of its own (`density_shape` reports the blocks).
  Plain version: `density_plain`.
* `forces(cfg, b, rp, dt) -> (pos, vel)` — csrc/sph_forces.cu, which
  replaces sph_pallas.py::_forces_kernel: pair forces, gravity and the
  integrate, back in particle order; a block a run of sorted positions,
  their 3x3 cells staged in shared memory in chunks, 2-8 lanes a particle
  chosen from the particle count (`forces_shape` reports the blocks).
  Plain version: `forces_plain`.

Neither the kernels nor their plain versions have a cell capacity: every
member of the 3x3 cells around a particle enters its pair sums, as in the
reference's linked lists (tau_sph.cu:165-176), so the 'cuda' engine keeps
every pair the 'exact' engine keeps.  The plain versions walk the same
cell ranges as a pair list, chunked, summed with `index_add_`, with the
kernels' arithmetic term by term: a kernel and its plain version differ
only in the order of their sums, and their cost scales with the pairs.

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
from ._common import LaunchCounter, on_cpu, tile_launch, tile_scratch
from ._common import grid_syncs as _grid_syncs

__all__ = ["LAUNCHES", "reset_launches", "Binned", "binning", "binning_plain",
           "BinLaunch", "bin_launch", "bin_grid_syncs", "pair_chunks",
           "density", "density_plain", "pair_density",
           "density_eos", "pair_forces", "forces",
           "forces_plain", "BlockShape", "density_shape", "forces_shape",
           "make_step_cuda", "load"]

LAUNCHES = LaunchCounter("bin", "density", "forces")
reset_launches = LAUNCHES.reset

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


class Binned(NamedTuple):
    """What the bin kernel gives the pair kernels."""

    cid: torch.Tensor     # (n,) int32 flat cell id, particle order
    rank: torch.Tensor    # (n,) int32 rank in the cell, particle order
    starts: torch.Tensor  # (M + 1,) int32 first sorted position of each cell
    order: torch.Tensor   # (n,) int32 particle index at each sorted position
    fields: torch.Tensor  # (n, 4) (x, y, vx, vy) at each sorted position


class _Params(ctypes.Structure):
    """Mirror of fst::SPHParams (csrc/sph.cuh)."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("n", "Gx", "Gy", "use_visc", "use_grav", "gamma_is_one")
                ] + [(name, ctypes.c_double) for name in
                     ("cell", "inv_h", "alpha", "alpha_q", "mass", "inv_rho0",
                      "c0sq_rho0", "gamma_eos", "four_h2", "two_h",
                      "visc_coef", "eps_h2", "gravity", "box_x", "box_y")]


class BlockShape(ctypes.Structure):
    """Mirror of fst::SPHBlockShape (csrc/sph.cuh): the density or forces
    kernel's threads a block, lanes a particle, candidates a staged chunk
    and dynamic shared memory a block."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("threads", "lanes", "chunk", "smem_bytes")]

    def asdict(self) -> dict:
        return {name: getattr(self, name) for name, _ in self._fields_}


class BinLaunch(ctypes.Structure):
    """Mirror of fst::BinLaunch (csrc/sph_bin.cu): the bin's two launches
    as its grid query reports them: the cooperative launch's blocks,
    threads a block and grid syncs; the second launch's blocks and the
    first of them that rank the listed cells; the most members of a cell
    ranked by counting in its slots' blocks (count_cap) and sorted at once
    (block_cap); dynamic shared memory a block of the second launch and
    the int32 words of scratch."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("grid", "threads", "grid_syncs", "rank_grid", "sort_blocks",
                 "count_cap", "block_cap", "smem_bytes")] + [
                     ("scratch_ints", ctypes.c_longlong)]

    def asdict(self) -> dict:
        return {name: getattr(self, name) for name, _ in self._fields_}


@functools.lru_cache(maxsize=None)
def _params(cfg) -> _Params:
    """The kernels' constants, formed from Python floats as the TPU kernels
    form them; the plain versions read the same values."""
    g = cfg.grid()
    h = cfg.h
    alpha = 10.0 / (7.0 * math.pi * h * h)
    return _Params(
        n=cfg.n, Gx=g.Gx, Gy=g.Gy, use_visc=int(cfg.use_visc),
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
                ("bin", [P, P] + tail + [P] * 7 + [ctypes.c_int] * 2),
                ("density", [P, P] + tail + [P]),
                ("forces", [P] * 5 + tail + [P, P])):
            fn = getattr(lib, f"fst_sph_{name}_{sfx}")
            fn.argtypes = argtypes + [ctypes.c_int, P]
            fn.restype = ctypes.c_int
        for name in ("density", "forces"):
            fn = getattr(lib, f"fst_sph_{name}_shape_{sfx}")
            fn.argtypes = [ctypes.c_int, ctypes.POINTER(BlockShape)]
            fn.restype = None
        fn = getattr(lib, f"fst_sph_bin_shape_{sfx}")
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(BinLaunch)]
        fn.restype = ctypes.c_int
    lib.fst_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fst_cuda_error_string.restype = ctypes.c_char_p
    return lib


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
    return Binned(cid=cid.to(i32), rank=rank.to(i32),
                  starts=starts.to(i32), order=order.to(i32),
                  fields=torch.cat([pos, vel], 1)[order])


@functools.lru_cache(maxsize=None)
def bin_launch(n: int, M: int, dtype: torch.dtype, index: int) -> BinLaunch:
    """The bin's launch over n particles and M cells on device `index`, as
    the library's grid query computes it (asked once per shape)."""
    return tile_launch(load(), f"fst_sph_bin_shape_{_SUFFIX[dtype]}", n, M,
                       index, kind=BinLaunch)


def _bin_scratch(n: int, M: int, dtype: torch.dtype, shape: BinLaunch,
                 device: torch.device, stream: int) -> tuple:
    # One scratch a launch shape: a launch leaves its counts at 0 for the
    # next launch on the scratch, and the layout follows (n, M, grid)
    # (csrc/sph_bin.cu bin_layout).
    return tile_scratch(("sph_bin", n, M, dtype, shape.grid),
                        shape.scratch_ints, torch.int32, device, stream)


def _bin_shape(cfg, dtype: torch.dtype, device: torch.device) -> tuple:
    g = cfg.grid()
    M = g.Gx * g.Gy
    return M, bin_launch(cfg.n, M, dtype, device.index)


def bin_grid_syncs(cfg, dtype: torch.dtype, device: torch.device) -> int:
    """The grid syncs that the last bin of cfg's particles of `dtype` on
    the device's current stream made, as the kernel counted them."""
    M, shape = _bin_shape(cfg, dtype, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    return _grid_syncs(_bin_scratch(cfg.n, M, dtype, shape, device,
                                    stream)[1])


def binning(cfg, pos, vel) -> Binned:
    """Rank-in-cell binning: the kernel on CUDA tensors, the plain version
    on CPU tensors."""
    if on_cpu(pos):
        return binning_plain(cfg, pos, vel)
    n = cfg.n
    _check(cfg, pos=(pos, None, (n, 2)), vel=(vel, None, (n, 2)))
    dev = pos.device
    M, shape = _bin_shape(cfg, pos.dtype, dev)
    scratch, words = _bin_scratch(
        n, M, pos.dtype, shape, dev,
        torch.cuda.current_stream(dev).cuda_stream)
    i32 = {"dtype": torch.int32, "device": dev}
    out = Binned(cid=torch.empty(n, **i32), rank=torch.empty(n, **i32),
                 starts=torch.empty(M + 1, **i32),
                 order=torch.empty(n, **i32),
                 fields=torch.empty((n, 4), dtype=pos.dtype, device=dev))
    _launch("bin", pos.dtype, dev, pos.data_ptr(), vel.data_ptr(),
            ctypes.byref(_params(cfg)), out.cid.data_ptr(),
            out.starts.data_ptr(), out.order.data_ptr(), out.rank.data_ptr(),
            out.fields.data_ptr(), scratch.data_ptr(), words.data_ptr(),
            shape.grid, shape.sort_blocks)
    return out


# ------------------ plain pair passes over the cell ranges -------------------

# Pairs a chunk of the plain pair passes holds at most (its receivers keep
# all their pairs in one chunk): ~2 GB of temporaries at float64.
CHUNK_PAIRS = 1 << 24


def pair_chunks(cfg, b: Binned):
    """Every pair the pair kernels walk, as (receiver, neighbour) sorted
    positions: for each sorted position, every member of the 3x3 cells
    around its cell (itself included), receiver by receiver, in chunks of
    whole receivers with at most CHUNK_PAIRS pairs (or one receiver).
    Yields int64 (recv, nbr) tensors."""
    g = cfg.grid()
    dev = b.fields.device
    starts = b.starts.long()
    sc = b.cid.long()[b.order.long()]
    off = torch.tensor(cd.NEIGHBOR_OFFSETS_2D, device=dev)
    ngx = (sc % g.Gx)[:, None] + off[:, 0]
    ngy = (sc // g.Gx)[:, None] + off[:, 1]
    inside = (ngx >= 0) & (ngx < g.Gx) & (ngy >= 0) & (ngy < g.Gy)
    nc = ngy.clamp(0, g.Gy - 1) * g.Gx + ngx.clamp(0, g.Gx - 1)
    beg = starts[nc]                                          # (n, 9)
    cnt = torch.where(inside, starts[nc + 1] - beg, 0)
    per_recv = cnt.sum(1)
    ends = torch.cumsum(per_recv, 0)
    lo = 0
    while lo < cfg.n:
        done = int(ends[lo - 1]) if lo else 0
        hi = int(torch.searchsorted(ends, done + CHUNK_PAIRS, right=True))
        hi = min(max(hi, lo + 1), cfg.n)
        c = cnt[lo:hi].reshape(-1)
        total = int(ends[hi - 1]) - done
        first = torch.cumsum(c, 0) - c
        recv = torch.arange(lo, hi, device=dev).repeat_interleave(
            per_recv[lo:hi])
        nbr = (beg[lo:hi].reshape(-1) - first).repeat_interleave(
            c, output_size=total) + torch.arange(total, device=dev)
        yield recv, nbr
        lo = hi


def pair_density(cfg, f, recv, nbr):
    """The density kernel's pair term, term by term, of each (receiver,
    neighbour) pair of sorted positions: W(r) without the mass (the self
    pair included).  f: the sorted (x, y, vx, vy)."""
    p = _params(cfg)
    x, y = f[:, 0], f[:, 1]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    dx = x[recv] - x[nbr]
    dy = y[recv] - y[nbr]
    q = torch.sqrt(dx * dx + dy * dy) * p.inv_h
    q2 = q * q
    t = 2.0 - q
    return torch.where(q < 1.0, p.alpha * (1.0 - 1.5 * q2 + 0.75 * q2 * q),
                       torch.where(q < 2.0, p.alpha_q * t * t * t, zero))


def density_eos(cfg, rho):
    """(rho, p / rho^2) per sorted position, (n, 2), from each position's
    sum of W: the mass, the log-density round trip and the Tait EOS, as the
    density kernel's lane 0 forms them."""
    p = _params(cfg)
    rho = p.mass * rho
    rho = torch.exp(torch.log(torch.clamp(rho, min=1e-6)))
    ratio = rho * p.inv_rho0
    powed = ratio if p.gamma_is_one else torch.exp(p.gamma_eos * torch.log(ratio))
    press = torch.clamp(p.c0sq_rho0 * (powed - 1.0)
                        / torch.full((), p.gamma_eos, dtype=rho.dtype,
                                     device=rho.device), min=0.0)
    rs = torch.clamp(rho, min=1e-30)
    return torch.stack([rho, press / (rs * rs)], -1)


def density_plain(cfg, b: Binned):
    """Plain PyTorch version of the density kernel: (rho, p / rho^2) per
    sorted position, (n, 2)."""
    rho = torch.zeros_like(b.fields[:, 0])
    for recv, nbr in pair_chunks(cfg, b):
        rho.index_add_(0, recv, pair_density(cfg, b.fields, recv, nbr))
    return density_eos(cfg, rho)


def pair_forces(cfg, f, rp, recv, nbr):
    """The forces kernel's pair term, term by term, of each (receiver,
    neighbour) pair of sorted positions: (c dx, c dy), 0 where the pair is
    skipped (the receiver itself, r^2 >= (2h)^2, r^2 <= 1e-16).  f: the
    sorted (x, y, vx, vy); rp: the density kernel's (rho, p / rho^2)."""
    p = _params(cfg)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    rho = torch.clamp(rp[:, 0], min=1e-30)
    fi, fj = f[recv], f[nbr]
    dx = fi[:, 0] - fj[:, 0]
    dy = fi[:, 1] - fj[:, 1]
    r2 = dx * dx + dy * dy
    valid = (recv != nbr) & (r2 < p.four_h2) & (r2 > 1e-16)
    r2s = torch.clamp(r2, min=1e-30)
    inv_r = 1.0 / torch.sqrt(r2s)
    r = r2s * inv_r
    q = r * p.inv_h
    t = 2.0 - q
    dwdq = torch.where(q < 1.0, p.alpha * (-3.0 * q + 2.25 * q * q),
                       p.alpha * (-0.75 * (t * t)))
    scale = torch.where((r > 1e-8) & (r < p.two_h),
                        dwdq * p.inv_h * inv_r, zero)
    common = -p.mass * (rp[recv, 1] + rp[nbr, 1])
    if p.use_visc:
        dot = (fi[:, 2] - fj[:, 2]) * dx + (fi[:, 3] - fj[:, 3]) * dy
        rho_bar = 0.5 * (rho[recv] + rho[nbr])
        pi = torch.where(dot < 0.0,
                         p.visc_coef * dot / ((r2 + p.eps_h2) * rho_bar),
                         zero)
        common = common - p.mass * pi
    c = torch.where(valid, common * scale, zero)
    return c * dx, c * dy


def forces_plain(cfg, b: Binned, rp, dt):
    """Plain PyTorch version of the forces + integrate kernel: (pos, vel)
    in particle order."""
    p = _params(cfg)
    f = b.fields
    acc = torch.zeros((cfg.n, 2), dtype=f.dtype, device=f.device)
    for recv, nbr in pair_chunks(cfg, b):
        cx, cy = pair_forces(cfg, f, rp, recv, nbr)
        acc.index_add_(0, recv, torch.stack([cx, cy], -1))
    if p.use_grav:
        acc = acc - torch.tensor([0.0, p.gravity], dtype=acc.dtype,
                                 device=acc.device)
    pos_s, vel_s = sph_mod._integrate(cfg, f[:, :2], f[:, 2:], acc, dt)
    order = b.order.long()
    pos, vel = torch.empty_like(pos_s), torch.empty_like(vel_s)
    pos[order] = pos_s
    vel[order] = vel_s
    return pos, vel


# ------------------------------ pair kernels --------------------------------


def density(cfg, b: Binned) -> torch.Tensor:
    """(rho, p / rho^2) per sorted position: the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if on_cpu(b.fields):
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
    if on_cpu(b.fields):
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


def _block_shape(name: str, cfg) -> BlockShape:
    out = BlockShape()
    sfx = _SUFFIX[cfg.torch_dtype]
    getattr(load(), f"fst_sph_{name}_shape_{sfx}")(cfg.n, ctypes.byref(out))
    return out


@functools.lru_cache(maxsize=None)
def density_shape(cfg) -> BlockShape:
    """The density kernel's blocks for cfg's particle count and dtype, as
    the library launches them (csrc/sph_density.cu: the
    FST_SPH_DENSITY_* constants, the lanes a particle chosen from the
    count)."""
    return _block_shape("density", cfg)


@functools.lru_cache(maxsize=None)
def forces_shape(cfg) -> BlockShape:
    """The forces kernel's blocks for cfg's particle count and dtype, as
    the library launches them (csrc/sph_forces.cu: the FST_SPH_*
    constants, the lanes a particle chosen from the count)."""
    return _block_shape("forces", cfg)


def make_step_cuda(cfg):
    """Frame step (state, dtau=None) -> state on the three kernels: per
    substep bin -> density -> forces + integrate, every pair kept, then
    rain and the τ bookkeeping, as fluidsims_tpu/kernels/sph_pallas.py::make_step_pallas
    does.  No value is read back to the host."""
    if cfg.use_xsph:
        raise ValueError("the cuda SPH engine does not implement XSPH")

    def substep(pos, vel, dt_sub):
        b = binning(cfg, pos, vel)
        return forces(cfg, b, density(cfg, b), dt_sub)

    def step(st, dtau=None):
        return sph_mod._advance(cfg, st, dtau, substep)

    return step
