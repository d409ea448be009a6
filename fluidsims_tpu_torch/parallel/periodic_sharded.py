"""x-slab sharding for periodic grid solvers (port of
fluidsims_tpu.parallel.periodic_sharded), with the Gray–Scott and D2Q9
LBM runners on their CUDA kernels.

Every periodic solver shares one pattern: exchange `halo` columns around
the ring of ranks (the ring is the periodic wrap), run the one-device
update on the extended slab, crop.  A slab edge's corruption creeps one
cell a step (stencil radius 1), so `halo = K` with a `local_step` of K
steps pays one exchange per K steps: after K steps the corrupted region
is exactly the K ghost columns that are cropped.

`make_sharded_gray_scott_run` / `make_sharded_lbm_run` resolve the engine
as the one-device `run` does: on a CUDA device ('cuda') `n // block_k`
supersteps, each one launch of the K-step kernel (#4, #6) on a slab of
nx / world + 2 block_k columns, then `n % block_k` steps of the one-step
kernel (#3, #5) on nx / world + 2 columns; on the CPU ('torch') one plain
step a superstep with halo 1.  A kernel wraps its own slab periodically
in x, which corrupts only the ghost columns, and in y, which is the
domain's own wrap (Gray–Scott) or wall (LBM: rows outside [0, ny) are out
of bounds in the port where JAX wraps them; the slabs are cut in x, so
the two agree).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable

import torch

from ..core.stepper import run_steps
from ..kernels import gray_scott_cuda as gk
from ..kernels import lbm_cuda as lk
from ..solvers import gray_scott as gs
from ..solvers import lbm
from .mesh import Mesh, gather, ppermute, shard

__all__ = ["exchange_periodic_x", "shard_arrays", "gather_arrays",
           "make_sharded_periodic_run", "make_sharded_split_run",
           "make_sharded_gray_scott_run", "make_sharded_lbm_run",
           "shard_state", "gather_state"]


def exchange_periodic_x(f: torch.Tensor, halo: int, mesh: Mesh,
                        axis: str = "x") -> torch.Tensor:
    """`f` with `halo` columns from each ring neighbour along x (fully
    periodic: rank 0's left neighbour is the last rank)."""
    n = mesh.axis_size(axis)
    left = ppermute(f[..., -halo:], mesh, axis,
                    [(i, (i + 1) % n) for i in range(n)])
    right = ppermute(f[..., :halo], mesh, axis,
                     [(i, (i - 1) % n) for i in range(n)])
    return torch.cat([left, f, right], dim=-1)


def shard_arrays(arrays: tuple, mesh: Mesh, axis: str = "x") -> tuple:
    """This rank's x-slab (last axis) of each global array."""
    return tuple(shard(a, mesh, {axis: a.ndim - 1}) for a in arrays)


def gather_arrays(arrays: tuple, mesh: Mesh, axis: str = "x") -> tuple:
    """The global arrays, on every rank, from each rank's slabs."""
    return tuple(gather(a, mesh, {axis: a.ndim - 1}) for a in arrays)


def shard_state(state, mesh: Mesh, axis: str = "x"):
    """A Gray–Scott or LBM state's x-slab, as its own state class."""
    return type(state)(*shard_arrays(tuple(state), mesh, axis))


def gather_state(state, mesh: Mesh, axis: str = "x"):
    """The global Gray–Scott or LBM state from each rank's slab."""
    return type(state)(*gather_arrays(tuple(state), mesh, axis))


def make_sharded_periodic_run(local_step: Callable[[tuple], tuple],
                              mesh: Mesh, halo: int, n_steps: int,
                              axis: str = "x"):
    """run(arrays) -> arrays: `n_steps` times, extend each array by `halo`
    ring-exchanged columns, apply `local_step(extended) -> extended` (the
    periodic one-device update of the extended slab, whose own wrap only
    corrupts the ghost columns) and crop.  All arrays have x last and one
    local width, at least `halo`."""

    def run(arrays: tuple) -> tuple:
        if n_steps and arrays[0].shape[-1] < halo:
            raise ValueError(f"local slab {arrays[0].shape[-1]} thinner than "
                             f"the halo {halo}")

        def one(arrays: tuple) -> tuple:
            ext = tuple(exchange_periodic_x(f, halo, mesh, axis)
                        for f in arrays)
            return tuple(f[..., halo:-halo].contiguous()
                         for f in local_step(ext))

        return run_steps(one, arrays, n_steps)

    return run


def make_sharded_split_run(block_step, one_step, k: int, mesh: Mesh,
                           n_steps: int, axis: str = "x"):
    """The sharded counterpart of core.stepper.run_split: `n_steps // k`
    supersteps of `block_step` (k steps, halo k) and then `n_steps % k` of
    `one_step` (halo 1); with k = 1, `one_step` every step."""
    n_blocks, rem = divmod(n_steps, k) if k > 1 else (0, n_steps)
    blocks = make_sharded_periodic_run(block_step, mesh, k, n_blocks, axis)
    ones = make_sharded_periodic_run(one_step, mesh, 1, rem, axis)
    return lambda arrays: ones(blocks(arrays))


def _local_width(nx: int, mesh: Mesh, axis: str, halo: int) -> int:
    n_dev = mesh.axis_size(axis)
    if nx % n_dev:
        raise ValueError(f"nx={nx} not divisible by {n_dev} devices")
    if nx // n_dev < halo:
        raise ValueError(f"local slab {nx // n_dev} thinner than the halo "
                         f"{halo}")
    return nx // n_dev


def _solver_run(cfg, mesh, n_steps, axis, engine, state_cls, multistep,
                step, plain):
    """The split run of one solver: the K-step and one-step kernels'
    wrappers `multistep` and `step` for the 'cuda' engine, `plain` steps
    otherwise."""
    k = cfg.block_k if engine == "cuda" else 1
    nxl = _local_width(cfg.nx, mesh, axis, k)
    cb, c1 = replace(cfg, nx=nxl + 2 * k), replace(cfg, nx=nxl + 2)
    if engine == "cuda":
        def block(ext):
            return tuple(multistep(cb, state_cls(*ext), k))

        def one(ext):
            return tuple(step(c1, state_cls(*ext)))
    else:
        block = None

        def one(ext):
            return tuple(plain(c1, state_cls(*ext)))
    run = make_sharded_split_run(block, one, k, mesh, n_steps, axis)
    return lambda s: state_cls(*run(tuple(s)))


def make_sharded_gray_scott_run(cfg: gs.GrayScottConfig, mesh: Mesh,
                                n_steps: int, axis: str = "x"):
    """run(local_state) -> local_state: `n_steps` Gray–Scott steps of this
    rank's slab on the engine `gs.resolve_engine` picks for the mesh's
    device."""
    return _solver_run(cfg, mesh, n_steps, axis,
                       gs.resolve_engine(cfg, mesh.device),
                       gs.GrayScottState, gk.gs_multistep, gk.gs_step,
                       gs.step)


def make_sharded_lbm_run(cfg: lbm.LBMConfig, mesh: Mesh, n_steps: int,
                         axis: str = "x"):
    """run(local_state) -> local_state: `n_steps` LBM steps of this rank's
    slab (the solid map exchanged with the packets) on the engine
    `lbm.resolve_engine` picks for the mesh's device."""
    return _solver_run(cfg, mesh, n_steps, axis,
                       lbm.resolve_engine(cfg, mesh.device), lbm.LBMState,
                       lk.lbm_multistep, lk.lbm_step, lbm.step)
