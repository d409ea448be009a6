"""Multi-device τ-clock periodic solvers: Burgers and shallow-water x-slabs
(port of fluidsims_tpu.parallel.tau_sharded).

Both are periodic shift-stencil updates with one global CFL reduction and
a replicated scalar clock, so they share one pattern: cut the (ny, nx)
fields along x, ring-exchange `halo` columns each step, run the
one-device step on the extended slab (its own wrap only corrupts the
ghost columns, which are cropped) with `wavespeed_reduce` an all-reduce
MAX over the mesh, so every rank advances with the same dt and the
sharded trajectory is bitwise the one-device plain one.

Halo widths (the reach of one step):
  * Burgers: faces reach 1 (2 with MUSCL slopes), plus 1 per viscosity
    substep chained through the update.
  * Shallow water: faces reach 1, plus 2 when viscosity is on (the
    Laplacian reads the updated velocity).

The steps are the plain ones, on whatever device the mesh has.  The
one-device CUDA engine of these solvers is a cooperative K-step kernel
(#7) that forms dt inside the launch from a grid-wide max, so it cannot
wait for a max over ranks; JAX's sharded runner likewise steps in XLA, not
with its resident Pallas kernel.
"""

from __future__ import annotations

from ..core.stepper import run_steps
from ..solvers import burgers as bg
from ..solvers import shallow_water as sw
from .mesh import Mesh, gather, pmax, shard
from .periodic_sharded import exchange_periodic_x

__all__ = ["burgers_halo", "shallow_water_halo", "shard_burgers",
           "shard_shallow_water", "gather_burgers", "gather_shallow_water",
           "make_sharded_burgers_run", "make_sharded_shallow_water_run"]


def burgers_halo(cfg: bg.BurgersConfig) -> int:
    return (2 if cfg.muscl else 1) + cfg.visc_substeps


def shallow_water_halo(cfg: sw.ShallowWaterConfig) -> int:
    return 1 + (2 if cfg.nu > 0.0 else 0)


def _shard(state, n_fields: int, mesh: Mesh, axis: str):
    return type(state)(*(
        shard(f, mesh, {axis: 1}) if i < n_fields else f.to(mesh.device)
        for i, f in enumerate(state)))


def _gather(state, n_fields: int, mesh: Mesh, axis: str):
    return type(state)(*(
        gather(f, mesh, {axis: 1}) if i < n_fields else f
        for i, f in enumerate(state)))


def shard_burgers(state: bg.BurgersState, mesh: Mesh, axis: str = "x"):
    """This rank's x-slab of (phi_u, phi_v); t and tau replicated."""
    return _shard(state, 2, mesh, axis)


def shard_shallow_water(state: sw.ShallowWaterState, mesh: Mesh,
                        axis: str = "x"):
    """This rank's x-slab of (sigma, u, v); t and tau replicated."""
    return _shard(state, 3, mesh, axis)


def gather_burgers(state: bg.BurgersState, mesh: Mesh, axis: str = "x"):
    return _gather(state, 2, mesh, axis)


def gather_shallow_water(state: sw.ShallowWaterState, mesh: Mesh,
                         axis: str = "x"):
    return _gather(state, 3, mesh, axis)


def _make_run(step_fn, state_cls, n_fields: int, halo: int, mesh: Mesh,
              nx: int, n_steps: int, axis: str):
    n_dev = mesh.axis_size(axis)
    if nx % n_dev:
        raise ValueError(f"nx={nx} not divisible by {n_dev} devices")
    if nx // n_dev < halo:
        raise ValueError(f"local slab {nx // n_dev} thinner than halo {halo}")

    def reduce(v):
        return pmax(v, mesh)

    def one(state):
        ext = tuple(exchange_periodic_x(f, halo, mesh, axis)
                    for f in state[:n_fields])
        out = step_fn(state_cls(*ext, *state[n_fields:]),
                      wavespeed_reduce=reduce)
        return state_cls(*(f[..., halo:-halo].contiguous()
                           for f in out[:n_fields]), *out[n_fields:])

    return lambda state: run_steps(one, state, n_steps)


def make_sharded_burgers_run(cfg: bg.BurgersConfig, mesh: Mesh,
                             n_steps: int, axis: str = "x"):
    """run(local_state) -> local_state: `n_steps` plain Burgers steps of
    this rank's slab.  Every rank calls it."""
    return _make_run(lambda s, **kw: bg.step(cfg, s, **kw), bg.BurgersState,
                     2, burgers_halo(cfg), mesh, cfg.nx, n_steps, axis)


def make_sharded_shallow_water_run(cfg: sw.ShallowWaterConfig, mesh: Mesh,
                                   n_steps: int, axis: str = "x"):
    """run(local_state) -> local_state: `n_steps` plain shallow-water steps
    of this rank's slab.  Every rank calls it."""
    return _make_run(lambda s, **kw: sw.step(cfg, s, **kw),
                     sw.ShallowWaterState, 3, shallow_water_halo(cfg), mesh,
                     cfg.nx, n_steps, axis)
