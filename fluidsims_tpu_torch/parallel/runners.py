"""The sharded runners by name, and one function that runs a list of them
on a rank: what the tests and chip_smoke.py hand to `launch.spawn`.

Each runner module has the shape of its JAX twin: `shard_state(state,
mesh)`, `make_sharded_run(cfg, mesh, n_steps)` and `gather_state(local,
mesh)`; the spatial ones (owner buffers of particles, migration)
`shard_state(state, cfg, mesh, axis)`, `make_sharded_run(cfg, mesh,
n_steps, axis)` and `gather_state(local, n, mesh)`, by particle id.
`RUNNERS` names them with the solver module, the mesh they take and the
one-device run they are held to.  The τ-clock and MHD runners step
plainly (see tau_sharded.py), so their one-device run is the plain
'torch' engine's; so is stam3d's, at the same `advect_k`: its runner
composes the dense-shift advection, set_bnd and the projection in torch
ops, as JAX's does, and runs only its Jacobi sweeps on #11 (the 'cuda'
engine's #12 gathers exactly, with no cap).  The SPH runners' one-device
run is the 'cuda' engine's (their kernels, or those kernels' plain
versions on the CPU), the spatial FLIP and MPM runners' the 'dense'
engine's (the engine they split); every other one, stam2d's (#9 and #10)
included, is the solver's `run` on the engine it picks for the device.
A case may give a runner's options (stam2d's `halo_k` and
`advect_halo`, stam3d's `halo_k`).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from types import ModuleType
from typing import Callable

import torch

from ..core.stepper import sync
from ..kernels import (burgers_cuda, flip_cuda, gray_scott_cuda,
                       hypersonic2d_cuda, hypersonic3d_cuda, lbm_cuda,
                       mhd_cuda, mpm_cuda, nbody_cuda, shallow_water_cuda,
                       sph_cuda, stam2d_cuda, stam3d_cuda)
from ..solvers import (burgers, flip_apic, gray_scott, hypersonic2d,
                       hypersonic3d, lbm, mhd, mpm, nbody_graph,
                       shallow_water, sph, stam2d, stam3d)
from . import flip_sharded as fsh
from . import flip_spatial as fsp
from . import hypersonic2d_sharded as h2s
from . import hypersonic2d_sharded2d as h2s2
from . import hypersonic3d_sharded as h3s
from . import mhd_sharded as msh
from . import mpm_sharded as mpsh
from . import mpm_spatial as mpsp
from . import nbody_sharded as nsh
from . import periodic_sharded as psh
from . import sph_sharded as ssh
from . import sph_spatial as ssp
from . import stam2d_sharded as s2s
from . import stam3d_sharded as s3s
from . import tau_sharded as tsh
from .launch import to_numpy, tree_map
from .mesh import make_mesh_1d, psum

__all__ = ["RUNNERS", "Runner", "make_mesh", "run_sharded", "run_dense",
           "max_rel_err", "max_abs_errs", "run_cases", "KERNEL_MODULES",
           "reset_launches", "launches"]

# Every kernel wrapper module of the port, whose LAUNCHES a case reports.
KERNEL_MODULES = {m.__name__.rsplit(".", 1)[1]: m for m in (
    hypersonic2d_cuda, hypersonic3d_cuda, gray_scott_cuda, lbm_cuda,
    burgers_cuda, shallow_water_cuda, mhd_cuda, stam3d_cuda, stam2d_cuda,
    flip_cuda, mpm_cuda, nbody_cuda, sph_cuda)}


def reset_launches() -> None:
    for mod in KERNEL_MODULES.values():
        mod.reset_launches()


def launches() -> dict:
    """{kernel module: {kernel: launches since the last reset}}."""
    return {m: dict(mod.LAUNCHES) for m, mod in KERNEL_MODULES.items()}


@dataclass(frozen=True)
class Runner:
    solver: ModuleType          # the solver: its `init` and `run`
    config: type
    axis: str | None            # the 1-D mesh's axis; None: the (y, x) mesh
    shard: Callable
    make_run: Callable
    gather: Callable
    dense_engine: str | None = None  # the one-device run's engine, if fixed
    particles: bool = False          # interleaved particle order
    held: tuple | None = None        # leaves max_rel_err reads; None: all
    spatial: bool = False            # owner buffers, gathered by id


RUNNERS = {
    "hypersonic2d": Runner(
        hypersonic2d, hypersonic2d.Hypersonic2DConfig, "x",
        h2s.shard_state, h2s.make_sharded_run, h2s.gather_state),
    "hypersonic2d_mesh2d": Runner(
        hypersonic2d, hypersonic2d.Hypersonic2DConfig, None,
        h2s2.shard_state, h2s2.make_sharded_run, h2s2.gather_state),
    "hypersonic3d": Runner(
        hypersonic3d, hypersonic3d.Hypersonic3DConfig, "z",
        h3s.shard_state, h3s.make_sharded_run, h3s.gather_state),
    "gray_scott": Runner(
        gray_scott, gray_scott.GrayScottConfig, "x", psh.shard_state,
        psh.make_sharded_gray_scott_run, psh.gather_state),
    "lbm": Runner(lbm, lbm.LBMConfig, "x", psh.shard_state,
                  psh.make_sharded_lbm_run, psh.gather_state),
    "burgers": Runner(
        burgers, burgers.BurgersConfig, "x", tsh.shard_burgers,
        tsh.make_sharded_burgers_run, tsh.gather_burgers,
        dense_engine="torch"),
    "shallow_water": Runner(
        shallow_water, shallow_water.ShallowWaterConfig, "x",
        tsh.shard_shallow_water, tsh.make_sharded_shallow_water_run,
        tsh.gather_shallow_water, dense_engine="torch"),
    "mhd": Runner(mhd, mhd.MHDConfig, "x", msh.shard_state,
                  msh.make_sharded_run, msh.gather_state,
                  dense_engine="torch"),
    "flip": Runner(flip_apic, flip_apic.FlipApicConfig, "p",
                   fsh.shard_state, fsh.make_sharded_run, fsh.gather_state,
                   particles=True),
    "mpm": Runner(mpm, mpm.MPMConfig, "p", mpsh.shard_state,
                  mpsh.make_sharded_run, mpsh.gather_state, particles=True),
    "nbody": Runner(nbody_graph, nbody_graph.GraphLayoutConfig, "b",
                    nsh.shard_state, nsh.make_sharded_run, nsh.gather_state,
                    held=(0,)),  # the positions, as JAX's test holds them
    "sph": Runner(sph, sph.SPHConfig, "c", ssh.shard_state,
                  ssh.make_sharded_run, ssh.gather_state,
                  dense_engine="cuda"),
    "sph_spatial": Runner(sph, sph.SPHConfig, "c", ssp.shard_state,
                          ssp.make_sharded_run, ssp.gather_state,
                          dense_engine="cuda", spatial=True),
    "flip_spatial": Runner(flip_apic, flip_apic.FlipApicConfig, "x",
                           fsp.shard_state, fsp.make_sharded_run,
                           fsp.gather_state, dense_engine="dense",
                           spatial=True),
    "mpm_spatial": Runner(mpm, mpm.MPMConfig, "x", mpsp.shard_state,
                          mpsp.make_sharded_run, mpsp.gather_state,
                          dense_engine="dense", spatial=True),
    "stam2d": Runner(stam2d, stam2d.Stam2DConfig, "x", s2s.shard_state,
                     s2s.make_sharded_run, s2s.gather_state),
    # JAX's axis name; the slabs are cut along z
    "stam3d": Runner(stam3d, stam3d.Stam3DConfig, "x", s3s.shard_state,
                     s3s.make_sharded_run, s3s.gather_state,
                     dense_engine="torch"),
}


def make_mesh(name: str, device=None, mesh2d: tuple | None = None):
    """The mesh runner `name` takes over the initialised process group:
    1-D on its axis, or (y, x) = `mesh2d` for the 2-D mesh."""
    r = RUNNERS[name]
    if r.axis is not None:
        return make_mesh_1d(axis=r.axis, device=device)
    py, px = mesh2d
    return h2s2.make_mesh_2d(px, py, device=device)


def run_sharded(name: str, cfg, state, n_steps: int, mesh, **options):
    """`n_steps` sharded steps of a global `state` (the same on every
    rank): shard, run, gather; `options` go to the runner's
    `make_sharded_run`.  Returns the global result on every rank
    (particles in interleaved order, or in particle order for the spatial
    runners)."""
    return _run(name, cfg, state, n_steps, mesh, options)[0]


def _run(name: str, cfg, state, n_steps: int, mesh, options: dict):
    """(run_sharded's result, what the run reports: a spatial run the
    particles lost to capacity and those that changed rank (summed over
    the ranks); the SPH runs [halo receivers, all receivers] of the rank's
    pair kernels)."""
    r = RUNNERS[name]
    info = {}
    if not r.spatial:
        run = r.make_run(cfg, mesh, n_steps, **options)
        got = r.gather(run(r.shard(state, mesh)), mesh)
    else:
        local = r.shard(state, cfg, mesh, r.axis)
        run = r.make_run(cfg, mesh, n_steps, r.axis)
        out = run(local)
        ids0, ids1 = local.ids[local.ids >= 0], out.ids[out.ids >= 0]
        moved = psum(torch.isin(ids1, ids0, invert=True).sum().reshape(1),
                     mesh)
        info = {"lost": int(out.lost), "moved": int(moved[0])}
        got = r.gather(out, _leaves(state)[0].shape[0], mesh)
    if hasattr(run, "stats"):
        info["receivers"] = [run.stats["halo"], run.stats["receivers"]]
    return got, info


def run_dense(name: str, cfg, state, n_steps: int):
    """The one-device run that runner `name` is held to."""
    r = RUNNERS[name]
    if r.dense_engine is not None:
        cfg = dataclasses.replace(cfg, engine=r.dense_engine)
    return r.solver.run(cfg, state, n_steps)


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _paired(name: str, got, ref, world: int) -> list:
    """The (sharded, one-device) pairs of leaves, the latter put in
    interleaved order for the particle runners, both on its device."""
    perm = None
    if RUNNERS[name].particles:
        perm = torch.from_numpy(fsh.interleave_perm(
            _leaves(ref)[0].shape[0], world))
    out = []
    for g, f in zip(_leaves(got), _leaves(ref)):
        if perm is not None and f.ndim >= 1 and f.shape[0] == perm.numel():
            f = f[perm.to(f.device)]
        out.append((g.to(f.device), f))
    return out


def max_rel_err(name: str, got, ref, world: int) -> tuple[float, bool]:
    """(largest over the float leaves of max|got - ref| / max|ref|, every
    leaf bitwise equal) of a sharded result against the one-device one,
    the latter put in interleaved order for the particle runners.  The
    error reads the runner's `held` leaves only (n-body: the positions,
    relative to the layout's extent)."""
    held = RUNNERS[name].held
    worst, same = 0.0, True
    for i, (g, f) in enumerate(_paired(name, got, ref, world)):
        same = same and bool(torch.equal(g, f))
        if f.is_floating_point() and (held is None or i in held):
            scale = float(f.abs().max()) if f.numel() else 0.0
            err = float((g - f).abs().max()) if f.numel() else 0.0
            worst = max(worst, err / scale if scale > 0 else err)
    return worst, same


def max_abs_errs(name: str, got, ref, world: int) -> list:
    """max |got - ref| of each float leaf and sum |got - ref| of each
    other (FLIP's raster: the particles counted in another cell, twice;
    a bool mask as 0 and 1), as max_rel_err pairs them."""
    out = []
    for g, f in _paired(name, got, ref, world):
        if not f.numel():
            out.append(None)
        elif f.is_floating_point():
            out.append(float((g - f).abs().max()))
        else:
            out.append(float((g.long() - f.long()).abs().sum()))
    return out


def run_cases(cases: list, device=None) -> list:
    """Run each case on this rank (every rank of the process group calls
    it with the same cases).  A case is a dict: `name` (a key of RUNNERS),
    `config` (the config's fields), `steps`, optionally `state` (a global
    state of tensors; default: the solver's `init` on the mesh's device),
    `mesh2d` ((py, px) for the 2-D mesh), `options` (the runner's
    options), `dense` (also run the one-device run on rank 0 and compare)
    and `keep` (rank 0 returns the gathered state).
    Returns, per case, the seconds of the sharded run (host clock, the
    device synchronised), the kernels' launches in it, what a spatial run
    reports (`_run`) and, on rank 0, what `dense` (with the one-device
    run's seconds) and `keep` ask for."""
    out = []
    for case in cases:
        name = case["name"]
        r = RUNNERS[name]
        mesh = make_mesh(name, device, case.get("mesh2d"))
        cfg = r.config(**case["config"])
        state = case.get("state")
        if state is None:
            state = r.solver.init(cfg, mesh.device)
        else:
            state = tree_map(lambda t: t.to(mesh.device), state)
        sync(mesh.device)
        reset_launches()
        t0 = time.perf_counter()
        got, info = _run(name, cfg, state, case["steps"], mesh,
                         case.get("options", {}))
        sync(mesh.device)
        res = {"name": name, "world": mesh.size, "backend": mesh.backend,
               "steps": case["steps"], "seconds": time.perf_counter() - t0,
               "launches": {m: c for m, c in launches().items()
                            if any(c.values())}, **info}
        if mesh.rank == 0:
            if case.get("dense"):
                t0 = time.perf_counter()
                ref = run_dense(name, cfg, state, case["steps"])
                sync(mesh.device)
                res["dense_seconds"] = time.perf_counter() - t0
                res["max_rel_err"], res["bitwise"] = max_rel_err(
                    name, got, ref, mesh.size)
                res["max_abs_err"] = max_abs_errs(name, got, ref, mesh.size)
            if case.get("keep"):
                res["state"] = to_numpy(got)
        out.append(res)
        del got, state
    return out
