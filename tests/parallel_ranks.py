"""Rank-side functions of the sharded-runner tests (tests/
test_torch_parallel_*.py), which parallel/launch.spawn sends to the ranks
by reference.  This module imports torch, the port and the tile models of
tests/oracles, never JAX, so the ranks import no JAX."""

from __future__ import annotations

import sys
from dataclasses import replace

import torch

from fluidsims_tpu_torch.kernels import gray_scott_cuda as gk
from fluidsims_tpu_torch.kernels import lbm_cuda as lk
from fluidsims_tpu_torch.parallel import (launch, mesh, periodic_sharded,
                                          runners)
from fluidsims_tpu_torch.solvers import gray_scott as gs
from fluidsims_tpu_torch.solvers import lbm
from tests.oracles import gs_tiles, lbm_tiles

CPU = torch.device("cpu")
# solver -> (config class, state class, tile model of the K-step kernel,
# one-step kernel wrapper)
_KSTEP = {"gray_scott": (gs.GrayScottConfig, gs.GrayScottState,
                         gs_tiles.tiled_run, gk.gs_step),
          "lbm": (lbm.LBMConfig, lbm.LBMState, lbm_tiles.tiled_run,
                  lk.lbm_step)}


def kstep_model_run(name: str, fields: dict, state, k: int, n_steps: int):
    """The 'cuda' engine's composition of parallel/periodic_sharded.py on
    the CPU: `make_sharded_split_run` with the K-step kernel's tile model
    (its tile rule at the slab's width, its windows, its periodic wrap of
    the slab) on nx / world + 2k columns and the one-step kernel's wrapper
    (its plain version here) on nx / world + 2; the gathered state on
    rank 0."""
    cfg_cls, state_cls, model, one = _KSTEP[name]
    m = mesh.make_mesh_1d(device=CPU)
    cfg = cfg_cls(**fields)
    nxl = cfg.nx // m.size
    cb, c1 = replace(cfg, nx=nxl + 2 * k), replace(cfg, nx=nxl + 2)
    run = periodic_sharded.make_sharded_split_run(
        lambda ext: tuple(model(cb, state_cls(*ext), k)),
        lambda ext: tuple(one(c1, state_cls(*ext))), k, m, n_steps)
    local = periodic_sharded.shard_state(state, m)
    out = periodic_sharded.gather_state(state_cls(*run(tuple(local))), m)
    return launch.to_numpy(out) if m.rank == 0 else None


def family(cases: list, kcases: list = ()):
    """`runners.run_cases(cases)` on the CPU, then each `kstep_model_run`
    of `kcases` (tuples of its arguments)."""
    return (runners.run_cases(cases, CPU),
            [kstep_model_run(*kc) for kc in kcases])


def collectives(world: int):
    """The halo and ring semantics on this rank, as numpy for rank r's
    check: ppermute with a pair missing (zeros), the open halo exchange
    with and without fills, the periodic exchange, pmax, psum of a tuple,
    a 2-D mesh's exchanges along each axis, and gather of shard."""
    from fluidsims_tpu_torch.parallel import halo

    m = mesh.make_mesh_1d(device=CPU)
    r = m.rank
    f = torch.arange(3 * 4, dtype=torch.float64).reshape(3, 4) + 100 * r
    jax_modules = sorted(k for k in sys.modules
                         if k.split(".")[0] in ("jax", "jaxlib",
                                                "fluidsims_tpu"))
    b = (f.to(torch.int64) % 3 == 0)
    out = {
        "shift_right": mesh.ppermute(f, m, "x",
                                     [(i, i + 1) for i in range(world - 1)]),
        "bool_left": mesh.ppermute(b, m, "x",
                                   [(i + 1, i) for i in range(world - 1)]),
        "halo": halo.extend_with_halo_x(f, 2, m),
        "halo_fill": halo.extend_with_halo_x(
            f, 1, m, left_fill=torch.full((3, 1), -1.0, dtype=f.dtype),
            right_fill=torch.full((3, 1), -2.0, dtype=f.dtype)),
        "ring": periodic_sharded.exchange_periodic_x(f, 1, m),
        "pmax": mesh.pmax(torch.tensor(float(r), dtype=torch.float64), m),
        "psum": mesh.psum((f, 2 * f), m),
        "jax_modules": jax_modules,
        "gathered": mesh.gather(mesh.shard(
            torch.arange(2 * 4 * world).reshape(2, 4 * world), m, {"x": 1}),
            m, {"x": 1}),
    }
    if world == 4:
        from fluidsims_tpu_torch.parallel import hypersonic2d_sharded2d as sh2

        m2 = sh2.make_mesh_2d(2, 2, device=CPU)
        out["mesh2d"] = (m2.axis_index("y"), m2.axis_index("x"))
        out["y_down"] = mesh.ppermute(f, m2, "y", [(0, 1)])
        out["x_left"] = mesh.ppermute(f, m2, "x", [(1, 0)])
        g = torch.arange(4 * 6).reshape(4, 6)
        out["block"] = mesh.shard(g, m2, {"y": 0, "x": 1})
        out["unblock"] = mesh.gather(out["block"], m2, {"y": 0, "x": 1})
    return launch.to_numpy(out)


def failing(rank_to_fail: int):
    """Raises on one rank while the others wait in a collective."""
    m = mesh.make_mesh_1d(device=CPU)
    if m.rank == rank_to_fail:
        raise RuntimeError("this rank fails on purpose")
    return mesh.pmax(torch.zeros(()), m)


def spatial_ops(payloads, owners, grids, mig_caps: tuple, p_cap: int,
                W: int, H: int):
    """parallel/spatial_common.py on this rank, as numpy for the check
    against JAX's: migrate of rank r's payload rows and owners (the id in
    the last column, -1 for an empty row) with each migration capacity of
    `mig_caps`, and halo_fill (fill -7) and halo_reduce of its
    (..., W + 2H) grid."""
    from fluidsims_tpu_torch.parallel import spatial_common as sc

    m = mesh.make_mesh_1d(axis="x", device=CPU)
    p = torch.from_numpy(payloads[m.rank])
    fill = torch.tensor([2.0, 2.0, 0.0, -1.0], dtype=p.dtype)
    out = {}
    for cap in mig_caps:
        out[cap] = sc.migrate(
            p, torch.from_numpy(owners[m.rank]), p[:, -1] >= 0, mesh=m,
            axis="x", mig_cap=cap, p_cap=p_cap, fill_row=fill)
    halo_fill, halo_reduce = sc.make_halo_ops(m, "x", W, H)
    g = torch.from_numpy(grids[m.rank])
    return launch.to_numpy({"migrate": out, "fill": halo_fill(g, -7.0),
                            "reduce": halo_reduce(g)})


def spatial_family(cases: list, ops: tuple):
    """`runners.run_cases(cases)` on the CPU, then `spatial_ops(*ops)`."""
    return runners.run_cases(cases, CPU), spatial_ops(*ops)


def stam_solve(dim: int, x, b, a: float, c: float, iters: int, halo_k: int):
    """The sharded Jacobi solve of parallel/stam2d_sharded.py (dim 2: x and
    b (n, n), cut into x-slabs) or parallel/stam3d_sharded.py (dim 3: x and
    b (n+2)^3, padded along z and cut into z-slabs) on this rank; the
    gathered result on rank 0, as numpy."""
    from fluidsims_tpu_torch.parallel import stam2d_sharded as s2s
    from fluidsims_tpu_torch.parallel import stam3d_sharded as s3s

    m = mesh.make_mesh_1d(device=CPU)
    if dim == 2:
        xs, bs = (mesh.shard(t, m, {"x": 1}) for t in (x, b))
        got = mesh.gather(s2s._lin_solve_sharded(
            xs, bs, a, c, iters, halo_k, m, "x"), m, {"x": 1})
    else:
        Np = x.shape[0]
        zp = s3s.padded_z(Np - 2, m.size)

        def slab(t):
            return mesh.shard(torch.cat([t, t.new_zeros((zp - Np, Np, Np))]),
                              m, {"x": 0})

        B = zp // m.size
        got = mesh.gather(s3s._lin_solve_sharded(
            slab(x), slab(b), a, c, iters, halo_k, Np, m.rank * B, m, "x"),
            m, {"x": 0})[:Np]
    return got.numpy() if m.rank == 0 else None


def stam_family(cases: list, solves: list):
    """`runners.run_cases(cases)` on the CPU, then each `stam_solve` of
    `solves` (tuples of its arguments)."""
    return (runners.run_cases(cases, CPU),
            [stam_solve(*args) for args in solves])
