#!/usr/bin/env python
"""Check and time the tiled kernels of the port on a GPU, and sweep their
tiles.

    python tools/tune_tiles_torch.py [check] [time] [sweep] [phases]
        [sass] [diff A B]
        [--root DIR] [--out PATH] [--define NAME=VALUE ...] [--only KEY ...]
        [--fmad] [--dump DIR] [--inputs DIR]
        [--set tiles|hypersonic|mhd|sph|flip|lbm|p2g|gs|g2p|set_bnd|bin|
               mpm|nbody|ws3]

The kernels: the Burgers and shallow-water K-step kernels
(csrc/burgers_multistep.cu, csrc/shallow_water_multistep.cu, TPU kernel
#7), the stam2d whole Jacobi solve (csrc/stam2d_lin_solve.cu, #9), the
two hypersonic step kernels (csrc/hypersonic2d_step.cu, #1;
csrc/hypersonic3d_step.cu, #2), the GLM-MHD K-step kernel
(csrc/mhd_multistep.cu, #8), the SPH density and forces kernels
(csrc/sph_density.cu, #14; csrc/sph_forces.cu, #15), the FLIP grid phase
(csrc/flip_grid.cu, #17), the LBM K-step kernel (csrc/lbm_multistep.cu,
#6), the MPM and FLIP P2Gs (csrc/mpm_p2g.cu, #19; csrc/flip_p2g.cu, #16;
both csrc/p2g_tiles.cuh), the Gray–Scott K-step kernel
(csrc/gray_scott_multistep.cu, #4), the FLIP G2P (csrc/flip_g2p.cu, #18),
the stam3d set_bnd (csrc/stam3d_set_bnd.cu, #13), the SPH bin
(csrc/sph_bin.cu, #22), the stam2d advection (csrc/stam2d_advect.cu,
#10), the MPM G2P with its grid update (csrc/mpm_g2p.cu, #20 and
#21), and two kernels that stand in for no Pallas kernel: the n-body
exact repulsion (csrc/nbody_repulsion.cu) and the 3-D masked max
wavespeed (csrc/hypersonic3d_wavespeed.cu).

* check — each kernel against its plain version on the card: Burgers and
  shallow water on 200x75 and 5x3 (every option), k = 1 within 1e-5
  (f32) / 1e-12 (f64) relative and k = 8 bitwise equal to 8 launches of
  k = 1; the solve bitwise equal at n = 1, 37 and 512 and 1, h, h + 1 and
  40 sweeps (h: sweeps a grid sync); the hypersonic steps within 1e-5
  (f32) / 1e-12 (f64) relative of their plain versions on small and
  ragged grids from init plus seeded noise, bitwise cases counted; the
  MHD kernel on 200x75, 37x23 and 256x128 (both problems, both flux
  signs, f32 and f64) at k = 1 within 1e-5 / 1e-12 relative, k = 8
  bitwise equal to 8 launches of k = 1, with K + 1 grid syncs as the
  kernel counts them (trees whose wrapper reports them); the SPH density
  and forces kernels within 1e-5 / 1e-12 relative on 4096 particles and
  on two crowded pools (one cell's neighbourhood larger than a staged
  chunk of the forces kernel, and of the density kernel where the tree
  reports its chunk), two launches of each bitwise equal; the FLIP grid
  phase bitwise equal to its plain
  version at n = 16, 37, 128 and 512 and 0, 1, 7, h, h + 1 and 48 sweeps
  (h: sweeps a grid sync), with max(ceil(sweeps / h), 1) - 1 grid syncs
  as the kernel counts them (trees whose wrapper reports them); the LBM
  K-step kernel bitwise equal to K plain steps and to K launches of the
  one-step kernel at K = 1, 3, 8 and 16 on 37x23 (an obstacle on a tile
  corner), 200x75 without the top wall and 20x17 (narrower than the
  window), with and without a drive override; the Gray–Scott K-step
  kernel bitwise equal to K plain steps and to K one-step launches at
  K = 1, 3, 16 and 32 on 37x23, 200x75, 256x128 and 20x17 (narrower than
  the window), f32 and f64, with and without feed=0.04, kill=0.058; the
  FLIP G2P bitwise equal to its plain version, the raster counting every
  particle, and set_bnd bitwise equal, on chip_smoke.py's phase-19 and
  phase-15 cases (G2P_CHECK, SET_BND_CHECK_N; this tree's chip_smoke.py);
  the SPH bin bitwise equal to its plain version in all five outputs on
  chip_smoke.py's phase-6 cases (BIN_CHECK: 4,096 particles in one cell, a
  cell of 3,000 at 2^16, 2^20 on 256^2 with empty cells), the stam2d
  advection of one field and of the velocity pair bitwise equal at n = 1,
  2, 3, 37, 200 and 512, f32 and f64 (ADVECT_CHECK_N), and the MPM kernels
  by chip_smoke.py's phase 21 (the G2P with its grid update bitwise equal
  to its plain version on every case; trees whose G2P reads the P2G
  grids); the n-body repulsion by chip_smoke.py's phase 23 (its cases
  and the launch tails, within 1e-5 / 1e-12 per body, and 5 steps
  against the plain hook); the 3-D wavespeed by phase 8's wavespeed
  cases (ragged cell counts, views at odd offsets, 64^3 and 256^3 f32 and
  f64 back to back, all bitwise).  Raises on the first failure.
* time — ms a launch by CUDA events (a warm-up, then the mean over a run
  of launches back to back) at the shapes chip_smoke.py's main runs use:
  Burgers 512^2 f32 K=16 and K=1, 4096^2 f32 K=16, 512^2 f64 K=16;
  shallow water the same at K=8; the solve at 512^2, 40 sweeps, f32 and
  f64; the hypersonic steps on the final state of chip_smoke.py's main
  runs (2048^2 f32 after 200 steps, 8192x1024 f64 after 50, 64^3 f32
  after 400, 256^3 f32 after 20), also as torch.profiler's device time a
  launch, with a sha256 of the run's final state and of the step's
  output, so that two trees' kernels can be held to each other bit for
  bit (--only: these keys alone); the MHD kernel the same way on the
  final state of chip_smoke.py's MHD runs (320x220 Brio–Wu f32 x 4000 at
  K=8 and K=1, 2048^2 Orszag–Tang f32 x 200 at K=8, 320x220 f64 x 1000 at
  K=8); the SPH density and forces kernels on the final state of its runs
  (65,536 f32 x 200, 2^20 f32 with rain x 50), each also as device time;
  the Gray–Scott K-step kernel at K=16 and the one-step kernel (the K=1
  keys) on the final state of chip_smoke.py's Gray–Scott runs (2048^2
  f32 x 2000, f64 x 400), also as device time; the FLIP grid phase on
  the P2G grids
  of the final state of its runs (65,536 on 128^2 f32 x 1000 and f64 x
  200, 2^20 on 512^2 f32 x 200); the LBM K-step kernel at K=8 and the
  one-step kernel (the K=1 run's) on the final state of the LBM runs
  (2048x1024 f32 x 1000, f64 x 200); the MPM and FLIP P2Gs on the final
  state of chip_smoke.py's MPM and FLIP runs (MPM 32,768 on 96^2 f32 x
  1000 and f64 x 200, 2^18 on 256^2 f32 x 200, 2^20 on 512^2 f32 x 200;
  FLIP likewise on 128^2, 256^2 and 512^2), also as torch.profiler's
  device time a launch of the P2G kernel and of all device work a wrapper
  call (the parent's zero fill, the atomic design's memset too; where the
  tree has two designs, each one's), and the host's time a wrapper call
  (`host_us`); the FLIP G2P ("g2p flip 128 f32", "... 128 f64", "... 512
  f32") on the inputs of the G2P of the final state of chip_smoke.py's
  FLIP runs, also as device time and the host's time a wrapper call
  (`host_us`), bitwise to plain or not, its launch,
  and digests of those inputs and of its outputs (with --inputs DIR the
  first process saves the inputs there and the next load them, so two
  trees are held to each other on the same bits: the P2G's atomics make
  two runs differ); set_bnd ("set_bnd 192 f32", "... f64") on the four
  fields of the final state of the stam3d runs (192^3 f32 x 100, f64 x
  20), also as device time, with digests of that state and of the
  output, and the Jacobi sweep (#11, "<key> jacobi", also as device
  time) on that state; the MPM G2P with its grid update (#20 and #21, one
  launch) on
  the P2G grids of the final state of the MPM runs ("mpm 96 f32", "mpm
  96 f64", "mpm 512 f32"; "<key> g2p", and for a tree that launches the
  grid update on its own, as the parent of that design does, "<key>
  grid" too), also as device time and the host's time a wrapper call,
  and the step's part ("<key> step") as events and device time in all,
  bitwise to the plain G2P of the plain grid update or not, with digests
  of the inputs and outputs (--inputs DIR as for the FLIP G2P); "mpm
  switch": that step part's device time on the final state of MPM runs
  of 65,536-524,288 particles (where a tree with one launch and one with
  two cross); and "p2g switch":
  each P2G design's device time a wrapper call on FLIP and MPM runs of
  65,536-262,144 particles, where FST_P2G_TILED_FROM should lie; the SPH
  bin ("bin 65536 f32", "bin 1048576 f32 rain") on the final state of
  chip_smoke.py's SPH runs: events, device time a call in all and by
  kernel ("<key> device parts"), the host's time a wrapper call, how full
  the cells are, bitwise to plain or not, its launch and grid syncs, and
  digests of the state and the outputs; the stam2d advection ("advect
  512 f32", "advect 512 f64") on the final state of the stam2d runs (400
  steps each), the velocity pair and the density ("<key> density") as the
  step calls them: events, device time, host time, bitwise to plain or
  not, and digests of the state and the outputs; the n-body repulsion
  ("nbody 2-D f32", "nbody 3-D f32", "nbody 2-D f64") on the positions
  of the final state of chip_smoke.py's phase-24 runs (2^17 bodies, 20,
  20 and 10 steps; with --inputs DIR the first process saves them and the
  next load them, since two trees' kernels round differently): events,
  device time, the error per body over sum |terms| against the f64 plain
  version, the launch, and digests of the positions and the forces; the
  3-D wavespeed ("wavespeed3 64^3 f32", "wavespeed3 256^3 f32") on the
  step's output from the final state of chip_smoke.py's 3-D runs (400
  and 20 steps): events, the host's time a wrapper call, device time a
  call in all and by kernel (the parent's memset too), bitwise to plain
  or not, and digests.  For the
  K=1 launches, also the device time a launch (torch.profiler's kernel
  time over 200 launches) and the host's time a wrapper call (the host
  clock over 200 calls that queue without a sync), by part.  With --root, the package is imported from
  DIR (an unpacked tree of another commit), so two commits are timed with
  one script on one card, each in its own process.
* sweep — the same times over candidate tiles: each candidate is a build
  of its own, the sources' tile constants set by -D (csrc/tiles.cuh
  FST_TILE_X, FST_TILE_Y; csrc/stam2d_lin_solve.cu FST_SOLVE_TILE_X,
  FST_SOLVE_TILE_Y, FST_SOLVE_SWEEPS, FST_SOLVE_THREADS), timed by this
  script with `time --define ...` in a process of its own; what the
  sources' defaults were chosen from.  `--set hypersonic` sweeps the
  hypersonic step kernels' tiles instead (csrc/hypersonic2d_step.cu
  FST_HYP2D_TILE_X, FST_HYP2D_TILE_Y for float, FST_HYP2D_F64_TILE_X,
  FST_HYP2D_F64_TILE_Y for double; csrc/hypersonic3d_step.cu
  FST_HYP3D_TILE_X, FST_HYP3D_TILE_Y, FST_HYP3D_TILE_Z); `--set gs` the
  Gray–Scott K-step kernel's threads, blocks an SM of __launch_bounds__,
  rows a strip and copies of the window, each dtype's
  (csrc/gray_scott_multistep.cu FST_GS_THREADS, FST_GS_MIN_BLOCKS,
  FST_GS_ROWS, FST_GS_COPIES and the FST_GS_F64_ ones); `--set mhd` the
  MHD kernel's tiles and threads (csrc/mhd_multistep.cu FST_MHD_TILE_X,
  _Y, FST_MHD_F64_TILE_X, _Y, FST_MHD_THREADS, FST_MHD_MIN_BLOCKS,
  FST_MHD_F64_MIN_BLOCKS); `--set sph` the SPH
  density kernel's threads, lanes a particle and staged bytes
  (csrc/sph_density.cu FST_SPH_DENSITY_THREADS, _MIN_LANES, _MAX_LANES,
  _LANE_THREADS, _STAGE_BYTES) beside the forces kernel's
  (csrc/sph_forces.cu FST_SPH_FORCES_THREADS, FST_SPH_MIN_LANES,
  FST_SPH_MAX_LANES, FST_SPH_STAGE_BYTES), each build timing both;
  `--set flip` the FLIP grid
  phase's sweeps a phase and its tiles and threads for small and large
  grids (csrc/flip_grid.cu FST_FLIP_SWEEPS, FST_FLIP_SMALL_TILE_X, _Y,
  FST_FLIP_SMALL_THREADS, FST_FLIP_TILE_X, _Y, FST_FLIP_THREADS); `--set
  lbm` the LBM K-step kernel's shared memory a block and threads
  (csrc/lbm_multistep.cu FST_LBM_SMEM, FST_LBM_THREADS); `--set p2g` the
  P2Gs' tiles, particles a chunk and threads a block (csrc/mpm_p2g.cu
  FST_MPM_P2G_TILE_X, _Y, FST_MPM_P2G_CHUNK, FST_MPM_P2G_THREADS;
  csrc/flip_p2g.cu FST_FLIP_P2G_...), timed by their device time; `--set
  g2p` the FLIP G2P's threads a block (csrc/flip_g2p.cu FST_G2P_THREADS,
  FST_G2P_F64_THREADS; pass --inputs so that every build times the same
  inputs); `--set set_bnd` the set_bnd block (csrc/stam3d_set_bnd.cu
  FST_SET_BND_X, FST_SET_BND_ROWS); `--set bin` the SPH bin's threads a
  block (csrc/sph_bin.cu FST_BIN_THREADS); `--set mpm` the MPM G2P's
  threads a block and window (csrc/mpm_g2p.cu FST_MPM_G2P_THREADS,
  FST_MPM_G2P_WINDOW; pass --inputs); `--set nbody` the n-body
  kernel's threads and targets a thread of each dtype and unroll
  (csrc/nbody_repulsion.cu FST_NBODY_THREADS, _TARGETS, _F64_THREADS,
  _F64_TARGETS, _UNROLL; pass --inputs); `--set ws3` the 3-D wavespeed's threads a block
  (csrc/hypersonic3d_wavespeed.cu FST_WS3_THREADS).
* phases — the tiled P2Gs' and the SPH bin's phase times on the final
  states that `time` uses (--only: those keys' alone; the bin's count,
  starts, fill and ranks from a build with -DFST_BIN_STAMPS,
  csrc/sph_bin.cu): a build with -DFST_P2G_STAMPS (csrc/p2g_tiles.cuh), in
  which
  block 0 stamps %globaltimer at the launch's start and after each of
  its three grid syncs and every block its end, launched 55 times; the
  mean over the last 50 of the count (with the zeroing of the grids), the
  scan, the fill with the chunk list and the chunks.  The stamps cost a
  few instructions a launch, so it runs alone (or with sass).
* sass — the atomic instructions of the built library's P2G kernels in
  `cuobjdump -sass`, and of a probe of float and double atomicAdd on
  shared memory built for the same target: ATOMS.CAST.SPIN is a
  compare-and-swap loop, ATOMS.ADD a native shared-memory add; and the
  number of SASS instructions of the FLIP G2P, set_bnd, n-body and 3-D
  wavespeed kernels with their commonest opcodes (--root: another
  tree's).
* --fmad — build with -fmad=true in place of -fmad=false: how much of a
  kernel's time the unfused multiplies and adds take.  A measurement
  only; the shipped build and every bitwise bar keep -fmad=false.
* --dump DIR — `time` also saves each hypersonic, MHD, SPH, FLIP and LBM
  key's final
  state and step output to DIR; `diff A B` then reports, key by key,
  whether two dumps (two trees, or two builds) are bitwise equal, and by
  how much they differ where they are not.

Prints one line per reading, the card's name and power limit first, and
writes all readings as JSON to --out (default build/tune_tiles_torch.json).
Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, n: int) -> float:
    """Mean ms a call of fn over n calls, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def device_ms(fn, n: int, fragment: str) -> float:
    """Device time a call of fn by torch.profiler: the kernels whose name
    holds `fragment`, over n calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and fragment in e.name]
    if not us:
        raise RuntimeError(f"torch.profiler recorded no {fragment} kernel")
    return sum(us) / len(us) / 1e3


def host_us(fn, n: int) -> float:
    """Host time a call of fn: n calls on the host clock, no sync between
    (the queue is deeper than n launches)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def host_parts(m, key, cfg, s, kern) -> dict:
    """Where a K=1 wrapper call's host time goes (trees whose wrappers
    report their launch, as this one's; others are left out): the CUDA
    launch alone through ctypes with its arguments formed once, the tensor
    checks, the two allocations of the result, the stream query."""
    out = {}
    mod = m.bk if hasattr(s, "phi_u") else m.swk
    dev = s[0].device
    if not hasattr(mod, "grid_syncs"):
        return out
    dt = cfg.torch_dtype
    fn, params, grid, threads = mod._launch_plan(cfg, 1, dev.index)[:4]
    nf = 2 if mod is m.bk else 3
    res = kern(cfg, s, 1)
    stream = torch.cuda.current_stream().cuda_stream
    scratch, words = mod._scratch(cfg, dev)
    ptrs = [f.data_ptr() for f in s] + [f.data_ptr() for f in res]
    args = (*ptrs, scratch.data_ptr(), words.data_ptr(), params, grid,
            threads, dev.index, stream)
    out[key + " host_us launch only"] = host_us(lambda: fn(*args), 200)
    out[key + " host_us checks"] = host_us(lambda: mod._check(cfg, s), 200)
    out[key + " host_us allocations"] = host_us(
        lambda: (torch.empty((nf, cfg.ny, cfg.nx), dtype=dt,
                             device=dev).unbind(0),
                 torch.empty(2, dtype=dt, device=dev).unbind(0)), 200)
    out[key + " host_us stream query"] = host_us(
        lambda: torch.cuda.current_stream(dev).cuda_stream, 200)
    return out


def noisy(mod, cfg, dev, seed: int):
    """init() plus seeded noise (Burgers: phi; shallow water: sigma, u,
    v)."""
    s = mod.init(cfg, torch.device("cpu"))
    rng = np.random.default_rng(seed)

    def nz(f, amp):
        return f + torch.tensor(amp * rng.standard_normal(tuple(f.shape)),
                                dtype=f.dtype)

    if hasattr(s, "sigma"):
        s = s._replace(sigma=nz(s.sigma, 1e-3), u=nz(s.u, 0.5),
                       v=nz(s.v, 0.5))
    else:
        s = s._replace(phi_u=nz(s.phi_u, 0.1), phi_v=nz(s.phi_v, 0.1))
    return type(s)(*(f.to(dev) for f in s))


def max_rel(a, b) -> float:
    worst = 0.0
    for x, y in zip(a, b):
        d = float((x.double() - y.double()).abs().max())
        worst = max(worst, d / max(float(y.double().abs().max()), 1e-300))
    return worst


def check(m, dev) -> list:
    out = []
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}
    for dtype in ("float32", "float64"):
        for nx, ny in ((200, 75), (5, 3)):
            cases = [(m.bg, m.bk.burgers_multistep,
                      m.bk.burgers_multistep_plain,
                      m.bg.BurgersConfig(nx=nx, ny=ny, dtype=dtype, dtau=1e-2,
                                         **o))
                     for o in ({}, {"muscl": True}, {"visc_substeps": 3},
                               {"muscl": True, "visc_substeps": 9})]
            cases += [(m.sw, m.swk.sw_multistep, m.swk.sw_multistep_plain,
                       m.sw.ShallowWaterConfig(nx=nx, ny=ny, dtype=dtype,
                                               dtau=1e-3, **o))
                      for o in ({}, {"nu": 0.0})]
            for mod, kern, plain, cfg in cases:
                s = noisy(mod, cfg, dev, 7)
                rel = max_rel(kern(cfg, s, 1), plain(cfg, s, 1))
                if not rel <= tol[cfg.torch_dtype]:
                    raise AssertionError(f"{cfg}: k=1 rel err {rel:.3e}")
                one = s
                for _ in range(8):
                    one = kern(cfg, one, 1)
                if not all(torch.equal(a, b) for a, b in
                           zip(kern(cfg, s, 8), one)):
                    raise AssertionError(f"{cfg}: k=8 != 8 x k=1")
                out.append({"case": f"{mod.__name__.split('.')[-1]} {nx}x{ny} "
                            f"{dtype}", "rel_k1": rel})
        dt = torch.float64 if dtype == "float64" else torch.float32
        rng = np.random.default_rng(11)
        h = (m.s2k.solve_launch(1, dt, dev.index).halo
             if hasattr(m.s2k, "solve_launch") else 8)
        for n in (1, 37, 512):
            x, b = (torch.tensor(rng.random((n, n)), dtype=dt, device=dev)
                    for _ in range(2))
            for iters in (1, h, h + 1, 40):
                got = m.s2k.lin_solve(x, b, 0.26, 2.04, iters)
                ref = m.s2k.lin_solve_plain(x, b, 0.26, 2.04, iters)
                if not torch.equal(got, ref):
                    raise AssertionError(f"lin_solve n={n} {iters} sweeps "
                                         f"{dtype}: not bitwise")
        out.append({"case": f"lin_solve {dtype}", "bitwise": True})
    torch.cuda.synchronize()
    log(f"[check] {len(out)} cases ok: K-step kernels within 1e-5 / 1e-12 "
        "of plain at k=1 and k=8 bitwise to 8 x k=1; lin_solve bitwise")
    return out


# The hypersonic step kernels (#1, #2) at chip_smoke.py's main runs: (key,
# dimensions, size, dtype, steps of the run, launches timed).
HYP_RUNS = (("hyp2d 2048x2048 f32", 2, (2048, 2048), "float32", 200, 20),
            ("hyp2d 8192x1024 f64", 2, (8192, 1024), "float64", 50, 10),
            ("hyp3d 64^3 f32", 3, 64, "float32", 400, 50),
            ("hyp3d 256^3 f32", 3, 256, "float32", 20, 10))
HYP_KEYS = tuple(r[0] for r in HYP_RUNS)


def hyp_noisy(m, dim, cfg, dev, seed: int):
    """init() plus seeded noise on the fluid cells (2-D: the conserved
    fields, so that some cells need the repair; 3-D: every log field and
    u0 = 0.05, as chip_smoke.py's hyp3d_state)."""
    rng = np.random.default_rng(seed)
    if dim == 2:
        s = m.h2.init(cfg, torch.device("cpu"))
        fl = ~s.mask.numpy()
        U = [f.numpy().astype(np.float64) for f in s.U]
        for k, amp in enumerate((0.2, 0.5, 0.5, 0.2)):
            noise = amp * rng.standard_normal(U[k].shape)
            U[k] = np.where(fl, U[k] * (1.0 + noise) if k in (0, 3)
                            else U[k] + noise, U[k])
        return m.interop.state_from_numpy(U, s.mask.numpy(), 0.0,
                                          dtype=cfg.torch_dtype, device=dev)
    s = m.h3.init(cfg, torch.device("cpu"))
    fl = ~s.solid.numpy()
    f = [x.numpy().astype(np.float64) for x in s[:6]]
    f[1][fl] = np.arcsinh(0.05 / cfg.u_ref)
    for k, amp in enumerate((0.3, 0.05, 0.05, 0.05, 0.3, 0.3)):
        f[k] = f[k] + np.where(fl, amp * rng.standard_normal(f[k].shape), 0.0)
    return m.interop.hyp3d_state_from_numpy(
        *f, s.solid.numpy(), cfg.t0, cfg.dtau0, dtype=cfg.torch_dtype,
        device=dev)


def hyp_calls(m, dim, cfg, s):
    """(kernel call, plain call) of the step on state s at its CFL dt."""
    if dim == 2:
        dt = m.cfl_dt(m.hk.inflow_wavespeed_plain(cfg, s.U, s.mask), cfg.cfl,
                      dx=1.0, nu_max=cfg.nu_max)
        return (lambda: m.hk.step_core(cfg, s.U, s.mask, dt),
                lambda: m.hk.step_core_plain(cfg, s.U, s.mask, dt))
    dev = s.xi.device
    sp = m.h3.solid_pad_of(cfg, dev)
    q = m.h3._decode(cfg, *s[:6])
    qp = m.h3._padded_prims(cfg, q, sp)
    dt = torch.div(torch.full((), cfg.cfl, dtype=cfg.torch_dtype, device=dev),
                   m.hk3.wavespeed_plain(cfg, q, s.solid))
    g = torch.full((), 0.6, dtype=cfg.torch_dtype, device=dev)
    return (lambda: m.hk3.step_core(cfg, qp, sp, dt, g),
            lambda: m.hk3.step_core_plain(cfg, qp, sp, dt, g))


def check_hyp(m, dev) -> list:
    """Both hypersonic steps against their plain versions on small and
    ragged grids (one smaller than any tile), f32 and f64."""
    out = []
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}
    for dtype in ("float32", "float64"):
        cases = [(2, m.h2.default_config(nx=nx, ny=ny, dtype=dtype))
                 for nx, ny in ((200, 75), (33, 9), (7, 5))]
        cases += [(3, m.h3.Hypersonic3DConfig(
            nx=nx, ny=ny, nz=nz, dx=1.0 / nx, dy=1.0 / ny, dz=1.0 / nz,
            outflow=outflow, dtype=dtype))
            for nz, ny, nx in ((24, 40, 56), (5, 7, 9))
            for outflow in ("transmissive", "characteristic")]
        for dim, cfg in cases:
            s = hyp_noisy(m, dim, cfg, dev, 5)
            kern, plain = hyp_calls(m, dim, cfg, s)
            got, ref = kern(), plain()
            for a, b in zip(got, ref):
                if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
                    raise AssertionError(f"{cfg}: non-finite cells differ")
            rel = max_rel([torch.nan_to_num(a) for a in got],
                          [torch.nan_to_num(b) for b in ref])
            if not rel <= tol[cfg.torch_dtype]:
                raise AssertionError(f"{cfg}: rel err {rel:.3e}")
            out.append({"case": f"hyp{dim}d {tuple(ref[0].shape)} {dtype}"
                        + ("" if dim == 2 else f" {cfg.outflow}"),
                        "rel": rel, "bitwise": all(
                            bits_equal(a, b) for a, b in zip(got, ref))})
    log(f"[check] hypersonic steps within 1e-5 / 1e-12 of plain in "
        f"{len(out)} cases, {sum(c['bitwise'] for c in out)} bitwise")
    return out


def mhd_noisy(m, cfg, dev, seed: int):
    """init() plus seeded noise on rho, mx, my and By (as chip_smoke.py's
    resident_state)."""
    s = m.mhd.init(cfg, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    U = s.U

    def nz(f, amp):
        return f + torch.tensor(amp * rng.standard_normal(tuple(f.shape)),
                                dtype=f.dtype)

    rho = U.rho * (1.0 + 0.02 * torch.tensor(
        rng.uniform(-1, 1, tuple(U.rho.shape)), dtype=U.rho.dtype))
    U = U._replace(rho=rho, mx=nz(U.mx, 0.02), my=nz(U.my, 0.02),
                   By=nz(U.By, 0.02))
    return m.mhd.MHDState(U=type(U)(*(f.to(dev) for f in U)), t=s.t.to(dev))


def check_mhd(m, dev) -> list:
    """The MHD kernel against its plain version: k = 1 within 1e-5 / 1e-12
    relative, k = 8 bitwise equal to 8 launches of k = 1, K + 1 grid
    syncs a launch where the wrapper reports them."""
    out = []
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}
    for dtype in ("float32", "float64"):
        for nx, ny in ((200, 75), (37, 23), (256, 128)):
            for problem in ("briowu", "orszag-tang"):
                for stable in (False, True):
                    cfg = m.mhd.MHDConfig(nx=nx, ny=ny, dtype=dtype,
                                          problem=problem, stable_hll=stable)
                    s = mhd_noisy(m, cfg, dev, 7)
                    a, b = (m.mk.mhd_multistep(cfg, s, 1),
                            m.mk.mhd_multistep_plain(cfg, s, 1))
                    rel = max_rel([*a.U, a.t], [*b.U, b.t])
                    if not rel <= tol[cfg.torch_dtype]:
                        raise AssertionError(f"{cfg}: k=1 rel err {rel:.3e}")
                    got8 = m.mk.mhd_multistep(cfg, s, 8)
                    syncs = (m.mk.grid_syncs(cfg, dev)
                             if hasattr(m.mk, "grid_syncs") else None)
                    if syncs not in (None, 9):
                        raise AssertionError(f"{cfg}: {syncs} grid syncs at "
                                             "k=8, want 9")
                    one = s
                    for _ in range(8):
                        one = m.mk.mhd_multistep(cfg, one, 1)
                    if not all(bits_equal(x, y) for x, y in
                               zip([*got8.U, got8.t], [*one.U, one.t])):
                        raise AssertionError(f"{cfg}: k=8 != 8 x k=1")
                    out.append({"case": f"mhd {nx}x{ny} {dtype} {problem} "
                                f"stable={stable}", "rel_k1": rel,
                                "grid_syncs_k8": syncs})
    torch.cuda.synchronize()
    log(f"[check] mhd: {len(out)} cases, k=1 within 1e-5 / 1e-12 of plain, "
        "k=8 bitwise to 8 x k=1, grid syncs K + 1 where counted")
    return out


def check_sph(m, dev) -> list:
    """The SPH density and forces kernels against their plain versions on
    the same binning (forces also on the same density), and two launches
    of each bitwise equal: 4096 particles from init with seeded velocity
    noise, and crowded pools (a cell packed with more candidates than a
    staged chunk of the forces kernel holds, and than one of the density
    kernel where the tree reports its chunk)."""
    out = []
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}
    rng = np.random.default_rng(9)
    for dtype in ("float32", "float64"):
        crowds = [0, 1500]
        if hasattr(m.sk, "density_shape"):
            cfg = m.ts.SPHConfig(n=4096, dtype=dtype)
            crowds.append(min(m.sk.density_shape(cfg).chunk + 500, 4000))
        for n, crowd in ((4096, c) for c in crowds):
            cfg = m.ts.SPHConfig(n=n, dtype=dtype)
            pos = m.ts.init(cfg, torch.device("cpu")).pos.clone()
            if crowd:
                c = cfg.grid().cell
                for k in (0, 1):
                    pos[:crowd, k] = torch.tensor(
                        (3.5 - k) * c + 0.45 * c * rng.uniform(-1, 1, crowd),
                        dtype=pos.dtype)
            vel = torch.tensor(0.5 * rng.standard_normal((n, 2)),
                               dtype=cfg.torch_dtype)
            pos, vel = pos.to(dev), vel.to(dev)
            b = m.sk.binning(cfg, pos, vel)
            rp, rp2 = (m.sk.density(cfg, b) for _ in range(2))
            rel_d = max_rel(rp.unbind(1), m.sk.density_plain(cfg, b).unbind(1))
            dt = torch.full((), 1e-4, dtype=cfg.torch_dtype, device=dev)
            got, again = (m.sk.forces(cfg, b, rp, dt) for _ in range(2))
            ref = m.sk.forces_plain(cfg, b, rp, dt)
            rel = max_rel(got, ref)
            what = f"n={n} crowd={crowd} {dtype}"
            if not (rel_d <= tol[cfg.torch_dtype]
                    and rel <= tol[cfg.torch_dtype]):
                raise AssertionError(f"sph {what}: rel err density "
                                     f"{rel_d:.3e}, forces {rel:.3e}")
            if not (bits_equal(rp, rp2)
                    and all(bits_equal(x, y) for x, y in zip(got, again))):
                raise AssertionError(f"sph {what}: two launches differ")
            peak = int(torch.bincount(b.cid.long()).max())
            out.append({"case": f"sph {what}", "rel_density": rel_d,
                        "rel": rel, "max_cell": peak})
    torch.cuda.synchronize()
    log(f"[check] sph density and forces: {len(out)} cases within 1e-5 / "
        "1e-12 of plain, two launches of each bitwise equal")
    return out


def flip_fields(m, n: int, dtype: str, seed: int):
    """(config, P2G grids) of 4 n^2 seeded particles (as chip_smoke.py's
    flip_particles: the first eight on the walls and corners), through
    the plain P2G."""
    cfg = m.fa.FlipApicConfig(particles=4 * n * n, grid=n, dtype=dtype)
    rng = np.random.default_rng(seed)
    pos = rng.random((cfg.particles, 2))
    pos[:8] = [[0, 0], [1, 1], [0, 1], [1, 0], [0.01, 0.99], [0.99, 0.01],
               [0.5, 0], [1, 0.5]]
    parts = [torch.tensor(a, dtype=cfg.torch_dtype) for a in
             (pos, *(rng.standard_normal((cfg.particles, 2))
                     for _ in range(3)))]
    return cfg, m.fk.p2g_plain(cfg, *parts)


def check_flip(m, dev) -> list:
    """The FLIP grid phase against its plain version, bitwise, with its
    grid syncs where the wrapper reports them."""
    out = []
    for dtype in ("float32", "float64"):
        for n in (16, 37, 128, 512):
            cfg, grids = flip_fields(m, n, dtype, 40 + n)
            grids = [g.to(dev) for g in grids]
            h = (m.fk.grid_launch(n, cfg.torch_dtype, dev.index).halo
                 if hasattr(m.fk, "grid_launch") else None)
            for jac in sorted({0, 1, 7, 48} | ({h, h + 1} if h else set())):
                c = cfg.replace(jacobi=jac)
                got = m.fk.grid_phase(c, *grids)
                ref = m.fk.grid_phase_plain(c, *grids)
                if not all(bits_equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError(f"flip grid n={n} jacobi={jac} "
                                         f"{dtype}: not bitwise")
                syncs = None
                if h:
                    syncs = m.fk.grid_syncs(n, cfg.torch_dtype, dev)
                    if syncs != max(-(-jac // h), 1) - 1:
                        raise AssertionError(f"flip grid n={n} jacobi={jac}"
                                             f": {syncs} grid syncs")
                out.append({"case": f"flip grid n={n} jacobi={jac} {dtype}",
                            "bitwise": True, "grid_syncs": syncs})
    torch.cuda.synchronize()
    log(f"[check] flip grid phase: {len(out)} cases bitwise to plain, grid "
        "syncs max(ceil(jacobi / h), 1) - 1 where counted")
    return out


def p2g_positions(rng, n_p: int, X: float, Y: float):
    """Seeded positions over [0, X] x [0, Y] with no particle in the
    grid's last quarter along x (empty tiles), 2,000 (or a third) crowded
    into one cell (more particles than a chunk), and twelve on and past
    the walls and corners (MPM drops their out-of-grid targets, FLIP clips
    them)."""
    pos = rng.random((n_p, 2)) * [0.75 * X, Y]
    crowd = min(n_p // 3, 2000)
    pos[12:12 + crowd] = [0.3 * X, 0.4 * Y] + 1e-3 * X * rng.random((crowd, 2))
    pos[:12] = [[0, 0], [X, Y], [0, Y], [X, 0], [-0.02 * X, 0.5 * Y],
                [1.03 * X, 0.5 * Y], [0.5 * X, -0.05 * Y],
                [0.3 * X, 1.1 * Y], [-X, -Y], [5 * X, 5 * Y],
                [0.999 * X, 0.001 * Y], [0.001 * X, 0.999 * Y]]
    return pos


def p2g_designs(mod) -> tuple:
    """The P2G designs a tree's wrapper takes (None: its only one)."""
    return (("atomic", "tiled") if hasattr(mod, "p2g_stats") else (None,))


def check_p2g_syncs(mod, cfg, n_p, dev, what, design):
    """The grid syncs of the P2G launch of `design` just made, where the
    wrapper reports them (None otherwise)."""
    if design is None:
        return None
    st = mod.p2g_stats(cfg, n_p, cfg.torch_dtype, dev, design)
    launch = (mod.p2g_launch(n_p, cfg.gx, cfg.gy, cfg.torch_dtype, dev.index,
                             design)
              if hasattr(cfg, "gx") else
              mod.p2g_launch(n_p, cfg.grid, cfg.torch_dtype, dev.index,
                             design))
    if st["grid_syncs"] != launch.grid_syncs:
        raise AssertionError(f"{what}: {st['grid_syncs']} grid syncs, the "
                             f"query says {launch.grid_syncs}")
    return st


def check_p2g(m, dev) -> list:
    """Both P2Gs, each design, against their plain versions, within 1e-5
    (f32) / 1e-12 (f64) relative to each grid's max."""
    out = []
    for dtype in ("float32", "float64"):
        bar = 1e-5 if dtype == "float32" else 1e-12
        for gx, gy in ((96, 96), (37, 53), (512, 512)):
            for material in ("mud", "snow", "sand"):
                cfg = m.mp.MPMConfig(n=4 * gx * gy, gx=gx, gy=gy,
                                     material=material, dtype=dtype)
                rng = np.random.default_rng(gx + gy)
                pos = p2g_positions(rng, cfg.n, (gx - 1) * cfg.dx,
                                    (gy - 1) * cfg.dx)
                F = np.eye(2) + 0.05 * rng.standard_normal((cfg.n, 2, 2))
                parts = [torch.tensor(a, dtype=cfg.torch_dtype, device=dev)
                         for a in (pos, rng.standard_normal((cfg.n, 2)), F,
                                   rng.uniform(0.5, 1.5, cfg.n))]
                ref = m.mpk.p2g_plain(cfg, *parts)
                for design in p2g_designs(m.mpk):
                    got = (m.mpk.p2g(cfg, *parts) if design is None else
                           m.mpk._p2g(cfg, *parts, design=design))
                    rel = max_rel(got, ref)
                    what = f"p2g mpm {gx}x{gy} {material} {dtype} {design}"
                    if not rel <= bar:
                        raise AssertionError(f"{what}: rel err {rel:.3e}")
                    out.append({"case": what, "rel": rel, **(check_p2g_syncs(
                        m.mpk, cfg, cfg.n, dev, what, design) or {})})
        for n in (128, 37, 512, 16):
            for apic in (None, 0.0, 1.0):
                cfg = m.fa.FlipApicConfig(particles=4 * n * n, grid=n,
                                          dtype=dtype)
                rng = np.random.default_rng(n)
                pos = p2g_positions(rng, cfg.particles, 1.0, 1.0)
                parts = [torch.tensor(a, dtype=cfg.torch_dtype, device=dev)
                         for a in (pos, *(rng.standard_normal(
                             (cfg.particles, 2)) for _ in range(3)))]
                ref = m.fk.p2g_plain(cfg, *parts, apic)
                for design in p2g_designs(m.fk):
                    got = (m.fk.p2g(cfg, *parts, apic) if design is None else
                           m.fk._p2g(cfg, *parts, apic, design=design))
                    rel = max_rel(got, ref)
                    what = f"p2g flip {n}^2 apic {apic} {dtype} {design}"
                    if not rel <= bar:
                        raise AssertionError(f"{what}: rel err {rel:.3e}")
                    out.append({"case": what, "rel": rel, **(check_p2g_syncs(
                        m.fk, cfg, cfg.particles, dev, what, design) or {})})
    torch.cuda.synchronize()
    log(f"[check] p2g: {len(out)} cases within 1e-5 / 1e-12 of plain, "
        f"worst {max(c['rel'] for c in out):.3e}; " + "; ".join(
            f"{c['case']}: chunks {c.get('chunks')}, most in a tile "
            f"{c.get('most_in_tile')}" for c in out
            if "96x96 snow" in c["case"] or "128^2 apic None" in c["case"]
            if "tiled" in c["case"]))
    return out


def device_call_ms(fn, n: int) -> float:
    """Device time a call of fn by torch.profiler: all kernels over n
    calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(us) / n / 1e3


# The P2Gs (#19, #16) at chip_smoke.py's MPM and FLIP runs, and 2^18
# particles on 256^2 between them: (key, solver, particles, grid, dtype,
# steps of the run, launches timed).
P2G_RUNS = (("p2g mpm 96 f32", "mpm", 32768, 96, "float32", 1000, 200),
            ("p2g mpm 96 f64", "mpm", 32768, 96, "float64", 200, 200),
            ("p2g mpm 256 f32", "mpm", 1 << 18, 256, "float32", 200, 100),
            ("p2g mpm 512 f32", "mpm", 1 << 20, 512, "float32", 200, 100),
            ("p2g flip 128 f32", "flip", 65536, 128, "float32", 1000, 200),
            ("p2g flip 128 f64", "flip", 65536, 128, "float64", 200, 200),
            ("p2g flip 256 f32", "flip", 1 << 18, 256, "float32", 200, 100),
            ("p2g flip 512 f32", "flip", 1 << 20, 512, "float32", 200, 100))
P2G_KEYS = tuple(r[0] for r in P2G_RUNS)


def p2g_run(m, dev, solver, n_p, n, dtype, steps) -> tuple:
    """(cfg, particles, wrapper module) of a P2G_RUNS run's final state."""
    if solver == "mpm":
        cfg = m.mp.MPMConfig(n=n_p, gx=n, gy=n, dtype=dtype)
        out = m.mp.run(cfg, m.mp.init(cfg, dev), steps)
        return cfg, (out.pos, out.vel, out.F, out.Jp), m.mpk
    cfg = m.fa.FlipApicConfig(particles=n_p, grid=n, dtype=dtype)
    out = m.fa.run(cfg, m.fa.init(cfg, dev), steps)
    return cfg, (out.pos, out.vel, out.affine_x, out.affine_y), m.fk


P2G_PHASES = ("count", "scan", "fill", "chunks")


def p2g_phases(m, dev, only=None, reps: int = 50) -> dict:
    """Mean us of each phase of the tiled P2G on each P2G_RUNS run's final
    state, from the stamps of a build with -DFST_P2G_STAMPS (csrc/
    p2g_tiles.cuh): the count (with the zeroing of the grids), the scan,
    the fill with the chunk list, and the chunks (to the last block's
    end); 5 launches, then the mean over `reps`."""
    res = {}
    for key, solver, n_p, n, dtype, steps, _ in P2G_RUNS:
        if only is not None and key not in only:
            continue
        cfg, parts, mod = p2g_run(m, dev, solver, n_p, n, dtype, steps)
        size = (n, n) if solver == "mpm" else (n,)
        launch = mod.p2g_launch(n_p, *size, cfg.torch_dtype, dev.index,
                                "tiled")
        words = mod._p2g_scratch(n_p, *size, cfg.torch_dtype, launch, dev,
                                 torch.cuda.current_stream(dev).cuda_stream)[1]
        acc = torch.zeros(len(P2G_PHASES), dtype=torch.float64)
        for r in range(reps + 5):
            torch.cuda.synchronize()
            words.zero_()
            mod._p2g(cfg, *parts, design="tiled")
            torch.cuda.synchronize()
            w = words.cpu().double()
            if r >= 5:
                acc += w[1:5] - w[0:4]
        us = (acc / reps / 1e3).tolist()
        res[key] = {**{f"{k}_us": v for k, v in zip(P2G_PHASES, us)},
                    "total_us": sum(us), "grid": launch.grid,
                    **mod.p2g_stats(cfg, n_p, cfg.torch_dtype, dev, "tiled")}
        log(f"[phases] {key}: {res[key]}")
    return res


# The SPH bin's phases, between its stamps (csrc/sph_bin.cu FST_BIN_STAMPS).
BIN_PHASES = ("count", "starts", "fill", "rank")


def bin_phases(m, dev, only=None, reps: int = 50) -> dict:
    """Mean us of each phase of the SPH bin on each BIN_RUNS run's final
    state, from the stamps of a build with -DFST_BIN_STAMPS: the count and
    the starts (each block's slice and the sums before it, with the list),
    each to the grid sync after it, the fill (to the cooperative launch's
    end) and the ranks (the second launch, to its last block's end); 5
    calls, then the mean over `reps`."""
    res = {}
    for key, n_p, rain, steps, _ in BIN_RUNS:
        if only is not None and key not in only:
            continue
        cfg = m.ts.SPHConfig(n=n_p, rain=rain)
        out = m.ts.run(cfg, m.ts.init(cfg, dev), steps)
        g = cfg.grid()
        shape = m.sk.bin_launch(n_p, g.Gx * g.Gy, cfg.torch_dtype, dev.index)
        words = m.sk._bin_scratch(n_p, g.Gx * g.Gy, cfg.torch_dtype, shape,
                                  dev,
                                  torch.cuda.current_stream(dev).cuda_stream)[1]
        acc = torch.zeros(len(BIN_PHASES), dtype=torch.float64)
        for r in range(reps + 5):
            torch.cuda.synchronize()
            words.zero_()
            m.sk.binning(cfg, out.pos, out.vel)
            torch.cuda.synchronize()
            w = words.cpu().double()
            if r >= 5:
                acc += w[1:5] - w[0:4]
        us = (acc / reps / 1e3).tolist()
        res[key] = {**{f"{k}_us": v for k, v in zip(BIN_PHASES, us)},
                    "total_us": sum(us), "grid": shape.grid}
        log(f"[phases] {key}: {res[key]}")
    return res


# Shared-memory atomicAdd of each float type, for `sass`.
SASS_PROBE = r"""
template <typename T>
__device__ void probe(T* out, const T* in) {
  __shared__ T s[32];
  if (threadIdx.x < 32) s[threadIdx.x] = T(0);
  __syncthreads();
  atomicAdd(s + (threadIdx.x & 31), in[threadIdx.x]);
  __syncthreads();
  if (threadIdx.x < 32) out[threadIdx.x] = s[threadIdx.x];
}
extern "C" __global__ void shared_add_f32(float* o, const float* i) {
  probe(o, i);
}
extern "C" __global__ void shared_add_f64(double* o, const double* i) {
  probe(o, i);
}
"""


def sass_atomics(cuobjdump: Path, binary: Path, fragment: str) -> dict:
    """The atomic instructions of each kernel of `binary` whose name holds
    `fragment`, counted in `cuobjdump -sass`: ATOMS.CAST.SPIN is a
    compare-and-swap loop on shared memory, ATOMS.ADD a native add there,
    RED/ATOM.E.ADD an add in L2."""
    text = subprocess.run([str(cuobjdump), "-sass", str(binary)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if fragment in name:
            out[name] = dict(collections.Counter(re.findall(
                r"\s((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[\w.]*)", part)))
            log(f"[sass] {name[:100]}: {out[name]}")
    return out


def sass_opcodes(cuobjdump: Path, binary: Path, fragment: str) -> dict:
    """The SASS instructions of each kernel of `binary` whose name holds
    `fragment`: their number and the ten commonest opcodes."""
    text = subprocess.run([str(cuobjdump), "-sass", str(binary)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if fragment in name:
            ops = collections.Counter(m.split(".")[0] for m in re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", part))
            out[name] = {"instructions": sum(ops.values()),
                         **dict(ops.most_common(10))}
            log(f"[sass] {name[:100]}: {out[name]}")
    return out


def sass(build) -> dict:
    """The atomic instructions of the built library's P2G kernels, and of
    a probe of float and double atomicAdd on shared memory built for the
    library's target; the instruction counts of the FLIP G2P, set_bnd,
    n-body and 3-D wavespeed kernels."""
    nvcc = Path(build.find_nvcc())
    cuobjdump = nvcc.parent / "cuobjdump"
    lib = build._lib_path(build.find_nvcc())  # the one this process built
    src = build.build_dir() / "sass_probe.cu"
    src.write_text(SASS_PROBE)
    cubin = src.with_suffix(".cubin")
    subprocess.run([str(nvcc), *build.NVCC_FLAGS[:2], "-cubin", "-o",
                    str(cubin), str(src)], check=True, capture_output=True)
    return {"p2g": sass_atomics(cuobjdump, lib, "p2g"),
            "shared_add": sass_atomics(cuobjdump, cubin, "shared_add"),
            "g2p": sass_opcodes(cuobjdump, lib, "10g2p_kernel"),
            "set_bnd": sass_opcodes(cuobjdump, lib, "set_bnd_kernel"),
            "nbody": sass_opcodes(cuobjdump, lib, "nbody_repulsion_kernel"),
            "wavespeed3": sass_opcodes(cuobjdump, lib, "wavespeed3_kernel")}


def p2g_timings(m, dev, only, dump) -> dict:
    """ms a launch of each P2G (the design the wrapper picks) on its run's
    final state by CUDA events, by torch.profiler (the P2G kernel's device
    time, and all device work a wrapper call), the host's time a call, and
    the kernel against its plain version there (rel err); where the tree
    has two designs, each one's device time a wrapper call too."""
    res = {}
    for key, solver, n_p, n, dtype, steps, reps in P2G_RUNS:
        if only is not None and key not in only:
            continue
        cfg, parts, mod = p2g_run(m, dev, solver, n_p, n, dtype, steps)
        call = lambda: mod.p2g(cfg, *parts)  # noqa: E731
        res[key] = time_ms(call, reps)
        res[key + " device"] = device_ms(call, reps, "p2g")
        res[key + " device_call"] = device_call_ms(call, reps)
        res[key + " host_us"] = host_us(call, reps)
        got = call()
        res[key + " rel to plain"] = max_rel(got, mod.p2g_plain(cfg, *parts))
        if hasattr(mod, "p2g_stats"):
            res[key + " stats"] = json.dumps(mod.p2g_stats(
                cfg, n_p, cfg.torch_dtype, dev))
            for design in p2g_designs(mod):
                one = lambda: mod._p2g(cfg, *parts, design=design)  # noqa
                res[f"{key} {design} device"] = device_call_ms(one, reps)
        record(res, key, list(parts), list(got), dump)
    return res


def lbm_noisy(m, cfg, dev, seed: int, top_wall: bool = True):
    """init() with the populations scaled by 1 + 0.05 x seeded noise (as
    chip_smoke.py's lbm_state), without the top wall row if asked."""
    s = m.lbm.init(cfg, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    f = s.f * (1.0 + torch.tensor(0.05 * rng.standard_normal(s.f.shape),
                                  dtype=s.f.dtype))
    solid = s.solid.clone()
    if not top_wall:
        solid[-1] = False
    return m.lbm.LBMState(f=f.contiguous().to(dev), solid=solid.to(dev))


def check_lbm(m, dev) -> list:
    """The LBM K-step kernel bitwise equal to K plain steps and to K
    one-step launches."""
    out = []
    for dtype in ("float32", "float64"):
        for nx, ny, top, corner in ((37, 23, True, True),
                                    (200, 75, False, False),
                                    (20, 17, True, False)):
            cfg = m.lbm.LBMConfig(nx=nx, ny=ny, dtype=dtype,
                                  obstacle_radius=4.0)
            s = lbm_noisy(m, cfg, dev, 7, top)
            for k in (1, 3, 8, 16):
                if corner and hasattr(m.lk, "launch_shape"):
                    # a 2x2 obstacle on the corner of the first tile
                    t = m.lk.launch_shape(cfg, k)
                    solid = s.solid.clone()
                    y, x = min(t.tile_y, ny - 2) - 1, min(t.tile_x, nx - 2) - 1
                    solid[y:y + 2, x:x + 2] = True
                    s = s._replace(solid=solid)
                for over in ({}, {"drive": 3e-4}):
                    got = m.lk.lbm_multistep(cfg, s, k, **over)
                    ref = m.lk.lbm_multistep_plain(cfg, s, k, **over)
                    one = s
                    for _ in range(k):
                        one = m.lk.lbm_step(cfg, one, **over)
                    if not (bits_equal(got.f, ref.f)
                            and bits_equal(got.f, one.f)):
                        raise AssertionError(f"lbm {nx}x{ny} {dtype} K={k} "
                                             f"{over}: not bitwise")
                out.append({"case": f"lbm {nx}x{ny} {dtype} K={k}",
                            "bitwise": True})
    torch.cuda.synchronize()
    log(f"[check] lbm K-step: {len(out)} cases bitwise to K plain steps and "
        "to K one-step launches")
    return out


def gs_noisy(m, cfg, dev, seed: int):
    """init() plus seeded normal noise (0.05) on u and v (as
    chip_smoke.py's gs_state)."""
    s = m.gs.init(cfg, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    return m.gs.GrayScottState(*(
        (f + torch.tensor(0.05 * rng.standard_normal(tuple(f.shape)),
                          dtype=f.dtype)).to(dev) for f in s))


def check_gs(m, dev) -> list:
    """The Gray–Scott K-step kernel bitwise equal to K plain steps and to
    K one-step launches."""
    out = []
    for dtype in ("float32", "float64"):
        for nx, ny in ((37, 23), (200, 75), (256, 128), (20, 17)):
            cfg = m.gs.GrayScottConfig(nx=nx, ny=ny, dtype=dtype)
            s = gs_noisy(m, cfg, dev, 7)
            for k in (1, 3, 16, 32):
                for over in ({}, {"feed": 0.04, "kill": 0.058}):
                    got = m.gk.gs_multistep(cfg, s, k, **over)
                    ref = m.gk.gs_multistep_plain(cfg, s, k, **over)
                    one = s
                    for _ in range(k):
                        one = m.gk.gs_step(cfg, one, **over)
                    if not all(bits_equal(a, b) and bits_equal(a, c)
                               for a, b, c in zip(got, ref, one)):
                        raise AssertionError(f"gs {nx}x{ny} {dtype} K={k} "
                                             f"{over}: not bitwise")
                shape = (m.gk.launch_shape(cfg, k).asdict()
                         if hasattr(m.gk, "launch_shape") else None)
                out.append({"case": f"gs {nx}x{ny} {dtype} K={k}",
                            "bitwise": True, "launch": shape})
    torch.cuda.synchronize()
    log(f"[check] gs K-step: {len(out)} cases bitwise to K plain steps and "
        "to K one-step launches")
    return out


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same bits (NaN payloads and the sign of zero included)."""
    it = torch.int32 if a.element_size() == 4 else torch.int64
    return a.dtype == b.dtype and torch.equal(a.view(it), b.view(it))


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def hyp_main_call(m, dim, size, dtype, steps, dev):
    """(the step kernel's call on the final state of the main run, the
    fields of that state), as chip_smoke.py times it."""
    if dim == 2:
        nx, ny = size
        cfg = m.h2.default_config(nx=nx, ny=ny, dtype=dtype)
        out = m.h2.run(cfg, m.h2.init(cfg, dev), steps)
        dt = torch.full((), 1e-3, dtype=cfg.torch_dtype, device=dev)
        return (lambda: m.hk.step_core(cfg, out.U, out.mask, dt)), list(out.U)
    cfg = m.h3.default_config(size, dtype=dtype)
    out = m.h3.run(cfg, m.h3.init(cfg, dev), steps)
    sp = m.h3.solid_pad_of(cfg, dev)
    qp = m.h3._padded_prims(cfg, m.h3._decode(cfg, *out[:6]), sp)
    dt = torch.full((), 1e-6, dtype=cfg.torch_dtype, device=dev)
    g = torch.full((), 1.0, dtype=cfg.torch_dtype, device=dev)
    return (lambda: m.hk3.step_core(cfg, qp, sp, dt, g)), list(out[:6])


def record(res: dict, key: str, state, out, dump) -> None:
    """The sha256 digests of a key's final state and of the kernel's output
    on it, and with `dump` both saved for `diff`."""
    res[key + " state sha256"] = digest(state)
    res[key + " out sha256"] = digest(out)
    if dump:
        Path(dump).mkdir(parents=True, exist_ok=True)
        torch.save({"state": [t.cpu() for t in state],
                    "out": [t.cpu() for t in out]},
                   Path(dump) / (key.replace(" ", "_").replace("^", "")
                                 + ".pt"))


def hyp_timings(m, dev, only, dump) -> dict:
    res = {}
    for key, dim, size, dtype, steps, n in HYP_RUNS:
        if only is not None and key not in only:
            continue
        call, state = hyp_main_call(m, dim, size, dtype, steps, dev)
        res[key] = time_ms(call, n)
        res[key + " device"] = device_ms(
            call, n, "step_kernel" if dim == 2 else "step3_kernel")
        record(res, key, state, list(call()), dump)
    return res


# The MHD K-step kernel (#8) at chip_smoke.py's MHD runs: (key, config
# fields, steps of the run, k a launch, launches timed).
MHD_RUNS = (("mhd 320x220 f32 K=8", dict(nx=320, ny=220), 4000, 8, 100),
            ("mhd 320x220 f32 K=1", dict(nx=320, ny=220), 4000, 1, 400),
            ("mhd 2048x2048 ot f32 K=8",
             dict(nx=2048, ny=2048, problem="orszag-tang"), 200, 8, 10),
            ("mhd 320x220 f64 K=8", dict(nx=320, ny=220, dtype="float64"),
             1000, 8, 100))
MHD_KEYS = tuple(r[0] for r in MHD_RUNS)


def mhd_timings(m, dev, only, dump) -> dict:
    """ms a launch of the MHD kernel on the final state of each run
    (K=1 also as device time and the host's time a wrapper call), with
    the digests of that state and of the launch's output."""
    res = {}
    for key, fields, steps, k, n in MHD_RUNS:
        if only is not None and key not in only:
            continue
        cfg = m.mhd.MHDConfig(**fields, block_k=k)
        out = m.mhd.run(cfg, m.mhd.init(cfg, dev), steps)
        res[key] = time_ms(lambda: m.mk.mhd_multistep(cfg, out, k), n)
        if k == 1:
            res[key + " device"] = device_ms(
                lambda: m.mk.mhd_multistep(cfg, out, k), n, "mhd_multistep")
            res[key + " host_us"] = host_us(
                lambda: m.mk.mhd_multistep(cfg, out, k), 200)
        got = m.mk.mhd_multistep(cfg, out, k)
        record(res, key, [*out.U, out.t], [*got.U, got.t], dump)
    return res


# The SPH density and forces kernels (#14, #15) at chip_smoke.py's SPH
# runs: (key, particles, rain, steps of the run, launches timed).
SPH_RUNS = (("sph 65536 f32", 65536, False, 200, 50),
            ("sph 1048576 f32 rain", 1 << 20, True, 50, 20))
SPH_KEYS = tuple(r[0] for r in SPH_RUNS)


def sph_timings(m, dev, only, dump) -> dict:
    """ms a launch of the forces kernel (the key) and of the density
    kernel (the key + " density"), each also as device time, on the
    binning (and density) of each run's final state, with the digests of
    that state and of the forces launch's output."""
    res = {}
    for key, n_p, rain, steps, n in SPH_RUNS:
        if only is not None and key not in only:
            continue
        cfg = m.ts.SPHConfig(n=n_p, rain=rain)
        out = m.ts.run(cfg, m.ts.init(cfg, dev), steps)
        b = m.sk.binning(cfg, out.pos, out.vel)
        rp = m.sk.density(cfg, b)
        dt = m.ts._frame_dt(cfg, out, None)
        res[key] = time_ms(lambda: m.sk.forces(cfg, b, rp, dt), n)
        res[key + " device"] = device_ms(lambda: m.sk.forces(cfg, b, rp, dt),
                                         n, "forces_kernel")
        res[key + " density"] = time_ms(lambda: m.sk.density(cfg, b), n)
        res[key + " density device"] = device_ms(
            lambda: m.sk.density(cfg, b), n, "density_kernel")
        record(res, key, [out.pos, out.vel], list(m.sk.forces(cfg, b, rp, dt)),
               dump)
    return res


# The FLIP grid phase (#17) at chip_smoke.py's FLIP runs: (key, particles,
# grid, dtype, steps of the run, launches timed).
FLIP_RUNS = (("flip 128 f32", 65536, 128, "float32", 1000, 200),
             ("flip 128 f64", 65536, 128, "float64", 200, 200),
             ("flip 512 f32", 1 << 20, 512, "float32", 200, 100))
FLIP_KEYS = tuple(r[0] for r in FLIP_RUNS)


def flip_timings(m, dev, only, dump) -> dict:
    """ms a launch of the grid phase (also as device time) on the P2G grids
    of each run's final state, with the digests of that state and of the
    launch's output."""
    res = {}
    for key, n_p, n, dtype, steps, reps in FLIP_RUNS:
        if only is not None and key not in only:
            continue
        cfg = m.fa.FlipApicConfig(particles=n_p, grid=n, dtype=dtype)
        out = m.fa.run(cfg, m.fa.init(cfg, dev), steps)
        grids = m.fk.p2g(cfg, out.pos, out.vel, out.affine_x, out.affine_y)
        res[key] = time_ms(lambda: m.fk.grid_phase(cfg, *grids), reps)
        res[key + " device"] = device_ms(
            lambda: m.fk.grid_phase(cfg, *grids), reps, "grid_kernel")
        res[key + " host_us"] = host_us(
            lambda: m.fk.grid_phase(cfg, *grids), reps)
        got = list(m.fk.grid_phase(cfg, *grids))
        # the P2G's atomics make each run's grids differ in their last
        # bits, so the digests of two trees differ; the kernel is held to
        # its plain version on the same grids instead
        res[key + " bitwise to plain"] = all(
            bits_equal(a, b) for a, b in
            zip(got, m.fk.grid_phase_plain(cfg, *grids)))
        record(res, key, list(grids), got, dump)
    return res


# The LBM kernels (#6 K-step, #5 one-step) at chip_smoke.py's LBM runs:
# (key, dtype, steps of the run, k a launch: 1 is the one-step kernel,
# launches timed).
LBM_RUNS = (("lbm 2048x1024 f32 K=8", "float32", 1000, 8, 50),
            ("lbm 2048x1024 f32 K=1", "float32", 1000, 1, 200),
            ("lbm 2048x1024 f64 K=8", "float64", 200, 8, 20),
            ("lbm 2048x1024 f64 K=1", "float64", 200, 1, 100))
LBM_KEYS = tuple(r[0] for r in LBM_RUNS)


def lbm_timings(m, dev, only, dump) -> dict:
    """ms a launch of the K-step kernel at K=8 and of the one-step kernel
    (also as device time) on the final state of the LBM run at block_k 8,
    with the digests of that state and of the launch's output."""
    res, states = {}, {}
    for key, dtype, steps, k, reps in LBM_RUNS:
        if only is not None and key not in only:
            continue
        cfg = m.lbm.LBMConfig(nx=2048, ny=1024, dtype=dtype)
        if dtype not in states:
            states[dtype] = m.lbm.run(cfg, m.lbm.init(cfg, dev), steps)
        s = states[dtype]
        call = ((lambda: m.lk.lbm_multistep(cfg, s, k)) if k > 1
                else (lambda: m.lk.lbm_step(cfg, s)))
        res[key] = time_ms(call, reps)
        res[key + " device"] = device_ms(
            call, reps, "multistep_kernel" if k > 1 else "step_kernel")
        record(res, key, [s.f], [call().f], dump)
    return res


# The Gray–Scott kernels (#4 K-step, #3 one-step) at chip_smoke.py's
# Gray–Scott runs: (key, dtype, steps of the run, k a launch: 1 is the
# one-step kernel, launches timed).
GS_RUNS = (("gs 2048x2048 f32 K=16", "float32", 2000, 16, 50),
           ("gs 2048x2048 f32 K=1", "float32", 2000, 1, 400),
           ("gs 2048x2048 f64 K=16", "float64", 400, 16, 20),
           ("gs 2048x2048 f64 K=1", "float64", 400, 1, 200))
GS_KEYS = tuple(r[0] for r in GS_RUNS)


def gs_timings(m, dev, only, dump) -> dict:
    """ms a launch of the K-step kernel at K=16 and of the one-step kernel
    (also as device time) on the final state of the Gray–Scott run of
    each dtype, with the digests of that state and of the launch's
    output, and the K-step launch's shape where the tree reports it."""
    res, states = {}, {}
    for key, dtype, steps, k, reps in GS_RUNS:
        if only is not None and key not in only:
            continue
        cfg = m.gs.GrayScottConfig(nx=2048, ny=2048, dtype=dtype)
        if dtype not in states:
            states[dtype] = m.gs.run(cfg, m.gs.init(cfg, dev), steps)
        s = states[dtype]
        call = ((lambda: m.gk.gs_multistep(cfg, s, k)) if k > 1
                else (lambda: m.gk.gs_step(cfg, s)))
        res[key] = time_ms(call, reps)
        res[key + " device"] = device_ms(
            call, reps, "multistep_kernel" if k > 1 else "step_kernel")
        if k > 1 and hasattr(m.gk, "launch_shape"):
            res[key + " launch"] = json.dumps(
                m.gk.launch_shape(cfg, k).asdict())
        record(res, key, list(s), list(call()), dump)
    return res


def smoke():
    """This tool's own tree's chip_smoke.py (whatever --root is): the case
    lists and checks of the G2P and set_bnd that `check` runs."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_g2p(m, dev) -> list:
    """The FLIP G2P bitwise equal to its plain version, the raster counting
    every particle: chip_smoke.py's phase-19 cases (G2P_CHECK)."""
    cs = smoke()
    errs = {"g2p": 0.0, "g2p_bitwise": [0, 0]}
    cs.check_g2p_cases(m.fk, m.fa, dev, errs)
    torch.cuda.synchronize()
    return [{"case": f"g2p {cs.G2P_CHECK}, f32 and f64, two blends",
             "bitwise": errs["g2p_bitwise"]}]


def check_bin(m, dev) -> list:
    """The SPH bin bitwise equal to its plain version in all five outputs:
    chip_smoke.py's phase-6 cases (BIN_CHECK)."""
    cs = smoke()
    errs = {}
    cs.check_bin_cases(m.sk, m.ts, dev, errs)
    torch.cuda.synchronize()
    return [{"case": f"bin {[c[0] for c in cs.BIN_CHECK]}",
             "bitwise": errs["bin_bitwise"]}]


def check_advect(m, dev) -> list:
    """The stam2d advection bitwise equal to its plain version, one field
    and the velocity pair, f32 and f64: chip_smoke.py's ADVECT_CHECK_N."""
    cs = smoke()
    errs = {}
    cs.check_advect_cases(m.s2k, m.s2, dev, errs)
    torch.cuda.synchronize()
    return [{"case": f"advect n = {cs.ADVECT_CHECK_N}",
             "bitwise": errs["advect_bitwise"]}]


def check_set_bnd(m, dev) -> list:
    """stam3d set_bnd bitwise equal to its plain version: chip_smoke.py's
    phase-15 cases (SET_BND_CHECK_N)."""
    cs = smoke()
    errs = {"set_bnd_bitwise": 0}
    cs.check_set_bnd_cases(m.sc, dev, errs)
    torch.cuda.synchronize()
    return [{"case": f"set_bnd n = {cs.SET_BND_CHECK_N}, f32 and f64",
             "bitwise": errs["set_bnd_bitwise"]}]


# The FLIP G2P (#18) at chip_smoke.py's FLIP runs: (key, particles, grid,
# dtype, steps of the run, launches timed).
G2P_RUNS = (("g2p flip 128 f32", 65536, 128, "float32", 1000, 200),
            ("g2p flip 128 f64", 65536, 128, "float64", 200, 200),
            ("g2p flip 512 f32", 1 << 20, 512, "float32", 200, 100))
G2P_KEYS = tuple(r[0] for r in G2P_RUNS)


def g2p_inputs(m, dev, key, cfg, steps, inputs) -> list:
    """(pos, vel, u_prev, v_prev, u_proj, v_proj) of the G2P on the final
    state of a G2P_RUNS run: from `inputs`/<key>.pt where saved, else from
    the run (its P2G's atomics land in no fixed order, so two runs differ
    in their last bits), saved there for the next process."""
    path = Path(inputs) / (key.replace(" ", "_") + ".pt") if inputs else None
    if path is not None and path.is_file():
        return [t.to(dev) for t in torch.load(path)]
    out = m.fa.run(cfg, m.fa.init(cfg, dev), steps)
    grids = m.fk.p2g(cfg, out.pos, out.vel, out.affine_x, out.affine_y)
    got = [out.pos, out.vel, *m.fk.grid_phase(cfg, *grids)]
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save([t.cpu() for t in got], path)
    return got


def g2p_timings(m, dev, only, dump, inputs) -> dict:
    """ms a launch of the FLIP G2P by CUDA events and torch.profiler on the
    inputs of g2p_inputs, whether it is bitwise to its plain version
    there, its launch where the tree reports it, and the digests of the
    inputs and the outputs (`inputs` shared by two trees: the same bits)."""
    res = {}
    for key, n_p, n, dtype, steps, reps in G2P_RUNS:
        if only is not None and key not in only:
            continue
        cfg = m.fa.FlipApicConfig(particles=n_p, grid=n, dtype=dtype)
        args = g2p_inputs(m, dev, key, cfg, steps, inputs)
        call = lambda: m.fk.g2p(cfg, *args)  # noqa: E731
        res[key] = time_ms(call, reps)
        res[key + " device"] = device_ms(call, reps, "::g2p_kernel")
        res[key + " host_us"] = host_us(call, reps)
        got = list(call())
        res[key + " bitwise to plain"] = all(
            bits_equal(a, b) for a, b in zip(got, m.fk.g2p_plain(cfg, *args)))
        if hasattr(m.fk, "g2p_launch"):
            res[key + " launch"] = json.dumps(
                m.fk.g2p_launch(n_p, cfg.torch_dtype).asdict())
        record(res, key, args, got, dump)
    return res


# The stam3d set_bnd (#13) at chip_smoke.py's stam3d runs: (key, n, dtype,
# steps of the run, launches timed).
SET_BND_RUNS = (("set_bnd 192 f32", 192, "float32", 100, 200),
                ("set_bnd 192 f64", 192, "float64", 20, 200))
SET_BND_KEYS = tuple(r[0] for r in SET_BND_RUNS)


def set_bnd_timings(m, dev, only, dump) -> dict:
    """ms a launch of set_bnd by CUDA events and torch.profiler on the
    four fields of each stam3d run's final state (in place: a second
    launch writes the bits of the first), its launch where the tree
    reports it, and the digests of the run's final state (all eight
    fields: no atomics, so two trees give the same bits) and of one
    launch's output."""
    res = {}
    for key, n, dtype, steps, reps in SET_BND_RUNS:
        if only is not None and key not in only:
            continue
        cfg = m.s3.Stam3DConfig(n=n, dtype=dtype)
        out = m.s3.run(cfg, m.s3.init(cfg, dev), steps)
        bnd = [f.clone() for f in (out.u, out.v, out.w, out.d)]
        call = lambda: m.sc.set_bnd(*bnd)  # noqa: E731
        res[key] = time_ms(call, reps)
        res[key + " device"] = device_ms(call, reps, "set_bnd_kernel")
        ref = [f.clone() for f in (out.u, out.v, out.w, out.d)]
        m.sc.set_bnd_plain(*ref)
        res[key + " bitwise to plain"] = all(
            bits_equal(a, b) for a, b in zip(bnd, ref))
        if hasattr(m.sc, "set_bnd_launch"):
            res[key + " launch"] = json.dumps(m.sc.set_bnd_launch(n).asdict())
        # the Jacobi sweep (#11) of the projection's solve on that state
        buf = out.w0.clone()
        sweep = lambda: m.sc.jacobi(out.u, out.v, buf, 1.0, 6.0)  # noqa: E731
        res[key + " jacobi"] = time_ms(sweep, reps)
        res[key + " jacobi device"] = device_ms(sweep, reps, "jacobi_kernel")
        record(res, key, list(out[:8]), bnd, dump)
    return res


def device_parts(fn, n: int) -> dict:
    """Device time a call of fn by torch.profiler, by kernel name (without
    its namespaces, template arguments and parameters): ms a call of each,
    over n calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"::(\w+)[<(]", e.name)
            name = m.group(1) if m else e.name.split(" (")[0].strip()
            out[name] += (e.time_range.end - e.time_range.start) / n / 1e3
    return dict(out)


# The SPH bin (#22) at chip_smoke.py's SPH runs: (key, particles, rain,
# steps of the run, calls timed).
BIN_RUNS = (("bin 65536 f32", 65536, False, 200, 200),
            ("bin 1048576 f32 rain", 1 << 20, True, 50, 100))
BIN_KEYS = tuple(r[0] for r in BIN_RUNS)


def cell_stats(b, M: int) -> dict:
    """How full the cells of a binning are: the empty ones, the largest,
    and the cells of more than 32, 256 and 2048 members with the
    particles they hold."""
    counts = torch.bincount(b.cid.long(), minlength=M)
    out = {"cells": M, "empty": int((counts == 0).sum()),
           "largest": int(counts.max())}
    for edge in (32, 256, 2048):
        big = counts > edge
        out[f"over {edge}"] = [int(big.sum()), int(counts[big].sum())]
    return out


def bin_timings(m, dev, only, dump) -> dict:
    """ms a call of the bin by CUDA events, its device time (all device
    work of a call: the parent's memset and four kernels, or this tree's
    two launches) in all and by kernel, and the host's time a
    wrapper call, on the final state of each SPH run; whether it is
    bitwise to its plain version there, how full the cells are, its
    launch and grid syncs where the tree reports them, and the digests of
    the run's final state and of the bin's outputs."""
    res = {}
    for key, n_p, rain, steps, reps in BIN_RUNS:
        if only is not None and key not in only:
            continue
        cfg = m.ts.SPHConfig(n=n_p, rain=rain)
        out = m.ts.run(cfg, m.ts.init(cfg, dev), steps)
        call = lambda: m.sk.binning(cfg, out.pos, out.vel)  # noqa: E731
        res[key] = time_ms(call, reps)
        parts = device_parts(call, reps)
        res[key + " device"] = sum(parts.values())
        res[key + " device parts"] = json.dumps(parts)
        res[key + " host_us"] = host_us(call, reps)
        got = call()
        res[key + " bitwise to plain"] = all(
            bits_equal(a, b) for a, b in zip(
                got, m.sk.binning_plain(cfg, out.pos, out.vel)))
        g = cfg.grid()
        res[key + " cells"] = json.dumps(cell_stats(got, g.Gx * g.Gy))
        if hasattr(m.sk, "bin_launch"):
            res[key + " launch"] = json.dumps(m.sk.bin_launch(
                n_p, g.Gx * g.Gy, cfg.torch_dtype, dev.index).asdict())
            res[key + " grid syncs"] = json.dumps(
                m.sk.bin_grid_syncs(cfg, cfg.torch_dtype, dev))
        record(res, key, [out.pos, out.vel], list(got), dump)
    return res


# The stam2d advection (#10) at chip_smoke.py's stam2d runs: (key, dtype,
# steps of the run, calls timed).
ADVECT_RUNS = (("advect 512 f32", "float32", 400, 400),
               ("advect 512 f64", "float64", 400, 400))
ADVECT_KEYS = tuple(r[0] for r in ADVECT_RUNS)


def advect_timings(m, dev, only, dump) -> dict:
    """ms a launch of the advection by CUDA events and torch.profiler on
    the final state of each stam2d run, as the step makes it: the
    velocity pair (the key) and the density ("<key> density"); whether
    each is bitwise to its plain version, and the digests of the run's
    final state (no atomics: two trees give the same bits) and of both
    launches' outputs."""
    res = {}
    for key, dtype, steps, reps in ADVECT_RUNS:
        if only is not None and key not in only:
            continue
        cfg = m.s2.Stam2DConfig(dtype=dtype)
        out = m.s2.run(cfg, m.s2.init(cfg, dev), steps)
        calls = {"": ((out.u0, out.v0), out.u0, out.v0),
                 " density": ((out.d0,), out.u, out.v)}
        got = []
        for part, (qs, uu, vv) in calls.items():
            call = lambda: m.s2k.advect(cfg, qs, uu, vv)  # noqa: E731
            res[key + part] = time_ms(call, reps)
            res[key + part + " device"] = device_ms(call, reps,
                                                    "advect_kernel")
            res[key + part + " host_us"] = host_us(call, reps)
            outs = call()
            res[key + part + " bitwise to plain"] = all(
                bits_equal(a, b) for a, b in zip(
                    outs, m.s2k.advect_plain(cfg, qs, uu, vv)))
            got += list(outs)
        record(res, key, list(out[:6]), got, dump)
    return res


# The MPM grid update (#20) and G2P (#21) at chip_smoke.py's MPM runs:
# (key, particles, grid, dtype, steps of the run, launches timed).
MPM_RUNS = (("mpm 96 f32", 32768, 96, "float32", 1000, 200),
            ("mpm 96 f64", 32768, 96, "float64", 200, 200),
            ("mpm 512 f32", 1 << 20, 512, "float32", 200, 100))
MPM_KEYS = tuple(r[0] for r in MPM_RUNS)


def mpm_inputs(m, dev, key, cfg, steps, inputs) -> list:
    """(pos, F, Jp, mass, mom_x, mom_y): the P2G grids of the final state
    of an MPM_RUNS run and its particles, from `inputs`/<key>.pt where
    saved, else from the run (its P2G's adds land in no fixed order, so
    two runs differ in their last bits), saved there for the next
    process."""
    path = Path(inputs) / (key.replace(" ", "_") + ".pt") if inputs else None
    if path is not None and path.is_file():
        return [t.to(dev) for t in torch.load(path)]
    out = m.mp.run(cfg, m.mp.init(cfg, dev), steps)
    got = [out.pos, out.F, out.Jp,
           *m.mpk.p2g(cfg, out.pos, out.vel, out.F, out.Jp)]
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save([t.cpu() for t in got], path)
    return got


def mpm_window_shape(m) -> tuple[int, int] | None:
    """(threads a block, nodes a block's window) of the tree's MPM G2P as
    built (the source's defaults, or --define's), or None for a G2P
    without a window."""
    from fluidsims_tpu_torch.kernels import _build
    src = (Path(m.mpk.__file__).parents[1] / "csrc" / "mpm_g2p.cu").read_text()
    shape = []
    for name in ("FST_MPM_G2P_THREADS", "FST_MPM_G2P_WINDOW"):
        got = re.search(rf"#define {name} (\d+)", src)
        if got is None:
            return None
        for flag in _build.NVCC_FLAGS:
            got = re.match(rf"-D{name}=(\d+)", flag) or got
        shape.append(int(got.group(1)))
    return tuple(shape)


def mpm_windows(cfg, pos, threads: int, window: int) -> dict:
    """The G2P's blocks on these particles as csrc/mpm_g2p.cu forms them:
    each block's box of the in-grid nodes its particles gather, how many
    blocks form it in a window (at most `window` nodes), and the box's
    nodes at the median and at most."""
    base = torch.floor(pos * (1.0 / cfg.dx) - 0.5).long()
    lo = base.clamp(min=0)
    hi = torch.minimum(base + 2, torch.tensor([cfg.gx - 1, cfg.gy - 1],
                                              device=pos.device))
    empty = (lo > hi).any(1, keepdim=True)
    big = 1 << 30
    lo = torch.where(empty, big, lo)
    hi = torch.where(empty, -big, hi)
    pad = -pos.shape[0] % threads
    lo = torch.cat([lo, lo.new_full((pad, 2), big)]).view(-1, threads, 2)
    hi = torch.cat([hi, hi.new_full((pad, 2), -big)]).view(-1, threads, 2)
    side = (hi.amax(1) - lo.amin(1) + 1).clamp(min=0)
    nodes = side[:, 0] * side[:, 1]
    return {"blocks": nodes.numel(),
            "windowed": int(((nodes > 0) & (nodes <= window)).sum()),
            "median_nodes": int(nodes.median()),
            "most_nodes": int(nodes.max())}


def mpm_step(m, cfg, pos, F, Jp, grids):
    """The step's grid update and G2P on the P2G grids: the tree's one
    call, or, for a tree with a grid-update launch, its two back to
    back."""
    if hasattr(m.mpk, "grid_update"):
        return lambda: m.mpk.g2p(cfg, pos, F, Jp,
                                 *m.mpk.grid_update(cfg, *grids))
    return lambda: m.mpk.g2p(cfg, pos, F, Jp, *grids)


# Where the one launch and the parent's two cross: particles, with the grid
# that keeps MPMConfig()'s particles a cell (32,768 on 96^2), each run 200
# steps from init.
MPM_SWITCH = (65536, 131072, 262144, 524288)


def mpm_switch_timings(m, dev, only) -> dict:
    """Device time of a step's grid update and G2P (one launch, or the
    parent's two) on the P2G grids of the final state of MPM runs of
    MPM_SWITCH's particles: keys "mpm switch <particles> on <grid>^2"."""
    res = {}
    if only is not None and "mpm switch" not in only:
        return res
    for n_p in MPM_SWITCH:
        n = round(96 * (n_p / 32768) ** 0.5)
        cfg = m.mp.MPMConfig(n=n_p, gx=n, gy=n)
        out = m.mp.run(cfg, m.mp.init(cfg, dev), 200)
        grids = m.mpk.p2g(cfg, out.pos, out.vel, out.F, out.Jp)
        step = mpm_step(m, cfg, out.pos, out.F, out.Jp, grids)
        res[f"mpm switch {n_p} on {n}^2"] = sum(
            device_parts(step, 100).values())
    return res


def mpm_timings(m, dev, only, dump, inputs) -> dict:
    """The MPM grid update and G2P of a step on the inputs of mpm_inputs:
    a tree whose G2P reads the P2G grids times its one launch ("<key>
    g2p"), a tree with a grid-update launch both ("<key> grid", "<key>
    g2p"), each by CUDA events, torch.profiler's device time and the
    host's time a wrapper call (`host_us`); and for both kinds the step's
    part ("<key> step": the one call, or the two back to back) by events
    and as device time in all, whether its outputs are bitwise those of
    the G2P of the plain grid update's node velocities, the G2P blocks'
    windows where the tree's kernel forms them ("<key> windows"), and the
    digests of the inputs and the outputs (`inputs` shared by two trees:
    the same bits)."""
    res = {}
    for key, n_p, n, dtype, steps, reps in MPM_RUNS:
        if only is not None and key not in only:
            continue
        cfg = m.mp.MPMConfig(n=n_p, gx=n, gy=n, dtype=dtype)
        args = mpm_inputs(m, dev, key, cfg, steps, inputs)
        pos, F, Jp, *grids = args
        step = mpm_step(m, cfg, pos, F, Jp, grids)
        calls = {"g2p": (step, "mpm_g2p_kernel")}
        if hasattr(m.mpk, "grid_update"):
            vels = m.mpk.grid_update(cfg, *grids)
            calls = {"grid": (lambda: m.mpk.grid_update(cfg, *grids),
                              "mpm_grid_kernel"),
                     "g2p": (lambda: m.mpk.g2p(cfg, pos, F, Jp, *vels),
                             "mpm_g2p_kernel")}
        for name, (call, frag) in calls.items():
            res[f"{key} {name}"] = time_ms(call, reps)
            res[f"{key} {name} device"] = device_ms(call, reps, frag)
            res[f"{key} {name} host_us"] = host_us(call, reps)
        shape = mpm_window_shape(m)
        if shape is not None:
            res[f"{key} windows"] = json.dumps(mpm_windows(cfg, pos, *shape))
        res[f"{key} step"] = time_ms(step, reps)
        parts = device_parts(step, reps)
        res[f"{key} step device"] = sum(parts.values())
        res[f"{key} step device parts"] = json.dumps(parts)
        got = list(step())
        res[f"{key} bitwise to plain"] = all(
            bits_equal(a, b) for a, b in zip(got, m.mp._g2p(
                cfg, pos, F, Jp, *m.mp._grid_update(cfg, *grids))))
        record(res, key, args, got, dump)
    return res


def check_mpm(m, dev) -> list:
    """chip_smoke.py's phase 21 on a tree whose G2P reads the P2G grids:
    the P2G within its bars, the G2P with its grid update bitwise equal to
    g2p_plain on every case, 5 cuda steps against scatter (none for a
    tree with a grid-update launch)."""
    if hasattr(m.mpk, "grid_update"):
        return []
    errs = smoke().phase_mpm_kernels(m.mpk, m.mp, dev)
    torch.cuda.synchronize()
    return [{"case": "mpm phase 21", "g2p_bitwise": errs["g2p_bitwise"],
             "rel": errs["rel"]}]


# Where the P2G designs cross (FST_P2G_TILED_FROM, csrc/p2g_tiles.cuh):
# particles, with the grid that keeps chip_smoke.py's particles a cell
# (FLIP 4, MPM 32,768 on 96^2), each run 200 steps.
P2G_SWITCH = (65536, 131072, 196608, 262144)


def p2g_switch_timings(m, dev, only) -> dict:
    """Device time a wrapper call of each P2G design (all device work:
    the atomic design's memset too) on the final state of FLIP and MPM
    runs of P2G_SWITCH's particles: keys "p2g switch <solver> <particles>
    <design>"."""
    res = {}
    if only is not None and "p2g switch" not in only:
        return res
    for n_p in P2G_SWITCH:
        for solver in ("flip", "mpm"):
            n = round((n_p / 4) ** 0.5 if solver == "flip"
                      else 96 * (n_p / 32768) ** 0.5)
            cfg, parts, mod = p2g_run(m, dev, solver, n_p, n, "float32", 200)
            for design in p2g_designs(mod):
                call = lambda: mod._p2g(cfg, *parts, design=design)  # noqa
                res[f"p2g switch {solver} {n_p} on {n}^2 {design}"] = \
                    device_call_ms(call, 100)
    return res


# The n-body exact repulsion at chip_smoke.py's phase 24 runs: (key, dims,
# dtype, steps of the run, launches timed), 2^17 bodies.
NBODY_RUNS = (("nbody 2-D f32", 2, "float32", 20, 10),
              ("nbody 3-D f32", 3, "float32", 20, 10),
              ("nbody 2-D f64", 2, "float64", 10, 5))
NBODY_KEYS = tuple(r[0] for r in NBODY_RUNS)
NBODY_N = 1 << 17


def nbody_inputs(m, dev, key, cfg, steps, inputs) -> torch.Tensor:
    """The positions of the final state of an NBODY_RUNS run: from
    `inputs`/<key>.pt where saved, else from the run through this tree's
    kernel (two trees' kernels round differently, so their runs differ),
    saved there for the next process."""
    path = Path(inputs) / (key.replace(" ", "_") + ".pt") if inputs else None
    if path is not None and path.is_file():
        return torch.load(path).to(dev)
    pos = m.ng.run(cfg, m.ng.init(cfg, dev), steps).pos
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(pos.cpu(), path)
    return pos


def nbody_timings(m, dev, only, dump, inputs) -> dict:
    """ms a launch of the n-body repulsion by CUDA events and
    torch.profiler's device time on the positions of nbody_inputs, the
    error per body over sum |terms| against the f64 plain version there,
    the launch where the tree reports it, and the digests of the positions
    and the forces (`inputs` shared by two trees: the same positions)."""
    res = {}
    for key, dims, dtype, steps, reps in NBODY_RUNS:
        if only is not None and key not in only:
            continue
        cfg = m.ng.GraphLayoutConfig(max_number=NBODY_N, dims=dims,
                                     dtype=dtype)
        pos = nbody_inputs(m, dev, key, cfg, steps, inputs)
        call = lambda: m.nk.repulsion_exact(cfg, pos)  # noqa: E731
        res[key] = time_ms(call, reps)
        res[key + " device"] = device_ms(call, reps, "nbody_repulsion_kernel")
        got = call()
        ref64 = m.nk.repulsion_exact_plain(cfg.replace(dtype="float64"),
                                           pos.double())
        scale = m.nk.term_scale(cfg, pos.double())
        res[key + " err per body"] = float(
            ((got.double() - ref64).abs().amax(-1) / scale).max())
        if hasattr(m.nk, "repulsion_launch"):
            res[key + " launch"] = json.dumps(
                m.nk.repulsion_launch(NBODY_N, cfg.torch_dtype))
        record(res, key, [pos], [got], dump)
    return res


def check_nbody(m, dev) -> list:
    """chip_smoke.py's phase 23: the kernel within 1e-5 (f32) / 1e-12 (f64)
    per body on its cases and tails, 5 steps against the plain hook."""
    errs = smoke().phase_nbody_kernels(m.nk, m.ng, dev)
    torch.cuda.synchronize()
    return [{"case": "nbody phase 23", "f32": errs["f32"],
             "f64": errs["f64"], "cases": errs["cases"],
             "traj": errs["traj"]}]


# The 3-D masked max wavespeed at chip_smoke.py's 3-D runs: (key, n,
# steps of the run, launches timed).
WS3_RUNS = (("wavespeed3 64^3 f32", 64, 400, 400),
            ("wavespeed3 256^3 f32", 256, 20, 100))
WS3_KEYS = tuple(r[0] for r in WS3_RUNS)


def ws3_timings(m, dev, only, dump) -> dict:
    """ms a call of the 3-D wavespeed by CUDA events, the host's time a
    wrapper call, and its device time a
    call in all and by kernel (a memset where the tree makes one) on the
    step's output from the final state of chip_smoke.py's 3-D runs, bitwise
    to plain or not, and the digests of that state and of the result (no
    atomics in the step: two trees give the same state)."""
    res = {}
    for key, n, steps, reps in WS3_RUNS:
        if only is not None and key not in only:
            continue
        cfg = m.h3.default_config(n)
        out = m.h3.run(cfg, m.h3.init(cfg, dev), steps)
        sp = m.h3.solid_pad_of(cfg, dev)
        qp = m.h3._padded_prims(cfg, m.h3._decode(cfg, *out[:6]), sp)
        q1 = m.hk3.step_core(cfg, qp, sp, torch.full((), 1e-6, device=dev),
                             torch.full((), 1.0, device=dev))
        call = lambda: m.hk3.wavespeed(cfg, q1, out.solid)  # noqa: E731
        res[key] = time_ms(call, reps)
        res[key + " host_us"] = host_us(call, reps)
        parts = device_parts(call, reps)
        res[key + " device"] = sum(parts.values())
        res[key + " device parts"] = json.dumps(parts)
        got = call()
        res[key + " bitwise to plain"] = bits_equal(
            got, m.hk3.wavespeed_plain(cfg, q1, out.solid))
        record(res, key, list(out[:6]), [got], dump)
    return res


def check_ws3(m, dev) -> list:
    """chip_smoke.py's wavespeed cases of phase 8: ragged cell counts,
    views, 64^3 and 256^3 f32 and f64 back to back, all bitwise."""
    cases = smoke().check_wavespeed_cases(m.h3, m.hk3, dev)
    torch.cuda.synchronize()
    return [{"case": "wavespeed3 phase 8 cases", "bitwise": cases}]


def diff(a: str, b: str) -> dict:
    """Key by key, two dumps' final states and step outputs: bitwise equal
    or not, the cells whose bits differ, and the max |a - b| over the
    cells finite in both, absolute and relative to max |b|."""
    res = {}
    for pa in sorted(Path(a).glob("*.pt")):
        pb = Path(b) / pa.name
        if not pb.is_file():
            continue
        da, db = torch.load(pa), torch.load(pb)
        for part in ("state", "out"):
            cells = ab = scale = 0.0
            for x, y in zip(da[part], db[part]):
                it = torch.int32 if x.element_size() == 4 else torch.int64
                cells += int((x.view(it) != y.view(it)).sum())
                fin = torch.isfinite(x) & torch.isfinite(y)
                if bool(fin.any()):
                    ab = max(ab, float((x[fin].double()
                                        - y[fin].double()).abs().max()))
                    scale = max(scale, float(y[fin].double().abs().max()))
            key = f"{pa.stem} {part}"
            res[key] = {"bitwise": cells == 0, "cells_differing": int(cells),
                        "max_abs": ab, "max_rel": ab / max(scale, 1e-300)}
            log(f"[diff] {key}: {res[key]}")
    return res


def checks(m, dev, only=None) -> list:
    """The checks of the kernels that `only`'s keys time (all without
    --only)."""
    parts = ((check, KSTEP_KEYS + SOLVE_KEYS), (check_hyp, HYP_KEYS),
             (check_mhd, MHD_KEYS), (check_sph, SPH_KEYS),
             (check_flip, FLIP_KEYS), (check_lbm, LBM_KEYS),
             (check_p2g, P2G_KEYS), (check_gs, GS_KEYS),
             (check_g2p, G2P_KEYS), (check_set_bnd, SET_BND_KEYS),
             (check_bin, BIN_KEYS), (check_advect, ADVECT_KEYS),
             (check_mpm, MPM_KEYS), (check_nbody, NBODY_KEYS),
             (check_ws3, WS3_KEYS))
    return [c for fn, keys in parts if only is None or set(keys) & set(only)
            for c in fn(m, dev)]


def timings(m, dev, only=None, dump=None, inputs=None) -> dict:
    """ms a launch at the main runs' shapes (only: the keys to time)."""
    res = hyp_timings(m, dev, only, dump)
    res.update(mhd_timings(m, dev, only, dump))
    res.update(sph_timings(m, dev, only, dump))
    res.update(flip_timings(m, dev, only, dump))
    res.update(lbm_timings(m, dev, only, dump))
    res.update(p2g_timings(m, dev, only, dump))
    res.update(gs_timings(m, dev, only, dump))
    res.update(g2p_timings(m, dev, only, dump, inputs))
    res.update(set_bnd_timings(m, dev, only, dump))
    res.update(mpm_timings(m, dev, only, dump, inputs))
    res.update(bin_timings(m, dev, only, dump))
    res.update(advect_timings(m, dev, only, dump))
    res.update(p2g_switch_timings(m, dev, only))
    res.update(mpm_switch_timings(m, dev, only))
    res.update(nbody_timings(m, dev, only, dump, inputs))
    res.update(ws3_timings(m, dev, only, dump))
    runs = (("burgers 512 f32 K=16", m.bg, m.bk.burgers_multistep,
             dict(nx=512, ny=512), 16, 50),
            ("burgers 512 f32 K=1", m.bg, m.bk.burgers_multistep,
             dict(nx=512, ny=512), 1, 400),
            ("burgers 4096 f32 K=16", m.bg, m.bk.burgers_multistep,
             dict(nx=4096, ny=4096), 16, 5),
            ("burgers 512 f64 K=16", m.bg, m.bk.burgers_multistep,
             dict(nx=512, ny=512, dtype="float64"), 16, 50),
            ("sw 512 f32 K=8", m.sw, m.swk.sw_multistep,
             dict(nx=512, ny=512), 8, 50),
            ("sw 512 f32 K=1", m.sw, m.swk.sw_multistep,
             dict(nx=512, ny=512), 1, 400),
            ("sw 4096 f32 K=8", m.sw, m.swk.sw_multistep,
             dict(nx=4096, ny=4096), 8, 5),
            ("sw 512 f64 K=8", m.sw, m.swk.sw_multistep,
             dict(nx=512, ny=512, dtype="float64"), 8, 50))
    for key, mod, kern, fields, k, n in runs:
        if only is not None and key not in only:
            continue
        cls = (mod.BurgersConfig if hasattr(mod, "BurgersConfig")
               else mod.ShallowWaterConfig)
        cfg = cls(**fields)
        s = mod.init(cfg, dev)
        res[key] = time_ms(lambda: kern(cfg, s, k), n)
        if k == 1 and only is None:
            res[key + " device"] = device_ms(lambda: kern(cfg, s, k), 200,
                                             "multistep_kernel")
            res[key + " host_us"] = host_us(lambda: kern(cfg, s, k), 200)
            res.update(host_parts(m, key, cfg, s, kern))
    for dtype in (torch.float32, torch.float64):
        key = f"lin_solve 512 {'f32' if dtype == torch.float32 else 'f64'}"
        if only is not None and key not in only:
            continue
        rng = np.random.default_rng(3)
        x, b = (torch.tensor(rng.random((512, 512)), dtype=dtype, device=dev)
                for _ in range(2))
        res[key] = time_ms(lambda: m.s2k.lin_solve(x, b, 1.0, 4.0, 40), 200)
    return res


# The sweep's candidates: the K-step kernels' tiles (FST_TILE_X,
# FST_TILE_Y) and the solve's tiles with threads a block
# (FST_SOLVE_TILE_X, FST_SOLVE_TILE_Y, FST_SOLVE_THREADS) at each of the
# sweeps a grid sync (FST_SOLVE_SWEEPS).
KSTEP_TILES = ((32, 16), (32, 32), (64, 16), (64, 32))
SOLVE_TILES = ((32, 32, 256), (32, 32, 512), (64, 16, 512), (64, 32, 256),
               (64, 32, 512))
SOLVE_SWEEPS = (5, 8, 10)
# The hypersonic sweep: 2-D tiles, float (FST_HYP2D_TILE_X, _Y) and double
# (FST_HYP2D_F64_TILE_X, _Y), and 3-D tiles (FST_HYP3D_TILE_X, _Y, _Z),
# paired into builds, each build timing all four keys.
HYP2D_TILES = (((16, 16), (16, 8)), ((32, 8), (32, 4)), ((16, 8), (16, 4)),
               ((32, 16), (8, 8)))
HYP3D_TILES = ((8, 8, 8), (16, 8, 4), (16, 8, 8), (8, 16, 8))
# The MHD sweep: (f32 tile, f64 tile, threads a block, f32 and f64 blocks
# an SM of __launch_bounds__) of each build.
MHD_VARIANTS = (
    ((16, 15), (16, 7), 128, 5, 3), ((16, 15), (16, 7), 128, 6, 2),
    ((32, 15), (16, 15), 128, 5, 2), ((8, 15), (8, 7), 64, 8, 5),
    ((16, 16), (16, 8), 128, 2, 2), ((16, 15), (16, 7), 128, 4, 4),
    ((32, 15), (16, 7), 256, 2, 3), ((16, 16), (16, 16), 256, 2, 2))
# The SPH sweep: the density kernel's (threads a block, fewest and most
# lanes a particle, lane threads, staged bytes) beside the forces kernel's
# defaults, then the forces kernel's (threads a block, fewest and most
# lanes a particle, staged bytes) beside the density kernel's defaults.
DENSITY_VARIANTS = ((128, 1, 8, 524288, 8192), (128, 2, 8, 524288, 8192),
                    (128, 4, 16, 1048576, 8192), (128, 2, 8, 1048576, 8192),
                    (128, 2, 8, 524288, 24576), (256, 2, 8, 524288, 8192))
SPH_VARIANTS = ((128, 2, 8, 24576), (128, 1, 8, 24576), (128, 4, 8, 24576),
                (128, 2, 4, 24576), (128, 2, 8, 12288), (256, 2, 8, 24576))
# The Gray–Scott K-step sweep: the f32 and the f64 design (threads a
# block, blocks an SM of __launch_bounds__, rows a strip, copies of the
# window) of each build: the sources', each dtype with the other's, and
# others.
GS_VARIANTS = (((1024, 1, 4, 2), (512, 1, 8, 1)),
               ((512, 1, 8, 1), (1024, 1, 4, 2)),
               ((1024, 1, 8, 2), (512, 1, 8, 2)),
               ((512, 1, 8, 2), (256, 2, 8, 1)),
               ((768, 1, 4, 1), (1024, 1, 2, 1)),
               ((768, 1, 4, 2), (512, 1, 8, 1)),
               ((1024, 1, 3, 2), (512, 1, 8, 1)),
               ((1024, 1, 6, 2), (512, 1, 8, 1)))
# The FLIP grid-phase sweep: (sweeps a phase; small-grid tile, threads;
# large-grid tile, threads) of each build.
FLIP_VARIANTS = ((8, (16, 8), 256, (64, 32), 512),
                 (8, (16, 16), 256, (32, 32), 512),
                 (12, (16, 8), 256, (64, 32), 512),
                 (6, (16, 8), 256, (64, 32), 512),
                 (8, (8, 8), 128, (64, 32), 1024),
                 (8, (16, 8), 128, (64, 16), 512),
                 (8, (32, 8), 256, (128, 32), 1024),
                 (8, (32, 16), 512, (32, 64), 512))
# The LBM K-step sweep: (shared memory a block, threads) of each build;
# 115712 and 76800 bytes hold two and three blocks an SM.
LBM_VARIANTS = ((232448, 1024), (232448, 512), (115712, 512),
                (115712, 1024), (76800, 640))
# The P2G sweep: (MPM tile, chunk, threads; FLIP tile, chunk, threads) of
# each build.
P2G_VARIANTS = (((16, 16), 512, 256, (16, 16), 512, 256),
                ((16, 16), 256, 256, (16, 16), 256, 256),
                ((16, 16), 1024, 256, (16, 16), 1024, 256),
                ((16, 16), 1024, 512, (16, 16), 1024, 512),
                ((8, 8), 512, 256, (8, 8), 512, 256),
                ((32, 32), 512, 256, (32, 32), 512, 256),
                ((16, 16), 128, 128, (16, 16), 128, 128))
# The FLIP G2P sweep: (threads a block at f32, at f64) of each build, the
# sources' first.
G2P_VARIANTS = ((64, 256), (128, 256), (256, 128), (32, 512))
# The set_bnd sweep: (threads along a face row, rows) of each build.
SET_BND_VARIANTS = ((32, 8), (32, 4), (64, 4), (128, 2))
# The SPH bin sweep: threads a block of each build.
BIN_VARIANTS = (512, 256, 1024, 128)
# The MPM G2P sweep: (threads a block, nodes a block's window) of each
# build, the source's first.
MPM_G2P_VARIANTS = ((256, 1024), (128, 1024), (64, 1024), (512, 1024),
                    (256, 512))
# The n-body sweep: (threads, targets a thread) f32, the same f64, and
# sources a step of a full tile's loop, of each build, the source's first.
# (Two staging buffers and the library's f64 rsqrt were also timed: both
# slower, and gone from the source; PERF.md says by how much.)
NBODY_VARIANTS = (((256, 2), (512, 1), 16), ((128, 4), (128, 2), 16),
                  ((256, 2), (256, 1), 8), ((128, 2), (128, 1), 8),
                  ((256, 2), (512, 1), 32))
# The 3-D wavespeed sweep: threads a block of each build, the source's
# first.
WS3_VARIANTS = (256, 512, 128)
KSTEP_KEYS = ("burgers 512 f32 K=16", "burgers 4096 f32 K=16",
              "burgers 512 f64 K=16", "sw 512 f32 K=8", "sw 4096 f32 K=8",
              "sw 512 f64 K=8")
SOLVE_KEYS = ("lin_solve 512 f32", "lin_solve 512 f64")


def variants() -> list[tuple[dict, tuple]]:
    """(defines, keys to time) of each build of the sweep: every solve
    candidate, the first len(KSTEP_TILES) of them with a K-step tile too
    (the two kernels are built from sources of their own, so one build
    times both)."""
    out = []
    solve = [(tx, ty, th, h) for tx, ty, th in SOLVE_TILES
             for h in SOLVE_SWEEPS]
    for i, (tx, ty, th, h) in enumerate(solve):
        d = {"FST_SOLVE_TILE_X": tx, "FST_SOLVE_TILE_Y": ty,
             "FST_SOLVE_THREADS": th, "FST_SOLVE_SWEEPS": h}
        keys = SOLVE_KEYS
        if i < len(KSTEP_TILES):
            d["FST_TILE_X"], d["FST_TILE_Y"] = KSTEP_TILES[i]
            keys = SOLVE_KEYS + KSTEP_KEYS
        out.append((d, keys))
    return out


def hyp_variants() -> list[tuple[dict, tuple]]:
    return [({"FST_HYP2D_TILE_X": a[0], "FST_HYP2D_TILE_Y": a[1],
              "FST_HYP2D_F64_TILE_X": a64[0], "FST_HYP2D_F64_TILE_Y": a64[1],
              "FST_HYP3D_TILE_X": b[0], "FST_HYP3D_TILE_Y": b[1],
              "FST_HYP3D_TILE_Z": b[2]}, HYP_KEYS)
            for (a, a64), b in zip(HYP2D_TILES, HYP3D_TILES)]


def mhd_variants() -> list[tuple[dict, tuple]]:
    keys = tuple(k for k in MHD_KEYS if "K=1" not in k)
    return [({"FST_MHD_TILE_X": a[0], "FST_MHD_TILE_Y": a[1],
              "FST_MHD_F64_TILE_X": b[0], "FST_MHD_F64_TILE_Y": b[1],
              "FST_MHD_THREADS": th, "FST_MHD_MIN_BLOCKS": m32,
              "FST_MHD_F64_MIN_BLOCKS": m64}, keys)
            for a, b, th, m32, m64 in MHD_VARIANTS]


def sph_variants() -> list[tuple[dict, tuple]]:
    density = [({"FST_SPH_DENSITY_THREADS": th,
                 "FST_SPH_DENSITY_MIN_LANES": fewest,
                 "FST_SPH_DENSITY_MAX_LANES": most,
                 "FST_SPH_DENSITY_LANE_THREADS": lane_threads,
                 "FST_SPH_DENSITY_STAGE_BYTES": stage}, SPH_KEYS)
               for th, fewest, most, lane_threads, stage in DENSITY_VARIANTS]
    return density + [({"FST_SPH_FORCES_THREADS": th,
                        "FST_SPH_MIN_LANES": fewest,
                        "FST_SPH_MAX_LANES": most,
                        "FST_SPH_STAGE_BYTES": stage}, SPH_KEYS)
                      for th, fewest, most, stage in SPH_VARIANTS[1:]]


def gs_variants() -> list[tuple[dict, tuple]]:
    keys = tuple(k for k in GS_KEYS if not k.endswith(" K=1"))
    names = ("THREADS", "MIN_BLOCKS", "ROWS", "COPIES")
    return [({**{f"FST_GS_{n}": v for n, v in zip(names, f32)},
              **{f"FST_GS_F64_{n}": v for n, v in zip(names, f64)}}, keys)
            for f32, f64 in GS_VARIANTS]


def flip_variants() -> list[tuple[dict, tuple]]:
    return [({"FST_FLIP_SWEEPS": h, "FST_FLIP_SMALL_TILE_X": a[0],
              "FST_FLIP_SMALL_TILE_Y": a[1], "FST_FLIP_SMALL_THREADS": ta,
              "FST_FLIP_TILE_X": b[0], "FST_FLIP_TILE_Y": b[1],
              "FST_FLIP_THREADS": tb}, FLIP_KEYS)
            for h, a, ta, b, tb in FLIP_VARIANTS]


def lbm_variants() -> list[tuple[dict, tuple]]:
    keys = tuple(k for k in LBM_KEYS if "K=1" not in k)
    return [({"FST_LBM_SMEM": smem, "FST_LBM_THREADS": threads}, keys)
            for smem, threads in LBM_VARIANTS]


def p2g_variants() -> list[tuple[dict, tuple]]:
    return [({"FST_MPM_P2G_TILE_X": a[0], "FST_MPM_P2G_TILE_Y": a[1],
              "FST_MPM_P2G_CHUNK": ca, "FST_MPM_P2G_THREADS": ta,
              "FST_FLIP_P2G_TILE_X": b[0], "FST_FLIP_P2G_TILE_Y": b[1],
              "FST_FLIP_P2G_CHUNK": cb, "FST_FLIP_P2G_THREADS": tb}, P2G_KEYS)
            for a, ca, ta, b, cb, tb in P2G_VARIANTS]


def g2p_variants() -> list[tuple[dict, tuple]]:
    return [({"FST_G2P_THREADS": t32, "FST_G2P_F64_THREADS": t64}, G2P_KEYS)
            for t32, t64 in G2P_VARIANTS]


def set_bnd_variants() -> list[tuple[dict, tuple]]:
    return [({"FST_SET_BND_X": x, "FST_SET_BND_ROWS": rows}, SET_BND_KEYS)
            for x, rows in SET_BND_VARIANTS]


def bin_variants() -> list[tuple[dict, tuple]]:
    return [({"FST_BIN_THREADS": t}, BIN_KEYS) for t in BIN_VARIANTS]


def mpm_variants() -> list[tuple[dict, tuple]]:
    return [({"FST_MPM_G2P_THREADS": t, "FST_MPM_G2P_WINDOW": w}, MPM_KEYS)
            for t, w in MPM_G2P_VARIANTS]


def nbody_variants() -> list[tuple[dict, tuple]]:
    return [({"FST_NBODY_THREADS": a[0], "FST_NBODY_TARGETS": a[1],
              "FST_NBODY_F64_THREADS": b[0], "FST_NBODY_F64_TARGETS": b[1],
              "FST_NBODY_UNROLL": unroll}, NBODY_KEYS)
            for a, b, unroll in NBODY_VARIANTS]


def ws3_variants() -> list[tuple[dict, tuple]]:
    return [({"FST_WS3_THREADS": t}, WS3_KEYS) for t in WS3_VARIANTS]


SWEEPS = {"tiles": variants, "hypersonic": hyp_variants, "mhd": mhd_variants,
          "sph": sph_variants, "flip": flip_variants, "lbm": lbm_variants,
          "p2g": p2g_variants, "gs": gs_variants, "g2p": g2p_variants,
          "set_bnd": set_bnd_variants, "bin": bin_variants,
          "mpm": mpm_variants, "nbody": nbody_variants, "ws3": ws3_variants}


def sweep(args) -> list:
    """Each variant built and timed by this script in a process of its
    own; a variant the card refuses (a window past shared memory) is
    recorded as refused."""
    out = []
    tmp = Path(args.out).with_suffix(".variant.json")
    for defines, keys in SWEEPS[args.set]():
        cmd = [sys.executable, __file__, "time", "--root", args.root,
               "--out", str(tmp), "--only", *keys]
        if args.inputs:
            cmd += ["--inputs", args.inputs]
        for name, value in defines.items():
            cmd += ["--define", f"{name}={value}"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tail = (proc.stdout + proc.stderr).strip().splitlines()[-1:]
            out.append({"defines": defines, "refused": tail})
            log(f"[sweep] {defines}: refused ({tail})")
            continue
        got = json.loads(tmp.read_text())
        for key, ms in got["time"].items():
            # the keys' ms a launch and, where timed, their device time (a
            # P2G key's, each design's; an MPM key's G2P and step)
            base = key.removesuffix(" device")
            for design in (" tiled", " atomic", " density", " g2p",
                           " step"):
                base = base.removesuffix(design)
            if not isinstance(ms, float) or base not in keys or (
                    base != key and not key.endswith(" device")):
                continue
            out.append({"defines": defines, "key": key, "ms": ms})
            log(f"[sweep] {defines} {key}: {ms:.4f} ms")
        out.append({"defines": defines, "ptxas": got.get("ptxas", [])})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", nargs="*", default=["check", "time"],
                    help="check, time, sweep, or diff A B")
    ap.add_argument("--root", default=str(ROOT),
                    help="tree to import fluidsims_tpu_torch from")
    ap.add_argument("--out", default="build/tune_tiles_torch.json")
    ap.add_argument("--define", action="append", default=[],
                    help="NAME=VALUE: build the kernels with -DNAME=VALUE")
    ap.add_argument("--only", nargs="*",
                    help="time these keys alone, and check their kernels")
    ap.add_argument("--fmad", action="store_true",
                    help="build with -fmad=true (a measurement only)")
    ap.add_argument("--dump", help="save the hypersonic outputs here")
    ap.add_argument("--inputs",
                    help="keep the G2P keys' inputs here (saved by the "
                    "first process, loaded by the next)")
    ap.add_argument("--set", default="tiles", choices=sorted(SWEEPS),
                    help="the kernels whose tiles `sweep` varies")
    args = ap.parse_args(argv)
    if args.what[:1] == ["diff"]:
        if len(args.what) != 3:
            raise SystemExit("diff takes two dump directories")
        res = {"diff": diff(*args.what[1:])}
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
        return 0
    bad = set(args.what) - {"check", "time", "sweep", "phases", "sass"}
    if bad:
        raise SystemExit(f"unknown: {sorted(bad)}")
    if "phases" in args.what:
        # the stamps are a build of their own, timed by nothing else
        if set(args.what) & {"check", "time", "sweep"}:
            raise SystemExit("phases runs alone or with sass")
        args.define += ["FST_P2G_STAMPS=1", "FST_BIN_STAMPS=1"]
    if not torch.cuda.is_available():
        raise SystemExit("tune_tiles_torch: needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    if "sweep" in args.what:
        log(f"[device] {smi}")
        res = {"device": smi, "sweep": sweep(args)}
        Path(args.out).write_text(json.dumps(res, indent=1))
        return 0
    sys.path.insert(0, str(Path(args.root).resolve()))
    import types

    from fluidsims_tpu_torch.kernels import _build
    # the flags are part of the build's name: a variant builds its own
    flags = _build.NVCC_FLAGS
    if args.fmad:
        flags = tuple("-fmad=true" if f == "-fmad=false" else f
                      for f in flags)
    _build.NVCC_FLAGS = (*flags, *(f"-D{d}" for d in args.define))
    from fluidsims_tpu_torch.kernels import burgers_cuda as bk
    from fluidsims_tpu_torch.kernels import shallow_water_cuda as swk
    from fluidsims_tpu_torch.kernels import stam2d_cuda as s2k
    from fluidsims_tpu_torch import interop
    from fluidsims_tpu_torch.core.clock import cfl_dt
    from fluidsims_tpu_torch.kernels import hypersonic2d_cuda as hk
    from fluidsims_tpu_torch.kernels import hypersonic3d_cuda as hk3
    from fluidsims_tpu_torch.solvers import burgers as bg
    from fluidsims_tpu_torch.solvers import hypersonic2d as h2
    from fluidsims_tpu_torch.solvers import hypersonic3d as h3
    from fluidsims_tpu_torch.solvers import shallow_water as sw
    from fluidsims_tpu_torch.kernels import mhd_cuda as mk
    from fluidsims_tpu_torch.kernels import sph_cuda as sk
    from fluidsims_tpu_torch.solvers import mhd
    from fluidsims_tpu_torch.solvers import sph as ts
    from fluidsims_tpu_torch.kernels import flip_cuda as fk
    from fluidsims_tpu_torch.kernels import lbm_cuda as lk
    from fluidsims_tpu_torch.solvers import flip_apic as fa
    from fluidsims_tpu_torch.solvers import lbm
    from fluidsims_tpu_torch.kernels import mpm_cuda as mpk
    from fluidsims_tpu_torch.solvers import mpm as mp
    from fluidsims_tpu_torch.kernels import gray_scott_cuda as gk
    from fluidsims_tpu_torch.solvers import gray_scott as gs
    from fluidsims_tpu_torch.kernels import stam3d_cuda as sc
    from fluidsims_tpu_torch.solvers import stam3d as s3
    from fluidsims_tpu_torch.solvers import stam2d as s2
    from fluidsims_tpu_torch.kernels import nbody_cuda as nk
    from fluidsims_tpu_torch.solvers import nbody_graph as ng

    m = types.SimpleNamespace(bk=bk, swk=swk, s2k=s2k, bg=bg, sw=sw, hk=hk,
                              hk3=hk3, h2=h2, h3=h3, interop=interop,
                              cfl_dt=cfl_dt, mk=mk, sk=sk, mhd=mhd, ts=ts,
                              fk=fk, lk=lk, fa=fa, lbm=lbm, mpk=mpk, mp=mp,
                              gk=gk, gs=gs, sc=sc, s3=s3, s2=s2, nk=nk,
                              ng=ng)
    log(f"[device] {smi}; package from {Path(bk.__file__).parents[1]}")
    dev = torch.device("cuda", 0)
    bk.load()
    res = {"device": smi, "root": str(Path(args.root).resolve()),
           "defines": args.define, "fmad": args.fmad}
    if hasattr(_build, "ptxas_usage"):
        res["ptxas"] = [u for name in ("burgers_multistep_kernel",
                                       "sw_multistep_kernel",
                                       "lin_solve_kernel", "11step_kernel",
                                       "12step3_kernel",
                                       "mhd_multistep_kernel",
                                       "forces_kernel", "11grid_kernel",
                                       "lbm_multistep_kernel", "p2g",
                                       "gs_multistep_kernel",
                                       "density_kernel", "10g2p_kernel",
                                       "set_bnd_kernel", "sph_bin_cu",
                                       "stam2d_advect_cu", "mpm_g2p_kernel",
                                       "nbody_repulsion_kernel",
                                       "wavespeed3_kernel")
                        for u in _build.ptxas_usage(name)]
        for u in res["ptxas"]:
            log(f"[build] ptxas {u}")
    if "check" in args.what:
        res["check"] = checks(m, dev, args.only)
    if "phases" in args.what:
        res["phases"] = {**p2g_phases(m, dev, args.only),
                         **bin_phases(m, dev, args.only)}
    if "sass" in args.what:
        res["sass"] = sass(_build)
    if "time" in args.what:
        res["time"] = timings(m, dev, args.only, args.dump, args.inputs)
        for key, v in res["time"].items():
            log(f"[time] {key}: " + (
                str(v) if isinstance(v, (str, bool))
                else f"{v:.2f} us a call" if "host" in key
                else f"{v:.3e}" if "rel" in key
                else f"{v:.4f} ms a launch"))
    Path(args.out).write_text(json.dumps(res, indent=1))
    log(json.dumps(res.get("time", {})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
