"""Command-line entry point of the port (headless).

    python -m fluidsims_tpu_torch.cli hypersonic2d --nx 2048 --ny 2048 --steps 200
    python -m fluidsims_tpu_torch.cli sph --n 65536 --no-rain --steps 200
    python -m fluidsims_tpu_torch.cli hypersonic3d --n 64 --steps 400
    python -m fluidsims_tpu_torch.cli th3cs --n 64 --out vol.4spl
    python -m fluidsims_tpu_torch.cli gray-scott --nx 2048 --ny 2048
    python -m fluidsims_tpu_torch.cli lbm --nx 2048 --ny 1024 --steps 1000
    python -m fluidsims_tpu_torch.cli burgers --steps 4000
    python -m fluidsims_tpu_torch.cli shallow-water --steps 4000
    python -m fluidsims_tpu_torch.cli mhd --case orszag-tang --steps 4000
    python -m fluidsims_tpu_torch.cli stam3d --n 192 --steps 100
    python -m fluidsims_tpu_torch.cli stam2d --n 512 --steps 400
    python -m fluidsims_tpu_torch.cli flip --particles 65536 --steps 200
    python -m fluidsims_tpu_torch.cli mpm --n 32768 --material snow --steps 500
    python -m fluidsims_tpu_torch.cli nbody --steps 20

Ports of the `hypersonic2d`, `sph`, `hypersonic3d`, `th3cs`, `gray-scott`,
`lbm`, `burgers`, `shallow-water`, `mhd`, `stam3d`, `stam2d`, `flip`,
`mpm` and `nbody` subcommands of fluidsims_tpu.cli with the same physics
flags and defaults, headless but for `nbody`'s terminal views.  All run on
`--device cuda` unless asked for the CPU.

hypersonic2d, hypersonic3d: `--impl cuda` (default) steps through the CUDA
kernels and needs `--device cuda`; `--impl torch` steps through their
plain PyTorch versions on either device, for timing and comparison.  There
is no automatic choice between them: what is asked for runs, or the
command fails.

th3cs: the `.4spl` schlieren volume-video export; the CUDA kernels on a
GPU, their plain versions on the CPU; the engine that ran is printed.

sph: `--engine auto` resolves as solvers.sph.resolve_engine does (the CUDA
kernels on a GPU unless --xsph, else the plain cell-dense engine); the
engine that ran is printed beside the rate.

gray-scott, lbm: `--engine auto` resolves as the solvers' resolve_engine
does (the CUDA kernels on a GPU, `--block-k` steps a K-step launch; the
plain torch step on the CPU; `cuda` on the CPU fails); they print the
engine, steps/s and Mcell-steps/s (Gray–Scott) or MLUPS (LBM, cells x
steps / s / 1e6 as tau_lbm.cu:291-294).  The whole run is one `run` call
bracketed by synchronisation, after a warm-up of block_k + 1 steps that
builds and loads the kernels.

burgers, shallow-water, mhd: the same engine rule and timing, `--block-k`
steps a launch of the K-step kernel (its remainder in one-step launches);
they print the engine, steps/s and Mcell-steps/s, and mhd the time t.
Their `--block-k` defaults are the JAX CLI's (16 for all three), which for
shallow water and MHD differ from the configs' (8).

stam3d: the same engine rule (the three CUDA kernels on a GPU, the plain
torch step on the CPU); it prints the engine, steps/s and Mcell-steps/s
(n^3 cells), and for the torch engine at `--advect-k` >= 1 the cells its
dense-shift advection capped on the final frame.  The warm-up is one step.

stam2d: the same engine rule (the two CUDA kernels on a GPU, the plain
torch step on the CPU); it prints the engine, steps/s and Mcell-steps/s
(n^2 cells), and `advect_overflow_count` of the final state: the
back-traces past `--advect-band` rows that JAX's banded TPU engine would
have clamped there.  A diagnostic only: no engine of the port clamps.
The warm-up is one step.

flip: `--engine auto` (the default here; JAX's CLI defaults to dense)
resolves as solvers.flip_apic.resolve_engine does (the three CUDA kernels
on a GPU, the cell-dense `dense` engine on the CPU; `cuda` on the CPU
fails; `scatter` is the exact engine anywhere); it prints the engine,
steps/s and M particle-steps/s, then `occupied` and `peak_cell` of the
final density raster and the overflow count (particles past a cell's
`--bin-capacity` slots, which only `dense` drops).  The warm-up is one
step.

mpm: the same engine rule as flip (the three CUDA kernels on a GPU, the
cell-dense `dense` engine on the CPU; `cuda` on the CPU fails; `scatter`
is the exact engine anywhere; `--engine auto` is the default here, JAX's
CLI defaults to dense); it prints the engine, steps/s and M
particle-steps/s, the mean height of the final state and the overflow
count.  JAX's `--cols`/`--rows` only size its terminal frames, which are
not ported.  The warm-up is one step.

nbody: the prime-graph layout of 2^17 bodies by default; engine `exact`
steps the all-pairs repulsion through its CUDA kernel on a GPU (its plain
version on the CPU), `grid` the grid-monopole approximation in plain
PyTorch; `--native` runs the threaded Barnes–Hut engine on the host
(`--threads`, `--theta`).  It prints JAX's two report lines (steps/s and
the layout's extent) after a line naming the engine and device, and with
`--render` the final frame; `--render --stride N --steps M` animates a
live view for M steps and `--interactive` runs it until 'q', with JAX's
keys.  The warm-up is one step.
"""

from __future__ import annotations

import argparse
import functools
import sys

__all__ = ["build_parser", "main"]


def _engine(cfg, impl: str, device, core_plain, wavespeed_plain) -> dict:
    """step() hooks for the chosen implementation: {} keeps step()'s
    defaults (the kernels), "torch" takes the kernels' plain versions."""
    if impl == "cuda":
        if device.type != "cuda":
            raise SystemExit("--impl cuda runs the CUDA kernels and needs "
                             "--device cuda; use --impl torch on the CPU")
        return {}
    return {"core": functools.partial(core_plain, cfg),
            "wavespeed": functools.partial(wavespeed_plain, cfg)}


def _device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def cmd_hypersonic2d(args):
    from .core.device import resolve_device
    from .core.stepper import benchmark
    from .kernels import hypersonic2d_cuda as hk
    from .solvers import hypersonic2d as h2

    device = resolve_device(args.device)
    cfg = h2.default_config(
        nx=args.nx, ny=args.ny, gamma=args.gamma, cfl=args.cfl,
        visc_nu=args.visc_nu, visc_rho=args.visc_rho, visc_e=args.visc_e,
        inflow_mach=args.mach, dtype=args.dtype,
    )
    engine = _engine(cfg, args.impl, device, hk.step_core_plain,
                     hk.inflow_wavespeed_plain)
    last = [h2.init(cfg, device)]

    def step_fn(st):
        last[0] = h2.step(cfg, st, **engine)
        return last[0]

    # One warm-up step builds and loads the kernels; it is not timed.
    res = benchmark(step_fn, last[0], args.steps, warmup_steps=1,
                    cells=cfg.nx * cfg.ny)
    name = _device_name(device)
    print(f"hypersonic2d {cfg.nx}x{cfg.ny} {cfg.dtype} impl={args.impl} "
          f"device={name}: {res['steps']} steps in {res['wall_s']:.3f}s -> "
          f"{res['steps_per_sec']:.1f} steps/s, "
          f"{res['mcells_per_sec']:.1f} Mcell-steps/s")
    print(f"t = {float(last[0].t):.6f}")
    return last[0]


def cmd_sph(args):
    from .core.device import resolve_device
    from .core.stepper import benchmark
    from .solvers import sph

    device = resolve_device(args.device)
    cfg = sph.SPHConfig(n=args.n, box_x=args.box, box_y=args.box,
                        rho0=args.rho0, c0=args.c0, gamma_eos=args.gamma,
                        gravity=args.gravity, dtau=args.dTau, cfl=args.CFL,
                        visc_alpha=args.visc, visc_substeps=args.visc_substeps,
                        use_xsph=args.xsph, xsph_eps=args.xsph_eps,
                        seed=args.seed, rain=not args.no_rain,
                        engine=args.engine, cell_capacity=args.bin_capacity,
                        dtype=args.dtype)
    engine = sph.resolve_engine(cfg, device)
    last = [sph.init(cfg, device)]

    def step_fn(st):
        last[0] = sph.step(cfg, st)
        return last[0]

    # One warm-up step builds and loads the kernels; it is not timed.
    res = benchmark(step_fn, last[0], args.steps, warmup_steps=1,
                    cells=cfg.n)
    name = _device_name(device)
    out = last[0]
    print(f"sph n={cfg.n} {cfg.dtype} engine={engine} device={name}: "
          f"{res['steps']} steps in {res['wall_s']:.3f}s -> "
          f"{res['steps_per_sec']:.1f} steps/s, "
          f"{res['mcells_per_sec']:.2f}M particle-steps/s")
    print(f"t = {float(out.t):.4f} tau = {float(out.tau):.4f}")
    n_dropped = int(sph.overflow_count(cfg, out))
    print(f"overflow: {n_dropped} particles beyond the cell capacity "
          f"K={cfg.grid().K}")
    if n_dropped > 0:
        print(f"WARNING: {n_dropped}/{cfg.n} particles exceed the cell-dense "
              "bin capacity and are excluded from interactions this frame; "
              "raise --bin-capacity or use --engine exact", file=sys.stderr)
    return out


def cmd_hypersonic3d(args):
    from .core.device import resolve_device
    from .core.stepper import benchmark
    from .kernels import hypersonic3d_cuda as hk3
    from .solvers import hypersonic3d as h3

    device = resolve_device(args.device)
    cfg = h3.default_config(args.n, dtype=args.dtype, outflow=args.outflow)
    engine = _engine(cfg, args.impl, device, hk3.step_core_plain,
                     hk3.wavespeed_plain)
    last = [h3.init(cfg, device)]

    def step_fn(st):
        last[0] = h3.step(cfg, st, **engine)
        return last[0]

    # One warm-up step builds and loads the kernels; it is not timed.
    res = benchmark(step_fn, last[0], args.steps, warmup_steps=1,
                    cells=cfg.nx * cfg.ny * cfg.nz)
    out = last[0]
    print(f"hypersonic3d {cfg.nx}^3 {cfg.dtype} outflow={cfg.outflow} "
          f"impl={args.impl} device={_device_name(device)}: {res['steps']} "
          f"steps in {res['wall_s']:.3f}s -> {res['steps_per_sec']:.1f} "
          f"steps/s, {res['mcells_per_sec']:.1f} Mcell-steps/s")
    refl = float(h3.outflow_reflection_metric(cfg, out))
    print(f"t = {float(out.t):.6f} dtau = {float(out.dtau):.3e} "
          f"refl_dp = {refl:.3e}")
    return out


def cmd_th3cs(args):
    import time

    import torch

    from .core.device import resolve_device
    from .solvers import hypersonic3d as h3
    from .solvers.th3cs import export_4spl

    device = resolve_device(args.device)
    engine = "cuda" if device.type == "cuda" else "torch"
    cfg = h3.default_config(args.n)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    export_4spl(args.out, cfg, frames=args.frames,
                steps_per_frame=args.steps_per_frame, device=device,
                engine=engine)
    wall = time.perf_counter() - t0
    print(f"th3cs {cfg.nx}^3 engine={engine} device={_device_name(device)}: "
          f"{args.frames} frames x {args.steps_per_frame} steps in "
          f"{wall:.3f}s -> {args.frames / wall:.2f} frames/s (kernel build "
          f"included)")
    print(f"wrote {args.out}")


def _bench_run(run, state, steps: int, warmup: int, cells: int):
    """core.stepper.benchmark of `run(state, n)` (n steps in one call, so
    K-step engines fuse them): (final state of the timed run, rates)."""
    from .core.stepper import benchmark

    last = [state]

    def run_fn(st, n):
        last[0] = run(st, n)
        return last[0]

    res = benchmark(None, state, steps, warmup_steps=warmup, cells=cells,
                    run_fn=run_fn)
    return last[0], res


def cmd_gray_scott(args):
    from .core.device import resolve_device
    from .solvers import gray_scott as gs

    device = resolve_device(args.device)
    cfg = gs.GrayScottConfig(
        nx=args.nx, ny=args.ny, dx=args.dx, dt=args.dt, Du=args.Du,
        Dv=args.Dv, feed=args.F, kill=args.k, seed=args.seed,
        dtype=args.dtype, engine=args.engine, block_k=args.block_k)
    engine = gs.resolve_engine(cfg, device)
    out, res = _bench_run(lambda st, n: gs.run(cfg, st, n),
                          gs.init(cfg, device), args.steps, cfg.block_k + 1,
                          cfg.nx * cfg.ny)
    print(f"gray-scott {cfg.nx}x{cfg.ny} {cfg.dtype} engine={engine} "
          f"block_k={cfg.block_k} device={_device_name(device)}: "
          f"{res['steps']} steps in {res['wall_s']:.3f}s -> "
          f"{res['steps_per_sec']:.1f} steps/s, "
          f"{res['mcells_per_sec']:.1f} Mcell-steps/s")
    print(f"v: min {float(out.v.min()):.4f} max {float(out.v.max()):.4f}")
    return out


def cmd_lbm(args):
    from .core.device import resolve_device
    from .solvers import lbm

    device = resolve_device(args.device)
    cfg = lbm.LBMConfig(
        nx=args.nx, ny=args.ny, tau=args.tau, drive=args.drive,
        obstacle=not args.no_obstacle, obstacle_radius=args.radius,
        dtype=args.dtype, engine=args.engine, block_k=args.block_k)
    engine = lbm.resolve_engine(cfg, device)
    out, res = _bench_run(lambda st, n: lbm.run(cfg, st, n),
                          lbm.init(cfg, device), args.steps, cfg.block_k + 1,
                          cfg.nx * cfg.ny)
    print(f"lbm {cfg.nx}x{cfg.ny} {cfg.dtype} engine={engine} "
          f"block_k={cfg.block_k} device={_device_name(device)}: "
          f"{res['steps']} steps in {res['wall_s']:.3f}s -> "
          f"{res['steps_per_sec']:.1f} steps/s, "
          f"{res['mcells_per_sec']:.1f} MLUPS")
    sp = lbm.speed_field(cfg, out)
    print(f"max |u| = {float(sp.max()):.5f}")
    return out


def _report(name, cfg, engine, device, res) -> None:
    print(f"{name} {cfg.nx}x{cfg.ny} {cfg.dtype} engine={engine} "
          f"block_k={cfg.block_k} device={_device_name(device)}: "
          f"{res['steps']} steps in {res['wall_s']:.3f}s -> "
          f"{res['steps_per_sec']:.1f} steps/s, "
          f"{res['mcells_per_sec']:.1f} Mcell-steps/s")


def cmd_burgers(args):
    from .core.device import resolve_device
    from .solvers import burgers as bg

    device = resolve_device(args.device)
    cfg = bg.BurgersConfig(
        nx=args.nx, ny=args.ny, dx=args.dx, dy=args.dy, nu=args.nu,
        u0=args.u0, amp=args.amp, bsig=args.bsig, swirl=args.swirl,
        rc=args.rc, offx=args.offx, offy=args.offy, asym=args.asym,
        cfl=args.CFL, tau0=args.tau0, t0=args.t0, dtau=args.dtau,
        muscl=args.muscl, visc_substeps=args.visc_substeps,
        colehopf=args.colehopf, ck=args.ck, ca=args.ca, dtype=args.dtype,
        engine=args.engine, block_k=args.block_k)
    engine = bg.resolve_engine(cfg, device)
    out, res = _bench_run(lambda st, n: bg.run(cfg, st, n),
                          bg.init(cfg, device), args.steps, cfg.block_k + 1,
                          cfg.nx * cfg.ny)
    _report("burgers", cfg, engine, device, res)
    if cfg.colehopf:
        print(f"Cole-Hopf rel L2 error {bg.cole_hopf_rel_l2(cfg, out):.4e}")
    return out


def cmd_shallow_water(args):
    from .core.device import resolve_device
    from .solvers import shallow_water as sw

    device = resolve_device(args.device)
    cfg = sw.ShallowWaterConfig(
        nx=args.nx, ny=args.ny, dx=args.dx, dy=args.dy, g=args.g, f0=args.f0,
        nu=args.nu, H0=args.H0, bump_amp=args.amp, bump_sigma=args.bsig,
        offx=args.offx, offy=args.offy, asym=args.asym, swirl=args.swirl,
        swirl_rc=args.rc, tau0=args.tau0, t0=args.t0, dtau=args.dtau,
        dtype=args.dtype, engine=args.engine, block_k=args.block_k)
    engine = sw.resolve_engine(cfg, device)
    out, res = _bench_run(lambda st, n: sw.run(cfg, st, n),
                          sw.init(cfg, device), args.steps, cfg.block_k + 1,
                          cfg.nx * cfg.ny)
    _report("shallow-water", cfg, engine, device, res)
    h = sw.depth(out)
    print(f"h: min {float(h.min()):.4f} max {float(h.max()):.4f}")
    return out


def cmd_mhd(args):
    from .core.device import resolve_device
    from .solvers import mhd

    device = resolve_device(args.device)
    cfg = mhd.MHDConfig(nx=args.nx, ny=args.ny, problem=args.case,
                        stable_hll=args.stable_hll, dtype=args.dtype,
                        engine=args.engine, block_k=args.block_k)
    engine = mhd.resolve_engine(cfg, device)
    out, res = _bench_run(lambda st, n: mhd.run(cfg, st, n),
                          mhd.init(cfg, device), args.steps, cfg.block_k + 1,
                          cfg.nx * cfg.ny)
    _report(f"mhd {cfg.problem}", cfg, engine, device, res)
    print(f"t = {float(out.t):.6f}")
    return out


def cmd_stam3d(args):
    from .core.device import resolve_device
    from .solvers import stam3d

    device = resolve_device(args.device)
    cfg = stam3d.Stam3DConfig(
        n=args.n, dt=args.dt, visc=args.visc, diff=args.diff,
        decay=args.decay, src_gain=args.src_gain, src_freq=args.src_freq,
        seed_amp=args.amp, seed_noise=args.noise, seed_dens_amp=args.dens_amp,
        seed_sigma=args.sigma, jacobi_iters=args.jacobi, seed=args.seed,
        dtype=args.dtype, advect_k=args.advect_k, engine=args.engine)
    engine = stam3d.resolve_engine(cfg, device)
    out, res = _bench_run(lambda st, n: stam3d.run(cfg, st, n),
                          stam3d.init(cfg, device), args.steps, 1, cfg.n ** 3)
    print(f"stam3d {cfg.n}^3 {cfg.dtype} engine={engine} "
          f"advect_k={cfg.advect_k} device={_device_name(device)}: "
          f"{res['steps']} steps in {res['wall_s']:.3f}s -> "
          f"{res['steps_per_sec']:.2f} steps/s, "
          f"{res['mcells_per_sec']:.1f} Mcell-steps/s")
    if engine == "torch" and cfg.advect_k >= 1:
        capped = int(stam3d.advect_capped_count(cfg, out))
        print(f"advect capped: {capped} cells past advect_k={cfg.advect_k} "
              "on the final frame (--advect-k 0 gathers exactly)")
    return out


def cmd_stam2d(args):
    from .core.device import resolve_device
    from .solvers import stam2d

    device = resolve_device(args.device)
    cfg = stam2d.Stam2DConfig(n=args.n, dtype=args.dtype, engine=args.engine,
                              advect_band=args.advect_band)
    engine = stam2d.resolve_engine(cfg, device)
    out, res = _bench_run(lambda st, n: stam2d.run(cfg, st, n),
                          stam2d.init(cfg, device), args.steps, 1, cfg.n ** 2)
    print(f"stam2d {cfg.n}^2 {cfg.dtype} engine={engine} "
          f"device={_device_name(device)}: "
          f"{res['steps']} steps in {res['wall_s']:.3f}s -> "
          f"{res['steps_per_sec']:.2f} steps/s, "
          f"{res['mcells_per_sec']:.1f} Mcell-steps/s")
    over = int(stam2d.advect_overflow_count(cfg, out))
    print(f"advect_overflow_count: {over} cells of the final state trace "
          f"past advect_band={cfg.advect_band} rows (JAX's banded TPU "
          f"engine would clamp them; engine={engine} traces them exactly)")
    return out


def cmd_flip(args):
    from .core.device import resolve_device
    from .solvers import flip_apic as fa

    device = resolve_device(args.device)
    cfg = fa.FlipApicConfig(particles=args.particles, grid=args.grid,
                            jacobi=args.jacobi, dt=args.dt,
                            gravity=args.gravity, flip=args.flip,
                            apic=args.apic, engine=args.engine,
                            bin_capacity=args.bin_capacity, dtype=args.dtype)
    engine = fa.resolve_engine(cfg, device)
    out, res = _bench_run(lambda st, n: fa.run(cfg, st, n),
                          fa.init(cfg, device), args.steps, 1, cfg.particles)
    print(f"flip-apic n={cfg.particles} grid={cfg.grid}^2 {cfg.dtype} "
          f"engine={engine} device={_device_name(device)}: "
          f"{res['steps']} steps in {res['wall_s']:.3f}s -> "
          f"{res['steps_per_sec']:.1f} steps/s, "
          f"{res['mcells_per_sec']:.2f}M particle-steps/s")
    dens = out.density
    print(f"occupied={int((dens > 0).sum())} peak_cell={int(dens.max())}")
    n_dropped = int(fa.overflow_count(cfg, out))
    print(f"overflow: {n_dropped} particles beyond the cell capacity "
          f"K={cfg.capacity}")
    if n_dropped > 0:
        print(f"WARNING: {n_dropped}/{cfg.particles} particles exceed the "
              "cell-dense bin capacity and are excluded from the transfers "
              "this frame; raise --bin-capacity or use --engine scatter "
              "for exact physics", file=sys.stderr)
    return out


def cmd_mpm(args):
    from .core.device import resolve_device
    from .solvers import mpm

    device = resolve_device(args.device)
    cfg = mpm.MPMConfig(n=args.n, gx=args.gx, gy=args.gy, dt=args.dt,
                        gravity=args.gravity, seed=args.seed,
                        material=args.material, engine=args.engine,
                        bin_capacity=args.bin_capacity, dtype=args.dtype)
    engine = mpm.resolve_engine(cfg, device)
    out, res = _bench_run(lambda st, n: mpm.run(cfg, st, n),
                          mpm.init(cfg, device), args.steps, 1, cfg.n)
    print(f"mpm n={cfg.n} grid={cfg.gx}x{cfg.gy} {cfg.material} {cfg.dtype} "
          f"engine={engine} device={_device_name(device)}: "
          f"{res['steps']} steps in {res['wall_s']:.3f}s -> "
          f"{res['steps_per_sec']:.1f} steps/s, "
          f"{res['mcells_per_sec']:.2f}M particle-steps/s")
    print(f"mean y {float(out.pos[:, 1].mean()):.6f}")
    n_dropped = int(mpm.overflow_count(cfg, out))
    print(f"overflow: {n_dropped} particles beyond the cell capacity "
          f"K={cfg.capacity}")
    if n_dropped > 0:
        print(f"WARNING: {n_dropped}/{cfg.n} particles exceed the "
              "cell-dense bin capacity and are excluded from the transfers "
              "this frame; raise --bin-capacity or use --engine scatter "
              "for exact physics", file=sys.stderr)
    return out


def _nbody_live(args, cfg, device):
    """Live terminal view of the relaxing layout with the reference's
    camera keys: pause, refit, reset, colour cycle, +/- frame stride,
    pan/zoom in 2-D (number_fluid2d.c:805-888), orbit yaw/pitch/zoom in
    3-D (number_fluid3d.c:909-958)."""
    import numpy as np

    from .core.interactive import interactive_loop
    from .render import points as rp
    from .solvers import nbody_graph as ng

    schemes = list(rp.SCHEMES)
    box = {"scheme": args.scheme, "cam": None}
    three_d = cfg.dims == 3

    if args.native:
        from .solvers import nbody_native as nn

        p0, v0, edges = ng.init_arrays(cfg)
        eng = nn.BHEngine(cfg, edges, n_threads=args.threads or None,
                          theta=args.theta)
        eng.__enter__()
        eng.set_state(p0, v0)

        def make_runner():
            def run(state, n):
                eng.run(n)
                return eng.get_state()[0]

            return run

        state0 = p0
        n_edges = len(edges)

        def reset(ctx):
            eng.set_state(p0, v0)
            ctx.state = p0
            box["cam"] = None
    else:
        s0 = ng.init(cfg, device)

        def make_runner():
            return lambda st, n: ng.run(cfg, st, n)

        state0 = s0
        n_edges = int(s0.edges.shape[0])

        def reset(ctx):
            ctx.state = s0
            box["cam"] = None

    def pos_of(state):
        return state if args.native else state.pos.cpu().numpy()

    def frame(state):
        pos = pos_of(state)
        if box["cam"] is None:
            box["cam"] = (rp.fit_orbit(pos) if three_d
                          else rp.camera_fit(pos, args.cols, args.rows))
        if three_d:
            return rp.render_points_3d(pos, args.cols, args.rows,
                                       scheme=box["scheme"],
                                       color=not args.no_color,
                                       camera=box["cam"])
        return rp.render_points(pos, args.cols, args.rows,
                                scheme=box["scheme"],
                                color=not args.no_color, camera=box["cam"])

    def pan(dx, dy):
        def h(ctx):
            cam = box["cam"]
            if isinstance(cam, rp.Camera2D):
                cam.tx += dx * args.cols * 0.15 / cam.zoom
                cam.ty += dy * args.rows * 0.3 / cam.zoom
        return h

    def zoom(f):
        def h(ctx):
            cam = box["cam"]
            if isinstance(cam, rp.Camera2D):
                cam.zoom = min(max(cam.zoom * f, 1e-9), 1e9)
            elif isinstance(cam, rp.OrbitCamera):
                cam.distance = max(cam.distance / f, 1e-6)
        return h

    def orbit(dyaw, dpitch):
        def h(ctx):
            cam = box["cam"]
            if isinstance(cam, rp.OrbitCamera):
                cam.yaw += dyaw
                cam.pitch = min(max(cam.pitch + dpitch, -1.55), 1.55)
        return h

    def stride_mul(f):
        def h(ctx):
            ctx.stride = min(max(int(ctx.stride * f), 1), 64)
        return h

    keys = {
        "p": ("pause", lambda ctx: setattr(ctx, "paused", not ctx.paused)),
        " ": ("step", lambda ctx: setattr(ctx, "step_once", True)),
        "r": ("refit", lambda ctx: box.update(cam=None)),
        "b": ("reset", reset),
        "c": ("colors", lambda ctx: box.update(
            scheme=schemes[(schemes.index(box["scheme"]) + 1)
                           % len(schemes)])),
        "z": ("zoom+", zoom(1.12)),
        "x": ("zoom-", zoom(1 / 1.12)),
        "+": ("stride*2", stride_mul(2)),
        "-": ("stride/2", stride_mul(0.5)),
    }
    if three_d:
        keys.update({
            "a": ("yaw-", orbit(-0.1, 0)),
            "d": ("yaw+", orbit(0.1, 0)),
            "w": ("pitch+", orbit(0, 0.1)),
            "s": ("pitch-", orbit(0, -0.1)),
        })
    else:
        keys.update({
            "h": ("pan-l", pan(-1, 0)),
            "l": ("pan-r", pan(1, 0)),
            "j": ("pan-d", pan(0, -1)),
            "k": ("pan-u", pan(0, 1)),
        })

    def status(ctx):
        cam = box["cam"]
        view = (f"yaw={cam.yaw:.2f} pitch={cam.pitch:.2f} "
                f"dist={cam.distance:.0f}" if isinstance(cam, rp.OrbitCamera)
                else f"zoom={cam.zoom:.3g}" if cam else "")
        return (f"{cfg.n_bodies} nodes {n_edges} edges "
                f"stride={ctx.stride} [{box['scheme']}] {view}")

    try:
        return interactive_loop(
            state0, make_runner, frame, keys,
            stride=max(args.stride, 1), max_steps=args.steps or None,
            status_fn=status, input_fn=args.input_fn)
    finally:
        if args.native:
            eng.__exit__(None, None, None)


def cmd_nbody(args):
    import time as _time

    import numpy as np

    from .core.device import resolve_device
    from .solvers import nbody_graph as ng

    device = resolve_device(args.device)
    cfg = ng.GraphLayoutConfig(max_number=args.max_number, dims=args.dims,
                               grid_res=args.grid_res, engine=args.engine,
                               dtype=args.dtype)
    # --interactive runs until 'q' (and implies --render); --render
    # --stride alone animates but stays bounded by --steps
    if args.interactive or (args.render and args.stride and args.steps):
        return _nbody_live(args, cfg, device)
    if args.native:
        # host path: the native engine touches no device
        from .solvers import nbody_native as nn

        p0, v0, edges = ng.init_arrays(cfg)
        with nn.BHEngine(cfg, edges, n_threads=args.threads or None,
                         theta=args.theta) as eng:
            eng.set_state(p0, v0)
            t0 = _time.perf_counter()
            eng.run(args.steps)
            wall = _time.perf_counter() - t0
            pos, _ = eng.get_state()
        n_edges = len(edges)
        print(f"nbody engine=native theta={args.theta} device=host")
        out = pos
    else:
        # one warm-up step (the kernel's build and first launch) untimed
        out, res = _bench_run(lambda st, n: ng.run(cfg, st, n),
                              ng.init(cfg, device), args.steps, 1,
                              cfg.n_bodies)
        wall = res["wall_s"]
        pos = out.pos.cpu().numpy()
        n_edges = int(out.edges.shape[0])
        print(f"nbody engine={cfg.engine} {cfg.dtype} "
              f"device={_device_name(device)}")
    rate = args.steps / wall if wall > 0 else 0.0
    print(f"nbody: {args.steps} steps, {cfg.n_bodies} nodes, "
          f"{n_edges} edges -> {rate:.1f} steps/s")
    print(f"layout extent: {np.abs(pos).max():.1f}")
    if args.render:
        from .render.points import render_points, render_points_3d

        if cfg.dims == 3:
            print(render_points_3d(pos, W=args.cols, H=args.rows,
                                   scheme=args.scheme,
                                   color=not args.no_color))
        else:
            print(render_points(pos, W=args.cols, H=args.rows,
                                scheme=args.scheme,
                                color=not args.no_color))
    return out


def _engine_args(p, block_k: int) -> None:
    p.add_argument("--engine", choices=("auto", "cuda", "torch"),
                   default="auto",
                   help="auto = the CUDA kernel on a GPU, the plain torch "
                        "step on the CPU")
    p.add_argument("--block-k", type=int, default=block_k, dest="block_k",
                   help="steps per K-step kernel launch (cuda engine; the "
                        "remainder runs one step a launch)")


def build_parser():
    ap = argparse.ArgumentParser(prog="fluidsims_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("hypersonic2d",
                       help="2-D hypersonic flow (tau_hypersonic_cuda)")
    p.add_argument("--nx", type=int, default=2048)
    p.add_argument("--ny", type=int, default=1024)
    p.add_argument("--gamma", type=float, default=1.1)
    p.add_argument("--cfl", type=float, default=0.25)
    p.add_argument("--visc-nu", type=float, default=5e-2)
    p.add_argument("--visc-rho", type=float, default=5e-2)
    p.add_argument("--visc-e", type=float, default=2e-2)
    p.add_argument("--mach", type=float, default=25.0)
    p.add_argument("--steps", type=int, default=100,
                   help="number of physics steps")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    p.add_argument("--impl", choices=("cuda", "torch"), default="cuda",
                   help="step implementation: the hand-written CUDA kernels "
                        "(needs --device cuda) or their plain PyTorch "
                        "versions")
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu; a missing GPU is an error")
    p.set_defaults(fn=cmd_hypersonic2d)

    p = sub.add_parser("sph", help="weakly-compressible SPH (tau_sph)")
    p.add_argument("--n", type=int, default=1 << 16)
    p.add_argument("--box", type=float, default=1.0,
                   help="square domain side (tau_sph.cu --box)")
    p.add_argument("--rho0", type=float, default=1.0)
    p.add_argument("--c0", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=1.0,
                   help="Tait EOS exponent (tau_sph.cu --gamma)")
    p.add_argument("--gravity", type=float, default=9.81)
    p.add_argument("--dTau", type=float, default=1.0)
    p.add_argument("--CFL", type=float, default=1.0)
    p.add_argument("--visc", type=float, default=0.25)
    p.add_argument("--visc_substeps", type=int, default=1)
    p.add_argument("--xsph", action="store_true",
                   help="enable XSPH velocity smoothing (k_xsph_cell)")
    p.add_argument("--xsph-eps", type=float, default=0.25, dest="xsph_eps")
    p.add_argument("--seed", type=int, default=69420)
    p.add_argument("--no-rain", action="store_true")
    p.add_argument("--engine", choices=("auto", "cuda", "torch", "exact"),
                   default="auto",
                   help="auto = the CUDA kernels on a GPU (torch with "
                        "--xsph or on the CPU); exact = O(n^2) all pairs, "
                        "correct at any occupancy")
    p.add_argument("--bin-capacity", type=int, default=0, dest="bin_capacity",
                   help="cell-dense slots per cell (0 = auto); particles "
                        "beyond it are dropped and reported")
    p.add_argument("--steps", type=int, default=100,
                   help="number of physics steps")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu; a missing GPU is an error")
    p.set_defaults(fn=cmd_sph)

    p = sub.add_parser("hypersonic3d",
                       help="3-D hypersonic flow (tau_hypersonic_3d_cuda)")
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--outflow", choices=("transmissive", "characteristic"),
                   default="transmissive")
    p.add_argument("--steps", type=int, default=100,
                   help="number of physics steps")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    p.add_argument("--impl", choices=("cuda", "torch"), default="cuda",
                   help="step implementation: the hand-written CUDA kernels "
                        "(needs --device cuda) or their plain PyTorch "
                        "versions")
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu; a missing GPU is an error")
    p.set_defaults(fn=cmd_hypersonic3d)

    p = sub.add_parser("th3cs", help=".4spl volume-video export (th3cs)")
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--out", default="tau_hypersonic.4spl")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--steps-per-frame", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu; a missing GPU is an error")
    p.set_defaults(fn=cmd_th3cs)

    p = sub.add_parser("gray-scott",
                       help="reaction-diffusion (tau_gray_scott)")
    p.add_argument("--nx", type=int, default=128)
    p.add_argument("--ny", type=int, default=128)
    p.add_argument("--dx", type=float, default=1.0)
    p.add_argument("--dt", type=float, default=1.0)
    p.add_argument("--Du", type=float, default=0.2)
    p.add_argument("--Dv", type=float, default=0.1)
    p.add_argument("--F", type=float, default=0.03)
    p.add_argument("--k", type=float, default=0.06)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--engine", choices=("auto", "cuda", "torch"),
                   default="auto",
                   help="auto = the CUDA kernels on a GPU, the plain torch "
                        "step on the CPU")
    p.add_argument("--block-k", type=int, default=16, dest="block_k",
                   help="steps per K-step kernel launch (cuda engine; 1 = "
                        "the one-step kernel every step)")
    p.add_argument("--steps", type=int, default=2000,
                   help="number of physics steps")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu; a missing GPU is an error")
    p.set_defaults(fn=cmd_gray_scott)

    p = sub.add_parser("lbm", help="D2Q9 lattice Boltzmann (tau_lbm)")
    p.add_argument("--nx", type=int, default=512)
    p.add_argument("--ny", type=int, default=256)
    p.add_argument("--tau", type=float, default=0.56)
    p.add_argument("--drive", type=float, default=1e-6)
    p.add_argument("--radius", type=float, default=32.0)
    p.add_argument("--no-obstacle", action="store_true")
    p.add_argument("--engine", choices=("auto", "cuda", "torch"),
                   default="auto",
                   help="auto = the CUDA kernels on a GPU, the plain torch "
                        "step on the CPU")
    p.add_argument("--block-k", type=int, default=8, dest="block_k",
                   help="steps per K-step kernel launch (cuda engine; 1 = "
                        "the one-step kernel every step)")
    p.add_argument("--steps", type=int, default=1000,
                   help="number of physics steps")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu; a missing GPU is an error")
    p.set_defaults(fn=cmd_lbm)

    p = sub.add_parser("burgers", help="2-D viscous Burgers (tau_burgers)")
    p.add_argument("--nx", type=int, default=512)
    p.add_argument("--ny", type=int, default=512)
    p.add_argument("--dx", type=float, default=1.0)
    p.add_argument("--dy", type=float, default=1.0)
    p.add_argument("--nu", type=float, default=0.1)
    p.add_argument("--u0", type=float, default=1.0)
    p.add_argument("--amp", type=float, default=1.0)
    p.add_argument("--bsig", type=float, default=16.0)
    p.add_argument("--swirl", type=float, default=10.0)
    p.add_argument("--rc", type=float, default=40.0)
    p.add_argument("--offx", type=float, default=0.0)
    p.add_argument("--offy", type=float, default=0.0)
    p.add_argument("--asym", type=float, default=0.0)
    p.add_argument("--CFL", type=float, default=0.45)
    p.add_argument("--tau0", type=float, default=0.0)
    p.add_argument("--t0", type=float, default=1.0)
    p.add_argument("--dtau", type=float, default=1.0)
    p.add_argument("--muscl", action="store_true")
    p.add_argument("--visc_substeps", type=int, default=1)
    p.add_argument("--colehopf", action="store_true")
    p.add_argument("--ck", type=int, default=4)
    p.add_argument("--ca", type=float, default=0.5)
    _engine_args(p, 16)
    p.add_argument("--steps", type=int, default=2000,
                   help="number of physics steps")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu; a missing GPU is an error")
    p.set_defaults(fn=cmd_burgers)

    p = sub.add_parser("shallow-water",
                       help="shallow water (tau_shallow_water)")
    p.add_argument("--nx", type=int, default=512)
    p.add_argument("--ny", type=int, default=512)
    p.add_argument("--dx", type=float, default=1.0)
    p.add_argument("--dy", type=float, default=1.0)
    p.add_argument("--g", type=float, default=9.81)
    p.add_argument("--f0", type=float, default=1.0)
    p.add_argument("--nu", type=float, default=0.001)
    p.add_argument("--H0", type=float, default=1000.0)
    p.add_argument("--amp", type=float, default=1.0)
    p.add_argument("--bsig", type=float, default=1.0)
    p.add_argument("--offx", type=float, default=100.0)
    p.add_argument("--offy", type=float, default=100.0)
    p.add_argument("--asym", type=float, default=10.0)
    p.add_argument("--swirl", type=float, default=1.0)
    p.add_argument("--rc", type=float, default=100.0)
    p.add_argument("--tau0", type=float, default=0.0)
    p.add_argument("--t0", type=float, default=1.0)
    p.add_argument("--dtau", type=float, default=1.0)
    _engine_args(p, 16)
    p.add_argument("--steps", type=int, default=2000,
                   help="number of physics steps")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu; a missing GPU is an error")
    p.set_defaults(fn=cmd_shallow_water)

    p = sub.add_parser("mhd", help="ideal MHD + GLM cleaning (tau_mhd)")
    p.add_argument("--nx", type=int, default=320)
    p.add_argument("--ny", type=int, default=220)
    p.add_argument("--case", default="briowu",
                   choices=["briowu", "orszag-tang"])
    p.add_argument("--stable-hll", action="store_true")
    _engine_args(p, 16)
    p.add_argument("--steps", type=int, default=200,
                   help="number of physics steps")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu; a missing GPU is an error")
    p.set_defaults(fn=cmd_mhd)

    p = sub.add_parser("stam3d", help="3-D stable fluids (js_cuda3d)")
    p.add_argument("--n", type=int, default=192)
    # physics / seeding (js_cuda3d.cu getopt)
    p.add_argument("--dt", type=float, default=1.0)
    p.add_argument("--visc", type=float, default=1e-5)
    p.add_argument("--diff", type=float, default=1e-6)
    p.add_argument("--decay", type=float, default=0.9)
    p.add_argument("--amp", type=float, default=1.2,
                   help="ABC-flow seed amplitude")
    p.add_argument("--noise", type=float, default=0.25)
    p.add_argument("--dens-amp", type=float, default=0.8, dest="dens_amp")
    p.add_argument("--sigma", type=float, default=0.12)
    p.add_argument("--src-gain", type=float, default=0.25, dest="src_gain")
    p.add_argument("--src-freq", type=float, default=0.02, dest="src_freq")
    p.add_argument("--jacobi", type=int, default=12)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--advect-k", type=int, default=2, dest="advect_k",
                   help="torch engine: 0 = exact gather advection; K >= 1 "
                        "= dense-shift advection, exact for backtraces <= "
                        "K cells (capped cells are reported); the cuda "
                        "engine always gathers")
    p.add_argument("--engine", choices=("auto", "cuda", "torch"),
                   default="auto",
                   help="auto = the CUDA kernels on a GPU, the plain torch "
                        "step on the CPU")
    p.add_argument("--steps", type=int, default=20,
                   help="number of physics steps")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu; a missing GPU is an error")
    p.set_defaults(fn=cmd_stam3d)

    p = sub.add_parser("stam2d", help="stable fluids log-eta grid (js_cuda)")
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--engine", choices=("auto", "cuda", "torch"),
                   default="auto",
                   help="auto = the CUDA kernels on a GPU, the plain torch "
                        "step on the CPU; both trace every cell exactly")
    p.add_argument("--advect-band", type=int, default=16,
                   dest="advect_band",
                   help="row band of JAX's TPU advection kernel, in cells: "
                        "only the advect_overflow_count diagnostic reads it")
    p.add_argument("--steps", type=int, default=100,
                   help="number of physics steps")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu; a missing GPU is an error")
    p.set_defaults(fn=cmd_stam2d)

    p = sub.add_parser("flip", help="FLIP/APIC hybrid fluid (tau_flip_apic)")
    p.add_argument("--particles", type=int, default=1 << 16)
    p.add_argument("--grid", type=int, default=128)
    p.add_argument("--jacobi", type=int, default=48)
    p.add_argument("--dt", type=float, default=0.004)
    p.add_argument("--gravity", type=float, default=7.5)
    p.add_argument("--flip", type=float, default=0.97)
    p.add_argument("--apic", type=float, default=0.85)
    p.add_argument("--engine", choices=("auto", "cuda", "dense", "scatter"),
                   default="auto",
                   help="auto = the CUDA kernels on a GPU, the cell-dense "
                        "engine on the CPU; cuda and scatter are exact, "
                        "dense drops particles past --bin-capacity")
    p.add_argument("--bin-capacity", type=int, default=0, dest="bin_capacity",
                   help="cell-dense slots per cell (0 = auto); particles "
                        "beyond it are dropped and reported")
    p.add_argument("--steps", type=int, default=200,
                   help="number of physics steps")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu; a missing GPU is an error")
    p.set_defaults(fn=cmd_flip)

    p = sub.add_parser("mpm", help="MLS-MPM elastoplastic (tau_mpm)")
    p.add_argument("--n", type=int, default=1 << 15)
    p.add_argument("--gx", type=int, default=96)
    p.add_argument("--gy", type=int, default=96)
    p.add_argument("--dt", type=float, default=8e-5)
    p.add_argument("--gravity", type=float, default=9.81)
    p.add_argument("--seed", type=int, default=2026)
    p.add_argument("--material", default="snow",
                   choices=["mud", "snow", "sand"])
    p.add_argument("--engine", choices=("auto", "cuda", "dense", "scatter"),
                   default="auto",
                   help="auto = the CUDA kernels on a GPU, the cell-dense "
                        "engine on the CPU; cuda and scatter are exact, "
                        "dense drops particles past --bin-capacity")
    p.add_argument("--bin-capacity", type=int, default=0, dest="bin_capacity",
                   help="cell-dense slots per cell (0 = auto); particles "
                        "beyond it are dropped and reported")
    p.add_argument("--steps", type=int, default=500,
                   help="number of physics steps")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu; a missing GPU is an error")
    p.set_defaults(fn=cmd_mpm)

    p = sub.add_parser("nbody",
                       help="prime-graph force layout (number_fluid2d/3d)")
    p.add_argument("--max-number", type=int, default=1 << 17)
    p.add_argument("--dims", type=int, default=2, choices=[2, 3])
    p.add_argument("--grid-res", type=int, default=32)
    p.add_argument("--native", action="store_true",
                   help="use the native threaded Barnes-Hut engine on the "
                        "host (fluidsims_tpu_torch/native/nbody_bh.c)")
    p.add_argument("--threads", type=int, default=None,
                   help="worker threads for --native (default: CPU count)")
    p.add_argument("--theta", type=float, default=0.75,
                   help="BH multipole acceptance for --native (0 = exact)")
    p.add_argument("--engine", choices=("exact", "grid"), default="exact",
                   help="repulsion: exact all-pairs (the CUDA kernel on a "
                        "GPU, default) or the grid-monopole approximation")
    p.add_argument("--scheme", default="mint",
                   choices=("mint", "index", "log", "radius", "xor"),
                   help="point color scheme (number_fluid2d.c:146-161)")
    p.add_argument("--cols", type=int, default=100)
    p.add_argument("--rows", type=int, default=40)
    p.add_argument("--no-color", action="store_true",
                   help="plain half-blocks without ANSI colors")
    p.add_argument("--steps", type=int, default=100,
                   help="number of physics steps")
    p.add_argument("--stride", type=int, default=0,
                   help="with --render: steps per live frame (0 = only the "
                        "final frame)")
    p.add_argument("--render", action="store_true",
                   help="print terminal frames")
    p.add_argument("--headless", action="store_true",
                   help="benchmark mode (no rendering)")
    p.add_argument("--interactive", action="store_true",
                   help="key-driven live view until 'q' (implies --render)")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu; a missing GPU is an error")
    p.set_defaults(fn=cmd_nbody, input_fn=None)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
