"""Command-line entry point of the port (headless).

    python -m fluidsims_tpu_torch.cli hypersonic2d --nx 2048 --ny 2048 --steps 200
    python -m fluidsims_tpu_torch.cli sph --n 65536 --no-rain --steps 200

Ports of the `hypersonic2d` and `sph` subcommands of fluidsims_tpu.cli with
the same physics flags and defaults, headless.  Both run on `--device cuda`
unless asked for the CPU.

hypersonic2d: `--impl cuda` (default) steps through the CUDA kernels and
needs `--device cuda`; `--impl torch` steps through their plain PyTorch
versions on either device, for timing and comparison.  There is no
automatic choice between them: what is asked for runs, or the command
fails.

sph: `--engine auto` resolves as solvers.sph.resolve_engine does (the CUDA
kernels on a GPU unless --xsph, else the plain cell-dense engine); the
engine that ran is printed beside the rate.
"""

from __future__ import annotations

import argparse
import functools
import sys

__all__ = ["build_parser", "main"]


def _engine(cfg, impl: str, device) -> dict:
    """step() hooks for the chosen implementation."""
    from .kernels import hypersonic2d_cuda as hk

    if impl == "cuda":
        if device.type != "cuda":
            raise SystemExit("--impl cuda runs the CUDA kernels and needs "
                             "--device cuda; use --impl torch on the CPU")
        return {}  # step()'s defaults: the kernels
    return {"core": functools.partial(hk.step_core_plain, cfg),
            "wavespeed": functools.partial(hk.inflow_wavespeed_plain, cfg)}


def cmd_hypersonic2d(args):
    import torch

    from .core.device import resolve_device
    from .core.stepper import benchmark
    from .solvers import hypersonic2d as h2

    device = resolve_device(args.device)
    cfg = h2.default_config(
        nx=args.nx, ny=args.ny, gamma=args.gamma, cfl=args.cfl,
        visc_nu=args.visc_nu, visc_rho=args.visc_rho, visc_e=args.visc_e,
        inflow_mach=args.mach, dtype=args.dtype,
    )
    engine = _engine(cfg, args.impl, device)
    last = [h2.init(cfg, device)]

    def step_fn(st):
        last[0] = h2.step(cfg, st, **engine)
        return last[0]

    # One warm-up step builds and loads the kernels; it is not timed.
    res = benchmark(step_fn, last[0], args.steps, warmup_steps=1,
                    cells=cfg.nx * cfg.ny)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"hypersonic2d {cfg.nx}x{cfg.ny} {cfg.dtype} impl={args.impl} "
          f"device={name}: {res['steps']} steps in {res['wall_s']:.3f}s -> "
          f"{res['steps_per_sec']:.1f} steps/s, "
          f"{res['mcells_per_sec']:.1f} Mcell-steps/s")
    print(f"t = {float(last[0].t):.6f}")
    return last[0]


def cmd_sph(args):
    import torch

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
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
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
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
