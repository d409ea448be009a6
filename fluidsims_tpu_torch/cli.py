"""Command-line entry point of the port (headless).

    python -m fluidsims_tpu_torch.cli hypersonic2d --nx 2048 --ny 2048 --steps 200

Port of the `hypersonic2d` subcommand of fluidsims_tpu.cli with the same
physics flags and defaults.  `--impl cuda` (default) steps through the
CUDA kernels and needs `--device cuda`; `--impl torch` steps through their
plain PyTorch versions on either device, for timing and comparison.
There is no automatic choice between them: what is asked for runs, or the
command fails.
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
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
