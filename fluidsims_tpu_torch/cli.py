"""Command-line entry point of the port.

    python -m fluidsims_tpu_torch.cli hypersonic2d --nx 2048 --ny 2048 --steps 200
    python -m fluidsims_tpu_torch.cli hypersonic2d --png f.png --stride 50
    python -m fluidsims_tpu_torch.cli hypersonic2d --serve --frames 120
    python -m fluidsims_tpu_torch.cli sph --n 65536 --no-rain --steps 200
    python -m fluidsims_tpu_torch.cli hypersonic3d --n 64 --steps 400
    python -m fluidsims_tpu_torch.cli th3cs --n 64 --out vol.4spl
    python -m fluidsims_tpu_torch.cli gray-scott --nx 2048 --ny 2048
    python -m fluidsims_tpu_torch.cli gray-scott --render --stride 50
    python -m fluidsims_tpu_torch.cli lbm --nx 2048 --ny 1024 --steps 1000
    python -m fluidsims_tpu_torch.cli burgers --steps 4000
    python -m fluidsims_tpu_torch.cli shallow-water --steps 4000
    python -m fluidsims_tpu_torch.cli mhd --case orszag-tang --steps 4000
    python -m fluidsims_tpu_torch.cli stam3d --n 192 --steps 100
    python -m fluidsims_tpu_torch.cli stam2d --n 512 --steps 400
    python -m fluidsims_tpu_torch.cli flip --particles 65536 --steps 200
    python -m fluidsims_tpu_torch.cli mpm --n 32768 --material snow --steps 500
    python -m fluidsims_tpu_torch.cli nbody --steps 20
    python -m fluidsims_tpu_torch.cli regression --write-baseline
    python -m fluidsims_tpu_torch.cli hypersonic2d-cpu --native

Ports of the 16 subcommands of fluidsims_tpu.cli with the same physics
flags and defaults.  All but `hypersonic2d-cpu` (the numpy/C CPU reference)
run on `--device cuda` unless asked for the CPU.

The common flags of every solver subcommand (JAX's `_common`):
`--steps`, `--dtype`, `--device`; `--render` prints the final terminal
frame, and with `--stride N` a live frame every N steps; `--png FILE`
writes the final frame as a PNG (with `--stride N`: FILE_0000.png, ... one
a frame; solvers without an RGB export warn); `--save-state FILE.npz`
checkpoints the final state and `--load-state FILE.npz` resumes from one
(`--load-lenient` accepts a legacy file whose structure string cannot be
checked); `--interactive` runs the key-driven live loop (pause, step,
reset and each solver's keys) until `--steps` steps or 'q'; `--headless`
turns frames off.  With none of them a subcommand runs its headless
benchmark: one warm-up from the start state (it builds and loads the
kernels; not timed), then the timed run from the start state, bracketed by
synchronisation, and its report lines.  The live loop times its frames
too.  Every frame and RGB function copies what it shows to the host once a
frame (`.cpu()`), then renders with numpy.

hypersonic2d, hypersonic3d: `--impl cuda` (default) steps through the CUDA
kernels and needs `--device cuda`; `--impl torch` steps through their
plain PyTorch versions on either device, for timing and comparison.  There
is no automatic choice between them: what is asked for runs, or the
command fails.  `--view` picks the view mode of the frames and PNGs;
hypersonic2d's `--serve` streams the view live to viewer/index.html as a
growing depth-1 `.4spl` (`--frames`, `--steps-per-frame`, `--serve-max`,
`--port`, `--out`).

th3cs: the `.4spl` schlieren volume-video export; the CUDA kernels on a
GPU, their plain versions on the CPU; the engine that ran is printed.
`--serve` streams it live to viewer/index.html while it runs.

sph: `--engine auto` resolves as solvers.sph.resolve_engine does (the CUDA
kernels on a GPU unless --xsph, else the plain cell-dense engine); the
engine that ran is printed beside the rate.

gray-scott, lbm: `--engine auto` resolves as the solvers' resolve_engine
does (the CUDA kernels on a GPU, `--block-k` steps a K-step launch; the
plain torch step on the CPU; `cuda` on the CPU fails); they print the
engine, steps/s and Mcell-steps/s (Gray–Scott) or MLUPS (LBM, cells x
steps / s / 1e6 as tau_lbm.cu:291-294).  The warm-up is block_k + 1
steps.  Gray–Scott's `--nx`/`--ny` default to 0: the terminal's size when
rendering, else 128.

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

mpm: the same engine rule as flip (the CUDA kernels on a GPU, the
cell-dense `dense` engine on the CPU; `cuda` on the CPU fails; `scatter`
is the exact engine anywhere; `--engine auto` is the default here, JAX's
CLI defaults to dense); it prints the engine, steps/s and M
particle-steps/s, the mean height of the final state and the overflow
count.  `--cols`/`--rows` size its frames.  The warm-up is one step.

nbody: the prime-graph layout of 2^17 bodies by default; engine `exact`
steps the all-pairs repulsion through its CUDA kernel on a GPU (its plain
version on the CPU), `grid` the grid-monopole approximation in plain
PyTorch; `--native` runs the threaded Barnes–Hut engine on the host
(`--threads`, `--theta`).  It prints JAX's two report lines (steps/s and
the layout's extent) after a line naming the engine and device, and with
`--render` the final frame; `--render --stride N --steps M` animates a
live view for M steps and `--interactive` runs it until 'q', with JAX's
keys.  `--save-state`/`--load-state` checkpoint the layout.  The warm-up
is one step.

regression: the flagship's snapshot regression gate on `--device`
(regression.run_regression); exits with its code.  hypersonic2d-cpu: the
numpy CPU reference (`--native`: its C build, bitwise equal).
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

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


# ------------------------------ driver surface -------------------------------


def _norm01(a):
    import numpy as np

    a = np.asarray(a, np.float64)
    lo, hi = np.nanmin(a), np.nanmax(a)
    return np.nan_to_num((a - lo) / max(hi - lo, 1e-30))


def _host(*tensors):
    """numpy copies of tensors of one shape and dtype, in one transfer."""
    import torch

    if len(tensors) == 1:
        return tensors[0].cpu().numpy()
    return tuple(torch.stack(tensors).cpu().numpy())


def _png_path(base: str, idx: int | None):
    if idx is None:
        return base
    stem, dot, ext = base.rpartition(".")
    return f"{stem}_{idx:04d}.{ext}" if dot else f"{base}_{idx:04d}"


def _maybe_png(args, rgb_fn, state, idx=None):
    if getattr(args, "png", None) and rgb_fn is not None:
        from .io.png import write_png

        path = _png_path(args.png, idx)
        write_png(path, rgb_fn(state))
        if idx is None:
            print(f"wrote {path}")


def _maybe_load(args, state):
    if getattr(args, "load_state", None):
        from .core.checkpoint import load_state

        state = load_state(args.load_state, state,
                           strict=not getattr(args, "load_lenient", False))
        print(f"resumed from {args.load_state}")
    return state


def _maybe_save(args, out):
    if getattr(args, "save_state", None):
        from .core.checkpoint import save_state

        save_state(args.save_state, out)
        print(f"saved state to {args.save_state}")
    return out


def _rates(tp) -> dict:
    """A core.metrics.Throughput's report under the keys of
    core.stepper.benchmark, which the subcommands' report lines read."""
    res = tp.report()
    return {**res, "cells": tp.cells,
            "mcells_per_sec": res.get("mlups", 0.0)}


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


def _live(args, run, state, name, cells, frame_fn, rgb_fn):
    """The live frame loop, core.stepper.frame_loop with one `run` of
    `--stride` steps a frame (the remainder of `--steps` the last
    frame's): after each frame's steps the PNG and the terminal frame.
    Rated by core.metrics.Throughput from the first step to the last
    frame, bracketed by synchronisation.  Returns (final state, rates)."""
    from .core.metrics import Throughput
    from .core.stepper import device_of, frame_loop, sync

    def on_frame(f, st):
        n = min(args.stride, args.steps - f * args.stride)
        tp.tick(n)
        done = f * args.stride + n
        _maybe_png(args, rgb_fn, st, idx=f)
        if args.render:
            frame = frame_fn(st)
            if f:
                sys.stdout.write(f"\x1b[{frame.count(chr(10)) + 2}A")
            print(frame)
            print(f"[{name}] step {done}/{args.steps}", flush=True)

    n_full, rem = divmod(args.steps, args.stride)
    device = device_of(state)
    sync(device)
    tp = Throughput(cells=cells)
    out = frame_loop(lambda st: run(st, args.stride), state, n_full, 1,
                     on_frame)
    if rem:
        out = frame_loop(lambda st: run(st, rem), out, 1, 1,
                         lambda f, st: on_frame(n_full, st))
    sync(device)
    return out, _rates(tp)


def _drive(args, run, state, name: str, warmup: int, cells: int, report,
           frame_fn=None, rgb_fn=None):
    """A solver subcommand's run (JAX's `_run_headless`): `--load-state`
    first; with `--render` or `--png` and `--stride N` (and a frame
    function) the live loop, else (with steps to run) the headless
    benchmark; then
    `report(out, rates)` prints the subcommand's lines, then the final PNG,
    `--save-state` and, with `--render` and no stride, the final frame.
    Returns the final state."""
    state = _maybe_load(args, state)
    if getattr(args, "png", None) and rgb_fn is None:
        print(f"WARNING: --png has no effect for {name} (no RGB export for "
              "this solver)", file=sys.stderr)
    live = (frame_fn is not None and (args.render or args.png)
            and not args.headless and args.stride > 0 and args.steps > 0)
    if live:
        out, res = _live(args, run, state, name, cells, frame_fn, rgb_fn)
    elif args.steps <= 0:
        # nothing to time (and no warm-up, which may touch the state)
        from .core.metrics import Throughput

        out, res = state, _rates(Throughput(cells=cells))
    else:
        out, res = _bench_run(run, state, args.steps, warmup, cells)
    report(out, res)
    if not live:
        _maybe_png(args, rgb_fn, out)
    _maybe_save(args, out)
    if (frame_fn is not None and args.render and not args.headless
            and not args.stride):
        print(frame_fn(out))
    return out


def _interactive_header(line: str) -> None:
    print(f"{line}: interactive ([q] quits)", flush=True)


def _basic_interactive(args, s0, make_runner, frame, reset_fn,
                       extra_keys=None, status_fn=None):
    """Wire the common pause / step-once / reset keys plus solver
    extras into core.interactive.interactive_loop (the reference's L4
    frame-loop controls; the q-only demos like tau_burgers.cu:752 get
    pause/reset on top)."""
    keys = {
        "p": ("pause", lambda ctx: setattr(ctx, "paused", not ctx.paused)),
        " ": ("step", lambda ctx: setattr(ctx, "step_once", True)),
        "r": ("reset", lambda ctx: setattr(ctx, "state", reset_fn())),
    }
    if extra_keys:
        keys.update(extra_keys)
    return _loop(args, s0, make_runner, frame, keys, status_fn)


def _loop(args, s0, make_runner, frame, keys, status_fn):
    from .core.interactive import interactive_loop

    return interactive_loop(
        s0, make_runner, frame, keys, stride=max(args.stride, 1),
        max_steps=args.steps or None, status_fn=status_fn,
        input_fn=args.input_fn)


def _terminal_auto_size(nx, ny, render, halfblocks=False, fallback=128):
    """Size the grid to the terminal when --nx/--ny are 0, like the
    reference (tau_gray_scott.cu:283-296): width = columns, height =
    rows-1 (doubled for half-block rendering); headless falls back to
    a fixed size."""
    import shutil

    if nx and ny:
        return nx, ny
    cols, rows = shutil.get_terminal_size(fallback=(fallback, fallback))
    if not render:
        cols = rows = fallback
    else:
        rows = max(rows - 1, 1) * (2 if halfblocks else 1)
    return nx or cols, ny or rows


def _halfblocks(top, bot) -> str:
    import numpy as np

    chars = np.where((top > 0) & (bot > 0), "█",
                     np.where(top > 0, "▀", np.where(bot > 0, "▄", " ")))
    return "\n".join("".join(r) for r in chars)


# -------------------------------- subcommands --------------------------------


def cmd_hypersonic2d(args):
    import numpy as np

    from .core.device import resolve_device
    from .kernels import hypersonic2d_cuda as hk
    from .render.colormap import jet
    from .render.terminal import render_palette256, render_ramp
    from .render.views import (VIEW_MODES, normalize_masked,
                               normalized_to_host, render_value)
    from .solvers import hypersonic2d as h2

    device = resolve_device(args.device)
    cfg = h2.default_config(
        nx=args.nx, ny=args.ny, gamma=args.gamma, cfl=args.cfl,
        visc_nu=args.visc_nu, visc_rho=args.visc_rho, visc_e=args.visc_e,
        inflow_mach=args.mach, dtype=args.dtype,
    )
    engine = _engine(cfg, args.impl, device, hk.step_core_plain,
                     hk.inflow_wavespeed_plain)
    s = h2.init(cfg, device)
    head = (f"hypersonic2d {cfg.nx}x{cfg.ny} {cfg.dtype} impl={args.impl} "
            f"device={_device_name(device)}")

    def run(st, n):
        return h2.run(cfg, st, n, **engine)

    def view_t(st, mode):
        return normalize_masked(render_value(cfg, st, mode), st.mask)

    if args.serve:
        # Live browser stream of the 2-D field (the reference renders every
        # 2-D solver in a live window, tau_hypersonic_cuda.cu:1892-1933):
        # the view field is mean-pooled to <= --serve-max per axis,
        # gamma-quantized on the device and streamed as a depth-1 .4spl
        # volume the web viewer's ?live=1 mode follows.
        from .io import fourspl
        from .io.live4spl import Stream4splWriter
        from .render.views import stream_frame_fn
        from .solvers.th3cs import stream_frames

        frame_fn, (wc, hc) = stream_frame_fn(cfg, run, args.view,
                                             args.steps_per_frame,
                                             args.serve_max)

        def produce(stream_path):
            with Stream4splWriter(stream_path, wc, hc, 1,
                                  fourspl.heat_palette(256)) as wtr:
                stream_frames(frame_fn, s, args.frames, wtr, verbose=True)

        print(f"{head}: streaming {args.frames} frames x "
              f"{args.steps_per_frame} steps, {wc}x{hc} view {args.view}",
              flush=True)
        _live_serve(args.out, args.port, produce)
        return None

    def frame(st):
        t = view_t(st, args.view).cpu().numpy()
        if args.colors == "256":
            bands = np.clip((t * 255 + 0.5).astype(int), 0, 255)
            return render_palette256(bands)
        return render_ramp(t, normalize=False)

    if args.interactive:
        # reference key set: R reset, M view cycle, SPACE pause
        # (tau_hypersonic_cuda.cu:1825-1831; SPACE is a toggle here)
        view = {"mode": args.view}

        def iframe(st):
            return render_ramp(view_t(st, view["mode"]).cpu().numpy(),
                               normalize=False)

        def cycle_view(ctx):
            i = VIEW_MODES.index(view["mode"])
            view["mode"] = VIEW_MODES[(i + 1) % len(VIEW_MODES)]

        keys = {
            "r": ("reset", lambda ctx: setattr(ctx, "state",
                                               h2.init(cfg, device))),
            "m": ("view", cycle_view),
            " ": ("pause", lambda ctx: setattr(ctx, "paused",
                                               not ctx.paused)),
        }
        _interactive_header(head)
        return _loop(args, s, lambda: run, iframe, keys,
                     lambda ctx: f"view={view['mode']} "
                                 f"t={float(ctx.state.t):.5f}")

    def rgb(st):
        t, solid = normalized_to_host(cfg, st, args.view)
        img = jet(np.clip(t, 0, 1))
        img[solid] = 0
        return img

    def report(out, res):
        print(f"{head}: {res['steps']} steps in {res['wall_s']:.3f}s -> "
              f"{res['steps_per_sec']:.1f} steps/s, "
              f"{res['mcells_per_sec']:.1f} Mcell-steps/s")
        print(f"t = {float(out.t):.6f}")

    # One warm-up step builds and loads the kernels; it is not timed.
    return _drive(args, run, s, "hypersonic2d", 1, cfg.nx * cfg.ny, report,
                  frame_fn=frame, rgb_fn=rgb)


def cmd_sph(args):
    from dataclasses import replace as _rep

    from .core.device import resolve_device
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
    s = sph.init(cfg, device)
    head = (f"sph n={cfg.n} {cfg.dtype} engine={engine} "
            f"device={_device_name(device)}")

    def frame(st, c=cfg):
        grid = sph.rasterize_counts(c, st.pos, W=args.cols,
                                    H=args.rows).cpu().numpy()
        return _halfblocks(grid[0::2][:args.rows], grid[1::2][:args.rows])

    if args.interactive:
        # reference key set (tau_sph.cu:622-657): p pause, SPACE step-once,
        # r reset, g gravity, v viscosity, =/- smoothing length, ]/[ c0,
        # >/< dTau.  h/c0/grav/visc nudges rebuild the runner from the new
        # config (the analog of ensure_cell_buffers re-deriving the cell
        # grid); dTau only enters the clock math, so it rides as an
        # argument of run (the reference's instant keys).
        box = {"cfg": cfg, "dtau": cfg.dtau}

        def nudge(**field_factors):
            def h(ctx):
                c = box["cfg"]
                box["cfg"] = _rep(c, **{f: getattr(c, f) * m if m else
                                        not getattr(c, f)
                                        for f, m in field_factors.items()})
                ctx.invalidate()
            return h

        def nudge_dtau(mult):
            def h(ctx):
                box["dtau"] *= mult
            return h

        def make_runner():
            c = box["cfg"]
            return lambda st, n: sph.run(c, st, n, dtau=box["dtau"])

        keys = {
            "p": ("pause", lambda ctx: setattr(ctx, "paused",
                                               not ctx.paused)),
            " ": ("step", lambda ctx: setattr(ctx, "step_once", True)),
            "r": ("reset", lambda ctx: setattr(
                ctx, "state", sph.init(box["cfg"], device))),
            "g": ("grav", nudge(use_grav=None)),
            "v": ("visc", nudge(use_visc=None)),
            "=": ("h+", nudge(h_mul=1.05)),
            "-": ("h-", nudge(h_mul=0.95)),
            "]": ("c0+", nudge(c0=1.05)),
            "[": ("c0-", nudge(c0=0.95)),
            ">": ("dTau+", nudge_dtau(1.2)),
            "<": ("dTau-", nudge_dtau(1 / 1.2)),
        }
        _interactive_header(head)
        return _loop(
            args, s, make_runner, lambda st: frame(st, box["cfg"]), keys,
            lambda ctx: (
                f"t={float(ctx.state.t):.3f} h={box['cfg'].h:.4f} "
                f"c0={box['cfg'].c0:.2f} dTau={box['dtau']:.3f} "
                f"grav={box['cfg'].use_grav} visc={box['cfg'].use_visc}"))

    def report(out, res):
        print(f"{head}: {res['steps']} steps in {res['wall_s']:.3f}s -> "
              f"{res['steps_per_sec']:.1f} steps/s, "
              f"{res['mcells_per_sec']:.2f}M particle-steps/s")
        print(f"t = {float(out.t):.4f} tau = {float(out.tau):.4f}")
        n_dropped = int(sph.overflow_count(cfg, out))
        print(f"overflow: {n_dropped} particles beyond the cell capacity "
              f"K={cfg.grid().K}")
        if n_dropped > 0:
            print(f"WARNING: {n_dropped}/{cfg.n} particles exceed the "
                  "cell-dense bin capacity and are excluded from "
                  "interactions this frame; raise --bin-capacity or use "
                  "--engine exact", file=sys.stderr)

    # One warm-up step builds and loads the kernels; it is not timed.
    return _drive(args, lambda st, n: sph.run(cfg, st, n), s, "sph", 1,
                  cfg.n, report, frame_fn=frame)


def cmd_hypersonic3d(args):
    from .core.device import resolve_device
    from .kernels import hypersonic3d_cuda as hk3
    from .render.terminal import render_ramp
    from .solvers import hypersonic3d as h3

    device = resolve_device(args.device)
    cfg = h3.default_config(args.n, dtype=args.dtype, outflow=args.outflow)
    engine = _engine(cfg, args.impl, device, hk3.step_core_plain,
                     hk3.wavespeed_plain)
    s = h3.init(cfg, device)
    head = (f"hypersonic3d {cfg.nx}^3 {cfg.dtype} outflow={cfg.outflow} "
            f"impl={args.impl} device={_device_name(device)}")
    box = {"view": args.view, "log": False, "zslice": cfg.nz // 2,
           "a_gain": 1.0}

    def frame(st):
        import numpy as np

        vol = h3.vis_field(cfg, st, box["view"])[box["zslice"]]
        vol = vol.cpu().numpy()
        if box["log"]:
            vol = np.log1p(np.abs(vol))
        return render_ramp(vol)

    def run(st, n):
        return h3.run(cfg, st, n, **engine)

    if args.interactive:
        # reference key set (tau_hypersonic_3d_cuda.cu:1645-1672): SPACE
        # pause, M view cycle, L log scale, R reset, -/= inflow gain nudge
        # (an argument of run: nothing is rebuilt), [/] z-slice
        def make_runner():
            return lambda st, n: h3.run(cfg, st, n, gain_mul=box["a_gain"],
                                        **engine)

        def cycle_view(ctx):
            modes = h3.VIS_MODES
            box["view"] = modes[(modes.index(box["view"]) + 1) % len(modes)]

        def gain(f, lo, hi):
            def h(ctx):
                box["a_gain"] = min(max(box["a_gain"] * f, lo), hi)
            return h

        _interactive_header(head)
        return _basic_interactive(
            args, s, make_runner, frame, lambda: h3.init(cfg, device),
            extra_keys={
                "m": ("view", cycle_view),
                "l": ("log", lambda ctx: box.update(log=not box["log"])),
                "-": ("gain-", gain(0.85, 0.05, 2.0)),
                "=": ("gain+", gain(1.18, 0.05, 2.0)),
                "[": ("slice-", lambda ctx: box.update(
                    zslice=(box["zslice"] - 1) % cfg.nz)),
                "]": ("slice+", lambda ctx: box.update(
                    zslice=(box["zslice"] + 1) % cfg.nz)),
            },
            status_fn=lambda ctx: (
                f"t={float(ctx.state.t):.4f} view={box['view']}"
                f"{' log' if box['log'] else ''} z={box['zslice']} "
                f"a_gain={box['a_gain']:.2f}"))

    def report(out, res):
        print(f"{head}: {res['steps']} steps in {res['wall_s']:.3f}s -> "
              f"{res['steps_per_sec']:.1f} steps/s, "
              f"{res['mcells_per_sec']:.1f} Mcell-steps/s")
        refl = float(h3.outflow_reflection_metric(cfg, out))
        print(f"t = {float(out.t):.6f} dtau = {float(out.dtau):.3e} "
              f"refl_dp = {refl:.3e}")

    # One warm-up step builds and loads the kernels; it is not timed.
    return _drive(args, run, s, "hypersonic3d",
                  1, cfg.nx * cfg.ny * cfg.nz, report, frame_fn=frame)


def _live_serve(out_path, port, produce):
    """Shared --serve scaffolding: serve a temp dir holding the web viewer
    plus a growing volume.4spl, run `produce(stream_path)` (the streaming
    export), copy the result to `out_path`, then keep serving the replay
    until Ctrl-C/SIGTERM.  The reference's live window
    (tau_hypersonic_cuda.cu:1892-1933, tau_hypersonic_3d_cuda.cu:1416-1497)
    re-homed to a browser polling the stream.  The viewer is the
    repository's viewer/index.html."""
    import pathlib
    import shutil
    import signal
    import tempfile

    from .io.live4spl import serve_dir

    # a supervisor's SIGTERM must exit the serve loop as cleanly as Ctrl-C
    # (flush/copy the stream, shut the server down), as the interactive
    # raw-mode traps do (core/interactive.py)
    def _term(signum, frame):
        raise KeyboardInterrupt

    prev_term = signal.signal(signal.SIGTERM, _term)
    viewer = (pathlib.Path(__file__).resolve().parent.parent
              / "viewer" / "index.html")
    with tempfile.TemporaryDirectory(prefix="fst_live_") as tmp:
        shutil.copy(viewer, pathlib.Path(tmp) / "index.html")
        stream_path = pathlib.Path(tmp) / "volume.4spl"
        srv, _ = serve_dir(tmp, port)
        bound = srv.server_address[1]
        print(f"live viewer: http://127.0.0.1:{bound}/index.html?live=1",
              flush=True)
        try:
            produce(stream_path)
            shutil.copy(stream_path, out_path)
            print(f"wrote {out_path}; still serving the replay "
                  "(Ctrl-C to stop)", flush=True)
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            # mid-stream interrupt: persist whatever frames completed so
            # --out is never empty when the caller asked for an export
            if not pathlib.Path(out_path).exists() and stream_path.exists():
                shutil.copy(stream_path, out_path)
                print(f"interrupted; wrote partial {out_path}", flush=True)
        finally:
            srv.shutdown()
            signal.signal(signal.SIGTERM, prev_term)


def cmd_th3cs(args):
    import torch

    from .core.device import resolve_device
    from .solvers import hypersonic3d as h3
    from .solvers.th3cs import export_4spl, export_4spl_streamed

    device = resolve_device(args.device)
    engine = "cuda" if device.type == "cuda" else "torch"
    cfg = h3.default_config(args.n)
    if args.serve:
        print(f"th3cs {cfg.nx}^3 engine={engine} "
              f"device={_device_name(device)}: streaming {args.frames} "
              f"frames x {args.steps_per_frame} steps", flush=True)
        _live_serve(args.out, args.port,
                    lambda sp: export_4spl_streamed(
                        sp, cfg, frames=args.frames,
                        steps_per_frame=args.steps_per_frame, device=device,
                        engine=engine, verbose=True))
        return
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


def cmd_gray_scott(args):
    from .core.device import resolve_device
    from .render.colormap import jet
    from .render.terminal import render_halfblocks, render_ramp
    from .solvers import gray_scott as gs

    device = resolve_device(args.device)
    nx, ny = _terminal_auto_size(args.nx, args.ny, args.render,
                                 args.halfblocks)
    cfg = gs.GrayScottConfig(
        nx=nx, ny=ny, dx=args.dx, dt=args.dt, Du=args.Du,
        Dv=args.Dv, feed=args.F, kill=args.k, seed=args.seed,
        dtype=args.dtype, engine=args.engine, block_k=args.block_k)
    engine = gs.resolve_engine(cfg, device)
    s = gs.init(cfg, device)
    head = (f"gray-scott {cfg.nx}x{cfg.ny} {cfg.dtype} engine={engine} "
            f"block_k={cfg.block_k} device={_device_name(device)}")

    def frame(st):
        v = st.v.cpu().numpy()
        return render_halfblocks(v) if args.halfblocks else render_ramp(v)

    if args.interactive:
        # live F/k nudges as arguments of run (nothing is rebuilt): explore
        # the Gray-Scott pattern space from the keyboard
        box = {"feed": cfg.feed, "kill": cfg.kill}

        def nudge(key, d):
            def h(ctx):
                box[key] = max(box[key] + d, 0.0)
            return h

        _interactive_header(head)
        return _basic_interactive(
            args, s, lambda: (lambda st, n: gs.run(
                cfg, st, n, feed=box["feed"], kill=box["kill"])),
            frame, lambda: gs.init(cfg, device),
            extra_keys={
                "F": ("F+", nudge("feed", 0.001)),
                "f": ("F-", nudge("feed", -0.001)),
                "K": ("k+", nudge("kill", 0.0005)),
                "k": ("k-", nudge("kill", -0.0005)),
            },
            status_fn=lambda ctx: (f"F={box['feed']:.4f} "
                                   f"k={box['kill']:.4f}"))

    def report(out, res):
        print(f"{head}: {res['steps']} steps in {res['wall_s']:.3f}s -> "
              f"{res['steps_per_sec']:.1f} steps/s, "
              f"{res['mcells_per_sec']:.1f} Mcell-steps/s")
        print(f"v: min {float(out.v.min()):.4f} max {float(out.v.max()):.4f}")

    return _drive(args, lambda st, n: gs.run(cfg, st, n), s, "gray-scott",
                  cfg.block_k + 1, cfg.nx * cfg.ny, report, frame_fn=frame,
                  rgb_fn=lambda st: jet(_norm01(st.v.cpu().numpy())))


def cmd_lbm(args):
    from dataclasses import replace as _rep

    import numpy as np

    from .core.device import resolve_device
    from .render.colormap import jet
    from .render.terminal import render_ramp
    from .solvers import lbm

    device = resolve_device(args.device)
    cfg = lbm.LBMConfig(
        nx=args.nx, ny=args.ny, tau=args.tau, drive=args.drive,
        obstacle=not args.no_obstacle, obstacle_radius=args.radius,
        dtype=args.dtype, engine=args.engine, block_k=args.block_k)
    engine = lbm.resolve_engine(cfg, device)
    s = lbm.init(cfg, device)
    head = (f"lbm {cfg.nx}x{cfg.ny} {cfg.dtype} engine={engine} "
            f"block_k={cfg.block_k} device={_device_name(device)}")

    def frame(st, c=cfg):
        sp = lbm.speed_field(c, st).cpu().numpy()
        return render_ramp(np.maximum(sp, 0.0))

    if args.interactive:
        # reference key set (tau_lbm.cu:281-286): +/- drive nudges (an
        # argument of run, instant as the reference's keys), o obstacle
        # toggle (re-initializes the field like init_kernel)
        box = {"cfg": cfg, "drive": cfg.drive}

        def make_runner():
            c = box["cfg"]
            return lambda st, n: lbm.run(c, st, n, drive=box["drive"])

        def drive(mult):
            def h(ctx):
                box["drive"] *= mult
            return h

        def toggle_obstacle(ctx):
            box["cfg"] = _rep(box["cfg"], obstacle=not box["cfg"].obstacle)
            ctx.state = lbm.init(box["cfg"], device)
            ctx.invalidate()

        keys = {
            "+": ("drive+", drive(1.2)),
            "-": ("drive-", drive(1 / 1.2)),
            "o": ("obstacle", toggle_obstacle),
            " ": ("pause", lambda ctx: setattr(ctx, "paused",
                                               not ctx.paused)),
        }
        _interactive_header(head)
        return _loop(args, s, make_runner, lambda st: frame(st, box["cfg"]),
                     keys, lambda ctx: (f"drive={box['drive']:.2e} "
                                        f"obstacle={box['cfg'].obstacle}"))

    def report(out, res):
        print(f"{head}: {res['steps']} steps in {res['wall_s']:.3f}s -> "
              f"{res['steps_per_sec']:.1f} steps/s, "
              f"{res['mcells_per_sec']:.1f} MLUPS")
        sp = lbm.speed_field(cfg, out)
        print(f"max |u| = {float(sp.max()):.5f}")

    return _drive(args, lambda st, n: lbm.run(cfg, st, n), s, "lbm",
                  cfg.block_k + 1, cfg.nx * cfg.ny, report, frame_fn=frame,
                  rgb_fn=lambda st: jet(_norm01(
                      lbm.speed_field(cfg, st).cpu().numpy())))


def _head(name, cfg, engine, device) -> str:
    return (f"{name} {cfg.nx}x{cfg.ny} {cfg.dtype} engine={engine} "
            f"block_k={cfg.block_k} device={_device_name(device)}")


def _report(name, cfg, engine, device, res) -> None:
    print(f"{_head(name, cfg, engine, device)}: {res['steps']} steps in "
          f"{res['wall_s']:.3f}s -> {res['steps_per_sec']:.1f} steps/s, "
          f"{res['mcells_per_sec']:.1f} Mcell-steps/s")


def cmd_burgers(args):
    import numpy as np

    from .core.device import resolve_device
    from .render.colormap import jet
    from .render.terminal import render_ramp
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
    s = bg.init(cfg, device)

    def run(st, n):
        return bg.run(cfg, st, n)

    def uv(st):
        return _host(*bg.velocities(cfg, st))

    def frame(st):
        return render_ramp(np.hypot(*uv(st)), dither=True)

    def rgb(st):
        return jet(_norm01(np.hypot(*uv(st))))

    if args.interactive:
        box = {"view": "speed"}

        def iframe(st):
            u, v = uv(st)
            f = {"speed": np.hypot(u, v), "u": u, "v": v}[box["view"]]
            return render_ramp(f, dither=True)

        def status(ctx):
            ch = (f" colehopf_relL2={bg.cole_hopf_rel_l2(cfg, ctx.state):.2e}"
                  if cfg.colehopf else "")
            return f"t={float(ctx.state.t):.4f} view={box['view']}{ch}"

        _interactive_header(_head("burgers", cfg, engine, device))
        return _basic_interactive(
            args, s, lambda: run, iframe, lambda: bg.init(cfg, device),
            extra_keys={"m": ("view", lambda ctx: box.update(
                view={"speed": "u", "u": "v", "v": "speed"}[box["view"]]))},
            status_fn=status)

    def report(out, res):
        _report("burgers", cfg, engine, device, res)
        if cfg.colehopf:
            print(f"Cole-Hopf rel L2 error "
                  f"{bg.cole_hopf_rel_l2(cfg, out):.4e}")

    return _drive(args, run, s, "burgers", cfg.block_k + 1, cfg.nx * cfg.ny,
                  report, frame_fn=frame, rgb_fn=rgb)


def cmd_shallow_water(args):
    import numpy as np

    from .core.device import resolve_device
    from .render.colormap import jet
    from .render.terminal import autocontrast, render_ramp
    from .solvers import shallow_water as sw

    device = resolve_device(args.device)
    cfg = sw.ShallowWaterConfig(
        nx=args.nx, ny=args.ny, dx=args.dx, dy=args.dy, g=args.g, f0=args.f0,
        nu=args.nu, H0=args.H0, bump_amp=args.amp, bump_sigma=args.bsig,
        offx=args.offx, offy=args.offy, asym=args.asym, swirl=args.swirl,
        swirl_rc=args.rc, tau0=args.tau0, t0=args.t0, dtau=args.dtau,
        dtype=args.dtype, engine=args.engine, block_k=args.block_k)
    engine = sw.resolve_engine(cfg, device)
    s = sw.init(cfg, device)

    def run(st, n):
        return sw.run(cfg, st, n)

    def frame(st):
        return render_ramp(autocontrast(st.sigma.cpu().numpy()),
                           normalize=False)

    if args.interactive:
        box = {"view": "sigma"}

        def iframe(st):
            if box["view"] == "sigma":
                f = st.sigma.cpu().numpy()
            else:
                f = np.hypot(*_host(st.u, st.v))
            return render_ramp(autocontrast(f), normalize=False)

        _interactive_header(_head("shallow-water", cfg, engine, device))
        return _basic_interactive(
            args, s, lambda: run, iframe, lambda: sw.init(cfg, device),
            extra_keys={"m": ("view", lambda ctx: box.update(
                view="speed" if box["view"] == "sigma" else "sigma"))},
            status_fn=lambda ctx: (f"t={float(ctx.state.t):.4f} "
                                   f"view={box['view']}"))

    def report(out, res):
        _report("shallow-water", cfg, engine, device, res)
        h = sw.depth(out)
        print(f"h: min {float(h.min()):.4f} max {float(h.max()):.4f}")

    return _drive(
        args, run, s, "shallow-water", cfg.block_k + 1, cfg.nx * cfg.ny,
        report, frame_fn=frame,
        rgb_fn=lambda st: jet(np.clip(autocontrast(st.sigma.cpu().numpy()),
                                      0, 1)))


def cmd_mhd(args):
    from dataclasses import replace as _rep

    from .core.device import resolve_device
    from .render.colormap import mhd_cmap
    from .render.terminal import render_ramp
    from .solvers import mhd

    device = resolve_device(args.device)
    cfg = mhd.MHDConfig(nx=args.nx, ny=args.ny, problem=args.case,
                        stable_hll=args.stable_hll, dtype=args.dtype,
                        engine=args.engine, block_k=args.block_k)
    engine = mhd.resolve_engine(cfg, device)
    s = mhd.init(cfg, device)

    def frame(st, c=cfg, view=args.view):
        return render_ramp(mhd.view_field(c, st, view).cpu().numpy())

    if args.interactive:
        # reference key set (tau_mhd.c:190-193): SPACE pause, R reset,
        # M view cycle, C problem cycle (re-inits)
        view_names = ["rho", "p", "|B|", "|divB|"]
        problems = ["briowu", "orszag-tang"]
        box = {"view": int(args.view), "cfg": cfg}

        def cycle_problem(ctx):
            prob = problems[(problems.index(box["cfg"].problem) + 1)
                            % len(problems)]
            box["cfg"] = _rep(box["cfg"], problem=prob)
            ctx.state = mhd.init(box["cfg"], device)
            ctx.invalidate()

        def make_runner():
            c = box["cfg"]
            return lambda st, n: mhd.run(c, st, n)

        _interactive_header(_head(f"mhd {cfg.problem}", cfg, engine, device))
        return _basic_interactive(
            args, s, make_runner,
            lambda st: frame(st, box["cfg"], box["view"]),
            lambda: mhd.init(box["cfg"], device),
            extra_keys={
                "m": ("view", lambda ctx: box.update(
                    view=(box["view"] + 1) % 4)),
                "c": ("problem", cycle_problem),
            },
            status_fn=lambda ctx: (f"t={float(ctx.state.t):.4f} "
                                   f"view={view_names[box['view']]} "
                                   f"problem={box['cfg'].problem}"))

    def report(out, res):
        _report(f"mhd {cfg.problem}", cfg, engine, device, res)
        print(f"t = {float(out.t):.6f}")

    return _drive(
        args, lambda st, n: mhd.run(cfg, st, n), s, "mhd", cfg.block_k + 1,
        cfg.nx * cfg.ny, report, frame_fn=frame,
        rgb_fn=lambda st: mhd_cmap(_norm01(
            mhd.view_field(cfg, st, args.view).cpu().numpy())))


def cmd_stam3d(args):
    import numpy as np

    from .core.device import resolve_device
    from .render.terminal import RAMP_BLOCKS, render_palette256
    from .solvers import stam3d

    device = resolve_device(args.device)
    cfg = stam3d.Stam3DConfig(
        n=args.n, dt=args.dt, visc=args.visc, diff=args.diff,
        decay=args.decay, src_gain=args.src_gain, src_freq=args.src_freq,
        seed_amp=args.amp, seed_noise=args.noise, seed_dens_amp=args.dens_amp,
        seed_sigma=args.sigma, jacobi_iters=args.jacobi, seed=args.seed,
        dtype=args.dtype, advect_k=args.advect_k, engine=args.engine)
    engine = stam3d.resolve_engine(cfg, device)
    s = stam3d.init(cfg, device)
    head = (f"stam3d {cfg.n}^3 {cfg.dtype} engine={engine} "
            f"advect_k={cfg.advect_k} device={_device_name(device)}")

    def run(st, n):
        return stam3d.run(cfg, st, n)

    def frame(st):
        img = stam3d.iso_render(cfg, st, W=args.cols, H=args.rows,
                                gain=args.gain, gamma=args.gamma,
                                levels=args.levels).cpu().numpy()
        if args.colors == "256":
            return render_palette256(img)
        t = img / max(img.max(), 1)
        idx = np.clip((t * 4 + 0.5).astype(int), 0, 4)
        return "\n".join("".join(RAMP_BLOCKS[k] for k in row) for row in idx)

    if args.interactive:
        _interactive_header(head)
        return _basic_interactive(
            args, s, lambda: run, frame, lambda: stam3d.init(cfg, device),
            status_fn=lambda ctx: f"engine={engine} advect_k={cfg.advect_k}")

    def report(out, res):
        print(f"{head}: {res['steps']} steps in {res['wall_s']:.3f}s -> "
              f"{res['steps_per_sec']:.2f} steps/s, "
              f"{res['mcells_per_sec']:.1f} Mcell-steps/s")
        if engine == "torch" and cfg.advect_k >= 1:
            capped = int(stam3d.advect_capped_count(cfg, out))
            print(f"advect capped: {capped} cells past advect_k="
                  f"{cfg.advect_k} on the final frame (--advect-k 0 gathers "
                  "exactly)")

    return _drive(args, run, s, "stam3d", 1, cfg.n ** 3, report,
                  frame_fn=frame)


def cmd_stam2d(args):
    import numpy as np

    from .core.device import resolve_device
    from .render.colormap import jet
    from .render.terminal import render_ramp
    from .solvers import stam2d

    device = resolve_device(args.device)
    cfg = stam2d.Stam2DConfig(n=args.n, dtype=args.dtype, engine=args.engine,
                              advect_band=args.advect_band)
    engine = stam2d.resolve_engine(cfg, device)
    s = stam2d.init(cfg, device)
    head = (f"stam2d {cfg.n}^2 {cfg.dtype} engine={engine} "
            f"device={_device_name(device)}")

    def run(st, n):
        return stam2d.run(cfg, st, n)

    def frame(st):
        return render_ramp(np.clip(st.d.cpu().numpy(), 0, 1), normalize=False)

    if args.interactive:
        _interactive_header(head)
        return _basic_interactive(
            args, s, lambda: run, frame, lambda: stam2d.init(cfg, device),
            status_fn=lambda ctx: f"engine={engine}")

    def report(out, res):
        print(f"{head}: {res['steps']} steps in {res['wall_s']:.3f}s -> "
              f"{res['steps_per_sec']:.2f} steps/s, "
              f"{res['mcells_per_sec']:.1f} Mcell-steps/s")
        over = int(stam2d.advect_overflow_count(cfg, out))
        print(f"advect_overflow_count: {over} cells of the final state "
              f"trace past advect_band={cfg.advect_band} rows (JAX's banded "
              f"TPU engine would clamp them; engine={engine} traces them "
              "exactly)")

    return _drive(args, run, s, "stam2d", 1, cfg.n ** 2, report,
                  frame_fn=frame,
                  rgb_fn=lambda st: jet(np.clip(st.d.cpu().numpy(), 0, 1)))


def cmd_flip(args):
    from .core.device import resolve_device
    from .render.terminal import render_ramp
    from .solvers import flip_apic as fa

    device = resolve_device(args.device)
    cfg = fa.FlipApicConfig(particles=args.particles, grid=args.grid,
                            jacobi=args.jacobi, dt=args.dt,
                            gravity=args.gravity, flip=args.flip,
                            apic=args.apic, engine=args.engine,
                            bin_capacity=args.bin_capacity, dtype=args.dtype)
    engine = fa.resolve_engine(cfg, device)
    s = fa.init(cfg, device)
    head = (f"flip-apic n={cfg.particles} grid={cfg.grid}^2 {cfg.dtype} "
            f"engine={engine} device={_device_name(device)}")

    def frame(st):
        return render_ramp(st.density.cpu().numpy()[::-1].astype(float))

    if args.interactive:
        # flip/apic blend nudges ride as arguments of run: nothing is
        # rebuilt
        box = {"flip": cfg.flip, "apic": cfg.apic}

        def blend(field, d):
            def h(ctx):
                box[field] = min(max(box[field] + d, 0.0), 1.0)
            return h

        _interactive_header(head)
        return _basic_interactive(
            args, s, lambda: (lambda st, n: fa.run(
                cfg, st, n, flip=box["flip"], apic=box["apic"])),
            frame, lambda: fa.init(cfg, device),
            extra_keys={
                "f": ("flip-", blend("flip", -0.05)),
                "F": ("flip+", blend("flip", 0.05)),
                "a": ("apic-", blend("apic", -0.05)),
                "A": ("apic+", blend("apic", 0.05)),
            },
            status_fn=lambda ctx: (f"flip={box['flip']:.2f} "
                                   f"apic={box['apic']:.2f}"))

    def report(out, res):
        print(f"{head}: {res['steps']} steps in {res['wall_s']:.3f}s -> "
              f"{res['steps_per_sec']:.1f} steps/s, "
              f"{res['mcells_per_sec']:.2f}M particle-steps/s")
        dens = out.density
        print(f"occupied={int((dens > 0).sum())} peak_cell={int(dens.max())}")
        n_dropped = int(fa.overflow_count(cfg, out))
        print(f"overflow: {n_dropped} particles beyond the cell capacity "
              f"K={cfg.capacity}")
        if n_dropped > 0:
            print(f"WARNING: {n_dropped}/{cfg.particles} particles exceed "
                  "the cell-dense bin capacity and are excluded from the "
                  "transfers this frame; raise --bin-capacity or use "
                  "--engine scatter for exact physics", file=sys.stderr)

    return _drive(args, lambda st, n: fa.run(cfg, st, n), s, "flip-apic", 1,
                  cfg.particles, report, frame_fn=frame)


def cmd_mpm(args):
    from dataclasses import replace as _rep

    import numpy as np

    from .core.device import resolve_device
    from .solvers import mpm

    device = resolve_device(args.device)
    cfg = mpm.MPMConfig(n=args.n, gx=args.gx, gy=args.gy, dt=args.dt,
                        gravity=args.gravity, seed=args.seed,
                        material=args.material, engine=args.engine,
                        bin_capacity=args.bin_capacity, dtype=args.dtype)
    engine = mpm.resolve_engine(cfg, device)
    s = mpm.init(cfg, device)
    head = (f"mpm n={cfg.n} grid={cfg.gx}x{cfg.gy} {cfg.material} "
            f"{cfg.dtype} engine={engine} device={_device_name(device)}")

    def frame(st):
        pos = st.pos.cpu().numpy()
        wd, hd = args.cols, args.rows
        cx = np.clip((pos[:, 0] / cfg.box_x * (wd - 1)).astype(int), 0,
                     wd - 1)
        sy = np.clip(((cfg.box_y - pos[:, 1]) / cfg.box_y
                      * (2 * hd - 1)).astype(int), 0, 2 * hd - 1)
        grid = np.zeros((2 * hd, wd), int)
        np.add.at(grid, (sy, cx), 1)
        return _halfblocks(grid[0::2], grid[1::2])

    if args.interactive:
        # material cycling + reset (the tau_mpm.cu material set as live
        # keys; cycling re-inits like the reference's per-material runs)
        mats = ["mud", "snow", "sand"]
        box = {"cfg": cfg}

        def make_runner():
            c = box["cfg"]
            return lambda st, n: mpm.run(c, st, n)

        def cycle_mat(ctx):
            c = box["cfg"]
            box["cfg"] = _rep(c, material=mats[
                (mats.index(c.material) + 1) % len(mats)])
            ctx.state = mpm.init(box["cfg"], device)
            ctx.invalidate()

        _interactive_header(head)
        return _basic_interactive(
            args, s, make_runner, frame,
            lambda: mpm.init(box["cfg"], device),
            extra_keys={"m": ("material", cycle_mat)},
            status_fn=lambda ctx: f"material={box['cfg'].material}")

    def report(out, res):
        print(f"{head}: {res['steps']} steps in {res['wall_s']:.3f}s -> "
              f"{res['steps_per_sec']:.1f} steps/s, "
              f"{res['mcells_per_sec']:.2f}M particle-steps/s")
        print(f"mean y {float(out.pos[:, 1].mean()):.6f}")
        n_dropped = int(mpm.overflow_count(cfg, out))
        print(f"overflow: {n_dropped} particles beyond the cell capacity "
              f"K={cfg.capacity}")
        if n_dropped > 0:
            print(f"WARNING: {n_dropped}/{cfg.n} particles exceed the "
                  "cell-dense bin capacity and are excluded from the "
                  "transfers this frame; raise --bin-capacity or use "
                  "--engine scatter for exact physics", file=sys.stderr)

    return _drive(args, lambda st, n: mpm.run(cfg, st, n), s, "mpm", 1,
                  cfg.n, report, frame_fn=frame)


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

        if args.load_state or args.save_state:
            raise SystemExit("--save-state/--load-state checkpoint the "
                             "device state; --native runs on the host")
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
                              _maybe_load(args, ng.init(cfg, device)),
                              args.steps, 1, cfg.n_bodies)
        wall = res["wall_s"]
        pos = out.pos.cpu().numpy()
        n_edges = int(out.edges.shape[0])
        print(f"nbody engine={cfg.engine} {cfg.dtype} "
              f"device={_device_name(device)}")
    rate = args.steps / wall if wall > 0 else 0.0
    print(f"nbody: {args.steps} steps, {cfg.n_bodies} nodes, "
          f"{n_edges} edges -> {rate:.1f} steps/s")
    print(f"layout extent: {np.abs(pos).max():.1f}")
    if args.png:
        print("WARNING: --png has no effect for nbody (no RGB export for "
              "this solver)", file=sys.stderr)
    if not args.native:
        _maybe_save(args, out)
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


def cmd_regression(args):
    from .core.device import resolve_device
    from .regression import run_regression

    device = resolve_device(args.device)
    print(f"regression hypersonic2d {args.nx}x{args.ny} steps={args.steps} "
          f"device={_device_name(device)}")
    code = run_regression(nx=args.nx, ny=args.ny, steps=args.steps,
                          baseline=args.baseline, write=args.write_baseline,
                          device=device)
    sys.exit(code)


def cmd_hypersonic2d_cpu(args):
    import numpy as np

    from .solvers.hypersonic2d_cpu import HypersonicCPU, HypersonicCPUConfig

    cfg = HypersonicCPUConfig(w=args.nx, h=args.ny, gamma=args.gamma,
                              cfl=args.cfl, mach=args.mach)
    if args.interactive:
        print("WARNING: --interactive has no effect for hypersonic2d-cpu "
              "(batch oracle solver; use hypersonic2d for the live view)",
              file=sys.stderr)
    if args.native:
        from .solvers.hypersonic2d_cpu_native import HypersonicCPUNative

        with HypersonicCPUNative(cfg) as sim:
            t0 = time.perf_counter()
            sim.step(args.steps)
            wall = time.perf_counter() - t0
            U, mask, t = sim.state
    else:
        sim = HypersonicCPU(cfg)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            sim.step()
        wall = time.perf_counter() - t0
        U, mask, t = sim.U, sim.mask, sim.t
    rho = np.maximum(U[..., 0], 1e-10)
    print(f"hypersonic2d-cpu[{'native' if args.native else 'numpy'}]: "
          f"{args.steps} steps in {wall:.3f}s -> "
          f"{args.steps / wall:.1f} steps/s")
    print(f"t = {t:.6f}  rho range [{rho[~mask].min():.4f}, "
          f"{rho[~mask].max():.4f}]")


def _common(p, steps_default: int) -> None:
    """The flags every solver subcommand shares (JAX's `_common`, with the
    port's `--device`)."""
    p.add_argument("--steps", type=int, default=steps_default,
                   help="number of physics steps")
    p.add_argument("--stride", type=int, default=0,
                   help="render every N steps (0 = only final frame)")
    p.add_argument("--render", action="store_true",
                   help="print terminal frames")
    p.add_argument("--headless", action="store_true",
                   help="benchmark mode (no rendering)")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    p.add_argument("--save-state", default=None, metavar="FILE.npz",
                   help="checkpoint the final state (core/checkpoint.py)")
    p.add_argument("--load-state", default=None, metavar="FILE.npz",
                   help="resume from a saved checkpoint")
    p.add_argument("--load-lenient", action="store_true",
                   help="accept a legacy checkpoint whose structure string "
                        "cannot be validated (load_state strict=False); "
                        "leaf count/shape checks still apply")
    p.add_argument("--interactive", action="store_true",
                   help="key-driven live mode (pause/step/reset plus "
                        "per-solver view cycles and parameter nudges)")
    p.add_argument("--png", default=None, metavar="FILE.png",
                   help="export the final frame as a PNG (with --stride: "
                        "numbered FILE_0000.png per rendered frame)")
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu; a missing GPU is an error")
    p.set_defaults(input_fn=None)


def _engine_args(p, block_k: int) -> None:
    p.add_argument("--engine", choices=("auto", "cuda", "torch"),
                   default="auto",
                   help="auto = the CUDA kernel on a GPU, the plain torch "
                        "step on the CPU")
    p.add_argument("--block-k", type=int, default=block_k, dest="block_k",
                   help="steps per K-step kernel launch (cuda engine; the "
                        "remainder runs one step a launch)")


def _impl_arg(p) -> None:
    p.add_argument("--impl", choices=("cuda", "torch"), default="cuda",
                   help="step implementation: the hand-written CUDA kernels "
                        "(needs --device cuda) or their plain PyTorch "
                        "versions")


def build_parser():
    from .render.views import VIEW_MODES
    from .solvers.hypersonic3d import VIS_MODES

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
    p.add_argument("--view", default="schlieren", choices=VIEW_MODES)
    p.add_argument("--colors", choices=("mono", "256"), default="mono",
                   help="256 = dynamic-palette ANSI renderer "
                        "(js_cuda3d.cu:471-517)")
    _impl_arg(p)
    p.add_argument("--serve", action="store_true",
                   help="stream the view field live to the web viewer "
                        "while the solver runs (prints the URL)")
    p.add_argument("--frames", type=int, default=120,
                   help="--serve frame count")
    p.add_argument("--steps-per-frame", type=int, default=4,
                   help="--serve physics steps per streamed frame")
    p.add_argument("--serve-max", type=int, default=256,
                   help="--serve raster cap per axis (mean-pooled)")
    p.add_argument("--port", type=int, default=0,
                   help="--serve HTTP port (0 = pick a free one)")
    p.add_argument("--out", default="hypersonic2d.4spl",
                   help="--serve stream export path")
    _common(p, 100)
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
    p.add_argument("--cols", type=int, default=100)
    p.add_argument("--rows", type=int, default=40)
    p.add_argument("--engine", choices=("auto", "cuda", "torch", "exact"),
                   default="auto",
                   help="auto = the CUDA kernels on a GPU (torch with "
                        "--xsph or on the CPU); exact = O(n^2) all pairs, "
                        "correct at any occupancy")
    p.add_argument("--bin-capacity", type=int, default=0, dest="bin_capacity",
                   help="cell-dense slots per cell (0 = auto); particles "
                        "beyond it are dropped and reported")
    _common(p, 100)
    p.set_defaults(fn=cmd_sph)

    p = sub.add_parser("hypersonic3d",
                       help="3-D hypersonic flow (tau_hypersonic_3d_cuda)")
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--view", default="schlieren", choices=VIS_MODES)
    p.add_argument("--outflow", choices=("transmissive", "characteristic"),
                   default="transmissive")
    _impl_arg(p)
    _common(p, 100)
    p.set_defaults(fn=cmd_hypersonic3d)

    p = sub.add_parser("th3cs", help=".4spl volume-video export (th3cs)")
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--out", default="tau_hypersonic.4spl")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--steps-per-frame", type=int, default=4)
    p.add_argument("--serve", action="store_true",
                   help="stream frames to the web viewer while the "
                        "solver runs (prints the live URL)")
    p.add_argument("--port", type=int, default=0,
                   help="--serve HTTP port (0 = pick a free one)")
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu; a missing GPU is an error")
    p.set_defaults(fn=cmd_th3cs)

    p = sub.add_parser("gray-scott",
                       help="reaction-diffusion (tau_gray_scott)")
    p.add_argument("--nx", type=int, default=0,
                   help="0 = terminal width when rendering, else 128")
    p.add_argument("--ny", type=int, default=0,
                   help="0 = terminal height when rendering, else 128")
    p.add_argument("--dx", type=float, default=1.0)
    p.add_argument("--dt", type=float, default=1.0)
    p.add_argument("--Du", type=float, default=0.2)
    p.add_argument("--Dv", type=float, default=0.1)
    p.add_argument("--F", type=float, default=0.03)
    p.add_argument("--k", type=float, default=0.06)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--halfblocks", action="store_true")
    p.add_argument("--engine", choices=("auto", "cuda", "torch"),
                   default="auto",
                   help="auto = the CUDA kernels on a GPU, the plain torch "
                        "step on the CPU")
    p.add_argument("--block-k", type=int, default=16, dest="block_k",
                   help="steps per K-step kernel launch (cuda engine; 1 = "
                        "the one-step kernel every step)")
    _common(p, 2000)
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
    _common(p, 1000)
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
    _common(p, 2000)
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
    _common(p, 2000)
    p.set_defaults(fn=cmd_shallow_water)

    p = sub.add_parser("mhd", help="ideal MHD + GLM cleaning (tau_mhd)")
    p.add_argument("--nx", type=int, default=320)
    p.add_argument("--ny", type=int, default=220)
    p.add_argument("--case", default="briowu",
                   choices=["briowu", "orszag-tang"])
    p.add_argument("--view", type=int, default=0, choices=(0, 1, 2, 3),
                   help="0 rho, 1 p, 2 |B|, 3 |divB| (tau_mhd.c:178-183)")
    p.add_argument("--stable-hll", action="store_true")
    _engine_args(p, 16)
    _common(p, 200)
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
    # iso-splat tone map (js_cuda3d.cu getopt: gain/gamma/levels)
    p.add_argument("--gain", type=float, default=0.2)
    p.add_argument("--gamma", type=float, default=1.2)
    p.add_argument("--levels", type=int, default=256)
    p.add_argument("--cols", type=int, default=100)
    p.add_argument("--rows", type=int, default=40)
    p.add_argument("--advect-k", type=int, default=2, dest="advect_k",
                   help="torch engine: 0 = exact gather advection; K >= 1 "
                        "= dense-shift advection, exact for backtraces <= "
                        "K cells (capped cells are reported); the cuda "
                        "engine always gathers")
    p.add_argument("--engine", choices=("auto", "cuda", "torch"),
                   default="auto",
                   help="auto = the CUDA kernels on a GPU, the plain torch "
                        "step on the CPU")
    p.add_argument("--colors", choices=("mono", "256"), default="mono",
                   help="256 = dynamic-palette ANSI renderer "
                        "(js_cuda3d.cu:471-517)")
    _common(p, 20)
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
    _common(p, 100)
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
    _common(p, 200)
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
    p.add_argument("--cols", type=int, default=100)
    p.add_argument("--rows", type=int, default=40)
    p.add_argument("--engine", choices=("auto", "cuda", "dense", "scatter"),
                   default="auto",
                   help="auto = the CUDA kernels on a GPU, the cell-dense "
                        "engine on the CPU; cuda and scatter are exact, "
                        "dense drops particles past --bin-capacity")
    p.add_argument("--bin-capacity", type=int, default=0, dest="bin_capacity",
                   help="cell-dense slots per cell (0 = auto); particles "
                        "beyond it are dropped and reported")
    _common(p, 500)
    p.set_defaults(fn=cmd_mpm)

    p = sub.add_parser("regression",
                       help="snapshot regression gate "
                            "(tau_hypersonic_cuda_tests)")
    p.add_argument("--nx", type=int, default=2048)
    p.add_argument("--ny", type=int, default=1024)
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--baseline", default="hypersonic2d_baseline.txt")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--write-baseline", action="store_true")
    g.add_argument("--verify-baseline", action="store_true", default=True)
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu; a missing GPU is an error")
    p.set_defaults(fn=cmd_regression)

    p = sub.add_parser("hypersonic2d-cpu",
                       help="CPU reference 2-D hypersonic solver "
                            "(tau_hypersonic / tau_hypersonic_simd)")
    p.add_argument("--nx", type=int, default=300)
    p.add_argument("--ny", type=int, default=300)
    p.add_argument("--gamma", type=float, default=1.4)
    p.add_argument("--cfl", type=float, default=0.3)
    p.add_argument("--mach", type=float, default=15.0)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--native", action="store_true",
                   help="use the C build (bitwise-equal to the NumPy path)")
    p.add_argument("--interactive", action="store_true",
                   help="accepted for symmetry with the other solvers; "
                        "warns and runs the batch oracle")
    p.set_defaults(fn=cmd_hypersonic2d_cpu)

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
    _common(p, 100)
    p.set_defaults(fn=cmd_nbody)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
