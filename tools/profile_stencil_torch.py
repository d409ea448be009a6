#!/usr/bin/env python
"""Where the time of the port's stencil runs goes, on a GPU.

    python tools/profile_stencil_torch.py [--out PATH] [--solvers a,b,...]

For the runs chip_smoke.py drives through the `run` of fluidsims_tpu_torch.
solvers.gray_scott, lbm, burgers, shallow_water and mhd with engine 'auto'
(the CUDA kernels): Gray–Scott 2048^2 f32 x 2000 steps and LBM 2048x1024
f32 x 1000 steps, each at the default block_k (16, 8) and at block_k = 1
(the one-step kernel every step), and Gray–Scott 2048^2 f64 x 400 at
block_k 16 (chip_smoke.py's f64 run); Burgers and shallow water 512^2 and MHD
320x220 Brio–Wu f32 x 4000 steps (bench.py's sizes and step counts) at
the default block_k (16, 8, 8) and at 1 (the K-step kernel with k = 1
every step), and Burgers and shallow water 4096^2, MHD Orszag–Tang 2048^2
f32 x 200 at the default block_k, and MHD 320x220 f64 x 1000 at block_k 8
(chip_smoke.py's fourth MHD run); each from init:

* the step time on the host clock, unprofiled: the whole run bracketed by
  torch.cuda.synchronize(), after a warm-up of block_k + 1 steps from the
  same state, three times (the median is used; all three are kept);
* `torch.profiler` over the same run: the device time of the K-step and
  the one-step kernel and of anything else on the device, each as a share
  of the device time, and the time per launch of every device kernel by
  name; the device time per step, from each kernel's mean time per
  captured launch times the launches the run makes (n // block_k K-step
  and n % block_k one-step; block_k = 1: n one-step), so that launches the
  profiler drops do not shrink it; the device busy share (union of the
  captured kernel intervals over the span from the first kernel's start
  to the last one's end; Burgers, shallow water and MHD have one kernel,
  launched n // block_k + n % block_k times); and the idle share 1 -
  (device time per step) /
  (unprofiled step time).  An idle share near 1 means the run waits on
  the host (launch-bound); near 0, on the kernels.  A run whose captured
  launches differ from the expected ones is flagged on its line and in
  the JSON (`launches_captured`, `launches_expected`).

Imports torch and the port only.  Prints one line per reading and writes
them all as JSON to `--out` (default build/profile_stencil_torch.json).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fluidsims_tpu_torch.solvers import burgers as bg  # noqa: E402
from fluidsims_tpu_torch.solvers import gray_scott as gs  # noqa: E402
from fluidsims_tpu_torch.solvers import lbm  # noqa: E402
from fluidsims_tpu_torch.solvers import mhd  # noqa: E402
from fluidsims_tpu_torch.solvers import shallow_water as sw  # noqa: E402

# (solver, config, steps)
RUNS = (("gray_scott", gs.GrayScottConfig(nx=2048, ny=2048, block_k=16), 2000),
        ("gray_scott", gs.GrayScottConfig(nx=2048, ny=2048, block_k=1), 2000),
        ("gray_scott", gs.GrayScottConfig(nx=2048, ny=2048, dtype="float64",
                                          block_k=16), 400),
        ("lbm", lbm.LBMConfig(nx=2048, ny=1024, block_k=8), 1000),
        ("lbm", lbm.LBMConfig(nx=2048, ny=1024, block_k=1), 1000),
        ("burgers", bg.BurgersConfig(nx=512, ny=512, block_k=16), 4000),
        ("burgers", bg.BurgersConfig(nx=512, ny=512, block_k=1), 4000),
        ("burgers", bg.BurgersConfig(nx=4096, ny=4096, block_k=16), 200),
        ("shallow_water", sw.ShallowWaterConfig(nx=512, ny=512, block_k=8),
         4000),
        ("shallow_water", sw.ShallowWaterConfig(nx=512, ny=512, block_k=1),
         4000),
        ("shallow_water", sw.ShallowWaterConfig(nx=4096, ny=4096, block_k=8),
         200),
        ("mhd", mhd.MHDConfig(nx=320, ny=220, block_k=8), 4000),
        ("mhd", mhd.MHDConfig(nx=320, ny=220, block_k=1), 4000),
        ("mhd", mhd.MHDConfig(nx=2048, ny=2048, problem="orszag-tang",
                              block_k=8), 200),
        ("mhd", mhd.MHDConfig(nx=320, ny=220, dtype="float64", block_k=8),
         1000))
MODULES = {"gray_scott": gs, "lbm": lbm, "burgers": bg, "shallow_water": sw,
           "mhd": mhd}
# solvers whose 'cuda' engine is one K-step kernel, launched with k = 1 for
# the remainder (no separate one-step kernel)
KSTEP_ONLY = ("burgers", "shallow_water", "mhd")


def _group(name: str) -> str:
    if "multistep_kernel" in name:
        return "K-step kernel"
    if "step_kernel" in name:
        return "one-step kernel"
    return "other"


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def profile_run(solver: str, cfg, steps: int) -> dict:
    mod = MODULES[solver]
    dev = torch.device("cuda")
    if mod.resolve_engine(cfg, dev) != "cuda":
        raise RuntimeError("engine auto did not resolve to cuda")
    s0 = mod.init(cfg, dev)
    mod.run(cfg, s0, cfg.block_k + 1)  # build, load and warm up
    torch.cuda.synchronize()

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        mod.run(cfg, s0, steps)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / steps)
    step_ms = sorted(walls)[1]

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        mod.run(cfg, s0, steps)
        torch.cuda.synchronize()
    kev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kev:
        raise RuntimeError("torch.profiler recorded no device kernel")
    groups = defaultdict(lambda: [0.0, 0])
    names = defaultdict(lambda: [0.0, 0])
    spans = []
    for e in kev:
        us = e.time_range.end - e.time_range.start
        for d, key in ((groups, _group(e.name)), (names, e.name)):
            d[key][0] += us
            d[key][1] += 1
        spans.append((e.time_range.start, e.time_range.end))
    dev_us = sum(v[0] for v in groups.values())
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    bk = cfg.block_k
    n_k, n_1 = divmod(steps, bk) if bk > 1 else (0, steps)
    expected = ({"K-step kernel": n_k + n_1} if solver in KSTEP_ONLY
                else {"K-step kernel": n_k, "one-step kernel": n_1})
    captured = {g: groups[g][1] if g in groups else 0 for g in expected}
    if any(captured[g] == 0 < expected[g] for g in expected):
        raise RuntimeError(f"no launch of a kernel captured: {captured}")
    # device us per step of each group: a kernel's mean per captured
    # launch times its expected launches; other work as captured
    per_step = {g: (us / c * expected[g] if g in expected else us) / steps
                for g, (us, c) in groups.items()}
    dev_ms = sum(per_step.values()) / 1e3
    cells = cfg.nx * cfg.ny
    return {
        "run": (f"{solver} {cfg.nx}x{cfg.ny} {cfg.dtype} block_k="
                f"{cfg.block_k}" + (f" {cfg.problem}" if solver == "mhd"
                                    else "")),
        "steps": steps, "step_ms_unprofiled": step_ms,
        "step_ms_unprofiled_runs": walls,
        "steps_per_s": 1e3 / step_ms,
        "mcell_steps_per_s": cells * 1e-3 / step_ms,
        "device_ms_per_step_profiled": dev_ms,
        "launches_expected": expected, "launches_captured": captured,
        "busy_share_profiled": _union_us(spans) / window,
        "idle_share": 1.0 - dev_ms / step_ms,
        "groups": sorted(({"name": g, "share": us / dev_us,
                           "us_per_step": per_step[g], "launches": c}
                          for g, (us, c) in groups.items()),
                         key=lambda r: -r["share"]),
        "kernels": sorted(({"name": k, "us_per_launch": us / c, "launches": c}
                           for k, (us, c) in names.items()),
                          key=lambda r: -r["us_per_launch"] * r["launches"]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile_stencil_torch.json")
    ap.add_argument("--solvers", default=",".join(MODULES),
                    help="comma-separated subset of " + ", ".join(MODULES))
    args = ap.parse_args(argv)
    solvers = args.solvers.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    res = {"card": smi, "torch": torch.__version__, "runs": []}
    print(f"card: {smi}; torch {torch.__version__}")
    for solver, cfg, steps in RUNS:
        if solver not in solvers:
            continue
        r = profile_run(solver, cfg, steps)
        res["runs"].append(r)
        runs = ", ".join(f"{w:.5f}" for w in r["step_ms_unprofiled_runs"])
        if r["launches_captured"] != r["launches_expected"]:
            print(f"WARNING {r['run']}: the profiler captured launches "
                  f"{r['launches_captured']} of {r['launches_expected']}; "
                  f"device time per step uses the expected launches")
        print(f"{r['run']} x {steps}: step {r['step_ms_unprofiled']:.5f} ms "
              f"unprofiled (runs {runs}; {r['steps_per_s']:.1f} steps/s, "
              f"{r['mcell_steps_per_s']:.1f} Mcell-steps/s), device "
              f"{r['device_ms_per_step_profiled']:.5f} ms/step profiled, busy "
              f"share {r['busy_share_profiled']:.4f} (profiled), idle share "
              f"{r['idle_share']:.4f}")
        for g in r["groups"]:
            print(f"  {g['share'] * 100:7.3f}%  {g['us_per_step']:10.3f} "
                  f"us/step x {g['launches']:6d} launches  {g['name']}")
        for k in r["kernels"][:6]:
            print(f"    {k['us_per_launch']:10.3f} us x {k['launches']:6d}  "
                  f"{k['name'][:90]}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
