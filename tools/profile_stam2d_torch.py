#!/usr/bin/env python
"""Where the time of the port's 2-D stable-fluids step goes, on a GPU.

    python tools/profile_stam2d_torch.py [--out PATH]

For the two runs chip_smoke.py drives through fluidsims_tpu_torch.
solvers.stam2d.run with engine 'auto' (the CUDA kernels): Stam2DConfig()
(512^2 f32) x 400 steps and 512^2 f64 x 400 steps, each from init:

* the step time on the host clock, unprofiled: the whole run bracketed by
  torch.cuda.synchronize(), after a one-step warm-up from the same state,
  three times (the median is used; all three are kept);
* `torch.profiler` over the same run: the device time of each kernel
  (the whole-solve lin_solve, advect) and of the torch ops around them
  (decay, source, divergence, gradient, the pads and zero fills),
  each as a share of the device time and per step, and the time per
  launch of every device kernel by name; the device busy share (union of
  kernel intervals over the span from the first kernel's start to the
  last one's end); and the idle share 1 - (device time per step) /
  (unprofiled step time).  An idle share near 1 means the step waits on
  the host (launch-bound); near 0, on the device.

Imports torch and the port only.  Prints one line per reading and writes
them all as JSON to `--out` (default build/profile_stam2d_torch.json).
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

from fluidsims_tpu_torch.solvers import stam2d as s2  # noqa: E402

RUNS = ((512, "float32", 400), (512, "float64", 400))
GROUPS = ("lin_solve_kernel", "advect_kernel")


def _group(name: str) -> str:
    for g in GROUPS:
        if g in name:
            return g
    return "torch ops"


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


def profile_run(n: int, dtype: str, steps: int) -> dict:
    cfg = s2.Stam2DConfig(n=n, dtype=dtype)
    dev = torch.device("cuda")
    if s2.resolve_engine(cfg, dev) != "cuda":
        raise RuntimeError("engine auto did not resolve to cuda")
    st0 = s2.init(cfg, dev)
    s2.run(cfg, st0, 1)  # build, load and warm up
    torch.cuda.synchronize()

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        s2.run(cfg, st0, steps)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / steps)
    step_ms = sorted(walls)[1]

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        s2.run(cfg, st0, steps)
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
    dev_ms = dev_us / 1e3 / steps
    return {
        "run": f"{n}^2 {dtype}", "steps": steps,
        "step_ms_unprofiled": step_ms, "step_ms_unprofiled_runs": walls,
        "steps_per_s": 1e3 / step_ms,
        "device_ms_per_step_profiled": dev_ms,
        "busy_share_profiled": _union_us(spans) / window,
        "idle_share": 1.0 - dev_ms / step_ms,
        "groups": sorted(({"name": g, "share": us / dev_us,
                           "us_per_step": us / steps, "launches": c}
                          for g, (us, c) in groups.items()),
                         key=lambda r: -r["share"]),
        "kernels": sorted(({"name": k, "us_per_launch": us / c, "launches": c}
                           for k, (us, c) in names.items()),
                          key=lambda r: -r["us_per_launch"] * r["launches"]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile_stam2d_torch.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    res = {"card": smi, "torch": torch.__version__, "runs": []}
    print(f"card: {smi}; torch {torch.__version__}")
    for n, dtype, steps in RUNS:
        r = profile_run(n, dtype, steps)
        res["runs"].append(r)
        runs = ", ".join(f"{w:.4f}" for w in r["step_ms_unprofiled_runs"])
        print(f"{r['run']} x {steps}: step {r['step_ms_unprofiled']:.4f} ms "
              f"unprofiled (runs {runs}; {r['steps_per_s']:.2f} steps/s), "
              f"device {r['device_ms_per_step_profiled']:.4f} ms/step "
              f"profiled, busy share {r['busy_share_profiled']:.4f} "
              f"(profiled), idle share {r['idle_share']:.4f}")
        for g in r["groups"]:
            print(f"  {g['share'] * 100:7.3f}%  {g['us_per_step']:10.2f} us/step "
                  f"x {g['launches']:6d} launches  {g['name']}")
        for k in r["kernels"][:16]:
            print(f"    {k['us_per_launch']:10.2f} us x {k['launches']:6d}  "
                  f"{k['name'][:90]}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
