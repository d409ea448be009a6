"""The profiler loop shared by the port's `tools/profile_*_torch.py` scripts.

A script names its runs and the kernel names to group by and calls `main`:

    main(argv, doc=__doc__, default_out="build/profile_x_torch.json",
         groups=("a_kernel", "b_kernel"),
         runs=[Run("512^2 f32", 400, make_go)])

`make_go()` builds the state on the GPU and returns `go(k)`, which runs k
steps from that state.  For each run:

* the step time on the host clock, unprofiled: `go(steps)` bracketed by
  torch.cuda.synchronize(), after a one-step warm-up, three times (the
  median is used; all three are kept);
* `torch.profiler` over one more `go(steps)`: the device time of each
  kernel group (a kernel whose name holds a group's name; everything else
  is "torch ops"), as a share of the device time and per step, and the
  time per launch of every device kernel by name; the device busy share
  (union of kernel intervals over the span from the first kernel's start
  to the last one's end); and the idle share 1 - (device time per step) /
  (unprofiled step time).  An idle share near 1 means the step waits on
  the host (launch-bound); near 0, on the device.

Prints one line per reading and writes them all as JSON to `--out`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, NamedTuple

import torch


class Run(NamedTuple):
    label: str
    steps: int
    make_go: Callable[[], Callable[[int], object]]
    items: int | None = None   # particles a step, for M particle-steps/s


def _group(name: str, groups) -> str:
    for g in groups:
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


def profile_run(run: Run, groups) -> dict:
    go, steps = run.make_go(), run.steps
    go(1)  # build, load and warm up
    torch.cuda.synchronize()

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        go(steps)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / steps)
    step_ms = sorted(walls)[1]

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        go(steps)
        torch.cuda.synchronize()
    kev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kev:
        raise RuntimeError("torch.profiler recorded no device kernel")
    by_group = defaultdict(lambda: [0.0, 0])
    names = defaultdict(lambda: [0.0, 0])
    spans = []
    for e in kev:
        us = e.time_range.end - e.time_range.start
        for d, key in ((by_group, _group(e.name, groups)), (names, e.name)):
            d[key][0] += us
            d[key][1] += 1
        spans.append((e.time_range.start, e.time_range.end))
    dev_us = sum(v[0] for v in by_group.values())
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    dev_ms = dev_us / 1e3 / steps
    res = {
        "run": run.label, "steps": steps,
        "step_ms_unprofiled": step_ms, "step_ms_unprofiled_runs": walls,
        "steps_per_s": 1e3 / step_ms,
        "device_ms_per_step_profiled": dev_ms,
        "busy_share_profiled": _union_us(spans) / window,
        "idle_share": 1.0 - dev_ms / step_ms,
        "groups": sorted(({"name": g, "share": us / dev_us,
                           "us_per_step": us / steps, "launches": c}
                          for g, (us, c) in by_group.items()),
                         key=lambda r: -r["share"]),
        "kernels": sorted(({"name": k, "us_per_launch": us / c, "launches": c}
                           for k, (us, c) in names.items()),
                          key=lambda r: -r["us_per_launch"] * r["launches"]),
    }
    if run.items is not None:
        res["mparticle_steps_per_s"] = run.items / step_ms / 1e3
    return res


def main(argv, *, doc: str, default_out: str, groups, runs) -> int:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--out", default=default_out)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    res = {"card": smi, "torch": torch.__version__, "runs": []}
    print(f"card: {smi}; torch {torch.__version__}")
    for run in runs:
        r = profile_run(run, groups)
        res["runs"].append(r)
        walls = ", ".join(f"{w:.4f}" for w in r["step_ms_unprofiled_runs"])
        rate = f"{r['steps_per_s']:.2f} steps/s"
        if "mparticle_steps_per_s" in r:
            rate += f", {r['mparticle_steps_per_s']:.3f} M particle-steps/s"
        print(f"{r['run']} x {run.steps}: step {r['step_ms_unprofiled']:.4f} "
              f"ms unprofiled (runs {walls}; {rate}), device "
              f"{r['device_ms_per_step_profiled']:.4f} ms/step profiled, busy "
              f"share {r['busy_share_profiled']:.4f} (profiled), idle share "
              f"{r['idle_share']:.4f}")
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
