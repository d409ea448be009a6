#!/usr/bin/env python
"""Where the time of one step of the port's 3-D hypersonic solver goes, on
a GPU.

    python tools/profile_hypersonic3d_torch.py [--steps 50]
        [--out chiprun_out/profile_hypersonic3d_torch.json]

For default_config(64) and default_config(256) float32 (the two sizes
chip_smoke.py drives), through fluidsims_tpu_torch.solvers.hypersonic3d.run
with its default engine (the CUDA step and wavespeed kernels):

* the step time on the host clock, unprofiled: `--steps` steps bracketed
  by torch.cuda.synchronize(), after a 5-step warm-up;
* `torch.profiler` over `--steps` steps: each device kernel's share of the
  device time and its mean time per launch, the two CUDA kernels' share
  and the plain torch ops' share (decode, BC padding, τ arithmetic,
  encode, keep-solid), the device busy share (union of kernel intervals
  over the span from the first kernel's start to the last one's end), and
  the idle share 1 - (device time per step) / (unprofiled step time).

Imports torch and the port only.  Prints one line per reading and writes
them all as JSON to `--out`.
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

from fluidsims_tpu_torch.solvers import hypersonic3d as h3  # noqa: E402

SIZES = (64, 256)
# device kernel names of csrc/hypersonic3d_step.cu and _wavespeed.cu
PORT_KERNELS = ("step3_kernel", "wavespeed3_kernel")


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


def profile_size(n: int, steps: int) -> dict:
    cfg = h3.default_config(n)
    s = h3.init(cfg, torch.device("cuda"))
    s = h3.run(cfg, s, 5)  # build, load and warm up
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    h3.run(cfg, s, steps)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        h3.run(cfg, s, steps)
        torch.cuda.synchronize()
    kev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kev:
        raise RuntimeError("torch.profiler recorded no device kernel")
    per_name = defaultdict(lambda: [0.0, 0])
    spans = []
    for e in kev:
        us = e.time_range.end - e.time_range.start
        per_name[e.name][0] += us
        per_name[e.name][1] += 1
        spans.append((e.time_range.start, e.time_range.end))
    dev_us = sum(v[0] for v in per_name.values())
    port_us = sum(us for name, (us, _) in per_name.items()
                  if any(k in name for k in PORT_KERNELS))
    torch_launches = sum(c for name, (_, c) in per_name.items()
                         if not any(k in name for k in PORT_KERNELS))
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    dev_ms_per_step = dev_us / 1e3 / steps
    kernels = sorted(
        ({"name": name, "share": us / dev_us, "launches": c,
          "us_per_launch": us / c} for name, (us, c) in per_name.items()),
        key=lambda r: -r["share"])
    return {
        "size": f"{n}^3 float32", "steps": steps,
        "step_ms_unprofiled": step_ms,
        "device_ms_per_step_profiled": dev_ms_per_step,
        "cuda_kernels_share": port_us / dev_us,
        "torch_ops_share": 1.0 - port_us / dev_us,
        "torch_op_launches_per_step": torch_launches / steps,
        "busy_share_profiled": _union_us(spans) / window,
        "idle_share": 1.0 - dev_ms_per_step / step_ms,
        "kernels": kernels,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--out",
                    default="chiprun_out/profile_hypersonic3d_torch.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    res = {"card": smi, "torch": torch.__version__, "sizes": []}
    print(f"card: {smi}; torch {torch.__version__}")
    for n in SIZES:
        r = profile_size(n, args.steps if n <= 64 else min(args.steps, 20))
        res["sizes"].append(r)
        print(f"{r['size']}: step {r['step_ms_unprofiled']:.4f} ms unprofiled, "
              f"device {r['device_ms_per_step_profiled']:.4f} ms/step "
              f"profiled (CUDA kernels {r['cuda_kernels_share']:.4f}, torch "
              f"ops {r['torch_ops_share']:.4f} over "
              f"{r['torch_op_launches_per_step']:.1f} launches/step), busy "
              f"share {r['busy_share_profiled']:.4f} (profiled), idle share "
              f"{r['idle_share']:.4f}")
        for k in r["kernels"][:12]:
            print(f"  {k['share'] * 100:7.3f}%  {k['us_per_launch']:10.2f} us "
                  f"x {k['launches']:4d}  {k['name'][:100]}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
