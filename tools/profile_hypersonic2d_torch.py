#!/usr/bin/env python
"""Where the time of one step of the port's flagship solver goes, on a GPU.

    python tools/profile_hypersonic2d_torch.py [--steps 50] [--out PATH]

For 2048x2048 float32 and 8192x1024 float64 (the two sizes chip_smoke.py
drives), through fluidsims_tpu_torch.solvers.hypersonic2d.run with its
default engine (the CUDA kernels):

* the step time on the host clock, unprofiled: `--steps` steps bracketed
  by torch.cuda.synchronize(), after a 5-step warm-up;
* `torch.profiler` over `--steps` steps: each device kernel's share of the
  device time and its mean time per launch, the device busy share (union
  of kernel intervals over the span from the first kernel's start to the
  last one's end), and the idle share 1 - (device time per step) /
  (unprofiled step time);
* a check of float32 division by a Python scalar on the device: how many
  of 2^20 quotients `x / 1.1` and `x / torch.full_like(x, 1.1)` differ
  from the correctly rounded quotient by float32(1.1).

Imports torch and the port only.  Prints one line per reading and writes
them all as JSON to `--out` (default build/profile_hypersonic2d_torch.json).
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

from fluidsims_tpu_torch.solvers import hypersonic2d as h2  # noqa: E402

SIZES = ((2048, 2048, "float32"), (8192, 1024, "float64"))


def _kernel_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


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


def profile_size(nx: int, ny: int, dtype: str, steps: int) -> dict:
    cfg = h2.default_config(nx=nx, ny=ny, dtype=dtype)
    s = h2.init(cfg, torch.device("cuda"))
    s = h2.run(cfg, s, 5)  # build, load and warm up
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    h2.run(cfg, s, steps)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        h2.run(cfg, s, steps)
        torch.cuda.synchronize()
    kev = _kernel_events(prof)
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
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    dev_ms_per_step = dev_us / 1e3 / steps
    kernels = sorted(
        ({"name": n, "share": us / dev_us, "launches": c,
          "us_per_launch": us / c} for n, (us, c) in per_name.items()),
        key=lambda r: -r["share"])
    return {
        "size": f"{nx}x{ny} {dtype}", "steps": steps,
        "step_ms_unprofiled": step_ms,
        "device_ms_per_step_profiled": dev_ms_per_step,
        "busy_share_profiled": _union_us(spans) / window,
        "idle_share": 1.0 - dev_ms_per_step / step_ms,
        "kernels": kernels,
    }


def scalar_division_check(n: int = 1 << 20) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(n, generator=g, device="cuda") * 10 + 0.1
    d32 = torch.tensor(1.1, dtype=torch.float32)
    exact = (x.double() / d32.double()).float()  # correctly rounded
    by_scalar = x / 1.1
    by_tensor = x / torch.full_like(x, 1.1)
    return {"n": n,
            "x/1.1 != exact": int((by_scalar != exact).sum()),
            "x/full_like(x,1.1) != exact": int((by_tensor != exact).sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--out", default="build/profile_hypersonic2d_torch.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    res = {"card": smi, "torch": torch.__version__, "sizes": []}
    print(f"card: {smi}; torch {torch.__version__}")
    for nx, ny, dtype in SIZES:
        r = profile_size(nx, ny, dtype, args.steps)
        res["sizes"].append(r)
        print(f"{r['size']}: step {r['step_ms_unprofiled']:.4f} ms unprofiled, "
              f"device {r['device_ms_per_step_profiled']:.4f} ms/step "
              f"profiled, busy share {r['busy_share_profiled']:.4f} "
              f"(profiled), idle share {r['idle_share']:.4f}")
        for k in r["kernels"]:
            print(f"  {k['share'] * 100:7.3f}%  {k['us_per_launch']:10.2f} us "
                  f"x {k['launches']:4d}  {k['name'][:100]}")
    res["scalar_division"] = scalar_division_check()
    print(f"f32 division on the device: {res['scalar_division']}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
