#!/usr/bin/env python
"""Where the shallow-water standing wave's period comes from on the card.

    python tools/probe_standing_wave_torch.py

Runs the standing-wave gate of tests/analytic_gates.py (128x8, h = 100 +
0.01 cos(kx), dtau = 1e9, 200 one-step runs) five ways: the #7 kernel
(engine 'cuda') and the plain version (engine 'torch') on the card, the
plain version on the CPU, and the kernel and the CPU plain version in
float64.  Prints each run's zero crossings of the mode amplitude, the
period they give (128 steps exact), the amplitudes around each crossing,
and the largest |sigma| difference between pairs of runs at steps 1, 10,
50 and 199.  Needs a CUDA device.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fluidsims_tpu_torch.solvers import shallow_water as sw  # noqa: E402


def amplitudes(engine: str, device: str, dtype: str = "float32"):
    cfg = sw.ShallowWaterConfig(nx=128, ny=8, H0=100.0, nu=0.0, bump_amp=0.0,
                                swirl=0.0, dtau=1e9, engine=engine,
                                dtype=dtype)
    td = cfg.torch_dtype
    k = 2 * math.pi * 2 / 128.0
    x = np.arange(128.0)
    h = 100.0 + 0.01 * np.cos(k * x)[None, :] * np.ones((8, 1))
    z = torch.zeros((8, 128), dtype=td, device=device)
    s = sw.init(cfg, device)._replace(
        sigma=torch.tensor(np.log(h), dtype=td, device=device), u=z, v=z)
    cosk = torch.tensor(np.cos(k * x), dtype=td, device=device)
    amps, sigmas = [], []
    for _ in range(200):
        amps.append(float(((torch.exp(s.sigma)[0] - 100.0) * cosk).mean()))
        sigmas.append(s.sigma.double().cpu().numpy())
        s = sw.run(cfg, s, 1)
    return np.array(amps), sigmas


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_standing_wave_torch: needs a CUDA device")
    runs = {"kernel": amplitudes("cuda", "cuda"),
            "torch_cuda": amplitudes("torch", "cuda"),
            "torch_cpu": amplitudes("torch", "cpu"),
            "kernel_f64": amplitudes("cuda", "cuda", "float64"),
            "torch_cpu_f64": amplitudes("torch", "cpu", "float64")}
    for name, (a, _) in runs.items():
        zc = np.where(np.diff(np.sign(a)) != 0)[0]
        print(name, "zero crossings", zc.tolist(), "period",
              2 * (zc[1] - zc[0]))
        for i in zc[:3]:
            print("   ", i, a[i - 1:i + 3].tolist())
    for a, b in (("kernel", "torch_cuda"), ("torch_cuda", "torch_cpu"),
                 ("kernel_f64", "torch_cpu_f64")):
        d = [np.abs(x - y).max() for x, y in zip(runs[a][1], runs[b][1])]
        print(a, "vs", b, "max |sigma diff| at steps 1, 10, 50, 199:",
              d[1], d[10], d[50], d[199])
    return 0


if __name__ == "__main__":
    sys.exit(main())
