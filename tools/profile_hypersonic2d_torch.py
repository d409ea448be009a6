#!/usr/bin/env python
"""Where the time of one step of the port's flagship solver goes, on a GPU.

    python tools/profile_hypersonic2d_torch.py [--out PATH]

For 2048x2048 float32 x 200 steps and 8192x1024 float64 x 50 (the two runs
chip_smoke.py drives), through fluidsims_tpu_torch.solvers.hypersonic2d.run
with its default engine (the CUDA step and inflow + wavespeed kernels),
each from init: the unprofiled step time and steps/s, and under
torch.profiler the device time of each kernel and of the torch ops around
them (the CFL dt), the busy and idle shares (tools/profile_torch_common.py
says how each is read).

Imports torch and the port only.  Writes JSON to `--out` (default
build/profile_hypersonic2d_torch.json).
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fluidsims_tpu_torch.solvers import hypersonic2d as h2  # noqa: E402
from profile_torch_common import Run, main  # noqa: E402

RUNS = ((2048, 2048, "float32", 200), (8192, 1024, "float64", 50))
# the kernels of csrc/hypersonic2d_step.cu and _wavespeed.cu
GROUPS = ("inflow_wavespeed_kernel", "step_kernel")


def _make_go(nx: int, ny: int, dtype: str):
    def make_go():
        cfg = h2.default_config(nx=nx, ny=ny, dtype=dtype)
        st0 = h2.init(cfg, torch.device("cuda"))
        return lambda k: h2.run(cfg, st0, k)
    return make_go


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], doc=__doc__,
                  default_out="build/profile_hypersonic2d_torch.json",
                  groups=GROUPS,
                  runs=[Run(f"{nx}x{ny} {dtype}", steps,
                            _make_go(nx, ny, dtype))
                        for nx, ny, dtype, steps in RUNS]))
