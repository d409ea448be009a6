#!/usr/bin/env python
"""Where the time of one step of the port's 3-D hypersonic solver goes, on
a GPU.

    python tools/profile_hypersonic3d_torch.py [--out PATH]

For default_config(64) float32 x 400 steps and default_config(256)
float32 x 20 (the two runs chip_smoke.py drives), through
fluidsims_tpu_torch.solvers.hypersonic3d.run with its default engine (the
CUDA prologue, step and wavespeed kernels), each from init: the
unprofiled step time and steps/s, and under torch.profiler the device
time of each kernel and of the torch ops around them (τ arithmetic,
encode, keep-solid), the busy and idle shares (tools/
profile_torch_common.py says how each is read).

Imports torch and the port only.  Writes JSON to `--out` (default
build/profile_hypersonic3d_torch.json).
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fluidsims_tpu_torch.solvers import hypersonic3d as h3  # noqa: E402
from profile_torch_common import Run, main  # noqa: E402

RUNS = ((64, 400), (256, 20))
# the kernels of csrc/hypersonic3d_step.cu, _wavespeed.cu and _pad.cu
GROUPS = ("step3_kernel", "wavespeed3_kernel", "pad3_kernel")


def _make_go(n: int):
    def make_go():
        cfg = h3.default_config(n)
        st0 = h3.init(cfg, torch.device("cuda"))
        return lambda k: h3.run(cfg, st0, k)
    return make_go


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], doc=__doc__,
                  default_out="build/profile_hypersonic3d_torch.json",
                  groups=GROUPS,
                  runs=[Run(f"{n}^3 float32", steps, _make_go(n))
                        for n, steps in RUNS]))
