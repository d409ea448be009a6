#!/usr/bin/env python
"""Where the time of the port's 2-D stable-fluids step goes, on a GPU.

    python tools/profile_stam2d_torch.py [--out PATH]

For the two runs chip_smoke.py drives through fluidsims_tpu_torch.
solvers.stam2d.run with engine 'auto' (the CUDA kernels): Stam2DConfig()
(512^2 f32) x 400 steps and 512^2 f64 x 400 steps, each from init: the
unprofiled step time, and under torch.profiler the device time of each
kernel (the whole-solve lin_solve, advect) and of the torch ops around
them (decay, source, divergence, gradient, the pads and zero fills), the
busy and idle shares (tools/profile_torch_common.py says how each is
read).

Imports torch and the port only.  Writes JSON to `--out` (default
build/profile_stam2d_torch.json).
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fluidsims_tpu_torch.solvers import stam2d as s2  # noqa: E402
from profile_torch_common import Run, main  # noqa: E402

RUNS = ((512, "float32", 400), (512, "float64", 400))
GROUPS = ("lin_solve_kernel", "advect_kernel")


def _make_go(n: int, dtype: str):
    def make_go():
        cfg = s2.Stam2DConfig(n=n, dtype=dtype)
        dev = torch.device("cuda")
        if s2.resolve_engine(cfg, dev) != "cuda":
            raise RuntimeError("engine auto did not resolve to cuda")
        st0 = s2.init(cfg, dev)
        return lambda k: s2.run(cfg, st0, k)
    return make_go


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], doc=__doc__,
                  default_out="build/profile_stam2d_torch.json",
                  groups=GROUPS,
                  runs=[Run(f"{n}^2 {dtype}", steps, _make_go(n, dtype))
                        for n, dtype, steps in RUNS]))
