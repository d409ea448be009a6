#!/usr/bin/env python
"""Where the time of the port's 3-D stable-fluids step goes, on a GPU.

    python tools/profile_stam3d_torch.py [--out PATH]

For the two runs chip_smoke.py drives through fluidsims_tpu_torch.
solvers.stam3d.run with engine 'auto' (the CUDA kernels): Stam3DConfig()
(192^3 f32) x 100 steps and 192^3 f64 x 20 steps, each from init: the
unprofiled step time, and under torch.profiler the device time of each
kernel (jacobi, advect, set_bnd) and of the torch ops around them (decay,
source, divergence, gradient, the copies and zero fills of the solves),
the busy and idle shares (tools/profile_torch_common.py says how each is
read).

Imports torch and the port only.  Writes JSON to `--out` (default
build/profile_stam3d_torch.json).
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fluidsims_tpu_torch.solvers import stam3d as s3  # noqa: E402
from profile_torch_common import Run, main  # noqa: E402

RUNS = ((192, "float32", 100), (192, "float64", 20))
GROUPS = ("jacobi_kernel", "advect_kernel", "set_bnd_kernel")


def _make_go(n: int, dtype: str):
    def make_go():
        cfg = s3.Stam3DConfig(n=n, dtype=dtype)
        dev = torch.device("cuda")
        if s3.resolve_engine(cfg, dev) != "cuda":
            raise RuntimeError("engine auto did not resolve to cuda")
        st0 = s3.init(cfg, dev)
        return lambda k: s3.run(cfg, st0, k)
    return make_go


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], doc=__doc__,
                  default_out="build/profile_stam3d_torch.json",
                  groups=GROUPS,
                  runs=[Run(f"{n}^3 {dtype}", steps, _make_go(n, dtype))
                        for n, dtype, steps in RUNS]))
