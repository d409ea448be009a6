#!/usr/bin/env python
"""Where the time of the port's n-body layout step goes, on a GPU.

    python tools/profile_nbody_torch.py [--out PATH]

For the runs chip_smoke.py drives through fluidsims_tpu_torch.solvers.
nbody_graph.run with the exact engine (the CUDA repulsion kernel) at
GraphLayoutConfig(max_number=2^17), 131,072 bodies: 2-D f32 x 20 steps
(bench.py's nbody_131072_exact size and count), 3-D f32 x 20 and 2-D f64
x 10; and the grid engine (plain PyTorch) at 2^17 2-D f32 x 10; each from
init: the unprofiled step time and steps/s, and under torch.profiler the
device time of the kernel (group "nbody_repulsion_kernel") and of the
rest (the springs' gather and index_add_, the integrator: "torch ops"),
the torch ops a step, and the busy and idle shares
(tools/profile_torch_common.py says how each is read).

Imports torch and the port only.  Writes JSON to `--out` (default
build/profile_nbody_torch.json).
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fluidsims_tpu_torch.solvers import nbody_graph as ng  # noqa: E402
from profile_torch_common import Run, main  # noqa: E402

N = 1 << 17
RUNS = (("exact", 2, "float32", 20), ("exact", 3, "float32", 20),
        ("exact", 2, "float64", 10), ("grid", 2, "float32", 10))
GROUPS = ("nbody_repulsion_kernel",)


def _make_go(engine: str, dims: int, dtype: str):
    def make_go():
        cfg = ng.GraphLayoutConfig(max_number=N, dims=dims, engine=engine,
                                   dtype=dtype)
        st0 = ng.init(cfg, torch.device("cuda"))
        return lambda k: ng.run(cfg, st0, k)
    return make_go


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], doc=__doc__,
                  default_out="build/profile_nbody_torch.json", groups=GROUPS,
                  runs=[Run(f"{N} bodies {engine} {dims}-D {dtype}", steps,
                            _make_go(engine, dims, dtype))
                        for engine, dims, dtype, steps in RUNS]))
