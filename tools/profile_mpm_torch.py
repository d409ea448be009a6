#!/usr/bin/env python
"""Where the time of the port's MLS-MPM step goes, on a GPU.

    python tools/profile_mpm_torch.py [--out PATH]

For two of the runs chip_smoke.py drives through fluidsims_tpu_torch.
solvers.mpm.run with engine 'auto' (the CUDA kernels): MPMConfig()
(32,768 snow particles on 96^2, f32) x 1000 steps and 2^20 particles on
512^2 f32 x 200 steps, each from init: the unprofiled step time and M
particle-steps/s, and under torch.profiler the device time of each kernel
(the P2G, group "MPMParticles": the tiled design at 2^20 particles, the
atomic one at 32,768; the G2P with its grid update, "mpm_g2p_kernel") and
of the rest (the atomic design's memset of the P2G grids), the busy and
idle shares (tools/profile_torch_common.py says how each is read).

Imports torch and the port only.  Writes JSON to `--out` (default
build/profile_mpm_torch.json).
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fluidsims_tpu_torch.solvers import mpm  # noqa: E402
from profile_torch_common import Run, main  # noqa: E402

RUNS = ((32768, 96, "float32", 1000), (1 << 20, 512, "float32", 200))
GROUPS = ("MPMParticles", "mpm_g2p_kernel")


def _make_go(n_p: int, g: int, dtype: str):
    def make_go():
        cfg = mpm.MPMConfig(n=n_p, gx=g, gy=g, dtype=dtype)
        dev = torch.device("cuda")
        if mpm.resolve_engine(cfg, dev) != "cuda":
            raise RuntimeError("engine auto did not resolve to cuda")
        st0 = mpm.init(cfg, dev)
        return lambda k: mpm.run(cfg, st0, k)
    return make_go


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], doc=__doc__,
                  default_out="build/profile_mpm_torch.json", groups=GROUPS,
                  runs=[Run(f"{n_p} particles {g}^2 {dtype}", steps,
                            _make_go(n_p, g, dtype), n_p)
                        for n_p, g, dtype, steps in RUNS]))
