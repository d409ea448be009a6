#!/usr/bin/env python
"""Where the time of the port's SPH and spatial particle runners goes at
world 1, beside the one-device runs they split, on a GPU; and how evenly
sph_spatial's slabs split a settled SPH pool.

    python tools/profile_parallel_torch.py [--out PATH]

In one process, a NCCL process group of one rank (the card): the
one-device run and the world-1 runner of SPH 65,536 particles without
rain (engine 'cuda'; parallel/sph_sharded.py and sph_spatial.py), FLIP
65,536 on 128^2 and MLS-MPM 32,768 on 96^2 (engine 'dense';
parallel/flip_spatial.py and mpm_spatial.py), each from init: the
unprofiled step time, and under torch.profiler the device time of each
kernel group (the SPH kernels, NCCL's) and of the torch ops, the busy and
idle shares (tools/profile_torch_common.py says how each is read).

Then the split of a pool settled by 200 and 2,000 one-device steps at
65,536 particles: for 2, 4 and 8 ranks, the owned receivers a rank of
sph_spatial's equal slabs of cell columns, as the largest over the mean
(1 is even; sph_sharded's equal ranges of sorted positions are even by
construction).

Imports torch and the port only.  Writes JSON to `--out` (default
build/profile_parallel_torch.json; the split to the same name with
`_split` before the suffix).
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fluidsims_tpu_torch.ops import cell_dense as cd  # noqa: E402
from fluidsims_tpu_torch.parallel import flip_spatial as fsp  # noqa: E402
from fluidsims_tpu_torch.parallel import mpm_spatial as msp  # noqa: E402
from fluidsims_tpu_torch.parallel import sph_sharded as ssh  # noqa: E402
from fluidsims_tpu_torch.parallel import sph_spatial as ssp  # noqa: E402
from fluidsims_tpu_torch.parallel.mesh import make_mesh_1d  # noqa: E402
from fluidsims_tpu_torch.solvers import flip_apic as fa  # noqa: E402
from fluidsims_tpu_torch.solvers import mpm, sph  # noqa: E402
from profile_torch_common import Run, main  # noqa: E402

GROUPS = ("density_kernel", "forces_kernel", "bin_kernel",
          "bin_rank_kernel", "nccl")
DEV = torch.device("cuda", 0)
SPH = sph.SPHConfig(n=65536, rain=False, engine="cuda")
FLIP = fa.FlipApicConfig(particles=65536, grid=128, engine="dense")
MPM = mpm.MPMConfig(n=32768, gx=96, gy=96, engine="dense")


def one_device(solver, cfg):
    def make_go():
        st0 = solver.init(cfg, DEV)
        return lambda k: solver.run(cfg, st0, k)
    return make_go


def sph_sharded():
    st0 = sph.init(SPH, DEV)
    mesh = make_mesh_1d(axis="c", device=DEV)
    return lambda k: ssh.make_sharded_run(SPH, mesh, k)(st0)


def spatial(mod, solver, cfg, axis):
    def make_go():
        mesh = make_mesh_1d(axis=axis, device=DEV)
        local = mod.shard_state(solver.init(cfg, DEV), cfg, mesh)
        return lambda k: mod.make_sharded_run(cfg, mesh, k)(local)
    return make_go


RUNS = [Run("sph 65536 one device", 20, one_device(sph, SPH), 65536),
        Run("sph 65536 sph_sharded world 1", 20, sph_sharded, 65536),
        Run("sph 65536 sph_spatial world 1", 10,
            spatial(ssp, sph, SPH, "c"), 65536),
        Run("flip 65536 on 128^2 dense one device", 5,
            one_device(fa, FLIP), 65536),
        Run("flip 65536 on 128^2 flip_spatial world 1", 5,
            spatial(fsp, fa, FLIP, "x"), 65536),
        Run("mpm 32768 on 96^2 dense one device", 10,
            one_device(mpm, MPM), 32768),
        Run("mpm 32768 on 96^2 mpm_spatial world 1", 10,
            spatial(msp, mpm, MPM, "x"), 32768)]


def split(out: str) -> None:
    """The largest over the mean of sph_spatial's owned receivers a
    rank, on settled pools."""
    g = SPH.grid()
    res = {}
    st = sph.init(SPH, DEV)
    done = 0
    for steps in (200, 2000):
        st = sph.run(SPH, st, steps - done)
        done = steps
        cid = cd._cid(g, st.pos)
        per_cell = torch.bincount(cid, minlength=g.Gx * g.Gy).double()
        for d in (2, 4, 8):
            cols = per_cell.reshape(g.Gy, d, -1).sum((0, 2))   # x-slabs
            res[f"{steps} steps, {d} ranks"] = {
                "sph_spatial": float(cols.max() / cols.mean())}
    for k, v in res.items():
        print(f"split after {k}: largest / mean owned receivers a rank "
              f"sph_spatial {v['sph_spatial']!r}")
    p = Path(out)
    p.with_name(p.stem + "_split" + p.suffix).write_text(
        json.dumps(res, indent=1))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    torch.cuda.set_device(DEV)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/rdv",
                                rank=0, world_size=1)
        try:
            dist.all_reduce(torch.zeros(1, device=DEV))  # form the group
            out = "build/profile_parallel_torch.json"
            argv = sys.argv[1:]
            if "--out" in argv:
                out = argv[argv.index("--out") + 1]
            code = main(argv, doc=__doc__, default_out=out, groups=GROUPS,
                        runs=RUNS)
            split(out)
        finally:
            dist.destroy_process_group()
    sys.exit(code)
