"""The cases of tests/test_torch_parallel_stam.py (2-D) and
tests/test_torch_parallel_stam3d.py (3-D): the sharded stable-fluids
runners of the port on gloo ranks against JAX's sharded runs on its
virtual CPU devices, and the sharded Jacobi solves alone.

Each run starts from JAX's initial state carried over by interop; one
spawn per world size runs a file's cases on CPU ranks
(tests/parallel_ranks.stam_family; the ranks import no JAX, and the
kernels' wrappers take their plain versions for CPU tensors), and rank 0
returns the gathered result.  Bars against JAX's sharded run: JAX's own
of tests/test_stam_sharded.py in float32 (rtol 1e-4 / atol 5e-5: XLA
contracts multiply-adds differently per local shape), 1e-10 in float64.
"""

import functools

import numpy as np
import torch

from fluidsims_tpu.parallel import stam2d_sharded as jsh2
from fluidsims_tpu.parallel import stam3d_sharded as jsh3
from fluidsims_tpu.parallel.mesh import make_mesh_1d
from fluidsims_tpu.solvers import stam2d as js2
from fluidsims_tpu.solvers import stam3d as js3
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.parallel import launch
from fluidsims_tpu_torch.solvers import stam2d as ts2
from fluidsims_tpu_torch.solvers import stam3d as ts3
from tests import parallel_ranks

CPU = torch.device("cpu")
CALM_DT = 0.05   # tests/test_stam_sharded.py _CALM_DT: no back-trace clamps
STEPS = 3
WORLDS = (2, 4)


def _cases() -> dict:
    """label -> (runner, JAX config, steps, runner options, worlds)."""
    out = {}
    for dt in ("float32", "float64"):
        for hk in (1, 3, 4):
            out[f"stam2d_{dt}_k{hk}"] = (
                "stam2d", js2.Stam2DConfig(n=32, dt=CALM_DT, dtype=dt),
                STEPS, dict(halo_k=hk), WORLDS)
        for hk in (1, 2, 4):
            out[f"stam3d_{dt}_k{hk}"] = (
                "stam3d", js3.Stam3DConfig(n=16, advect_k=2, dtype=dt),
                STEPS, dict(halo_k=hk), WORLDS)
        # n + 2 = 13 slices padded to 16 at world 4: the top face gz = 12 is
        # slice 0 of rank 3, its neighbour gz = 11 on rank 2, and rank 3
        # also holds three padded slices
        out[f"stam3d_n11_{dt}"] = (
            "stam3d", js3.Stam3DConfig(n=11, advect_k=2, dtype=dt), STEPS,
            dict(halo_k=4), (4,))
    # JAX's clamp case (tests/test_stam_sharded.py): dt = 1 on the init
    # swirl traces back tens of columns, past 2 exchanged columns
    out["stam2d_clamp"] = ("stam2d", js2.Stam2DConfig(n=32, dtype="float64"),
                           1, dict(halo_k=4, advect_halo=2), WORLDS)
    return out


CASES = _cases()


def labels(runner: str, calm: bool = False) -> list:
    """The labels of a runner's cases (calm: without the clamp case)."""
    return [lb for lb, c in CASES.items() if c[0] == runner
            and not (calm and lb == "stam2d_clamp")]


def params(labels: list) -> list:
    """(label, world) of each case at each of its world sizes."""
    return [(lb, w) for lb in labels for w in WORLDS if w in CASES[lb][4]]


@functools.lru_cache(maxsize=None)
def inputs(label: str):
    """(runner, JAX config, port config, JAX initial state, port initial
    state)."""
    name, jc = CASES[label][:2]
    mod, pre = (js2, "stam2d") if name == "stam2d" else (js3, "stam3d")
    tc = getattr(interop, f"{pre}_config_from_dict")(jc.asdict())
    sj = mod.init(jc)
    st = getattr(interop, f"{pre}_state_from_numpy")(
        *(np.asarray(f) for f in sj), dtype=tc.torch_dtype, device=CPU)
    return name, jc, tc, sj, st


def solve_inputs(dim: int) -> list:
    """The sharded solves' cases: (dim, x, b, a, c, iters, halo_k), seeded
    numpy as JAX's test draws them: 2-D n = 32, 40 sweeps, halo_k 1, 3,
    4; 3-D n = 16, 12 sweeps, halo_k 1, 2, 3, 4 (an odd width starts
    rounds on odd sweeps)."""
    shape, hks, c, iters = ({2: ((32, 32), (1, 3, 4), 4.0, 40),
                             3: ((18, 18, 18), (1, 2, 3, 4), 6.0, 12)}[dim])
    out = []
    for dtype in (torch.float32, torch.float64):
        rng = np.random.default_rng(7 + dim)
        x, b = (torch.tensor(rng.normal(size=shape), dtype=dtype)
                for _ in range(2))
        out += [(dim, x, b, 1.0, c, iters, hk) for hk in hks]
    return out


def one_device_solve(case) -> np.ndarray:
    """The port's one-device solve of a solve_inputs case."""
    dim, x, b, a, c, iters, _ = case
    if dim == 2:
        return ts2._lin_solve(x, b, a, c, iters).numpy()
    cfg = ts3.Stam3DConfig(n=x.shape[0] - 2, jacobi_iters=iters)
    return ts3._lin_solve(cfg, x, b, a, c).numpy()


def run_ranks(labels: list, solves: list) -> tuple:
    """({(label, world): rank 0's result of the case}, {(i, world): the
    gathered solve of solves[i]}), from one spawn of each world size."""
    runs, got = {}, {}
    for world in WORLDS:
        mine = [lb for lb in labels if world in CASES[lb][4]]
        cases = [dict(name=inputs(lb)[0], config=inputs(lb)[2].asdict(),
                      state=inputs(lb)[4], steps=CASES[lb][2],
                      options=CASES[lb][3], keep=True) for lb in mine]
        res, sol = launch.spawn(parallel_ranks.stam_family, world, "gloo",
                                args=(cases, solves), timeout=300)[0]
        runs.update({(lb, world): r for lb, r in zip(mine, res)})
        got.update({(i, world): g for i, g in enumerate(sol)})
    return runs, got


@functools.lru_cache(maxsize=None)
def jax_sharded(label: str, world: int) -> list:
    """JAX's sharded run of `label` on `world` devices, as numpy leaves in
    the state's order."""
    name, jc, _, sj, _ = inputs(label)
    steps, opts = CASES[label][2:4]
    mesh = make_mesh_1d(world)
    if name == "stam2d":
        out = jsh2.make_sharded_run(jc, mesh, steps, **opts)(
            jsh2.shard_state(sj, mesh))
    else:
        out = jsh3.unshard_state(jsh3.make_sharded_run(
            jc, mesh, steps, **opts)(jsh3.shard_state(sj, mesh)), jc.n)
    return [np.asarray(f) for f in out]


def assert_matches_jax(got, label: str, world: int) -> None:
    """The gathered state within the bars of JAX's sharded run; integer
    leaves (the step index, 2-D's clamp count) equal."""
    ref = jax_sharded(label, world)
    rtol, atol = ((1e-4, 5e-5) if CASES[label][1].dtype == "float32"
                  else (1e-10, 1e-10))
    for a, b in zip(got, ref):
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
        else:
            np.testing.assert_array_equal(a, b)
