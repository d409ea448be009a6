"""GPU smoke test of the PyTorch + CUDA port (fluidsims_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU and nvcc (found through $CUDA_HOME, $PATH or
/usr/local/cuda).  Imports torch, numpy and the port only.  Phases, any
failure of which ends the run with a non-zero exit:

1. device  — a CUDA device is present; print its name and power limit.
2. build   — build both kernels from fluidsims_tpu_torch/csrc; print the
             seconds and ptxas' register/spill report.
3. kernels — each kernel against its plain PyTorch version on the same
             inputs, f32 and f64, on a block-aligned (256x128) and a ragged
             (200x75) grid, from a perturbed state with a NaN cell and a
             near-vacuum patch: f64 rel err <= 1e-12, f32 <= 1e-5 (the
             Pallas-vs-XLA bar of the JAX package), NaN cells in the same
             places, the wavespeed bitwise equal.
4. main    — the flagship solver through solvers.hypersonic2d.run: 2048^2
             f32 x 200 steps and 8192x1024 f64 x 50 steps; every step must
             launch both kernels once; rates beside the plain version's;
             then, from each run's final state, both kernels against their
             plain versions at these full shapes (same bars as phase 3).
5. physics — fluid cells finite, min rho >= 1e-25, min p > 0, and a bow
             shock (rho > 1.5) upstream of the body after the 2048^2 run.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
STEP_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s); using {name}")
    log(f"[device] nvidia-smi: {smi}")
    return smi


def phase_build(hk, build) -> None:
    t0 = time.perf_counter()
    hk.load()
    secs = time.perf_counter() - t0
    log(f"[build] kernels built and loaded in {secs:.1f} s")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] ptxas: {line.strip()}")


def perturbed_state(h2, interop, cfg, device):
    """init() plus seeded noise in the primitives of the fluid cells, one
    NaN cell and a near-vacuum patch, so the HLLE fallback and the
    positivity repair both run."""
    s = h2.init(cfg, torch.device("cpu"))
    rng = np.random.default_rng(SEED)
    U = [f.numpy().astype(np.float64) for f in s.U]
    mask = s.mask.numpy()
    g = cfg.gamma
    rho = U[0]
    u, v = U[1] / rho, U[2] / rho
    p = (g - 1.0) * (U[3] - 0.5 * rho * (u * u + v * v))
    shape = rho.shape
    rho = rho * (1.0 + 0.2 * rng.uniform(-1, 1, shape))
    u = u + 2.0 * rng.standard_normal(shape)
    v = v + 2.0 * rng.standard_normal(shape)
    p = p * (1.0 + 0.2 * rng.uniform(-1, 1, shape))
    ny, nx = shape
    y0, x0 = ny // 5, nx // 3          # near-vacuum patch, away from the body
    rho[y0:y0 + 4, x0:x0 + 5] = 1e-20
    p[y0:y0 + 4, x0:x0 + 5] = 1e-24
    u[y0:y0 + 4, x0:x0 + 5] = 0.0
    v[y0:y0 + 4, x0:x0 + 5] = 0.0
    new = [rho, rho * u, rho * v, p / (g - 1.0) + 0.5 * rho * (u * u + v * v)]
    new = [np.where(mask, old, nw) for old, nw in zip(U, new)]
    yn, xn = (4 * ny) // 5, nx // 2    # one NaN cell
    if mask[yn, xn]:
        raise AssertionError(f"NaN cell ({yn}, {xn}) lies in the body")
    new[0][yn, xn] = np.nan
    new[3][yn, xn] = np.nan
    return interop.state_from_numpy(new, mask, 0.0, dtype=cfg.torch_dtype,
                                    device=device)


def clone_U(U):
    return type(U)(*(f.clone() for f in U))


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN in the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def compare(got, ref, what: str, tol: float) -> tuple[float, float]:
    """Max |err|/max(|ref|,1) and max |err| over finite cells; raises on a
    tolerance breach or on non-finite cells in different places."""
    rel = ab = 0.0
    for name, a, b in zip(ref._fields, got, ref):
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        if not torch.equal(fa, fb):
            raise AssertionError(f"{what}.{name}: non-finite cells differ "
                                 f"({int((~fa).sum())} vs {int((~fb).sum())})")
        d = torch.where(fb, (a - b).abs(), 0)
        scale = torch.where(fb, b.abs().clamp_min(1.0), 1.0)
        rel = max(rel, float((d / scale).max()))
        ab = max(ab, float(d.max()))
    if not rel <= tol:
        raise AssertionError(f"{what}: max rel err {rel:.3e} > {tol:g}")
    return rel, ab


def check_one_call(hk, cfl_dt, cfg, U, mask, what: str, errs: dict) -> float:
    """Both kernels vs their plain versions on copies of the same U: the
    wavespeed and the in-place inflow column bitwise, then the step from
    the same U and dt within STEP_TOL.  Folds the absolute errors into
    `errs` and returns the step's max rel err."""
    a, b = clone_U(U), clone_U(U)
    wk = hk.inflow_wavespeed(cfg, a, mask)
    wp = hk.inflow_wavespeed_plain(cfg, b, mask)
    errs["wavespeed"] = max(errs["wavespeed"], float((wk - wp).abs()))
    if not torch.equal(wk.view(1), wp.view(1)):
        raise AssertionError(f"wavespeed {what}: kernel {float(wk)!r} != "
                             f"plain {float(wp)!r}")
    for fa, fb in zip(a, b):  # the in-place inflow column
        if not same(fa, fb):
            raise AssertionError(f"inflow column writes differ, {what}")
    dt = cfl_dt(wk, cfg.cfl, dx=1.0, nu_max=cfg.nu_max)
    ck = hk.step_core(cfg, a, mask, dt)
    cp = hk.step_core_plain(cfg, a, mask, dt)
    rel, ab = compare(ck, cp, f"step {what}", STEP_TOL[cfg.torch_dtype])
    errs["step"] = max(errs["step"], ab)
    return rel


def phase_kernels(h2, hk, interop, cfl_dt, device) -> dict:
    """Each kernel vs its plain version on identical inputs, step by step
    along the kernel path's trajectory, then the two 4-step trajectories."""
    errs = {"step": 0.0, "step_rel": {}, "wavespeed": 0.0}
    for dtype in (torch.float32, torch.float64):
        for nx, ny in ((256, 128), (200, 75)):
            cfg = h2.default_config(nx=nx, ny=ny,
                                    dtype=str(dtype).split(".")[1])
            plain = {"core": lambda U, m, dt, c=cfg: hk.step_core_plain(c, U, m, dt),
                     "wavespeed": lambda U, m, c=cfg: hk.inflow_wavespeed_plain(c, U, m)}
            sk = perturbed_state(h2, interop, cfg, device)
            sp = h2.Hypersonic2DState(clone_U(sk.U), sk.mask, sk.t.clone())
            worst = 0.0
            for k in range(4):
                worst = max(worst, check_one_call(
                    hk, cfl_dt, cfg, sk.U, sk.mask,
                    f"{nx}x{ny} {dtype} call {k}", errs))
                sk = h2.step(cfg, sk)
                sp = h2.step(cfg, sp, **plain)
            torch.cuda.synchronize()
            rel, ab = compare(sk.U, sp.U, f"4 steps {nx}x{ny} {dtype}",
                              STEP_TOL[dtype])
            worst = max(worst, rel)
            errs["step"] = max(errs["step"], ab)
            n_nan = int((~torch.isfinite(sk.U.rho)).sum())
            if n_nan == 0:
                raise AssertionError("the injected NaN cell vanished")
            key = f"{nx}x{ny} {str(dtype).split('.')[1]}"
            errs["step_rel"][key] = worst
            log(f"[kernels] {key}: step max rel err {worst:.3e} "
                f"(tol {STEP_TOL[dtype]:g}), wavespeed bitwise equal, "
                f"{n_nan} NaN cells in the same places after 4 steps")
    return errs


def time_launches(fn, n: int) -> float:
    """Mean ms per call of fn() over n calls, by CUDA events, after one
    warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def run_timed(h2, cfg, s, steps, **engine):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = h2.run(cfg, s, steps, **engine)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_physics(h2, regression, cfg, out, steps, bow_shock: bool) -> None:
    U, mask = out.U, out.mask
    fluid = ~mask
    for name, f in zip(U._fields, U):
        if not bool(torch.isfinite(f[fluid]).all()):
            raise AssertionError(f"non-finite {name} in fluid cells")
    snap = regression.compute_snapshot(cfg, out, steps)
    if not (snap["fluid_cells"] > 0 and snap["min_rho"] >= 1e-25
            and snap["min_p"] > 0):
        raise AssertionError(f"physical invariants violated: {snap}")
    msg = (f"[physics] {cfg.nx}x{cfg.ny} {cfg.dtype}: fluid cells finite, "
           f"min_rho {snap['min_rho']:.4g}, min_p {snap['min_p']:.4g}, "
           f"max_mach {snap['max_mach']:.4g}, t {float(out.t):.6f}")
    if bow_shock:
        # upstream of the body: the fluid cells left of each row's first
        # solid cell
        m = mask.cpu().numpy()
        rho = U.rho.cpu().numpy()
        rows = np.flatnonzero(m.any(axis=1))
        first = m[rows].argmax(axis=1)
        up = max(float(rho[r, :c].max()) for r, c in zip(rows, first) if c > 0)
        if not up > 1.5:
            raise AssertionError(f"no bow shock: max rho upstream {up:.4g}")
        msg += f", bow shock: max rho upstream of the body {up:.4g}"
    log(msg)


def phase_main(h2, hk, regression, cfl_dt, device, smi, errs) -> dict:
    hk.reset_launches()
    runs = []
    for nx, ny, dtype, steps, bow in ((2048, 2048, "float32", 200, True),
                                      (8192, 1024, "float64", 50, False)):
        cfg = h2.default_config(nx=nx, ny=ny, dtype=dtype)
        before = dict(hk.LAUNCHES)
        out, wall = run_timed(h2, cfg, h2.init(cfg, device), steps)
        for k in ("step", "wavespeed"):
            if hk.LAUNCHES[k] - before[k] != steps:
                raise AssertionError(
                    f"{k} kernel launched {hk.LAUNCHES[k] - before[k]} times "
                    f"in {steps} steps")
        plain = {"core": lambda U, m, dt, c=cfg: hk.step_core_plain(c, U, m, dt),
                 "wavespeed": lambda U, m, c=cfg: hk.inflow_wavespeed_plain(c, U, m)}
        pl_steps = 20
        _, pl_wall = run_timed(h2, cfg, h2.init(cfg, device), pl_steps, **plain)
        if hk.LAUNCHES["step"] - before["step"] != steps:
            raise AssertionError("the plain version launched a kernel")
        cells = nx * ny
        k_rate, p_rate = steps / wall, pl_steps / pl_wall
        log(f"[main] {nx}x{ny} {dtype} on {smi}: kernels {steps} steps "
            f"{k_rate:.2f} steps/s {cells * k_rate / 1e6:.1f} Mcell-steps/s; "
            f"plain torch {pl_steps} steps {p_rate:.2f} steps/s "
            f"{cells * p_rate / 1e6:.1f} Mcell-steps/s; kernel launches "
            f"step={hk.LAUNCHES['step'] - before['step']} "
            f"wavespeed={hk.LAUNCHES['wavespeed'] - before['wavespeed']}")
        check_physics(h2, regression, cfg, out, steps, bow)
        runs.append((cfg, out))
    launches = dict(hk.LAUNCHES)

    # Both kernels vs their plain versions at the main path's shapes, on
    # the state each run ended in; then per-launch times there.  None of
    # these launches is counted above.
    times = {}
    for cfg, out in runs:
        U, mask = out.U, out.mask
        key = f"{cfg.nx}x{cfg.ny} {cfg.dtype}"
        rel = check_one_call(hk, cfl_dt, cfg, U, mask, key, errs)
        errs["step_rel"][key] = rel
        log(f"[main] {key}: kernels vs plain from the final state: step max "
            f"rel err {rel:.3e} (tol {STEP_TOL[cfg.torch_dtype]:g}), NaN "
            f"cells in the same places, wavespeed and inflow column bitwise "
            f"equal")
        dt = torch.full((), 1e-3, dtype=cfg.torch_dtype, device=device)
        times[key] = {
            "step": time_launches(lambda: hk.step_core(cfg, U, mask, dt), 20),
            "step_plain": time_launches(
                lambda: hk.step_core_plain(cfg, U, mask, dt), 3),
            "wavespeed": time_launches(
                lambda: hk.inflow_wavespeed(cfg, U, mask), 50),
            "wavespeed_plain": time_launches(
                lambda: hk.inflow_wavespeed_plain(cfg, U, mask), 10),
        }
        t = times[key]
        log(f"[main] per launch at {key} on {smi}: step kernel "
            f"{t['step']:.4f} ms vs plain {t['step_plain']:.4f} ms; wavespeed "
            f"kernel {t['wavespeed']:.4f} ms vs plain "
            f"{t['wavespeed_plain']:.4f} ms")
    return {"launches": launches, "times": times}


def main() -> int:
    smi = phase_device()
    from fluidsims_tpu_torch import interop, regression
    from fluidsims_tpu_torch.core.clock import cfl_dt
    from fluidsims_tpu_torch.kernels import _build
    from fluidsims_tpu_torch.kernels import hypersonic2d_cuda as hk
    from fluidsims_tpu_torch.solvers import hypersonic2d as h2

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_build(hk, _build)
    errs = phase_kernels(h2, hk, interop, cfl_dt, device)
    main_res = phase_main(h2, hk, regression, cfl_dt, device, smi, errs)

    t = main_res["times"]
    flag, ref = t["2048x2048 float32"], t["8192x1024 float64"]
    kernels = [
        {"name": "hypersonic2d_step", "route": "cuda",
         "source": "fluidsims_tpu_torch/csrc/hypersonic2d_step.cu",
         "replaces": "fluidsims_tpu/kernels/hypersonic2d_pallas.py:60",
         "launches": main_res["launches"]["step"],
         "max_abs_err": errs["step"],
         "ms": flag["step"], "plain_ms": flag["step_plain"],
         "ms_8192x1024_f64": ref["step"],
         "plain_ms_8192x1024_f64": ref["step_plain"],
         "max_rel_err": errs["step_rel"]},
        {"name": "hypersonic2d_inflow_wavespeed", "route": "cuda",
         "source": "fluidsims_tpu_torch/csrc/hypersonic2d_wavespeed.cu",
         # JAX computes this part as plain XLA (max_wavespeed), next to the
         # Pallas step kernel
         "replaces": "fluidsims_tpu/solvers/hypersonic2d.py:401",
         "launches": main_res["launches"]["wavespeed"],
         "max_abs_err": errs["wavespeed"],
         "ms": flag["wavespeed"], "plain_ms": flag["wavespeed_plain"],
         "ms_8192x1024_f64": ref["wavespeed"],
         "plain_ms_8192x1024_f64": ref["wavespeed_plain"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
