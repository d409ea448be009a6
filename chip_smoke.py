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
6. sph_kernels — the three SPH kernels (bin, density, forces + integrate)
             against their plain PyTorch versions on the same inputs, f32
             and f64, on 4096 particles from init plus seeded velocity
             noise and on 512 particles with cell_capacity=8 (particles
             past a cell's K slots): the binning bitwise, density and
             forces max|err| / max|ref| <= 1e-5 (f32) / 1e-12 (f64); then
             5 steps of the cuda engine against the same steps through the
             plain versions at f32 (atol 2e-6 pos, 2e-5 vel).
7. sph_main — SPH through solvers.sph.run with engine 'auto', which must
             resolve to 'cuda': 65,536 particles f32 without rain x 200
             steps (bench.py's configuration) and 2^20 particles f32 with
             rain x 50 steps (256 x 256 cells); each kernel launched once
             per substep; M particle-steps/s beside the plain 'torch'
             engine's; overflow reported; physics (finite, in the box,
             mean height below the initial one, tau > 0); then, from each
             run's final state, each kernel against its plain version at
             that shape (same bars) and per-launch times.

Every kernel's line in {"kernels": [...]} carries bound_ms, the least time
the card could take for its work at the main path's shape: the larger of
the bytes it must move (inputs read once, outputs written once) over
3.35 TB/s and its operations over 67 TFLOP/s (f32) or 34 TFLOP/s (f64),
the peaks of an H100 SXM at 700 W; bound_by says which.  Operation counts
per cell or pair are counted from the CUDA sources (see *_OPS below);
where the work depends on the data (SPH pairs), this run's pairs are
counted.

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

# H100 SXM peaks (NVIDIA data sheet), for bound_ms
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# Operations (each add, multiply, division, square root, log, exp once),
# counted from the CUDA sources:
# hypersonic2d_step.cu per fluid cell: 6 MUSCL-Hancock predicts (~227:
# 7 primitive decodes, 5 encodes, 4 limited slopes, 2 fluxes, 2 half
# steps) + 4 HLLC solves (~97) + ghost, update, diffusion and repair
# (~140); solid cells copy their state.
HYP2D_STEP_OPS_PER_FLUID_CELL = 1900
# hypersonic2d_wavespeed.cu per fluid cell: one decode, sound speed, max.
HYP2D_WAVESPEED_OPS_PER_FLUID_CELL = 17
# sph_density.cu: per candidate pair the distance, sqrt, q and the sum
# (9), per pair within 2h the spline (6 more); per stored particle the
# EOS and p/rho^2 (10).
SPH_DENSITY_OPS = (9, 6, 10)
# sph_forces.cu: per candidate pair the distance test (5), per pair
# within 2h and not self the gradient, pressure term and sums (23, the
# viscosity branch not counted); per particle gravity and the integrate
# with walls (14).
SPH_FORCES_OPS = (5, 23, 14)
# sph_bin.cu per particle: the cell id (2 divisions, 2 floors).
SPH_BIN_OPS_PER_PARTICLE = 4


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


def bound(bytes_moved: float, ops: float, dtype) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for the work on an H100."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hyp2d_bounds(cfg, mask) -> dict:
    """bound_ms of both hypersonic kernels at cfg's shape."""
    cells = cfg.nx * cfg.ny
    fluid = int((~mask).sum())
    T = torch.finfo(cfg.torch_dtype).bits // 8
    return {"step": bound(cells * (8 * T + 1),
                          fluid * HYP2D_STEP_OPS_PER_FLUID_CELL,
                          cfg.torch_dtype),
            "wavespeed": bound(cells * (4 * T + 1),
                               fluid * HYP2D_WAVESPEED_OPS_PER_FLUID_CELL,
                               cfg.torch_dtype)}


# ---------------------------------- SPH ------------------------------------

def sph_pairs(sk, cfg, b) -> dict:
    """This binning's pair counts: candidates (stored receivers x stored
    members of the 3x3 cells around them, self included) and those within
    2h, self excluded; counted on the dense layout of the plain versions."""
    p = sk._params(cfg)
    slot, ok = sk._dense_slots(cfg, b)
    occ = sk._to_dense(cfg, slot, ok[:, None])[..., 0]
    dpos = sk._to_dense(cfg, slot, b.fields[:, :2])
    occ_c = occ[..., :, None]
    cand = near = 0
    for ox, oy in ((ox, oy) for oy in (-1, 0, 1) for ox in (-1, 0, 1)):
        _, nocc, _, _, r2 = sk._pairs(cfg, dpos, occ, oy, ox)
        both = occ_c & nocc
        cand += int(both.sum())
        near += int((both & (r2 < p.four_h2) & (r2 > 1e-16)).sum())
    stored = int(ok.sum())
    return {"candidates": cand, "near": near, "stored": stored}


def sph_bounds(sk, cfg, b) -> dict:
    """bound_ms of the three SPH kernels for this binning."""
    n, g = cfg.n, cfg.grid()
    M = g.Gx * g.Gy
    T = torch.finfo(cfg.torch_dtype).bits // 8
    pr = sph_pairs(sk, cfg, b)
    dc, dn, dp = SPH_DENSITY_OPS
    fc, fn, fp = SPH_FORCES_OPS
    return {
        "bin": bound(n * 4 * T + n * (4 + 4 + 1 + 4 + 4 * T) + 4 * (M + 1),
                     n * SPH_BIN_OPS_PER_PARTICLE, cfg.torch_dtype),
        "density": bound(n * 4 * T + 4 * (M + 1) + n * 2 * T,
                         dc * pr["candidates"] + dn * pr["near"]
                         + dp * pr["stored"], cfg.torch_dtype),
        "forces": bound(n * 6 * T + 4 * (M + 1) + 4 * n + T + n * 4 * T,
                        fc * pr["candidates"] + fn * pr["near"] + fp * n,
                        cfg.torch_dtype),
        "pairs": pr}


def rel_err(got, ref) -> tuple[float, float]:
    """(max |err| / max |ref|, max |err|); raises on non-finite values."""
    if not (bool(torch.isfinite(got).all())
            and bool(torch.isfinite(ref).all())):
        raise AssertionError("non-finite values")
    ab = float((got - ref).abs().max())
    return ab / max(float(ref.abs().max()), 1e-300), ab


def check_sph_call(sk, cfg, pos, vel, what: str, errs: dict) -> dict:
    """The three SPH kernels against their plain versions on the same
    inputs: the binning bitwise, then density from the kernel's binning
    and forces + integrate from the kernel's binning and density.  Folds
    the absolute errors into `errs`; returns the max rel errors."""
    tol = STEP_TOL[cfg.torch_dtype]
    b = sk.binning(cfg, pos, vel)
    bp = sk.binning_plain(cfg, pos, vel)
    for name, x, y in zip(b._fields, b, bp):
        if not torch.equal(x, y):
            raise AssertionError(f"bin {what}: {name} differs from the plain "
                                 f"version")
    out = {}
    rp = sk.density(cfg, b)
    rpp = sk.density_plain(cfg, b)
    out["density"] = max(rel_err(rp[:, k], rpp[:, k])[0] for k in (0, 1))
    errs["density"] = max(errs["density"], float((rp - rpp).abs().max()))
    dt_cfl = cfg.cfl * cfg.h / (cfg.c0 * (1.0 + 2.0 * cfg.visc_alpha))
    dt = torch.full((), dt_cfl, dtype=pos.dtype, device=pos.device)
    pk, vk = sk.forces(cfg, b, rp, dt)
    pp, vp = sk.forces_plain(cfg, b, rp, dt)
    (rp_, ap), (rv_, av) = rel_err(pk, pp), rel_err(vk, vp)
    out["forces"] = max(rp_, rv_)
    errs["forces"] = max(errs["forces"], ap, av)
    for k in ("density", "forces"):
        if not out[k] <= tol:
            raise AssertionError(f"{k} {what}: max rel err {out[k]:.3e} > "
                                 f"{tol:g}")
    stored = int(b.ok.sum())
    log(f"[sph] {what}: bin bitwise equal ({cfg.n - stored} of {cfg.n} past "
        f"K={cfg.grid().K}); density max rel err {out['density']:.3e}, "
        f"forces+integrate {out['forces']:.3e} (tol {tol:g})")
    return out


def plain_sph_step(sk, ts, cfg):
    """The cuda engine's frame step with each kernel's plain version."""
    def substep(pos, vel, dt_sub):
        b = sk.binning_plain(cfg, pos, vel)
        return sk.forces_plain(cfg, b, sk.density_plain(cfg, b), dt_sub)
    return lambda st: ts._advance(cfg, st, None, substep)


def phase_sph_kernels(sk, ts, device) -> dict:
    errs = {"density": 0.0, "forces": 0.0, "rel": {}}
    rng = np.random.default_rng(SEED)
    for dtype in ("float32", "float64"):
        for n, cap in ((4096, 0), (512, 8)):
            cfg = ts.SPHConfig(n=n, cell_capacity=cap, dtype=dtype)
            st = ts.init(cfg, device)
            vel = torch.tensor(0.5 * rng.standard_normal((n, 2)),
                               dtype=cfg.torch_dtype, device=device)
            key = f"n={n} K={cfg.grid().K} {dtype}"
            errs["rel"][key] = check_sph_call(sk, cfg, st.pos, vel, key,
                                              errs)
    cfg = ts.SPHConfig(n=4096, rain=True, dtau=1e-2)
    a = b = ts.init(cfg, device)
    plain = plain_sph_step(sk, ts, cfg)
    for _ in range(5):
        a, b = ts.step(cfg, a), plain(b)
    torch.cuda.synchronize()
    dp = float((a.pos - b.pos).abs().max())
    dv = float((a.vel - b.vel).abs().max())
    if not (dp <= 2e-6 and dv <= 2e-5):
        raise AssertionError(f"5 steps cuda vs plain: pos {dp:.3e} vel "
                             f"{dv:.3e} (atol 2e-6 / 2e-5)")
    log(f"[sph] 5 steps n=4096 f32 rain, cuda engine vs plain versions: max "
        f"|d pos| {dp:.3e} (atol 2e-6), |d vel| {dv:.3e} (atol 2e-5)")
    errs["trajectory"] = {"pos": dp, "vel": dv}
    return errs


def check_sph_physics(ts, cfg, st0, out) -> dict:
    pos = out.pos
    if not (bool(torch.isfinite(pos).all())
            and bool(torch.isfinite(out.vel).all())):
        raise AssertionError("non-finite SPH state")
    inside = ((pos[:, 0] >= 0) & (pos[:, 0] <= cfg.box_x)
              & (pos[:, 1] >= 0) & (pos[:, 1] <= cfg.box_y))
    if not bool(inside.all()):
        raise AssertionError(f"{int((~inside).sum())} particles outside the box")
    y0, y1 = float(st0.pos[:, 1].mean()), float(pos[:, 1].mean())
    if not y1 < y0:
        raise AssertionError(f"mean height {y1:.6f} not below initial {y0:.6f}")
    if not float(out.tau) > 0:
        raise AssertionError(f"tau {float(out.tau)} not > 0")
    ov = int(ts.overflow_count(cfg, out))
    log(f"[physics] sph n={cfg.n}: finite, all in the box, mean height "
        f"{y0:.6f} -> {y1:.6f}, tau {float(out.tau):.6f}, t {float(out.t):.6f}; "
        f"overflow {ov} of {cfg.n} past K={cfg.grid().K} (reported, not "
        f"asserted)")
    return {"overflow": ov, "mean_y0": y0, "mean_y": y1}


# (n, rain, steps): bench.py's configuration, and 2^20 with the CLI's rain
SPH_RUNS = ((65536, False, 200), (1 << 20, True, 50))


def phase_sph_main(sk, ts, device, smi, errs, runs=SPH_RUNS) -> dict:
    res = {}
    for n, rain, steps in runs:
        cfg = ts.SPHConfig(n=n, rain=rain)
        engine = ts.resolve_engine(cfg, device)
        if engine != "cuda":
            raise AssertionError(f"engine auto resolved to {engine!r}")
        st0 = ts.init(cfg, device)
        ts.run(cfg, st0, 1)   # warm-up, not counted
        sk.reset_launches()
        out, wall = run_timed(ts, cfg, st0, steps)
        launches = dict(sk.LAUNCHES)
        want = steps * cfg.visc_substeps
        if any(v != want for v in launches.values()):
            raise AssertionError(f"launches {launches} in {steps} steps, "
                                 f"want {want} each")
        # the plain engine: 20 steps at 65,536; one step (one substep) at
        # 2^20, whose dense pair blocks take GBs
        pcfg = cfg.replace(engine="torch")
        p_steps = 20 if n <= 65536 else 1
        _, p_wall = run_timed(ts, pcfg, st0, p_steps)
        if sk.LAUNCHES != launches:
            raise AssertionError("the plain engine launched a kernel")
        rate, p_rate = cfg.n * steps / wall / 1e6, cfg.n * p_steps / p_wall / 1e6
        log(f"[sph] n={cfg.n} f32 rain={cfg.rain} engine={engine} on {smi}: "
            f"{steps} steps in {wall:.3f} s, {rate:.2f} M particle-steps/s "
            f"({steps / wall:.1f} steps/s); plain torch engine {p_steps} "
            f"step(s) {p_rate:.3f} M particle-steps/s; launches {launches}")
        phys = check_sph_physics(ts, cfg, st0, out)

        key = f"n={cfg.n} final state f32"
        errs["rel"][key] = check_sph_call(sk, cfg, out.pos, out.vel, key,
                                          errs)
        b = sk.binning(cfg, out.pos, out.vel)
        rp = sk.density(cfg, b)
        dt = ts._frame_dt(cfg, out, None)
        big = n > 65536
        times = {
            "bin": time_launches(lambda: sk.binning(cfg, out.pos, out.vel), 20),
            "bin_plain": time_launches(
                lambda: sk.binning_plain(cfg, out.pos, out.vel), 10),
            "density": time_launches(lambda: sk.density(cfg, b), 20),
            "density_plain": time_launches(lambda: sk.density_plain(cfg, b),
                                           2 if big else 5),
            "forces": time_launches(lambda: sk.forces(cfg, b, rp, dt), 20),
            "forces_plain": time_launches(lambda: sk.forces_plain(cfg, b, rp, dt),
                                          2 if big else 5),
        }
        bounds = sph_bounds(sk, cfg, b)
        log(f"[sph] per launch at n={cfg.n} f32 on {smi}: " + ", ".join(
            f"{k} {times[k]:.4f} ms vs plain {times[k + '_plain']:.4f} ms "
            f"(bound {bounds[k][0]:.4f} ms, {bounds[k][1]})"
            for k in ("bin", "density", "forces")) + f"; pairs {bounds['pairs']}")
        res[n] = {"launches": launches, "times": times, "bounds": bounds,
                     "rate": rate, "plain_rate": p_rate, "physics": phys}
    return res


def main() -> int:
    smi = phase_device()
    from fluidsims_tpu_torch import interop, regression
    from fluidsims_tpu_torch.core.clock import cfl_dt
    from fluidsims_tpu_torch.kernels import _build
    from fluidsims_tpu_torch.kernels import hypersonic2d_cuda as hk
    from fluidsims_tpu_torch.kernels import sph_cuda as sk
    from fluidsims_tpu_torch.solvers import hypersonic2d as h2
    from fluidsims_tpu_torch.solvers import sph as ts

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_build(hk, _build)
    sk.load()
    errs = phase_kernels(h2, hk, interop, cfl_dt, device)
    sk.reset_launches()
    main_res = phase_main(h2, hk, regression, cfl_dt, device, smi, errs)
    if any(sk.LAUNCHES.values()):
        raise AssertionError(f"the hypersonic path launched SPH kernels: "
                             f"{sk.LAUNCHES}")
    sph_errs = phase_sph_kernels(sk, ts, device)
    hk.reset_launches()
    sph_res = phase_sph_main(sk, ts, device, smi, sph_errs)
    if any(hk.LAUNCHES.values()):
        raise AssertionError(f"the SPH path launched hypersonic kernels: "
                             f"{hk.LAUNCHES}")

    t = main_res["times"]
    flag, ref = t["2048x2048 float32"], t["8192x1024 float64"]
    hb = {}
    for key, nx, ny, dt in (("flag", 2048, 2048, "float32"),
                            ("ref", 8192, 1024, "float64")):
        cfg = h2.default_config(nx=nx, ny=ny, dtype=dt)
        hb[key] = hyp2d_bounds(cfg, h2.build_mask(cfg, device))
    kernels = [
        {"name": "hypersonic2d_step", "route": "cuda",
         "source": "fluidsims_tpu_torch/csrc/hypersonic2d_step.cu",
         "replaces": "fluidsims_tpu/kernels/hypersonic2d_pallas.py:60",
         "launches": main_res["launches"]["step"],
         "max_abs_err": errs["step"],
         "ms": flag["step"], "plain_ms": flag["step_plain"],
         "bound_ms": hb["flag"]["step"][0], "bound_by": hb["flag"]["step"][1],
         "library_ms": None,
         "ms_8192x1024_f64": ref["step"],
         "plain_ms_8192x1024_f64": ref["step_plain"],
         "bound_ms_8192x1024_f64": hb["ref"]["step"][0],
         "max_rel_err": errs["step_rel"]},
        {"name": "hypersonic2d_inflow_wavespeed", "route": "cuda",
         "source": "fluidsims_tpu_torch/csrc/hypersonic2d_wavespeed.cu",
         # JAX computes this part as plain XLA (max_wavespeed), next to the
         # Pallas step kernel
         "replaces": "fluidsims_tpu/solvers/hypersonic2d.py:401",
         "launches": main_res["launches"]["wavespeed"],
         "max_abs_err": errs["wavespeed"],
         "ms": flag["wavespeed"], "plain_ms": flag["wavespeed_plain"],
         "bound_ms": hb["flag"]["wavespeed"][0],
         "bound_by": hb["flag"]["wavespeed"][1], "library_ms": None,
         "ms_8192x1024_f64": ref["wavespeed"],
         "plain_ms_8192x1024_f64": ref["wavespeed_plain"],
         "bound_ms_8192x1024_f64": hb["ref"]["wavespeed"][0]},
    ]
    a, b = (sph_res[n] for n, _, _ in SPH_RUNS)
    for name, src, replaces in (
            ("bin", "sph_bin.cu", "fluidsims_tpu/ops/rank_pallas.py:44"),
            ("density", "sph_density.cu",
             "fluidsims_tpu/kernels/sph_pallas.py:80"),
            ("forces", "sph_forces.cu",
             "fluidsims_tpu/kernels/sph_pallas.py:121")):
        kernels.append({
            "name": f"sph_{name}", "route": "cuda",
            "source": f"fluidsims_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": a["launches"][name] + b["launches"][name],
            "max_abs_err": sph_errs.get(name, 0.0),
            "ms": a["times"][name], "plain_ms": a["times"][name + "_plain"],
            "bound_ms": a["bounds"][name][0], "bound_by": a["bounds"][name][1],
            "library_ms": None,
            "launches_65536": a["launches"][name],
            "launches_1048576": b["launches"][name],
            "ms_1048576": b["times"][name],
            "plain_ms_1048576": b["times"][name + "_plain"],
            "bound_ms_1048576": b["bounds"][name][0],
            "bound_by_1048576": b["bounds"][name][1]})
    log(f"[sph] M particle-steps/s: n=65536 {a['rate']:.3f} (plain "
        f"{a['plain_rate']:.4f}), n=1048576 {b['rate']:.3f} (plain "
        f"{b['plain_rate']:.4f}); pairs {a['bounds']['pairs']} / "
        f"{b['bounds']['pairs']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
