"""Golden-baseline snapshot regression for the flagship solver.

Port of fluidsims_tpu.regression.  Behavioral spec:
tau_hypersonic_cuda_tests.cu — run the real solver N steps (default 24),
reduce the state to a 12-field snapshot (conserved sums, min rho/p, max
Mach, position-weighted checksums w=(i % 8191)+1, :143-176), write or
verify a text baseline with tolerance rel 5e-8|x| + 1e-8 (:84-125,
:522-559).  The reduction runs in float64 numpy on the host copy of the
state; the text format is the JAX package's.
"""

from __future__ import annotations

import numpy as np

from .core.device import resolve_device
from .interop import state_to_numpy
from .solvers import hypersonic2d as h2

__all__ = ["compute_snapshot", "write_snapshot", "read_snapshot",
           "verify_snapshot", "run_regression"]

FIELDS = ["steps", "fluid_cells", "sum_rho", "sum_mx", "sum_my", "sum_E",
          "min_rho", "min_p", "max_mach", "checksum_rho", "checksum_mx",
          "checksum_E"]


def compute_snapshot(cfg, state, steps: int) -> dict:
    U, mask, _ = state_to_numpy(state)
    rho, mx, my, E = [np.asarray(f, np.float64) for f in U]
    fl = ~mask
    g = cfg.gamma
    r = np.maximum(rho[fl], 1e-25)
    u = mx[fl] / r
    v = my[fl] / r
    eint = E[fl] - 0.5 * r * (u * u + v * v)
    p = (g - 1.0) * np.maximum(eint, 1e-25)
    a = np.sqrt(g * p / r)
    mach = np.sqrt(u * u + v * v) / np.maximum(a, 1e-30)
    idx = np.arange(rho.size).reshape(rho.shape)[fl]
    w = (idx % 8191 + 1).astype(np.float64)
    return {
        "steps": steps,
        "fluid_cells": int(fl.sum()),
        "sum_rho": float(r.sum()),
        "sum_mx": float(mx[fl].sum()),
        "sum_my": float(my[fl].sum()),
        "sum_E": float(E[fl].sum()),
        "min_rho": float(r.min()),
        "min_p": float(p.min()),
        "max_mach": float(mach.max()),
        "checksum_rho": float((w * r).sum()),
        "checksum_mx": float((w * mx[fl]).sum()),
        "checksum_E": float((w * E[fl]).sum()),
    }


def write_snapshot(path, snap: dict) -> None:
    with open(path, "w") as f:
        for k in FIELDS:
            v = snap[k]
            if k in ("steps", "fluid_cells"):
                f.write(f"{k} {int(v)}\n")
            else:
                f.write(f"{k} {v:.17g}\n")


def read_snapshot(path) -> dict:
    snap = {}
    with open(path) as f:
        for line in f:
            k, v = line.split()
            snap[k] = int(v) if k in ("steps", "fluid_cells") else float(v)
    missing = [k for k in FIELDS if k not in snap]
    if missing:
        raise ValueError(f"baseline missing fields: {missing}")
    return snap


def verify_snapshot(current: dict, expected: dict) -> list[str]:
    """Returns a list of failure messages (empty = pass), using the
    reference tolerances (tau_hypersonic_cuda_tests.cu:530-557)."""
    fails = []
    if expected["steps"] != current["steps"]:
        fails.append("steps mismatch")
    if expected["fluid_cells"] != current["fluid_cells"]:
        fails.append("fluid_cells mismatch")
    for k in FIELDS[2:]:
        tol = 1e-9 if k in ("min_rho", "min_p") \
            else 5e-8 * abs(expected[k]) + 1e-8
        if abs(current[k] - expected[k]) > tol:
            fails.append(
                f"{k}: {current[k]!r} vs baseline {expected[k]!r} (tol {tol:g})"
            )
    return fails


def run_regression(nx=2048, ny=1024, steps=24, baseline="hypersonic2d_baseline.txt",
                   write=False, device="cuda") -> int:
    """Run `steps` real solver steps on `device` (through the CUDA kernels
    there; the plain version on the CPU) and write or verify the baseline.
    Returns a process exit code."""
    dev = resolve_device(device)
    cfg = h2.default_config(nx=nx, ny=ny)
    state = h2.run(cfg, h2.init(cfg, dev), steps)
    snap = compute_snapshot(cfg, state, steps)

    ok = snap["fluid_cells"] > 0 and snap["min_rho"] >= 1e-25 \
        and snap["min_p"] > 0
    if not ok:
        print("FAIL: physical invariants violated")
        return 1

    if write:
        write_snapshot(baseline, snap)
        print(f"wrote baseline {baseline}")
        return 0

    expected = read_snapshot(baseline)
    fails = verify_snapshot(snap, expected)
    for m in fails:
        print(f"FAIL: {m}")
    print(f"Passed: {len(FIELDS) - len(fails)}\nFailed: {len(fails)}")
    return 1 if fails else 0
