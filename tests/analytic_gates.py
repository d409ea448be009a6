"""The JAX suite's analytic gates, run on the port.

Each gate holds a solver to an exact solution, not to the JAX package.  It
runs the solver through its entry point (`hypersonic2d.run`,
`hypersonic3d.step`, `mhd.run`, `shallow_water.run`, `lbm.run`,
`burgers.run`) in the configuration, for the steps and over the comparison
window of the JAX gate named in its docstring, on the device its tensors
are made on: the plain PyTorch versions for CPU tensors, the CUDA kernels
for CUDA ones.  It returns a `Gate`: what it measured beside the JAX
gate's bars.

tests/test_torch_{riemann_exact,convergence_order,long_horizon,
lbm_poiseuille}.py run the gates on the CPU; chip_smoke.py (phase 27) runs
them on the card.  This module imports torch, numpy, the port and the
numpy oracles of tests/oracles only.
"""

from __future__ import annotations

import math
import operator
from dataclasses import dataclass, field

import numpy as np
import torch

from fluidsims_tpu_torch.ops import euler2d as e2
from fluidsims_tpu_torch.regression import compute_snapshot
from fluidsims_tpu_torch.solvers import burgers as bg
from fluidsims_tpu_torch.solvers import hypersonic2d as h2
from fluidsims_tpu_torch.solvers import hypersonic3d as h3
from fluidsims_tpu_torch.solvers import lbm
from fluidsims_tpu_torch.solvers import mhd
from fluidsims_tpu_torch.solvers import shallow_water as sw
from tests.oracles import riemann_exact as rx
from tests.oracles import swe_riemann_exact as swx

GAMMA = 1.4
SOD = ((1.0, 0.0, 1.0), (0.125, 0.0, 0.1))           # (rho, u, p) left, right
DOUBLE_RAREFACTION = ((1.0, -0.4, 0.4), (1.0, 0.4, 0.4))
CONVERGENCE_LADDER = (100, 200, 400)

_OPS = {"<": operator.lt, "<=": operator.le, ">": operator.gt,
        ">=": operator.ge, "==": operator.eq}


@dataclass
class Gate:
    """A gate's readings, name -> (value, op, bar): the reading holds where
    `value op bar` ("in": bar[0] < value < bar[1]).  `info` holds what the
    gate measured without a bar."""

    name: str
    steps: int
    readings: dict = field(default_factory=dict)
    info: dict = field(default_factory=dict)
    state: object = None       # the 2-D tubes' final state

    def read(self, key: str, value, op: str, bar) -> None:
        self.readings[key] = (float(value), op, bar)

    def misses(self) -> dict:
        out = {}
        for key, (value, op, bar) in self.readings.items():
            ok = (bar[0] < value < bar[1]) if op == "in" \
                else _OPS[op](value, bar)
            if not ok:
                out[key] = (value, op, bar)
        return out

    def check(self) -> None:
        miss = self.misses()
        if miss:
            raise AssertionError(f"gate {self.name} missed its bars: {miss}")


def rel_l1(num, exact) -> float:
    return float(np.abs(num - exact).mean() / np.abs(exact).mean())


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


# ------------------------ 2-D flagship as a shock tube -----------------------


def tube_config(nx: int, ny: int = 4, inflow_mach: float = 1e-9):
    """The flagship as a 1-D tube (tests/test_riemann_exact.py:29-37): the
    obstacle out of the domain, every explicit viscosity off, f64."""
    return h2.Hypersonic2DConfig(
        nx=nx, ny=ny, gamma=GAMMA, cfl=0.4,
        visc_nu=0.0, visc_rho=0.0, visc_e=0.0, inflow_mach=inflow_mach,
        geom_x0=-1e6, geom_cy=ny / 2.0, geom_Rb=ny / 12.0,
        geom_Rn=ny / 24.0, dtype="float64")


def tube_state(cfg, rho, u, p, device) -> h2.Hypersonic2DState:
    """A y-uniform state from the x-profiles of rho, u and p (v = 0)."""
    def rows(a):
        return torch.tensor(np.tile(np.asarray(a, np.float64), (cfg.ny, 1)),
                            dtype=cfg.torch_dtype, device=device)

    U = e2.prim_to_cons(
        e2.Prim(rows(rho), rows(u), rows(np.zeros(cfg.nx)), rows(p)),
        cfg.gamma)
    return h2.Hypersonic2DState(
        U=U, mask=h2.build_mask(cfg, device),
        t=torch.zeros((), dtype=cfg.torch_dtype, device=device))


def _run_tube(name, nx, steps, left, right, device):
    """tests/test_riemann_exact.py:40-71: a y-uniform Riemann problem;
    returns the gate and (xi, rho, u, p, t_end) of the middle row."""
    cfg = tube_config(nx)
    x_half = nx // 2
    sel = np.arange(nx) < x_half
    rho, u, p = (np.where(sel, a, b) for a, b in zip(left, right))
    s = tube_state(cfg, rho, u, p, device)
    gate = Gate(name, steps)
    gate.read("solid_cells", int(s.mask.sum()), "==", 0)
    s = h2.run(cfg, s, steps)
    gate.state = s
    t_end = gate.info["t_end"] = float(s.t)
    q = e2.cons_to_prim(s.U, cfg.gamma)
    rho, u, p = _np(q.rho), _np(q.u), _np(q.p)
    mid = cfg.ny // 2
    # y-uniform data must stay exactly y-uniform
    gate.read("y_spread_rho", np.abs(rho - rho[mid][None, :]).max(), "==", 0.0)
    xi = (np.arange(nx) + 0.5 - x_half) / t_end
    return gate, (xi, rho[mid], u[mid], p[mid], t_end)


def sod_2d(device) -> Gate:
    """tests/test_riemann_exact.py:82-104."""
    left, right = SOD
    gate, (xi, rho, u, p, t_end) = _run_tube("sod_2d", 600, 300, left,
                                             right, device)
    re, ue, pe = rx.sample(xi, *left, *right, GAMMA)
    # the waves stay clear of both x boundaries
    gate.read("exact_left_outer", np.abs(re[:60] - left[0]).max(), "<", 1e-12)
    gate.read("exact_right_outer", np.abs(re[-60:] - right[0]).max(), "<",
              1e-12)
    gate.read("rel_l1_rho", rel_l1(rho, re), "<", 6e-3)
    gate.read("rel_l1_p", rel_l1(p, pe), "<", 5e-3)
    gate.read("mae_u", np.abs(u - ue).mean(), "<", 8e-3)
    # the shock (rightmost jump) at the exact shock speed, within 2.5 cells
    p_s, _ = rx.solve_star(*left, *right, GAMMA)
    a_r = math.sqrt(GAMMA * right[2] / right[0])
    gp, gm = (GAMMA + 1) / (2 * GAMMA), (GAMMA - 1) / (2 * GAMMA)
    s_shock = right[1] + a_r * math.sqrt(gp * p_s / right[2] + gm)
    k = (GAMMA - 1) / (GAMMA + 1)
    rho_post = right[0] * ((p_s / right[2] + k) / (k * p_s / right[2] + 1))
    i_num = np.where(rho > 0.5 * (right[0] + rho_post))[0].max()
    gate.read("shock_offset_cells", abs(xi[i_num] - s_shock) * t_end, "<",
              2.5)
    return gate


def double_rarefaction(device) -> Gate:
    """tests/test_riemann_exact.py:107-121: near-vacuum positivity and
    mirror symmetry, compared on the window [100, 500) that the left
    boundary's transient does not reach."""
    left, right = DOUBLE_RAREFACTION
    gate, (xi, rho, u, p, _) = _run_tube("double_rarefaction", 600, 100,
                                         left, right, device)
    gate.read("min_rho", rho.min(), ">", 0.0)
    gate.read("min_p", p.min(), ">", 0.0)
    re, _, pe = rx.sample(xi, *left, *right, GAMMA)
    w = slice(100, 500)
    gate.read("rel_l1_rho", rel_l1(rho[w], re[w]), "<", 6e-3)
    gate.read("rel_l1_p", rel_l1(p[w], pe[w]), "<", 6e-3)
    gate.read("u_antisymmetry", np.abs(u[w] + u[::-1][w]).max(), "<", 1e-12)
    gate.read("rho_symmetry", np.abs(rho[w] - rho[::-1][w]).max(), "<",
              1e-12)
    return gate


def convergence(device, ladder=CONVERGENCE_LADDER) -> Gate:
    """tests/test_convergence_order.py:25-78: a smooth density pulse in
    the uniform Mach-0.1 inflow state advects exactly; L1 errors at the
    same final time fall at second order (40 steps per 100 cells)."""
    mach = 0.1
    u0 = mach * math.sqrt(GAMMA)
    gate = Gate("convergence", sum(40 * n // 100 for n in ladder))
    errs = []
    for n in ladder:
        cfg = tube_config(n, inflow_mach=mach)
        x = (np.arange(n) + 0.5) / n
        w = 0.08
        s = tube_state(cfg, 1.0 + 0.2 * np.exp(-(((x - 0.3) / w) ** 2)),
                       np.full(n, u0), np.ones(n), device)
        s = h2.run(cfg, s, 40 * n // 100)
        t_end = float(s.t)
        q = e2.cons_to_prim(s.U, GAMMA)
        rho, u, p = (_np(f)[2] for f in (q.rho, q.u, q.p))
        xc = np.arange(n) + 0.5
        rho_e = 1.0 + 0.2 * np.exp(
            -((((xc - u0 * t_end) / n) - 0.3) / w) ** 2)
        errs.append(float(np.abs(rho - rho_e).mean()))
        gate.info[f"err_{n}"] = errs[-1]
        if n == ladder[0]:
            gate.read(f"err_{n}", errs[-1], "<", 3e-4)
            # u and p stay uniform: the pulse is an exact contact
            gate.read(f"u_perturbation_{n}", np.abs(u - u0).max(), "<", 1e-3)
            gate.read(f"p_perturbation_{n}", np.abs(p - 1.0).max(), "<", 1e-3)
    for (a, b), (ea, eb) in zip(zip(ladder, ladder[1:]),
                                zip(errs, errs[1:])):
        gate.read(f"rate_{a}_{b}", math.log2(ea / eb), ">", 1.7)
    return gate


def long_horizon(device, nx: int = 128, ny: int = 64) -> Gate:
    """tests/test_long_horizon.py:39-57: the flagship at default_config(nx,
    ny), f32 against f64 over 1000 steps, compared by the regression
    snapshot (sums in f64 on the host) at 500 steps and at the end."""
    steps = 1000
    cfg32 = h2.default_config(nx=nx, ny=ny)
    snaps = {}
    for cfg in (cfg32, cfg32.replace(dtype="float64")):
        s, prev = h2.init(cfg, device), 0
        for done in (steps // 2, steps):
            s, prev = h2.run(cfg, s, done - prev), done
            snaps[cfg.dtype, done] = compute_snapshot(cfg, s, done)
    gate = Gate(f"long_horizon_{nx}x{ny}", 2 * steps)
    for done in (steps // 2, steps):
        a, b = snaps["float32", done], snaps["float64", done]
        gate.read(f"fluid_cells_diff_{done}",
                  a["fluid_cells"] - b["fluid_cells"], "==", 0)
        for key in ("sum_rho", "sum_E", "sum_mx"):
            gate.read(f"{key}_rel_{done}",
                      abs(a[key] - b[key]) / max(abs(b[key]), 1e-30), "<",
                      2e-6)
        gate.read(f"min_rho_{done}", a["min_rho"], ">", 0.0)
        gate.read(f"min_p_{done}", a["min_p"], ">", 0.0)
        gate.read(f"max_mach_diff_{done}", abs(a["max_mach"] - b["max_mach"]),
                  "<", 1e-2)
        gate.read(f"sum_rho_ratio_{done}", a["sum_rho"] / b["sum_rho"], "in",
                  (0.1, 10.0))
    return gate


# ------------------------------ 3-D WENO tube --------------------------------


def sod_3d(device) -> Gate:
    """tests/test_riemann_exact.py:124-199: the 3-D WENO5 + HLLC solver as
    a y/z-uniform, periodic Sod tube (sphere out of the domain, sponges
    off, vibration frozen), compared at the accumulated physical time:
    each step's dt, t e^dtau dtau, from the state before it, summed in
    f64."""
    nx, nyz, steps = 256, 4, 400
    cfg = h3.Hypersonic3DConfig(
        nx=nx, ny=nyz, nz=nyz, dx=1.0 / nx, dy=1.0 / nx, dz=1.0 / nx,
        cfl=0.3333, u_ref=10.0, R=1.0, gamma_floor=GAMMA, Twall=0.02,
        tau_vib=1e9, theta_v=1e3,
        sdf_cx=-100.0, sdf_cy=0.5, sdf_cz=0.5, sdf_r=0.25,
        inflow_r=1.0, inflow_p=1.0, inflow_u=0.0,
        sponge_n=0, sponge_out_n=0,
        t0=1e-3, dtau0=5e-3, dtype="float64")
    dt64 = cfg.torch_dtype
    shape = (nyz, nyz, nx)
    x = (np.arange(nx) + 0.5) / nx
    sel = x < 0.5

    def f(a, b):
        return torch.tensor(np.broadcast_to(np.where(sel, a, b), shape)
                            .copy(), dtype=dt64, device=device)

    zero = torch.zeros(shape, dtype=dt64, device=device)
    q = h3.PrimT(r=f(1.0, 0.125), u=zero, v=zero, w=zero, p=f(1.0, 0.1),
                 ev=torch.full(shape, 1e-10, dtype=dt64, device=device))
    solid = torch.from_numpy(h3.build_solid(cfg)).to(device)
    gate = Gate("sod_3d", steps)
    gate.read("solid_cells", int(solid.sum()), "==", 0)
    s = h3.Hypersonic3DState(
        *h3._encode(cfg, q), solid=solid,
        t=torch.tensor(cfg.t0, dtype=dt64, device=device),
        dtau=torch.tensor(cfg.dtau0, dtype=dt64, device=device))
    t_eff = torch.zeros((), dtype=torch.float64, device=device)
    for _ in range(steps):
        t_eff = t_eff + (s.t * torch.exp(s.dtau) * s.dtau).double()
        s = h3.step(cfg, s)
    t_eff = float(t_eff)
    # waves resolved, the outlet's boundary wave still clear of the window
    gate.read("t_eff", t_eff, "in", (0.05, 0.16))
    xi = _np(s.xi)
    gate.read("yz_spread_xi", np.abs(xi - xi[0, 0][None, None, :]).max(),
              "==", 0.0)
    c = nyz // 2
    rho = np.exp(xi[c, c])
    u = cfg.u_ref * np.sinh(_np(s.phix)[c, c])
    p = np.exp(_np(s.lam)[c, c])
    left, right = SOD
    re, ue, pe = rx.sample((x - 0.5) / t_eff, *left, *right, GAMMA)
    w = (x > 0.1) & (x < 0.80)
    gate.read("rel_l1_rho", rel_l1(rho[w], re[w]), "<", 8e-3)
    gate.read("rel_l1_p", rel_l1(p[w], pe[w]), "<", 7e-3)
    gate.read("mae_u", np.abs(u[w] - ue[w]).mean(), "<", 1.2e-2)
    return gate


# ------------------------------- GLM-MHD tube --------------------------------


def mhd_hydro_limit(device) -> Gate:
    """tests/test_riemann_exact.py:202-245: GLM-MHD with B = psi = 0 is
    2-D Euler; the Sod tube on the textbook HLL (stable_hll), compared on
    the window (0.2, 0.85) the boundary waves do not reach."""
    nx, ny, steps = 600, 6, 600
    cfg = mhd.MHDConfig(nx=nx, ny=ny, gamma=GAMMA, cfl=0.22,
                        stable_hll=True, dtype="float64")
    dt64 = cfg.torch_dtype
    xp = (np.arange(nx) + 0.5) / nx

    def f(a, b):
        return torch.tensor(np.tile(np.where(xp < 0.5, a, b), (ny, 1)),
                            dtype=dt64, device=device)

    z = torch.zeros((ny, nx), dtype=dt64, device=device)
    U = mhd.prim_to_cons(mhd.PrimM(rho=f(1.0, 0.125), u=z, v=z,
                                   p=f(1.0, 0.1), Bx=z, By=z, psi=z),
                         cfg.gamma)
    s = mhd.run(cfg, mhd.MHDState(
        U=U, t=torch.zeros((), dtype=dt64, device=device)), steps)
    gate = Gate("mhd_hydro_limit", steps)
    t_end = float(s.t)
    gate.read("t_end", t_end, "in", (0.03, 0.055))
    q = mhd.cons_to_prim(s.U, cfg.gamma)
    # B stays identically zero: the hydro limit is exact
    gate.read("max_abs_Bx", float(q.Bx.abs().max()), "==", 0.0)
    gate.read("max_abs_By", float(q.By.abs().max()), "==", 0.0)
    rho, p = _np(q.rho)[ny // 2], _np(q.p)[ny // 2]
    re, _, pe = rx.sample((xp - 0.5) / t_end, *SOD[0], *SOD[1], GAMMA)
    w = (xp > 0.2) & (xp < 0.85)
    gate.read("rel_l1_rho", rel_l1(rho[w], re[w]), "<", 0.035)
    gate.read("rel_l1_p", rel_l1(p[w], pe[w]), "<", 0.04)
    return gate


# ------------------------------- shallow water -------------------------------


def sw_dt(cfg, s):
    """The dt a shallow-water step applies to state s (the solver's own
    formula, tests/test_riemann_exact.py:277-283)."""
    c = torch.sqrt(cfg.g * torch.exp(s.sigma))
    cmax = torch.clamp_min(torch.max(torch.maximum(
        torch.abs(s.u) + c, torch.abs(s.v) + c)), 1e-12)
    return torch.minimum(s.t * cfg.dtau, cfg.cfl * min(cfg.dx, cfg.dy) / cmax)


def dam_break(device) -> Gate:
    """tests/test_riemann_exact.py:248-306: the log-depth HLL solver as a
    periodic 1-D dam break, one step a call, compared with the exact
    wet-bed solution at the accumulated physical time on the window
    (160, 450) that the seam's waves do not reach."""
    nx, ny, steps, g = 600, 4, 400, 9.81
    cfg = sw.ShallowWaterConfig(
        nx=nx, ny=ny, dx=1.0, dy=1.0, g=g, nu=0.0, H0=1.0, bump_amp=0.0,
        swirl=0.0, cfl=0.45, t0=1.0, dtau=1.0, dtype="float64")
    dt64 = cfg.torch_dtype
    x = np.arange(nx) + 0.5
    x_half = nx // 2
    h0 = np.where(x < x_half, 1.0, 0.1)
    z = torch.zeros((ny, nx), dtype=dt64, device=device)
    s = sw.ShallowWaterState(
        sigma=torch.tensor(np.log(np.tile(h0, (ny, 1))), dtype=dt64,
                           device=device),
        u=z, v=z, t=torch.tensor(cfg.t0, dtype=dt64, device=device),
        tau=torch.tensor(cfg.tau0, dtype=dt64, device=device))
    t_eff = torch.zeros((), dtype=torch.float64, device=device)
    for _ in range(steps):
        t_eff = t_eff + sw_dt(cfg, s)
        s = sw.run(cfg, s, 1)
    gate = Gate("dam_break", steps)
    t_eff = float(t_eff)
    gate.read("t_eff", t_eff, "in", (30.0, 45.0))
    h = np.exp(_np(s.sigma))[ny // 2]
    un = _np(s.u)[ny // 2]
    he, ue = swx.sample((x - x_half) / t_eff, 1.0, 0.0, 0.1, 0.0, g)
    w = (x > 160) & (x < 450)
    gate.read("rel_l1_h", rel_l1(h[w], he[w]), "<", 0.025)
    gate.read("mae_u", np.abs(un[w] - ue[w]).mean(), "<", 0.06)
    gate.read("min_h", h.min(), ">", 0.0)
    return gate


def standing_wave(device) -> Gate:
    """tests/test_burgers_sw_stam.py:267-301: h = H0 + eps cos(kx)
    oscillates at omega = k sqrt(g H0); at the CFL-locked dt (dtau = 1e9)
    the mode amplitude's zero crossings give the period in steps, one step
    a call."""
    steps = 200
    cfg = sw.ShallowWaterConfig(nx=128, ny=8, H0=100.0, nu=0.0,
                                bump_amp=0.0, swirl=0.0, dtau=1e9)
    s0 = sw.init(cfg, device)
    eps, k = 0.01, 2 * math.pi * 2 / 128.0
    x = np.arange(128.0)
    h = 100.0 + eps * np.cos(k * x)[None, :] * np.ones((8, 1))
    z = torch.zeros((8, 128), dtype=torch.float32, device=device)
    s = s0._replace(sigma=torch.tensor(np.log(h), dtype=torch.float32,
                                       device=device), u=z, v=z)
    c = math.sqrt(9.81 * 100.0)
    expected = 2 * math.pi / (k * c) / (0.5 / c)     # dt = cfl dx / c
    cosk = torch.tensor(np.cos(k * x), dtype=torch.float32, device=device)
    amps = []
    for _ in range(steps):
        amps.append(((torch.exp(s.sigma)[0] - 100.0) * cosk).mean())
        s = sw.run(cfg, s, 1)
    zc = np.where(np.diff(np.sign(_np(torch.stack(amps)))) != 0)[0]
    gate = Gate("standing_wave", steps)
    gate.read("zero_crossings", len(zc), ">=", 2)
    period = 2 * (zc[1] - zc[0]) if len(zc) >= 2 else math.inf
    gate.read("period_error_steps", abs(period - expected), "<=", 3)
    return gate


# ---------------------------------- Burgers ----------------------------------


def cole_hopf(device) -> Gate:
    """tests/test_burgers_sw_stam.py:16-33: 1-D viscous Burgers against
    the exact Cole–Hopf solution, relative L2 error."""
    cfg = bg.BurgersConfig(nx=256, ny=1, colehopf=True, nu=0.1, ck=4,
                           ca=0.5, dtau=1e-3, t0=1.0, cfl=0.45,
                           dtype="float64")
    s = bg.run(cfg, bg.init(cfg, device), 200)
    gate = Gate("cole_hopf", 200)
    gate.read("rel_l2", bg.cole_hopf_rel_l2(cfg, s), "<", 0.05)
    return gate


# --------------------------------- Poiseuille --------------------------------


def poiseuille(device, block_ks=(8,)) -> Gate:
    """tests/test_lbm.py:171-200: body-forced channel flow from rest
    relaxes to the exact parabola u(y) = a / (2 nu) y (H - y), nu = (tau -
    1/2) / 3, a = drive / tau, the walls half a cell inside the solid
    rows; one run of 20,000 steps a block_k (on the CPU block_k changes
    nothing)."""
    tau, drive, steps = 0.8, 1e-6, 20000
    ny, nx = 34, 32
    f0 = np.stack([lbm.feq(q, 1.0, np.zeros((ny, nx)), np.zeros((ny, nx)))
                   for q in range(9)])
    nu = (tau - 0.5) / 3.0
    y = np.arange(ny) - 0.5
    exact = drive / tau / (2 * nu) * y * (32.0 - y)
    fl = slice(1, 33)
    gate = Gate("poiseuille", steps * len(block_ks))
    for k in block_ks:
        cfg = lbm.LBMConfig(nx=nx, ny=ny, tau=tau, drive=drive,
                            obstacle=False, block_k=k)
        s = lbm.LBMState(f=torch.tensor(f0, dtype=torch.float32,
                                        device=device),
                         solid=lbm.init(cfg, device).solid)
        s = lbm.run(cfg, s, steps)
        prof = _np(lbm.macroscopic(s.f)[1])[:, 16]
        rel = np.abs(prof[fl] - exact[fl]) / exact[fl].max()
        gate.read(f"rel_max_k{k}", rel.max(), "<", 0.02)
    return gate
