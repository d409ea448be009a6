"""CPU double-precision Stam solver — the scalar reference for stam2d (a
NumPy copy of fluidsims_tpu.solvers.stam2d_cpu on the port's core/config).

Behavioral spec: sim.c — (N+2)^2 double fields on the log-η grid; 15
Gauss–Seidel iterations with `bnd` reflections after every sweep (lin
:110-119); bnd reflects the normal velocity component and averages corners
(:97-108); metric-scaled divergence/projection (proj :148-165); the same
τ-advection as js_cuda.cu (adv :125-146); seed + orbiting source + decay
(:61-95, 181-185).

This is a NumPy implementation (Gauss–Seidel is inherently sequential — it
is the CPU reference, mirroring the reference repo where sim.c is the
scalar oracle for js_cuda.cu). Use small n; the GPU path is stam2d.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..core.config import BaseConfig

__all__ = ["Stam2DCPUConfig", "Stam2DCPU"]


@dataclass(frozen=True)
class Stam2DCPUConfig(BaseConfig):
    n: int = 512
    dt: float = 1.0
    visc: float = 1e-6
    diff: float = 1e-7
    dens_decay: float = 1.0 - 1e-6
    x0: float = 1.0
    y0: float = 1.0
    eta_min: float = -1.5
    eta_max: float = 1.5
    gs_iters: int = 15

    def validate(self):
        self._require(self.n > 0, "n must be positive")


class Stam2DCPU:
    """Stateful CPU solver mirroring sim.c's globals."""

    def __init__(self, cfg: Stam2DCPUConfig):
        self.cfg = cfg
        n = cfg.n
        shape = (n + 2, n + 2)  # [j, i]
        self.u = np.zeros(shape)
        self.v = np.zeros(shape)
        self.u0 = np.zeros(shape)
        self.v0 = np.zeros(shape)
        self.d = np.zeros(shape)
        self.d0 = np.zeros(shape)
        deta = (cfg.eta_max - cfg.eta_min) / n
        idx = np.arange(n + 2, dtype=np.float64)
        eta = cfg.eta_min + (idx - 0.5) * deta
        self.dx = cfg.x0 * (np.exp(eta + deta / 2) - np.exp(eta - deta / 2))
        self.dy = self.dx.copy()
        self.step_idx = 0
        self._seed()

    # -- init / sources (sim.c:61-95) --

    def _seed(self):
        n = self.cfg.n
        cx = cy = n // 2
        R = n / 2.5
        sw = 0.5
        for j in range(1, n + 1):
            for i in range(1, n + 1):
                dx_, dy_ = i - cx, j - cy
                r2 = dx_ * dx_ + dy_ * dy_
                if r2 < R * R:
                    r = math.sqrt(r2) + 1e-6
                    self.d[j, i] += 0.4 * math.exp(-r2 / (R * R))
                    self.u[j, i] = -sw * dy_ / r
                    self.v[j, i] = sw * dx_ / r

    def _add_source(self):
        n = self.cfg.n
        ang = self.step_idx * 0.015
        cx = n // 2 + int((n / 4) * math.cos(ang))
        cy = n // 2 + int((n / 4) * math.sin(ang))
        R = 3.0
        swirl = 0.6
        amp = 0.5 + 0.4 * math.sin(self.step_idx * 0.02)
        for j in range(cy - 2, cy + 3):
            for i in range(cx - 2, cx + 3):
                if i < 1 or i > n or j < 1 or j > n:
                    continue
                dx_, dy_ = i - cx, j - cy
                r2 = dx_ * dx_ + dy_ * dy_
                if r2 > R * R:
                    continue
                r = math.sqrt(r2) + 1e-6
                self.d[j, i] += amp * math.exp(-r2 / (R * R))
                self.u[j, i] += -swirl * dy_ / r
                self.v[j, i] += swirl * dx_ / r

    # -- numerics (sim.c:97-165) --

    def _bnd(self, b, x):
        n = self.cfg.n
        sx = -1.0 if b == 1 else 1.0
        sy = -1.0 if b == 2 else 1.0
        x[1:n + 1, 0] = sx * x[1:n + 1, 1]
        x[1:n + 1, n + 1] = sx * x[1:n + 1, n]
        x[0, 1:n + 1] = sy * x[1, 1:n + 1]
        x[n + 1, 1:n + 1] = sy * x[n, 1:n + 1]
        x[0, 0] = 0.5 * (x[0, 1] + x[1, 0])
        x[n + 1, 0] = 0.5 * (x[n + 1, 1] + x[n, 0])
        x[0, n + 1] = 0.5 * (x[0, n] + x[1, n + 1])
        x[n + 1, n + 1] = 0.5 * (x[n + 1, n] + x[n, n + 1])

    def _lin(self, b, x, x0, a, c):
        """15 Gauss–Seidel sweeps in the reference's i-then-j order."""
        n = self.cfg.n
        for _ in range(self.cfg.gs_iters):
            for j in range(1, n + 1):
                for i in range(1, n + 1):
                    x[j, i] = (
                        x0[j, i]
                        + a * (x[j, i - 1] + x[j, i + 1]
                               + x[j - 1, i] + x[j + 1, i])
                    ) / c
            self._bnd(b, x)

    def _diff(self, b, x, x0, coeff):
        n = self.cfg.n
        a = self.cfg.dt * coeff * n * n
        self._lin(b, x, x0, a, 1 + 4 * a)

    def _adv(self, b, q, q0, uu, vv):
        cfg = self.cfg
        n = cfg.n
        deta = (cfg.eta_max - cfg.eta_min) / n
        for j in range(1, n + 1):
            for i in range(1, n + 1):
                eta_x = cfg.eta_min + (i - 0.5) * deta
                eta_y = cfg.eta_min + (j - 0.5) * deta
                xp = cfg.x0 * math.exp(eta_x)
                yp = cfg.y0 * math.exp(eta_y)
                bx = eta_x - cfg.dt * uu[j, i] / xp
                by = eta_y - cfg.dt * vv[j, i] / yp
                s = min(max((bx - cfg.eta_min) / deta + 0.5, 0.5), n + 0.5)
                t = min(max((by - cfg.eta_min) / deta + 0.5, 0.5), n + 0.5)
                i0 = int(s)
                j0 = int(t)
                s1 = s - i0
                t1 = t - j0
                q[j, i] = (1 - s1) * (
                    (1 - t1) * q0[j0, i0] + t1 * q0[j0 + 1, i0]
                ) + s1 * ((1 - t1) * q0[j0, i0 + 1] + t1 * q0[j0 + 1, i0 + 1])
        self._bnd(b, q)

    def _proj(self, uu, vv, p, div):
        n = self.cfg.n
        div[1:n + 1, 1:n + 1] = -0.5 * (
            (uu[1:n + 1, 2:n + 2] - uu[1:n + 1, 0:n]) / self.dx[None, 1:n + 1]
            + (vv[2:n + 2, 1:n + 1] - vv[0:n, 1:n + 1]) / self.dy[1:n + 1, None]
        )
        p[1:n + 1, 1:n + 1] = 0
        self._bnd(0, div)
        self._bnd(0, p)
        self._lin(0, p, div, 1, 4)
        uu[1:n + 1, 1:n + 1] -= 0.5 * self.dx[None, 1:n + 1] * (
            p[1:n + 1, 2:n + 2] - p[1:n + 1, 0:n]
        )
        vv[1:n + 1, 1:n + 1] -= 0.5 * self.dy[1:n + 1, None] * (
            p[2:n + 2, 1:n + 1] - p[0:n, 1:n + 1]
        )
        self._bnd(1, uu)
        self._bnd(2, vv)

    # -- frame step (sim.c:230-245) --

    def step(self):
        cfg = self.cfg
        n = cfg.n
        self.d[1:n + 1, 1:n + 1] *= cfg.dens_decay
        self._add_source()

        # vel_step (sim.c:167-174) — note the buffer reuse: proj uses u,v as
        # pressure/divergence scratch for the u0,v0 projection and vice versa
        self._diff(1, self.u0, self.u, cfg.visc)
        self._diff(2, self.v0, self.v, cfg.visc)
        self._proj(self.u0, self.v0, self.u, self.v)
        self._adv(1, self.u, self.u0, self.u0, self.v0)
        self._adv(2, self.v, self.v0, self.u0, self.v0)
        self._proj(self.u, self.v, self.u0, self.v0)

        # dens_step (sim.c:176-179)
        self._diff(0, self.d0, self.d, cfg.diff)
        self._adv(0, self.d, self.d0, self.u, self.v)

        self.step_idx += 1
