"""CPU reference 2-D hypersonic solver (MUSCL-Hancock + HLLC, slip walls);
a NumPy copy of fluidsims_tpu.solvers.hypersonic2d_cpu on the port's
core/config.

Behavioral spec: tau_hypersonic.c — 300x300 serial double-precision solver:
gamma=1.4, CFL=0.3, Mach-15 inflow (:16-19, 245-254); circular obstacle at
(W/3, H/2) radius H/6 (:450-475); SLIP walls — normal-only velocity
reflection (reflect_slip :279-293, unlike the CUDA flagship's no-slip
ghost); per-axis face loops with MUSCL reconstruction + Hancock predictor
recomputed at each face (:500-657); plain HLLC without HLLE fallback
(:117-243); full-grid max-wavespeed dt (:477-498); final positivity clamp
(:659-671).

This NumPy float64 implementation is the vectorized CPU path — the analog
of tau_hypersonic_simd.c, which keeps "bit-for-bit math order" with the
scalar file (tau_hypersonic_simd.c:5-11); here the same flux set is
evaluated whole-grid at once (per-cell float summation order at the two
faces is preserved: x contributions then y contributions, :577-656).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..core.config import BaseConfig

__all__ = ["HypersonicCPUConfig", "HypersonicCPU"]

EPS_RHO = 1e-10
EPS_P = 1e-10


@dataclass(frozen=True)
class HypersonicCPUConfig(BaseConfig):
    w: int = 300
    h: int = 300
    gamma: float = 1.4
    cfl: float = 0.3
    mach: float = 15.0
    steps_per_frame: int = 2

    def validate(self):
        self._require(self.w > 4 and self.h > 4, "grid too small")
        self._require(self.gamma > 1.0, "gamma must be > 1")


class HypersonicCPU:
    """Stateful CPU solver (mirrors the reference's globals U/Unew/mask)."""

    def __init__(self, cfg: HypersonicCPUConfig):
        self.cfg = cfg
        self.t = 0.0
        self._init_sim()

    # fields are (h, w, 4) float64 [rho, mx, my, E]

    def _inflow_prim(self):
        g = self.cfg.gamma
        a = math.sqrt(g * 1.0 / 1.0)
        return np.array([1.0, self.cfg.mach * a, 0.0, 1.0])

    def _cons_to_prim(self, c):
        g = self.cfg.gamma
        rho = np.maximum(c[..., 0], EPS_RHO)
        u = c[..., 1] / rho
        v = c[..., 2] / rho
        eint = c[..., 3] - 0.5 * rho * (u * u + v * v)
        p = (g - 1.0) * np.maximum(eint, EPS_P)
        return np.stack([rho, u, v, p], -1)

    def _prim_to_cons(self, q):
        g = self.cfg.gamma
        rho = np.maximum(q[..., 0], EPS_RHO)
        p = np.maximum(q[..., 3], EPS_P)
        return np.stack(
            [rho, rho * q[..., 1], rho * q[..., 2],
             p / (g - 1.0) + 0.5 * rho * (q[..., 1] ** 2 + q[..., 2] ** 2)],
            -1,
        )

    def _init_sim(self):
        cfg = self.cfg
        self.t = 0.0
        cx, cy, r = cfg.w // 3, cfg.h // 2, cfg.h // 6
        x = np.arange(cfg.w)[None, :]
        y = np.arange(cfg.h)[:, None]
        self.mask = ((x - cx) ** 2 + (y - cy) ** 2 < r * r)
        infl = self._inflow_prim()
        q = np.broadcast_to(infl, (cfg.h, cfg.w, 4)).copy()
        q[self.mask, 1] = 0.0
        q[self.mask, 2] = 0.0
        self.U = self._prim_to_cons(q)

    # ------------------------------------------------------------------

    def _reflect_slip(self, cons, nx, ny):
        """Slip wall: v_n -> -v_n, v_t unchanged (reflect_slip, :279-293)."""
        q = self._cons_to_prim(cons)
        u, v = q[..., 1], q[..., 2]
        vn = u * nx + v * ny
        ut = -u * ny + v * nx
        vn = -vn
        q2 = q.copy()
        q2[..., 1] = vn * nx - ut * ny
        q2[..., 2] = vn * ny + ut * nx
        return self._prim_to_cons(q2)

    def _neighbor_or_wall(self, dxs, dys, nx, ny):
        """Whole-grid neighbor with BCs (neighbor_or_wall, :295-314)."""
        cfg = self.cfg
        h, w = cfg.h, cfg.w
        ys = np.clip(np.arange(h)[:, None] + dys, 0, h - 1)
        xs = np.arange(w)[None, :] + dxs
        infl = self._prim_to_cons(self._inflow_prim()[None])[0]

        xs_c = np.clip(xs, 0, w - 1)
        out = self.U[ys, xs_c]
        m_n = self.mask[ys, xs_c]
        ghost = self._reflect_slip(self.U, nx, ny)
        in_x = (xs >= 0) & (xs < w)
        sel = m_n & in_x
        out = np.where(sel[..., None], ghost, out)
        # x < 0 -> inflow (takes precedence)
        out = np.where((xs < 0)[..., None], infl, out)
        return out

    def _flux(self, c, axis):
        q = self._cons_to_prim(c)
        un = q[..., 1] if axis == 0 else q[..., 2]
        p = q[..., 3]
        if axis == 0:
            return np.stack(
                [c[..., 1], c[..., 1] * un + p, c[..., 2] * un,
                 (c[..., 3] + p) * un], -1)
        return np.stack(
            [c[..., 2], c[..., 1] * un, c[..., 2] * un + p,
             (c[..., 3] + p) * un], -1)

    @staticmethod
    def _minmod(a, b):
        return np.where(a * b <= 0.0, 0.0, np.where(np.abs(a) < np.abs(b),
                                                    a, b))

    def _mc(self, dl, dc, dr):
        mm1 = self._minmod(dl, dr)
        mm2 = self._minmod(dc, 2.0 * dl)
        mm3 = self._minmod(dc, 2.0 * dr)
        return self._minmod(mm1, self._minmod(mm2, mm3))

    def _reconstruct(self, axis):
        """(qL, qR) face prims per cell (reconstruct_x/y, :348-418),
        including the positivity contraction (:320-346)."""
        dxs, dys = (1, 0) if axis == 0 else (0, 1)
        nx, ny = (1.0, 0.0) if axis == 0 else (0.0, 1.0)
        qm = self._cons_to_prim(self._neighbor_or_wall(-dxs, -dys, nx, ny))
        qc = self._cons_to_prim(self.U)
        qp = self._cons_to_prim(self._neighbor_or_wall(dxs, dys, nx, ny))

        s = self._mc(qc - qm, 0.5 * (qp - qm), qp - qc)
        qL = qc - 0.5 * s
        qR = qc + 0.5 * s

        for _ in range(8):
            bad = ((qL[..., 0] <= EPS_RHO) | (qR[..., 0] <= EPS_RHO)
                   | (qL[..., 3] <= EPS_P) | (qR[..., 3] <= EPS_P))
            if not bad.any():
                break
            qL = np.where(bad[..., None], 0.5 * (qL + qc), qL)
            qR = np.where(bad[..., None], 0.5 * (qR + qc), qR)
        qL[..., 0] = np.maximum(qL[..., 0], EPS_RHO)
        qR[..., 0] = np.maximum(qR[..., 0], EPS_RHO)
        qL[..., 3] = np.maximum(qL[..., 3], EPS_P)
        qR[..., 3] = np.maximum(qR[..., 3], EPS_P)
        return qL, qR

    def _half_step(self, q, dF, half_dt, axis):
        c = self._prim_to_cons(q) - half_dt * dF
        out = self._cons_to_prim(c)
        out[..., 0] = np.maximum(out[..., 0], EPS_RHO)
        out[..., 3] = np.maximum(out[..., 3], EPS_P)
        return out

    def _hllc(self, qL, qR, axis):
        """Vectorized HLLC (hllc_x/hllc_y, :117-243; no HLLE fallback)."""
        g = self.cfg.gamma
        UL = self._prim_to_cons(qL)
        UR = self._prim_to_cons(qR)
        nidx = 1 if axis == 0 else 2
        tidx = 2 if axis == 0 else 1
        unL, unR = qL[..., nidx], qR[..., nidx]
        utL, utR = qL[..., tidx], qR[..., tidx]
        rhoL, rhoR = qL[..., 0], qR[..., 0]
        pL, pR = qL[..., 3], qR[..., 3]
        aL = np.sqrt(g * np.maximum(pL, EPS_P) / np.maximum(rhoL, EPS_RHO))
        aR = np.sqrt(g * np.maximum(pR, EPS_P) / np.maximum(rhoR, EPS_RHO))
        SL = np.minimum(unL - aL, unR - aR)
        SR = np.maximum(unL + aL, unR + aR)
        FL = self._flux(UL, axis)
        FR = self._flux(UR, axis)

        den = rhoL * (SL - unL) - rhoR * (SR - unR)
        den = np.where(np.abs(den) < 1e-300, 1e-300, den)
        SM = (pR - pL + rhoL * unL * (SL - unL) - rhoR * unR * (SR - unR)) \
            / den
        pStar = np.maximum(pL + rhoL * (SL - unL) * (SM - unL), EPS_P)

        def star(rho, un, ut, p, S, Ubase, F):
            dS = np.where(np.abs(S - SM) < 1e-300, 1e-300, S - SM)
            rs = rho * (S - un) / dS
            es = ((S - un) * Ubase[..., 3] - p * un + pStar * SM) / dS
            mom_n = rs * SM
            mom_t = rs * ut
            if axis == 0:
                Ustar = np.stack([rs, mom_n, mom_t, es], -1)
            else:
                Ustar = np.stack([rs, mom_t, mom_n, es], -1)
            return F + S[..., None] * (Ustar - Ubase)

        F_ls = star(rhoL, unL, utL, pL, SL, UL, FL)
        F_rs = star(rhoR, unR, utR, pR, SR, UR, FR)
        mid = np.where((SM >= 0.0)[..., None], F_ls, F_rs)
        out = np.where((SL >= 0.0)[..., None], FL,
                       np.where((SR <= 0.0)[..., None], FR, mid))
        return out

    def compute_dt(self):
        q = self._cons_to_prim(self.U)
        a = np.sqrt(self.cfg.gamma * np.maximum(q[..., 3], EPS_P)
                    / np.maximum(q[..., 0], EPS_RHO))
        s = np.maximum(np.abs(q[..., 1]) + a, np.abs(q[..., 2]) + a)
        s = np.where(self.mask, 1e-12, s)
        return self.cfg.cfl * 1.0 / max(s.max(), 1e-12)

    def step(self):
        cfg = self.cfg
        h, w = cfg.h, cfg.w
        dt = self.compute_dt()
        half_dt = 0.5 * dt

        infl = self._prim_to_cons(self._inflow_prim()[None])[0]
        col0 = ~self.mask[:, 0]
        self.U[col0, 0] = infl

        mask = self.mask
        Unew = self.U.copy()

        for axis in (0, 1):
            nx, ny = (1.0, 0.0) if axis == 0 else (0.0, 1.0)
            qLr, qRr = self._reconstruct(axis)
            F_face_L = self._flux(self._prim_to_cons(qLr), axis)
            F_face_R = self._flux(self._prim_to_cons(qRr), axis)
            dF = F_face_R - F_face_L
            pred_R = self._half_step(qRr, dF, half_dt, axis)  # high face
            pred_L = self._half_step(qLr, dF, half_dt, axis)  # low face

            ghost = self._cons_to_prim(self._reflect_slip(self.U, nx, ny))

            if axis == 0:
                # faces between (x-1, x) for x in [1, W)
                mL = mask[:, :-1]
                mR = mask[:, 1:]
                qL = np.where(mL[..., None],
                              self._cons_to_prim(self._reflect_slip(
                                  self.U[:, 1:], nx, ny)),
                              pred_R[:, :-1])
                qR = np.where(mR[..., None],
                              self._cons_to_prim(self._reflect_slip(
                                  self.U[:, :-1], nx, ny)),
                              pred_L[:, 1:])
                both = mL & mR
                for q_ in (qL, qR):
                    q_[..., 0] = np.maximum(q_[..., 0], EPS_RHO)
                    q_[..., 3] = np.maximum(q_[..., 3], EPS_P)
                F = self._hllc(qL, qR, axis)
                F[both] = 0.0
                upd = dt * F
                subL = np.where(mL[..., None], 0.0, upd)
                addR = np.where(mR[..., None], 0.0, upd)
                Unew[:, :-1] -= subL
                Unew[:, 1:] += addR
            else:
                mB = mask[:-1, :]
                mT = mask[1:, :]
                qB = np.where(mB[..., None],
                              self._cons_to_prim(self._reflect_slip(
                                  self.U[1:, :], nx, ny)),
                              pred_R[:-1, :])
                qT = np.where(mT[..., None],
                              self._cons_to_prim(self._reflect_slip(
                                  self.U[:-1, :], nx, ny)),
                              pred_L[1:, :])
                both = mB & mT
                for q_ in (qB, qT):
                    q_[..., 0] = np.maximum(q_[..., 0], EPS_RHO)
                    q_[..., 3] = np.maximum(q_[..., 3], EPS_P)
                F = self._hllc(qB, qT, axis)
                F[both] = 0.0
                upd = dt * F
                subB = np.where(mB[..., None], 0.0, upd)
                addT = np.where(mT[..., None], 0.0, upd)
                Unew[:-1, :] -= subB
                Unew[1:, :] += addT

        fl = ~mask
        Unew[..., 0] = np.maximum(Unew[..., 0], EPS_RHO)
        q = self._cons_to_prim(Unew)
        low_p = q[..., 3] <= EPS_P
        if low_p.any():
            q[..., 3] = np.maximum(q[..., 3], EPS_P)
            Unew = np.where(low_p[..., None], self._prim_to_cons(q), Unew)
        self.U[fl] = Unew[fl]
        self.t += dt
