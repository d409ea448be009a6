// Device math of the 3-D hypersonic step, shared by the step and wavespeed
// kernels: the per-cell form of fluidsims_tpu_torch/solvers/hypersonic3d.py
// and ops/weno.py (and of their JAX twins).
//
// Rules that keep these functions equal to the plain PyTorch version:
//  * Every literal is cast to T before it meets a T value, so float math
//    stays float.  Constants that the Python code forms from Python floats
//    alone (gamma - 1, R * theta_v, 1/dx, 13/12, 1/6, 5 * 0.5, the inflow
//    state and the sponge targets) arrive from the host in double and are
//    rounded to T once, as JAX's weakly typed scalars are.
//  * Each expression keeps the Python version's association order.
//  * max/min propagate NaN (nmax/nmin from euler2d.cuh), as torch.maximum
//    and jnp.maximum do: a NaN density must not be floored to 1e-30 and
//    escape the repair to inflow.
//  * The library is built with -fmad=false: no multiply-add contraction.
#pragma once

#include "euler2d.cuh"

namespace fst {

// Host-side parameters, in double, shared by every launch of a step.
struct Hyp3DParams {
  int nz, ny, nx;            // interior cells of the window
  int nx_global, x0;         // grid width and the window's first global x
  int sponge_n, sponge_out_n;
  double gamma, gm1, R, theta_v, R_theta_v;
  double tau_vib;            // max(tau_vib, 1e-9)
  double inv_d[3];           // 1/dx, 1/dy, 1/dz
  double d[3];               // dx, dy, dz
  double infl[6];            // inflow primitives r, u, v, w, p, ev
  double sponge_strength, sponge_out_strength;
  double tgt_r, tgt_p, tgt_ev;  // sponge targets
};

// Primitive (r, u, v, w, p, ev) or conserved (r, mx, my, mz, Et, Ev).
template <typename T>
struct Q6 {
  T f[6];
};

// The constants of Hyp3DParams, rounded to T.
template <typename T>
struct Gas3 {
  T gamma, gm1, R, theta_v, R_theta_v;
};

template <typename T>
inline Gas3<T> gas3_of(const Hyp3DParams& p) {
  return {T(p.gamma), T(p.gm1), T(p.R), T(p.theta_v), T(p.R_theta_v)};
}

template <typename T> __device__ __forceinline__ T rp_floor() { return T(1e-30); }
template <typename T> __device__ __forceinline__ T denom_eps() { return T(1e-12); }
template <typename T> __device__ __forceinline__ T newton_floor() { return T(1e-6); }

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }

enum { R_ = 0, U_ = 1, V_ = 2, W_ = 3, P_ = 4, EV_ = 5 };

template <typename T>
__device__ __forceinline__ Q6<T> floor_prim(Q6<T> q) {
  q.f[R_] = nmax(q.f[R_], rp_floor<T>());
  q.f[P_] = nmax(q.f[P_], rp_floor<T>());
  q.f[EV_] = nmax(q.f[EV_], T(0));
  return q;
}

template <typename T>
__device__ __forceinline__ Q6<T> prim_to_cons(const Q6<T>& q, const Gas3<T>& g) {
  const T r = q.f[R_], u = q.f[U_], v = q.f[V_], w = q.f[W_];
  const T ke = T(0.5) * ((u * u + v * v) + w * w);
  const T e_th = q.f[P_] / nmax(g.gm1 * r, rp_floor<T>());
  Q6<T> c;
  c.f[0] = r;
  c.f[1] = r * u;
  c.f[2] = r * v;
  c.f[3] = r * w;
  c.f[4] = r * ((ke + e_th) + q.f[EV_]);
  c.f[5] = r * q.f[EV_];
  return c;
}

template <typename T>
__device__ __forceinline__ Q6<T> cons_to_prim(const Q6<T>& U, const Gas3<T>& g) {
  Q6<T> q;
  const T r = nmax(U.f[0], rp_floor<T>());
  const T u = U.f[1] / r, v = U.f[2] / r, w = U.f[3] / r;
  const T ke = T(0.5) * ((u * u + v * v) + w * w);
  const T ev = nmax(U.f[5] / r, T(0));
  const T e_th = nmax((U.f[4] / r - ke) - ev, T(1e-12));
  q.f[R_] = r;
  q.f[U_] = u;
  q.f[V_] = v;
  q.f[W_] = w;
  q.f[P_] = nmax((g.gm1 * r) * e_th, rp_floor<T>());
  q.f[EV_] = ev;
  return q;
}

template <typename T>
__device__ __forceinline__ T soundspeed(T r, T p, const Gas3<T>& g) {
  return dsqrt(nmax((g.gamma * p) / r, denom_eps<T>()));
}

template <typename T>
__device__ __forceinline__ T evib_eq(T Tk, const Gas3<T>& g) {
  const T a = g.theta_v / nmax(Tk, newton_floor<T>());
  const T denom = nmax(dexp(a) - T(1), newton_floor<T>());
  return g.R_theta_v / denom;
}

// axis_flux: physical flux along AXIS (0 = x, 1 = y, 2 = z).
template <typename T, int AXIS>
__device__ __forceinline__ Q6<T> axis_flux(const Q6<T>& q, const Gas3<T>& g) {
  const T r = q.f[R_], u = q.f[U_], v = q.f[V_], w = q.f[W_], p = q.f[P_],
          ev = q.f[EV_];
  const T un = q.f[1 + AXIS];
  const T H = ((p / r) + (T(0.5) * ((u * u + v * v) + w * w) + ev)) +
              p / nmax(g.gm1 * r, rp_floor<T>());
  Q6<T> F;
  F.f[0] = r * un;
  F.f[1] = (r * u) * un;
  F.f[2] = (r * v) * un;
  F.f[3] = (r * w) * un;
  F.f[1 + AXIS] = F.f[1 + AXIS] + p;
  F.f[4] = (r * H) * un;
  F.f[5] = (r * ev) * un;
  return F;
}

template <typename T>
__device__ __forceinline__ T signed_denom(T x) {
  const T m = nmax(dabs(x), denom_eps<T>());
  return x >= T(0) ? m : -m;
}

template <typename T>
__device__ __forceinline__ T entropy_fix(T s, T a_ref) {
  const T d = T(0.1) * a_ref;
  const T as = dabs(s);
  const T sm = T(0.5) * ((as * as) / nmax(d, denom_eps<T>()) + d);
  const T sgn = s >= T(0) ? T(1) : T(-1);
  return as >= d ? s : sgn * sm;
}

template <typename T>
__device__ __forceinline__ T clip01(T x) {
  return nmin(nmax(x, T(0)), T(1));
}

// hllc_flux of the solver: HLLC with entropy fix and shock-sensor HLL
// blending.  The selects of the Python version become branches that pick
// the same values; only the star side that is selected is formed.
template <typename T, int AXIS>
__device__ Q6<T> hllc_flux(const Q6<T>& L, const Q6<T>& R, const Gas3<T>& g) {
  const T aL = soundspeed(L.f[R_], L.f[P_], g);
  const T aR = soundspeed(R.f[R_], R.f[P_], g);
  const T unL = L.f[1 + AXIS], unR = R.f[1 + AXIS];
  const T aRef = nmax(aL, aR);
  const T sL = entropy_fix(nmin(unL - aL, unR - aR), aRef);
  const T sR = entropy_fix(nmax(unL + aL, unR + aR), aRef);

  const Q6<T> FL = axis_flux<T, AXIS>(L, g);
  const Q6<T> FR = axis_flux<T, AXIS>(R, g);
  if (sL >= T(0)) return FL;
  if (sR <= T(0)) return FR;

  const Q6<T> UL = prim_to_cons(L, g);
  const Q6<T> UR = prim_to_cons(R, g);
  const T rL = L.f[R_], rR = R.f[R_], pL = L.f[P_], pR = R.f[P_];

  const T denom = signed_denom(rL * (sL - unL) - rR * (sR - unR));
  const T sM = (((pR - pL) + (rL * unL) * (sL - unL)) -
                (rR * unR) * (sR - unR)) / denom;
  const T pStar = T(0.5) * ((pL + (rL * (sL - unL)) * (sM - unL)) +
                            (pR + (rR * (sR - unR)) * (sM - unR)));

  // _crossflow_speed: 0 + (|a1| + |b1|) + (|a2| + |b2|), times 0.5
  T cross = T(0);
#pragma unroll
  for (int c = 1; c <= 3; ++c) {
    if (c == 1 + AXIS) continue;
    cross = cross + (dabs(L.f[c]) + dabs(R.f[c]));
  }
  cross = cross * T(0.5);
  const T align = clip01(T(1) - cross / nmax(aRef, denom_eps<T>()));
  const T dp = dabs(pR - pL) / nmax(pR + pL, denom_eps<T>());
  const T dr = dabs(rR - rL) / nmax(rR + rL, denom_eps<T>());
  const T alpha = clip01(T(5.0 * 0.5) * (dp + dr)) * align;

  const T invSRL = T(1) / signed_denom(sR - sL);

  // star flux of the side sM selects
  const bool left = sM >= T(0);
  const Q6<T>& qS = left ? L : R;
  const Q6<T>& US = left ? UL : UR;
  const Q6<T>& FS = left ? FL : FR;
  const T sS = left ? sL : sR;
  const T unS = left ? unL : unR;
  const T d = signed_denom(sS - sM);
  const T rStar = (qS.f[R_] * (sS - unS)) / d;
  Q6<T> Us;
  Us.f[0] = rStar;
  Us.f[1] = rStar * qS.f[U_];
  Us.f[2] = rStar * qS.f[V_];
  Us.f[3] = rStar * qS.f[W_];
  Us.f[1 + AXIS] = rStar * sM;
  Us.f[4] = (((sS - unS) * US.f[4]) - qS.f[P_] * unS + pStar * sM) / d;
  Us.f[5] = (US.f[5] * (sS - unS)) / d;

  const T sLsR = sL * sR;
  Q6<T> out;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const T fstar = FS.f[k] + sS * (Us.f[k] - US.f[k]);
    const T fhll = ((sR * FL.f[k] - sL * FR.f[k]) + sLsR * (UR.f[k] - UL.f[k])) *
                   invSRL;
    out.f[k] = (T(1) - alpha) * fstar + alpha * fhll;
  }
  return out;
}

// hllc_wall_flux of the solver: hllc_flux(q, mirror(q)) for LEFT, else
// hllc_flux(mirror(q), q), in the specialised symmetric-pair form.
template <typename T, int AXIS>
__device__ Q6<T> hllc_wall_flux(Q6<T> L, bool left, const Gas3<T>& g) {
  if (!left) L.f[1 + AXIS] = -L.f[1 + AXIS];
  const T a = soundspeed(L.f[R_], L.f[P_], g);
  const T unL = L.f[1 + AXIS];
  const T sL = -(dabs(unL) + a);
  const Q6<T> UL = prim_to_cons(L, g);
  const Q6<T> FL = axis_flux<T, AXIS>(L, g);
  const T d = signed_denom(sL);
  const T rStar = (L.f[R_] * (sL - unL)) / d;
  Q6<T> Us;
  Us.f[0] = rStar;
  Us.f[1] = rStar * L.f[U_];
  Us.f[2] = rStar * L.f[V_];
  Us.f[3] = rStar * L.f[W_];
  Us.f[1 + AXIS] = T(0);
  Us.f[4] = (((sL - unL) * UL.f[4]) - L.f[P_] * unL) / d;
  Us.f[5] = (UL.f[5] * (sL - unL)) / d;
  Q6<T> out;
#pragma unroll
  for (int k = 0; k < 6; ++k) out.f[k] = FL.f[k] + sL * (Us.f[k] - UL.f[k]);
  return out;
}

// WENO5 face values of one field along a line, the per-cell form of
// ops/weno.weno5_lr_slab, split so that each value is formed once: a
// cell's reciprocal-square smoothness weights (weno_weights), the left
// state of the face right of it (weno_left) and the right state of the
// face left of it (weno_right), each from the five cells s[0..4] around
// the cell (s[2]).  A face's L takes its left cell's weights and its R
// its right cell's, each with weno5_lr_slab's expressions in its order.
template <typename T>
struct WenoWeights {
  T inv0, inv1, inv2;
};

template <typename T>
__device__ __forceinline__ WenoWeights<T> weno_weights(const T s[5]) {
  const T c13 = T(13.0 / 12.0);
  const T eps = T(1e-6);
  // D centred on s[1], s[2], s[3]
  T D[3];
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const T d2 = (s[o] - T(2) * s[o + 1]) + s[o + 2];
    D[o] = (c13 * d2) * d2;
  }
  const T cd = s[3] - s[1];
  const T C = (T(0.25) * cd) * cd;
  const T gd = (s[0] - T(4) * s[1]) + T(3) * s[2];
  const T G = (T(0.25) * gd) * gd;
  const T fd = (T(3) * s[2] - T(4) * s[3]) + s[4];
  const T F = (T(0.25) * fd) * fd;
  const T t0 = eps + (D[0] + G);
  const T t1 = eps + (D[1] + C);
  const T t2 = eps + (D[2] + F);
  return {T(1) / (t0 * t0), T(1) / (t1 * t1), T(1) / (t2 * t2)};
}

// L at the face between s[2] and s[3], from s[0..4] and s[2]'s weights.
template <typename T>
__device__ __forceinline__ T weno_left(const T s[5], WenoWeights<T> w) {
  const T sixth = T(1.0 / 6.0);
  const T A = ((T(2) * s[0] - T(7) * s[1]) + T(11) * s[2]) * sixth;
  const T M = ((-s[1] + T(5) * s[2]) + T(2) * s[3]) * sixth;
  const T N = ((T(2) * s[2] + T(5) * s[3]) - s[4]) * sixth;
  const T a0 = T(0.1) * w.inv0, a1 = T(0.6) * w.inv1, a2 = T(0.3) * w.inv2;
  return ((a0 * A + a1 * M) + a2 * N) / ((a0 + a1) + a2);
}

// R at the face between s[1] and s[2], from s[0..4] and s[2]'s weights.
template <typename T>
__device__ __forceinline__ T weno_right(const T s[5], WenoWeights<T> w) {
  const T sixth = T(1.0 / 6.0);
  const T M = ((-s[0] + T(5) * s[1]) + T(2) * s[2]) * sixth;
  const T N = ((T(2) * s[1] + T(5) * s[2]) - s[3]) * sixth;
  const T B = ((T(11) * s[2] - T(7) * s[3]) + T(2) * s[4]) * sixth;
  const T r0 = T(0.1) * w.inv2, r1 = T(0.6) * w.inv1, r2 = T(0.3) * w.inv0;
  return ((r0 * B + r1 * N) + r2 * M) / ((r0 + r1) + r2);
}

}  // namespace fst
