// Device math of the 2-D Euler step, shared by the step and wavespeed
// kernels: the per-cell form of fluidsims_tpu_torch/ops/euler2d.py,
// limiters.py and riemann.py (and of their JAX twins).
//
// Rules that keep these functions equal to the plain PyTorch version:
//  * Every literal is cast to T before it meets a T value, so float math
//    stays float (a bare 0.5 would promote to double).
//  * Constants that the Python code forms from Python floats alone
//    (gamma - 1, 1/12, M*sqrt(gamma)) arrive from the host already formed
//    in double and rounded once to T.
//  * max/min propagate NaN (nmax/nmin), as torch.maximum and jnp.maximum
//    do; fmax/fmin would drop it and hide a broken cell from the repair.
//  * The library is built with -fmad=false: no multiply-add contraction.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fst {

// Cons (rho, mx, my, E) or Prim (rho, u, v, p).
template <typename T>
struct Q4 {
  T r, a, b, e;
};

// Host-side parameters, in double, shared by every launch of a step.
struct Hyp2DParams {
  int ny, nx;
  double gamma, gm1;                // gamma, gamma - 1 (formed in double)
  double visc_rho, visc_nu, visc_e;
  double infl[4];                   // inflow state, conserved, already in T
};

template <typename T>
struct Gas {
  T gamma, gm1;
};

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

template <typename T>
__device__ __forceinline__ T nmin(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

template <typename T> __device__ __forceinline__ T eps_rho() { return T(1e-25); }
template <typename T> __device__ __forceinline__ T eps_p() { return T(1e-25); }
template <typename T> __device__ __forceinline__ T tiny() { return T(1e-14); }

template <typename T>
__device__ __forceinline__ Q4<T> cons_to_prim(Q4<T> c, Gas<T> g) {
  const T rho = nmax(c.r, eps_rho<T>());
  const T inv = T(1) / rho;
  const T u = c.a * inv;
  const T v = c.b * inv;
  const T kin = T(0.5) * rho * (u * u + v * v);
  const T eint = c.e - kin;
  const T p = g.gm1 * nmax(eint, eps_p<T>());
  return {rho, u, v, p};
}

template <typename T>
__device__ __forceinline__ Q4<T> prim_to_cons(Q4<T> q, Gas<T> g) {
  const T rho = nmax(q.r, eps_rho<T>());
  const T pr = nmax(q.e, eps_p<T>());
  return {rho, rho * q.a, rho * q.b,
          pr / g.gm1 + T(0.5) * rho * (q.a * q.a + q.b * q.b)};
}

template <typename T>
__device__ __forceinline__ T sound_speed(Q4<T> q, Gas<T> g) {
  return dsqrt(g.gamma * nmax(q.e, eps_p<T>()) / nmax(q.r, eps_rho<T>()));
}

template <typename T>
__device__ __forceinline__ Q4<T> wall_ghost(Q4<T> q) {
  return {q.r, -q.a, -q.b, q.e};
}

template <typename T>
__device__ __forceinline__ Q4<T> clamp_prim(Q4<T> q) {
  return {nmax(q.r, eps_rho<T>()), q.a, q.b, nmax(q.e, eps_p<T>())};
}

// Physical flux of conserved state c along AXIS (0 = x, 1 = y), given its
// primitive decode q = cons_to_prim(c).
template <typename T, int AXIS>
__device__ __forceinline__ Q4<T> flux_of(Q4<T> c, Q4<T> q) {
  if (AXIS == 0) {
    const T un = q.a;
    return {c.a, c.a * un + q.e, c.b * un, (c.e + q.e) * un};
  }
  const T un = q.b;
  return {c.b, c.a * un, c.b * un + q.e, (c.e + q.e) * un};
}

template <typename T>
__device__ __forceinline__ T minmod(T a, T b) {
  const bool pick_a = dabs(a) < dabs(b);
  const bool same_sign = a * b > T(0);
  return same_sign ? (pick_a ? a : b) : T(0);
}

template <typename T>
__device__ __forceinline__ T mc_limiter(T dl, T dc, T dr) {
  const T mm1 = minmod(dl, dr);
  const T mm2 = minmod(dc, T(2) * dl);
  const T mm3 = minmod(dc, T(2) * dr);
  return minmod(mm1, minmod(mm2, mm3));
}

template <typename T>
__device__ __forceinline__ T safe_div(T num, T den) {
  return num / (dabs(den) < tiny<T>() ? T(1) : den);
}

template <typename T, int AXIS>
__device__ __forceinline__ T normal_vel(Q4<T> q) { return AXIS == 0 ? q.a : q.b; }
template <typename T, int AXIS>
__device__ __forceinline__ T tangent_vel(Q4<T> q) { return AXIS == 0 ? q.b : q.a; }

// HLLE flux (riemann.py::hlle), with the primitive decodes, wave speeds and
// physical fluxes the HLLC caller has already formed.
template <typename T>
__device__ __forceinline__ Q4<T> hlle_mid(Q4<T> UL, Q4<T> UR, Q4<T> FL,
                                          Q4<T> FR, T SL, T SR) {
  const T denom = SR - SL;
  if (dabs(denom) < tiny<T>()) {
    return {T(0.5) * (FL.r + FR.r), T(0.5) * (FL.a + FR.a),
            T(0.5) * (FL.b + FR.b), T(0.5) * (FL.e + FR.e)};
  }
  const T inv = T(1) / denom;  // safe_div(1, denom): |denom| >= tiny here
  const T msl = -SL;
  const T slsr = SL * SR;
  return {inv * ((SR * FL.r + msl * FR.r) + slsr * (UR.r - UL.r)),
          inv * ((SR * FL.a + msl * FR.a) + slsr * (UR.a - UL.a)),
          inv * ((SR * FL.b + msl * FR.b) + slsr * (UR.b - UL.b)),
          inv * ((SR * FL.e + msl * FR.e) + slsr * (UR.e - UL.e))};
}

// HLLC three-wave flux with per-face HLLE fallback (riemann.py::hllc).
// The select dataflow of the Python version becomes branches that pick
// the same values; the fallback is evaluated only where it is selected.
template <typename T, int AXIS>
__device__ Q4<T> hllc(Q4<T> UL, Q4<T> UR, Gas<T> g) {
  const Q4<T> L = cons_to_prim(UL, g);
  const Q4<T> R = cons_to_prim(UR, g);
  const T unL = normal_vel<T, AXIS>(L), unR = normal_vel<T, AXIS>(R);
  const T utL = tangent_vel<T, AXIS>(L), utR = tangent_vel<T, AXIS>(R);
  const T aL = sound_speed(L, g), aR = sound_speed(R, g);
  const T SL = nmin(unL - aL, unR - aR);
  const T SR = nmax(unL + aL, unR + aR);

  const Q4<T> FL = flux_of<T, AXIS>(UL, L);
  const Q4<T> FR = flux_of<T, AXIS>(UR, R);
  if (SL >= T(0)) return FL;
  if (SR <= T(0)) return FR;

  const T rhoL = L.r, rhoR = R.r, pL = L.e, pR = R.e;
  const T num = pR - pL + rhoL * unL * (SL - unL) - rhoR * unR * (SR - unR);
  const T den = rhoL * (SL - unL) - rhoR * (SR - unR);
  const T SM = safe_div(num, den);

  bool bad = (dabs(den) < tiny<T>()) || !isfinite(num) || !isfinite(den);
  bad = bad || !isfinite(SM);

  const T pStar = nmax(pL + rhoL * (SL - unL) * (SM - unL), eps_p<T>());
  const T dLS = SL - SM;
  const T dRS = SR - SM;
  bad = bad || (dabs(dLS) < tiny<T>()) || (dabs(dRS) < tiny<T>());

  const T rhoStarL = rhoL * safe_div(SL - unL, dLS);
  const T rhoStarR = rhoR * safe_div(SR - unR, dRS);
  bad = bad || !(rhoStarL > T(0)) || !(rhoStarR > T(0));
  bad = bad || !isfinite(rhoStarL) || !isfinite(rhoStarR);

  const T EStarL = safe_div((SL - unL) * UL.e - pL * unL + pStar * SM, dLS);
  const T EStarR = safe_div((SR - unR) * UR.e - pR * unR + pStar * SM, dRS);
  bad = bad || !isfinite(EStarL) || !isfinite(EStarR);

  if (bad) return hlle_mid(UL, UR, FL, FR, SL, SR);

  // star = SM >= 0 ? F_left_star : F_right_star  (F + S * (U* - U))
  const bool left = SM >= T(0);
  const T S = left ? SL : SR;
  const T rs = left ? rhoStarL : rhoStarR;
  const T ut = left ? utL : utR;
  const T Es = left ? EStarL : EStarR;
  const Q4<T> U = left ? UL : UR;
  const Q4<T> F = left ? FL : FR;
  const T momN = rs * SM, momT = rs * ut;
  const T smx = AXIS == 0 ? momN : momT;
  const T smy = AXIS == 0 ? momT : momN;
  return {F.r + S * (rs - U.r), F.a + S * (smx - U.a), F.b + S * (smy - U.b),
          F.e + S * (Es - U.e)};
}

}  // namespace fst
