// What the MLS-MPM particle kernels share (mpm_p2g.cu, mpm_g2p.cu): the
// particle's base node and fraction, the quadratic B-spline weights, the
// elastic part Fe of F (snow's clamp), the stress and the grid update of
// one node, each written once in the operation order of the plain PyTorch
// version (solvers/mpm.py::_base_frac, _bspline_w, _elastic,
// _plastic_and_stress, _grid_update), so that with -fmad=false the kernels
// round as it does.
#pragma once

#include <cuda_runtime.h>

namespace fst {

// jnp.clip / torch.clamp: NaN passes through.
template <typename T>
__device__ __forceinline__ T mpm_clip(T x, T lo, T hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// jnp.maximum(x, lo) for a constant lo: NaN passes through.
template <typename T>
__device__ __forceinline__ T mpm_max(T x, T lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ int mpm_clampi(int i, int lo, int hi) {
  return i < lo ? lo : (i > hi ? hi : i);
}

// A 2x2 matrix, row major: (a00, a01; a10, a11).
template <typename T>
struct Mat2 {
  T a00, a01, a10, a11;
};

// What the launches share, every constant rounded once to T from the
// double that JAX forms from Python numbers.
template <typename T>
struct MPMConsts {
  int gx, gy;
  int material;   // MATERIALS: 0 mud, 1 snow, 2 sand
  T inv_dx;       // 1 / dx
  T dx;
  T pm;           // particle mass
  T fe_lo, fe_hi; // snow: 1 - critical_compression, 1 + critical_stretch
  T hardening, mu0, lambda0;
  T stress_c;     // -4 inv_dx^2 dt volume
  T c4;           // 4 inv_dx
  T dt;
  T x_lo, x_hi, y_hi;  // 2 dx, (Gx - 3) dx, (Gy - 3) dx
  T gdt;          // gravity * dt
};

// The base node and fraction on one axis: xp = p inv_dx, fb = floor(xp -
// 0.5), f = xp - fb.  The integer base is clamped to [-3, g], which keeps
// every target of a far-off (or non-finite) coordinate outside the grid.
template <typename T>
__device__ __forceinline__ int mpm_base(T p, T inv_dx, int g, T& f) {
  const T xp = p * inv_dx;
  const T fb = floor(xp - T(0.5));
  f = xp - fb;
  return fb >= T(-3) && fb <= T(g) ? (int)fb : (fb > T(g) ? g : -3);
}

// Quadratic B-spline weights for offsets 0, 1, 2 (tau_mpm.cu:138-147).
template <typename T>
__device__ __forceinline__ void mpm_bspline(T f, T w[3]) {
  const T a = T(1.5) - f, b = f - T(1), c = f - T(0.5);
  w[0] = T(0.5) * (a * a);
  w[1] = T(0.75) - b * b;
  w[2] = T(0.5) * (c * c);
}

// The elastic part of F (k_p2g :146-156): snow clamps the diagonal to
// [fe_lo, fe_hi] and decays the shear by 0.98; mud and sand keep F.
template <typename T>
__device__ __forceinline__ Mat2<T> mpm_elastic(Mat2<T> F,
                                               const MPMConsts<T>& c) {
  if (c.material == 1) {
    F.a00 = mpm_clip(F.a00, c.fe_lo, c.fe_hi);
    F.a11 = mpm_clip(F.a11, c.fe_lo, c.fe_hi);
    F.a01 = F.a01 * T(0.98);
    F.a10 = F.a10 * T(0.98);
  }
  return F;
}

// The stress of the elastic part Fe (k_p2g :157-165): J = max(det Fe,
// 0.2), e = exp(h (1 - Jp)), mu and lambda with the material's factors,
// P Fe^T = mu (Fe Fe^T - I) + lambda log(J) J I, times stress_c.
template <typename T>
__device__ __forceinline__ Mat2<T> mpm_stress(Mat2<T> Fe, T Jp,
                                              const MPMConsts<T>& c) {
  const T J = mpm_max(Fe.a00 * Fe.a11 - Fe.a01 * Fe.a10, T(0.2));
  const T e = exp(c.hardening * (T(1) - Jp));
  T mu = c.mu0 * e;
  T lam = c.lambda0 * e;
  if (c.material == 0) {
    mu = mu * T(0.25);
  } else if (c.material == 2) {
    mu = mu * T(1.8);
    lam = lam * T(0.75);
  }
  const T llj = lam * log(J) * J;
  const T s01 = mu * (Fe.a00 * Fe.a10 + Fe.a01 * Fe.a11);
  Mat2<T> s;
  s.a00 = (mu * (Fe.a00 * Fe.a00 + Fe.a01 * Fe.a01 - T(1)) + llj) *
          c.stress_c;
  s.a01 = s01 * c.stress_c;
  s.a10 = s.a01;
  s.a11 = (mu * (Fe.a10 * Fe.a10 + Fe.a11 * Fe.a11 - T(1)) + llj) *
          c.stress_c;
  return s;
}

// The grid update of one node (k_grid_update, tau_mpm.cu:185-198) from its
// P2G sums m, mx, my at node (x, y): where m > 0, u = mx / max(m, 1e-30)
// and v = my / max(m, 1e-30) - gravity dt (true divisions), then u = 0
// where the node is in the 3 columns of a side wall and u points out of
// it, v likewise in the 3 rows of the floor and the lid; u = v = 0 where
// there is no mass (NaN mass included).
template <typename T>
__device__ __forceinline__ void mpm_node_velocity(T m, T mx, T my, int x,
                                                  int y,
                                                  const MPMConsts<T>& c,
                                                  T& u, T& v) {
  u = T(0);
  v = T(0);
  if (m > T(0)) {
    const T fm = mpm_max(m, T(1e-30));
    u = mx / fm;
    v = my / fm - c.gdt;
    if ((x < 3 && u < T(0)) || (x > c.gx - 4 && u > T(0))) u = T(0);
    if ((y < 3 && v < T(0)) || (y > c.gy - 4 && v > T(0))) v = T(0);
  }
}

}  // namespace fst
