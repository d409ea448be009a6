// D2Q9 collision shared by lbm_step.cu (one step a launch) and
// lbm_multistep.cu (K steps a launch in shared memory): the per-cell form
// of fluidsims_tpu_torch/solvers/lbm.py::step.
//
// Rules that keep both kernels bitwise equal to that plain version (as in
// euler2d.cuh): the moments in the plain version's explicit order (rho =
// f0 + ... + f8, floored at 1e-6 with a NaN-propagating max; ux = f1 - f3
// + f5 - f6 - f7 + f8; uy = f2 - f4 + f5 + f6 - f7 - f8; each divided by
// rho; ux + drive); feq as W rho (((1 + cu) + (0.5 cu) cu) - 1.5 u2) with
// cu = 3 (ex ux + ey uy), the products by ex, ey in {-1, 0, 1} kept as in
// the plain version; post = f - omega (f - feq); omega = 1 / tau, the
// weights and drive formed in double on the host and rounded once to T;
// the library is built with -fmad=false, so no multiply-add is contracted.
// Streaming moves bits and does no arithmetic.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fst {

// Host-side parameters, in double, formed by kernels/lbm_cuda.py.
struct LBMParams {
  int ny, nx;
  int k;          // steps per launch (the K-step kernel)
  double omega;   // 1 / tau
  double drive;   // drive override or cfg.drive
  double w[9];    // lattice weights
};

template <typename T>
struct LBMConst {
  T omega, drive;
  T w[9];
};

template <typename T>
LBMConst<T> lbm_const(const LBMParams& p) {
  LBMConst<T> c;
  c.omega = T(p.omega);
  c.drive = T(p.drive);
  for (int q = 0; q < 9; ++q) c.w[q] = T(p.w[q]);
  return c;
}

// D2Q9 lattice: rest, +x, +y, -x, -y, then diagonals (tau_lbm.cu:56-61):
// EX = {0, 1, 0, -1, 0, 1, -1, -1, 1}, EY = {0, 0, 1, 0, -1, 1, 1, -1, -1},
// OPP = {0, 3, 4, 1, 2, 7, 8, 5, 6}.  Functions, so that unrolled loops
// fold them to constants.
__host__ __device__ constexpr int ex_of(int q) {
  return (q == 1 || q == 5 || q == 8) ? 1 : (q == 3 || q == 6 || q == 7) ? -1
                                                                          : 0;
}
__host__ __device__ constexpr int ey_of(int q) {
  return (q == 2 || q == 5 || q == 6) ? 1 : (q == 4 || q == 7 || q == 8) ? -1
                                                                          : 0;
}
__host__ __device__ constexpr int opp_of(int q) {
  return q == 0 ? 0 : q <= 4 ? 1 + (q + 1) % 4 : 5 + (q - 3) % 4;
}

template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// BGK collision of one fluid cell: f[9] in, post[9] out (may alias).
template <typename T>
__device__ __forceinline__ void lbm_collide(const LBMConst<T>& c, const T* f,
                                            T* post) {
  T rho = f[0] + f[1];
  rho = rho + f[2];
  rho = rho + f[3];
  rho = rho + f[4];
  rho = rho + f[5];
  rho = rho + f[6];
  rho = rho + f[7];
  rho = rho + f[8];
  rho = nmax(rho, T(1e-6));
  const T sx = ((((f[1] - f[3]) + f[5]) - f[6]) - f[7]) + f[8];
  const T sy = ((((f[2] - f[4]) + f[5]) + f[6]) - f[7]) - f[8];
  const T ux = sx / rho + c.drive;
  const T uy = sy / rho;
  const T u2 = ux * ux + uy * uy;
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const T cu = T(3) * (T(ex_of(q)) * ux + T(ey_of(q)) * uy);
    const T eq = (c.w[q] * rho) * (((T(1) + cu) + (T(0.5) * cu) * cu)
                                   - T(1.5) * u2);
    post[q] = f[q] - c.omega * (f[q] - eq);
  }
}

}  // namespace fst
