// Gray–Scott cell update shared by gray_scott_step.cu (one step a launch)
// and gray_scott_multistep.cu (K steps a launch in shared memory): the
// per-cell form of fluidsims_tpu_torch/solvers/gray_scott.py::step.
//
// Rules that keep both kernels bitwise equal to that plain version (as in
// euler2d.cuh): every operation in the plain version's order — the
// Laplacian as right + left + down + up - 4c, then times inv_dx2; the
// reaction as (Du lap_u - uvv) + feed (1 - u) and (Dv lap_v + uvv) -
// (feed + kill) v; constants formed by Python in double arrive in double
// and are rounded once to T; the library is built with -fmad=false, so no
// multiply-add is contracted.
#pragma once

#include <cuda_runtime.h>

namespace fst {

// Host-side parameters, in double, formed by kernels/gray_scott_cuda.py.
struct GSParams {
  int ny, nx;
  int k;            // steps per launch (the K-step kernel)
  double inv_dx2;   // 1 / (dx * dx)
  double Du, Dv, dt;
  double feed;      // feed override or cfg.feed
  double fk;        // feed + kill as the plain version forms it
};

template <typename T>
struct GSConst {
  T inv_dx2, Du, Dv, dt, feed, fk;
};

template <typename T>
GSConst<T> gs_const(const GSParams& p) {
  return {T(p.inv_dx2), T(p.Du), T(p.Dv), T(p.dt), T(p.feed), T(p.fk)};
}

// One cell: centre (uc, vc) and its right, left, down (y + 1) and up
// (y - 1) neighbours.
template <typename T>
__device__ __forceinline__ void gs_cell(const GSConst<T>& c, T uc, T ur, T ul,
                                        T ud, T uu, T vc, T vr, T vl, T vd,
                                        T vu, T* u_new, T* v_new) {
  const T lap_u = ((((ur + ul) + ud) + uu) - T(4) * uc) * c.inv_dx2;
  const T lap_v = ((((vr + vl) + vd) + vu) - T(4) * vc) * c.inv_dx2;
  const T uvv = (uc * vc) * vc;
  const T du = ((c.Du * lap_u) - uvv) + c.feed * (T(1) - uc);
  const T dv = ((c.Dv * lap_v) + uvv) - c.fk * vc;
  *u_new = uc + c.dt * du;
  *v_new = vc + c.dt * dv;
}

// Periodic index: i mod n in [0, n) for any i, n > 0.
__device__ __forceinline__ int wrap(int i, int n) { return ((i % n) + n) % n; }

}  // namespace fst
