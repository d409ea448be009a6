// Device math and layout shared by the three SPH kernels (sph_bin.cu,
// sph_density.cu, sph_forces.cu): the per-pair form of the plain versions
// in fluidsims_tpu_torch/kernels/sph_cuda.py, which in turn follow the
// TPU kernels of fluidsims_tpu/kernels/sph_pallas.py.
//
// Layout.  The bin kernel sorts the particles by cell, and inside a cell by
// particle index, into `fields` (n, 4) = (x, y, vx, vy); `starts` (M + 1)
// holds each cell's first position in that order.  Every member of a cell
// is a neighbour in the pair sums of the particles of the 3x3 cells around
// it: there is no cell capacity, so no pair is dropped however full a cell
// gets, as in the reference's linked lists (tau_sph.cu:165-176).  A
// particle's position in the sorted order minus its cell's start is its
// rank in the cell.
//
// Rules that keep the kernels equal to the plain versions (as in
// euler2d.cuh): literals cast to T before they meet a T value; constants
// the Python code forms from Python floats alone arrive in double from the
// host and are rounded once to T; max propagates NaN; the library is built
// with -fmad=false, so no multiply-add is contracted.
#pragma once

#include <cuda_runtime.h>

namespace fst {

// Host-side parameters, in double, formed by kernels/sph_cuda.py::_params.
struct SPHParams {
  int n, Gx, Gy;
  int use_visc, use_grav, gamma_is_one;
  double cell;        // cell side (2h)
  double inv_h;       // 1 / h
  double alpha;       // 10 / (7 pi h^2)
  double alpha_q;     // alpha * 0.25
  double mass;
  double inv_rho0;    // 1 / rho0
  double c0sq_rho0;   // c0^2 * rho0
  double gamma_eos;
  double four_h2;     // (2h)^2
  double two_h;       // 2h
  double visc_coef;   // -visc_alpha * c0 * h
  double eps_h2;      // 0.01 * h^2
  double gravity;
  double box_x, box_y;
};

template <typename T>
struct alignas(4 * sizeof(T)) V4 {
  T x, y, vx, vy;
};

template <typename T>
struct alignas(2 * sizeof(T)) V2 {
  T a, b;
};

template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// Flat cell id gy * Gx + gx: floor(x / cell) with an IEEE division,
// clamped to the grid (ops/cell_dense.py::_cid).
template <typename T>
__device__ __forceinline__ int cell_of(T x, T y, const SPHParams& p) {
  const T cell = T(p.cell);
  int gx = (int)floor(x / cell);
  int gy = (int)floor(y / cell);
  gx = min(max(gx, 0), p.Gx - 1);
  gy = min(max(gy, 0), p.Gy - 1);
  return gy * p.Gx + gx;
}

// The members of cell (gx, gy): [*b, *e).  False outside the grid.
__device__ __forceinline__ bool cell_range(const int* __restrict__ starts,
                                           int gx, int gy, const SPHParams& p,
                                           int* b, int* e) {
  if (gx < 0 || gx >= p.Gx || gy < 0 || gy >= p.Gy) return false;
  const int c = gy * p.Gx + gx;
  *b = __ldg(starts + c);
  *e = __ldg(starts + c + 1);
  return true;
}

}  // namespace fst
