// Particle-to-grid transfer of MLS-MPM, for float and double: each particle
// adds its quadratic-B-spline-weighted mass, and its momentum plus the
// stress force, to the 3 x 3 grid nodes from its base node, by atomicAdd,
// into three zeroed (Gy, Gx) grids.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/mpm_pallas.py::_p2g_kernel
// (pallas_call at :190).  The TPU has no fast scatter, so that kernel read
// particles binned into a (16, K, rows * 128) slab, K slots a cell (the
// particles past K dropped), and summed the 9 offsets as lane shifts of
// dense rows.  Hopper has atomics in L2, so this kernel is the
// reference's k_p2g (tau_mpm.cu:123-183) as JAX's exact scatter engine
// writes it (solvers/mpm.py::_p2g): one thread a particle, no binning, no
// capacity, no particle dropped.  Per particle: the base node and
// fraction, the weights, Fe and the stress inline (csrc/mpm.cuh); per
// offset (ox outer, oy inner) the target is skipped where it lies outside
// the grid (JAX's mode="drop"; FLIP's P2G clips instead), w = wx wy,
// dpos = (o - f) dx, force = stress dpos, and w pm, w (pm vx + fx), w (pm
// vy + fy) are added.  Atomics add in no fixed order, and exp and log are
// CUDA's, so a node's sum matches the plain version's to rounding, not
// bitwise.
//
// What bounds it on an H100: the atomics.  The bytes are small (7 values a
// particle in, 3 grids out: ~1 MB at 32,768 particles f32, ~0.3 us at
// 3.35 TB/s) and so are the ~100 operations a particle; but each particle
// makes 27 atomic adds, ~19 particles share a cell, so a node takes ~170
// adds a grid, resolved in L2, and neighbours in a warp hit the same
// nodes.  A first, plain kernel: aggregating a warp's adds per node is
// later work.  Consecutive threads read consecutive particles.
#include <cuda_runtime.h>

#include "mpm.cuh"

namespace fst {
namespace {

template <typename T>
struct P2GArgs {
  const T* pos;   // (np, 2)
  const T* vel;   // (np, 2)
  const T* F;     // (np, 2, 2)
  const T* Jp;    // (np,)
  T* mass;        // (Gy, Gx), zeroed by the caller
  T* mom_x;
  T* mom_y;
  long long np;
  MPMConsts<T> c;
};

template <typename T>
__global__ void __launch_bounds__(kMPMThreads) mpm_p2g_kernel(P2GArgs<T> p) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p.np) return;
  const MPMConsts<T> c = p.c;
  T fx, fy;
  const int bx = mpm_base(__ldg(p.pos + 2 * k), c.inv_dx, c.gx, fx);
  const int by = mpm_base(__ldg(p.pos + 2 * k + 1), c.inv_dx, c.gy, fy);
  T wx[3], wy[3];
  mpm_bspline(fx, wx);
  mpm_bspline(fy, wy);
  const Mat2<T> F{__ldg(p.F + 4 * k), __ldg(p.F + 4 * k + 1),
                  __ldg(p.F + 4 * k + 2), __ldg(p.F + 4 * k + 3)};
  const Mat2<T> s = mpm_stress(mpm_elastic(F, c), __ldg(p.Jp + k), c);
  const T mvx = c.pm * __ldg(p.vel + 2 * k);
  const T mvy = c.pm * __ldg(p.vel + 2 * k + 1);
#pragma unroll
  for (int ox = 0; ox < 3; ++ox) {
    const int ix = bx + ox;
    if (ix < 0 || ix >= c.gx) continue;
    const T dposx = (T(ox) - fx) * c.dx;
#pragma unroll
    for (int oy = 0; oy < 3; ++oy) {
      const int iy = by + oy;
      if (iy < 0 || iy >= c.gy) continue;
      const T w = wx[ox] * wy[oy];
      const T dposy = (T(oy) - fy) * c.dx;
      const T fcx = s.a00 * dposx + s.a01 * dposy;
      const T fcy = s.a10 * dposx + s.a11 * dposy;
      const size_t node = (size_t)iy * c.gx + ix;
      atomicAdd(p.mass + node, w * c.pm);
      atomicAdd(p.mom_x + node, w * (mvx + fcx));
      atomicAdd(p.mom_y + node, w * (mvy + fcy));
    }
  }
}

template <typename T>
int launch_p2g(const T* pos, const T* vel, const T* F, const T* Jp, T* mass,
               T* mom_x, T* mom_y, long long np, const MPMConsts<T>& c,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const P2GArgs<T> args{pos, vel, F, Jp, mass, mom_x, mom_y, np, c};
  const long long blocks = (np + kMPMThreads - 1) / kMPMThreads;
  mpm_p2g_kernel<T><<<(unsigned)blocks, kMPMThreads, 0,
                      (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_mpm_p2g_f32(const float* pos, const float* vel, const float* F,
                    const float* Jp, float* mass, float* mom_x, float* mom_y,
                    long long np, const fst::MPMConsts<float>* c, int device,
                    void* stream) {
  return fst::launch_p2g<float>(pos, vel, F, Jp, mass, mom_x, mom_y, np, *c,
                                device, stream);
}

int fst_mpm_p2g_f64(const double* pos, const double* vel, const double* F,
                    const double* Jp, double* mass, double* mom_x,
                    double* mom_y, long long np,
                    const fst::MPMConsts<double>* c, int device,
                    void* stream) {
  return fst::launch_p2g<double>(pos, vel, F, Jp, mass, mom_x, mom_y, np, *c,
                                 device, stream);
}

}  // extern "C"
