// Grid-to-particle transfer of MLS-MPM, for float and double: per particle
// the velocity and the affine matrix C gathered from the 3 x 3 nodes, the
// update F <- (I + dt C) Fe, mud's shear relaxation, Jp <- clip(Jp oldJ /
// newJ, 0.05, 20) and x <- clip(x + dt v, 2 dx, (G - 3) dx).
//
// Replaces the TPU kernel fluidsims_tpu/kernels/mpm_pallas.py::_g2p_kernel
// (pallas_call at :220).  Mosaic has no gather, so that kernel walked the
// binned (16, K, rows * 128) slab eight grid rows at a time, rolled grid
// rows by the x offsets, and wrote 9 channels a slot that XLA gathered
// back to particle order.  Hopper gathers from L1/L2, so this kernel is
// the reference's k_g2p (tau_mpm.cu:200-257) as JAX's exact scatter
// engine writes it (solvers/mpm.py::_g2p): one thread a particle, in
// particle order.  It recomputes the base node, the fraction, the weights
// and Fe from the input state (csrc/mpm.cuh; the snow clamp again, since
// the update multiplies the clamped Fe, not F), gathers the 9 nodes (ox
// outer, oy inner; an out-of-grid node weighs 0 and reads 0), accumulates
// v += w g and C += 4 inv_dx ((w g) dpos), and writes the new pos, vel, F
// and Jp to fresh outputs: it never writes its input.  The 2 x 2 products
// are written out in the plain version's order; with -fmad=false the
// outputs are bitwise those of the plain version for equal grids.
//
// What bounds it on an H100: bytes, at large particle counts.  A particle
// reads 7 values and writes 9 (64 bytes at f32: 2.1 MB at 32,768 and
// 67 MB at 2^20, ~20 us at 3.35 TB/s); the two grids are read once from
// device memory and then from L1/L2 (neighbouring particles gather
// neighbouring nodes); ~150 operations a particle stay below the card's
// rate.  Consecutive threads read and write consecutive particles.
#include <cuda_runtime.h>

#include "mpm.cuh"

namespace fst {
namespace {

template <typename T>
struct G2PArgs {
  const T* pos;   // (np, 2)
  const T* F;     // (np, 2, 2)
  const T* Jp;    // (np,)
  const T* gu;    // (Gy, Gx)
  const T* gv;
  T* pos_out;     // (np, 2)
  T* vel_out;     // (np, 2)
  T* F_out;       // (np, 2, 2)
  T* Jp_out;      // (np,)
  long long np;
  MPMConsts<T> c;
};

template <typename T>
__global__ void __launch_bounds__(kMPMThreads) mpm_g2p_kernel(G2PArgs<T> p) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p.np) return;
  const MPMConsts<T> c = p.c;
  const T px = __ldg(p.pos + 2 * k), py = __ldg(p.pos + 2 * k + 1);
  T fx, fy;
  const int bx = mpm_base(px, c.inv_dx, c.gx, fx);
  const int by = mpm_base(py, c.inv_dx, c.gy, fy);
  T wx[3], wy[3];
  mpm_bspline(fx, wx);
  mpm_bspline(fy, wy);

  T nvx = T(0), nvy = T(0);
  T C00 = T(0), C01 = T(0), C10 = T(0), C11 = T(0);
#pragma unroll
  for (int ox = 0; ox < 3; ++ox) {
    const int ix = bx + ox;
    const bool okx = ix >= 0 && ix < c.gx;
    const int cx = mpm_clampi(ix, 0, c.gx - 1);
    const T dposx = (T(ox) - fx) * c.dx;
#pragma unroll
    for (int oy = 0; oy < 3; ++oy) {
      const int iy = by + oy;
      const bool ok = okx && iy >= 0 && iy < c.gy;
      const size_t node = (size_t)mpm_clampi(iy, 0, c.gy - 1) * c.gx + cx;
      const T w = ok ? wx[ox] * wy[oy] : T(0);
      const T gvx = ok ? __ldg(p.gu + node) : T(0);
      const T gvy = ok ? __ldg(p.gv + node) : T(0);
      const T dposy = (T(oy) - fy) * c.dx;
      const T wgx = w * gvx, wgy = w * gvy;
      nvx = nvx + wgx;
      nvy = nvy + wgy;
      C00 = C00 + c.c4 * (wgx * dposx);
      C01 = C01 + c.c4 * (wgx * dposy);
      C10 = C10 + c.c4 * (wgy * dposx);
      C11 = C11 + c.c4 * (wgy * dposy);
    }
  }

  const Mat2<T> F{__ldg(p.F + 4 * k), __ldg(p.F + 4 * k + 1),
                  __ldg(p.F + 4 * k + 2), __ldg(p.F + 4 * k + 3)};
  const Mat2<T> f = mpm_elastic(F, c);
  const T dt = c.dt;
  const T a00 = T(1) + dt * C00, a01 = dt * C01;
  const T a10 = dt * C10, a11 = T(1) + dt * C11;
  const T n00 = a00 * f.a00 + a01 * f.a10;
  T n01 = a00 * f.a01 + a01 * f.a11;
  T n10 = a10 * f.a00 + a11 * f.a10;
  const T n11 = a10 * f.a01 + a11 * f.a11;
  const T oldJ = mpm_max(f.a00 * f.a11 - f.a01 * f.a10, T(1.0e-6));
  const T newJ = mpm_max(n00 * n11 - n01 * n10, T(1.0e-6));
  if (c.material == 0) {  // mud relaxes shear
    n01 = n01 * T(0.96);
    n10 = n10 * T(0.96);
  }
  p.F_out[4 * k] = n00;
  p.F_out[4 * k + 1] = n01;
  p.F_out[4 * k + 2] = n10;
  p.F_out[4 * k + 3] = n11;
  p.Jp_out[k] = mpm_clip(__ldg(p.Jp + k) * oldJ / newJ, T(0.05), T(20));
  p.pos_out[2 * k] = mpm_clip(px + dt * nvx, c.x_lo, c.x_hi);
  p.pos_out[2 * k + 1] = mpm_clip(py + dt * nvy, c.x_lo, c.y_hi);
  p.vel_out[2 * k] = nvx;
  p.vel_out[2 * k + 1] = nvy;
}

template <typename T>
int launch_g2p(const T* pos, const T* F, const T* Jp, const T* gu,
               const T* gv, T* pos_out, T* vel_out, T* F_out, T* Jp_out,
               long long np, const MPMConsts<T>& c, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const G2PArgs<T> args{pos,     F,     Jp,     gu, gv, pos_out,
                        vel_out, F_out, Jp_out, np, c};
  const long long blocks = (np + kMPMThreads - 1) / kMPMThreads;
  mpm_g2p_kernel<T><<<(unsigned)blocks, kMPMThreads, 0,
                      (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_mpm_g2p_f32(const float* pos, const float* F, const float* Jp,
                    const float* gu, const float* gv, float* pos_out,
                    float* vel_out, float* F_out, float* Jp_out, long long np,
                    const fst::MPMConsts<float>* c, int device,
                    void* stream) {
  return fst::launch_g2p<float>(pos, F, Jp, gu, gv, pos_out, vel_out, F_out,
                                Jp_out, np, *c, device, stream);
}

int fst_mpm_g2p_f64(const double* pos, const double* F, const double* Jp,
                    const double* gu, const double* gv, double* pos_out,
                    double* vel_out, double* F_out, double* Jp_out,
                    long long np, const fst::MPMConsts<double>* c, int device,
                    void* stream) {
  return fst::launch_g2p<double>(pos, F, Jp, gu, gv, pos_out, vel_out, F_out,
                                 Jp_out, np, *c, device, stream);
}

}  // extern "C"
