// Grid-to-particle transfer of FLIP/APIC, for float and double: per
// particle the bilinear samples of the pre- and post-projection grids, the
// FLIP/PIC blend, the APIC affine matrix from +-h samples of the projected
// field, the advection with restitution walls, and the density raster.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/flip_pallas.py::
// _g2p_kernel (pallas_call at :301).  Mosaic has no gather, so that kernel
// walked the binned (14, K, cells) slab row by row, weighting static
// windows of the grids with hat functions, and wrote 8 channels a slot
// that XLA then gathered back to particle order and rasterized.  Hopper
// gathers from L1/L2, so this kernel is the reference's sample_grid/k_g2p
// (tau_flip_apic.cu:186-241) as JAX's exact scatter engine writes it
// (solvers/flip_apic.py::_g2p): one thread a particle, in particle order,
// six two-field samples (csrc/flip.cuh), the blend (1 - flip) new + flip
// (vel + new - old), the affine terms (0.5 (s(+h) - s(-h))) / h as true
// divisions, x + v dt with v *= -0.35 where x leaves [0.01, 0.99] and x
// clipped there, and the raster count at (int)(x n) clipped, by an int32
// atomicAdd into a zeroed (n, n) grid (exact in any order).  flip is a
// launch argument (1 - flip rounded once from double, as the plain
// version's Python arithmetic does).  With -fmad=false the particle
// outputs are bitwise those of the plain version for equal grids.
//
// What bounds it on an H100: bytes, at large particle counts.  A particle
// reads 4 values and writes 8 (48 bytes at f32: 3.1 MB at 65,536 and
// 50 MB at 2^20, ~15 us at 3.35 TB/s), the 4 grids are read once from
// device memory and then from L1/L2 (neighbouring particles sample
// neighbouring nodes); ~230 operations a particle stay below the card's
// rate.  Consecutive threads read and write consecutive (x, y) pairs.
#include <cuda_runtime.h>

#include "flip.cuh"

namespace fst {
namespace {

template <typename T>
struct G2PArgs {
  const T* pos;     // (np, 2)
  const T* vel;
  const T* u_prev;  // (n, n)
  const T* v_prev;
  const T* u_proj;
  const T* v_proj;
  T* pos_out;       // (np, 2) x 4
  T* vel_out;
  T* ax_out;
  T* ay_out;
  int* density;     // (n, n), zeroed by the caller
  long long np;
  int n;
  T hi;             // n - 1.001 in T
  T h;              // 1 / (n - 1) in T
  T flip;
  T one_m_flip;     // 1 - flip in T
  T dt;
};

template <typename T>
__global__ void __launch_bounds__(kFlipThreads) g2p_kernel(G2PArgs<T> p) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p.np) return;
  const int n = p.n;
  const T nm1 = T(n - 1), h = p.h, hi = p.hi, half = T(0.5);
  const T px = __ldg(p.pos + 2 * k), py = __ldg(p.pos + 2 * k + 1);
  const T vx = __ldg(p.vel + 2 * k), vy = __ldg(p.vel + 2 * k + 1);

  T new_u, new_v, old_u, old_v;
  flip_sample(p.u_proj, p.v_proj, px, py, n, nm1, hi, new_u, new_v);
  flip_sample(p.u_prev, p.v_prev, px, py, n, nm1, hi, old_u, old_v);
  const T flip_u = (vx + new_u) - old_u;
  const T flip_v = (vy + new_v) - old_v;
  T vel_x = p.one_m_flip * new_u + p.flip * flip_u;
  T vel_y = p.one_m_flip * new_v + p.flip * flip_v;

  T ux1, vx1, ux0, vx0, uy1, vy1, uy0, vy0;
  flip_sample(p.u_proj, p.v_proj, px + h, py, n, nm1, hi, ux1, vx1);
  flip_sample(p.u_proj, p.v_proj, px - h, py, n, nm1, hi, ux0, vx0);
  flip_sample(p.u_proj, p.v_proj, px, py + h, n, nm1, hi, uy1, vy1);
  flip_sample(p.u_proj, p.v_proj, px, py - h, n, nm1, hi, uy0, vy0);

  const T lo_w = T(0.01), hi_w = T(0.99), rest = T(-0.35);
  T nx = px + vel_x * p.dt;
  T ny = py + vel_y * p.dt;
  if (nx < lo_w || nx > hi_w) vel_x = vel_x * rest;
  if (ny < lo_w || ny > hi_w) vel_y = vel_y * rest;
  nx = flip_clip(nx, lo_w, hi_w);
  ny = flip_clip(ny, lo_w, hi_w);

  p.pos_out[2 * k] = nx;
  p.pos_out[2 * k + 1] = ny;
  p.vel_out[2 * k] = vel_x;
  p.vel_out[2 * k + 1] = vel_y;
  p.ax_out[2 * k] = (half * (ux1 - ux0)) / h;
  p.ax_out[2 * k + 1] = (half * (vx1 - vx0)) / h;
  p.ay_out[2 * k] = (half * (uy1 - uy0)) / h;
  p.ay_out[2 * k + 1] = (half * (vy1 - vy0)) / h;

  const T tn = T(n);
  const int rx = flip_clampi((int)(nx * tn), 0, n - 1);
  const int ry = flip_clampi((int)(ny * tn), 0, n - 1);
  atomicAdd(p.density + (size_t)ry * n + rx, 1);
}

template <typename T>
int launch_g2p(const T* pos, const T* vel, const T* u_prev, const T* v_prev,
               const T* u_proj, const T* v_proj, T* pos_out, T* vel_out,
               T* ax_out, T* ay_out, int* density, long long np, int n,
               double flip, double dt, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const G2PArgs<T> args{pos,     vel,     u_prev,  v_prev,  u_proj,
                        v_proj,  pos_out, vel_out, ax_out,  ay_out,
                        density, np,      n,       T((double)n - 1.001),
                        T(1.0 / (double)(n - 1)),  T(flip), T(1.0 - flip),
                        T(dt)};
  const long long blocks = (np + kFlipThreads - 1) / kFlipThreads;
  g2p_kernel<T><<<(unsigned)blocks, kFlipThreads, 0, (cudaStream_t)stream>>>(
      args);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_flip_g2p_f32(const float* pos, const float* vel, const float* u_prev,
                     const float* v_prev, const float* u_proj,
                     const float* v_proj, float* pos_out, float* vel_out,
                     float* ax_out, float* ay_out, int* density, long long np,
                     int n, double flip, double dt, int device,
                     void* stream) {
  return fst::launch_g2p<float>(pos, vel, u_prev, v_prev, u_proj, v_proj,
                                pos_out, vel_out, ax_out, ay_out, density, np,
                                n, flip, dt, device, stream);
}

int fst_flip_g2p_f64(const double* pos, const double* vel,
                     const double* u_prev, const double* v_prev,
                     const double* u_proj, const double* v_proj,
                     double* pos_out, double* vel_out, double* ax_out,
                     double* ay_out, int* density, long long np, int n,
                     double flip, double dt, int device, void* stream) {
  return fst::launch_g2p<double>(pos, vel, u_prev, v_prev, u_proj, v_proj,
                                 pos_out, vel_out, ax_out, ay_out, density,
                                 np, n, flip, dt, device, stream);
}

}  // extern "C"
