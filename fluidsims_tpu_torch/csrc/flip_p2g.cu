// Particle-to-grid transfer of FLIP/APIC, for float and double: each
// particle adds its hat-weighted mass and APIC momentum to the 3 x 3 grid
// nodes around its base node, by atomicAdd, into zeroed (n, n) grids.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/flip_pallas.py::
// _p2g_kernel (pallas_call at :271).  The TPU has no fast scatter, so that
// kernel read particles binned into a (14, K, cells) slab, K slots a cell
// (particles past K dropped), and summed the 9 offsets' weight products
// over K as dense row windows.  Hopper has atomics in L2, so this kernel
// is the reference's k_p2g (tau_flip_apic.cu:105-131) as JAX's exact
// scatter engine writes it (solvers/flip_apic.py::_p2g): one thread a
// particle, no binning, no capacity, no particle dropped.  For each offset
// the target index is clipped to [0, n - 1] (at a wall the out-of-grid
// offset folds onto the wall node with the clipped index's weight, as the
// reference's clip does), wt = w1(gx - i) w1(gy - j), r = (node - g) /
// (n - 1) a true division, vv = vel + apic (a_x rx + a_y ry), and wt,
// wt vvx, wt vvy are added where wt > 0.  apic is a launch argument, so a
// per-call override needs no other build.  Atomics add in no fixed order,
// so a node's sum matches the plain version's `index_add_` to rounding,
// not bitwise (nor does index_add_ repeat itself on the card).
//
// What bounds it on an H100: the atomics.  The bytes are small (8 values
// a particle in, 3 grids out: ~2.3 MB at 65,536 particles f32, ~0.7 us at
// 3.35 TB/s) and so are the ~130 operations a particle; but each particle
// makes 12 (interior) to 27 atomic adds, resolved in L2, and neighbours
// in a warp hit the same nodes.  A first, plain kernel: aggregating a
// warp's adds per node (a sort by cell, or shared-memory tiles) is later
// work.  A particle's inputs are interleaved (x, y) pairs; consecutive
// threads read consecutive pairs.
#include <cuda_runtime.h>

#include "flip.cuh"

namespace fst {
namespace {

template <typename T>
struct P2GArgs {
  const T* pos;   // (np, 2)
  const T* vel;
  const T* ax;    // APIC d(vel)/dx
  const T* ay;    // APIC d(vel)/dy
  T* mass;        // (n, n), zeroed by the caller
  T* mom_u;
  T* mom_v;
  long long np;
  int n;
  T apic;
};

template <typename T>
__global__ void __launch_bounds__(kFlipThreads) p2g_kernel(P2GArgs<T> p) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p.np) return;
  const int n = p.n;
  const T nm1 = T(n - 1);
  const T gx = __ldg(p.pos + 2 * k) * nm1;
  const T gy = __ldg(p.pos + 2 * k + 1) * nm1;
  const T vx = __ldg(p.vel + 2 * k), vy = __ldg(p.vel + 2 * k + 1);
  const T ax0 = __ldg(p.ax + 2 * k), ax1 = __ldg(p.ax + 2 * k + 1);
  const T ay0 = __ldg(p.ay + 2 * k), ay1 = __ldg(p.ay + 2 * k + 1);
  // a base past [-1, n] clips to the same targets as [-1, n] does; the
  // clamp keeps base + offset from overflowing for non-finite input
  const int bx = flip_clampi((int)floor(gx), -1, n);
  const int by = flip_clampi((int)floor(gy), -1, n);
  for (int oy = -1; oy <= 1; ++oy) {
    const int j = flip_clampi(by + oy, 0, n - 1);
    const T wy = flip_w1(gy - T(j));
    const T ry = (T(j) - gy) / nm1;
    for (int ox = -1; ox <= 1; ++ox) {
      const int i = flip_clampi(bx + ox, 0, n - 1);
      const T wt = flip_w1(gx - T(i)) * wy;
      if (!(wt > T(0))) continue;
      const T rx = (T(i) - gx) / nm1;
      const T vvx = vx + p.apic * (ax0 * rx + ay0 * ry);
      const T vvy = vy + p.apic * (ax1 * rx + ay1 * ry);
      const size_t c = (size_t)j * n + i;
      atomicAdd(p.mass + c, wt);
      atomicAdd(p.mom_u + c, wt * vvx);
      atomicAdd(p.mom_v + c, wt * vvy);
    }
  }
}

template <typename T>
int launch_p2g(const T* pos, const T* vel, const T* ax, const T* ay, T* mass,
               T* mom_u, T* mom_v, long long np, int n, double apic,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const P2GArgs<T> args{pos, vel, ax, ay, mass, mom_u, mom_v, np, n, T(apic)};
  const long long blocks = (np + kFlipThreads - 1) / kFlipThreads;
  p2g_kernel<T><<<(unsigned)blocks, kFlipThreads, 0, (cudaStream_t)stream>>>(
      args);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_flip_p2g_f32(const float* pos, const float* vel, const float* ax,
                     const float* ay, float* mass, float* mom_u, float* mom_v,
                     long long np, int n, double apic, int device,
                     void* stream) {
  return fst::launch_p2g<float>(pos, vel, ax, ay, mass, mom_u, mom_v, np, n,
                                apic, device, stream);
}

int fst_flip_p2g_f64(const double* pos, const double* vel, const double* ax,
                     const double* ay, double* mass, double* mom_u,
                     double* mom_v, long long np, int n, double apic,
                     int device, void* stream) {
  return fst::launch_p2g<double>(pos, vel, ax, ay, mass, mom_u, mom_v, np, n,
                                 apic, device, stream);
}

}  // extern "C"
