// The grid update and grid-to-particle transfer of MLS-MPM in one launch,
// for float and double: per particle the 3 x 3 nodes' P2G sums (mass,
// mom_x, mom_y) gathered and each node's velocity formed where it is
// gathered, then the velocity and the affine matrix C from those nodes,
// the update F <- (I + dt C) Fe, mud's shear relaxation, Jp <- clip(Jp
// oldJ / newJ, 0.05, 20) and x <- clip(x + dt v, 2 dx, (G - 3) dx).
//
// Replaces two TPU kernels of fluidsims_tpu/kernels/mpm_pallas.py:
// _grid_kernel (pallas_call at :206), which held the (Gy, 128) lane-padded
// grids in VMEM, and _g2p_kernel (pallas_call at :220).  Mosaic has no
// gather, so that G2P walked the binned (16, K, rows * 128) slab eight
// grid rows at a time, rolled grid rows by the x offsets, and wrote 9
// channels a slot that XLA gathered back to particle order.  Hopper
// gathers from L1/L2, so this kernel is the reference's k_grid_update and
// k_g2p (tau_mpm.cu:185-257) as JAX's exact scatter engine writes them
// (solvers/mpm.py::_grid_update, _g2p): one thread a particle, in particle
// order.  It recomputes the base node, the fraction, the weights and Fe
// from the input state (csrc/mpm.cuh; the snow clamp again, since the
// update multiplies the clamped Fe, not F).  A node's velocity is formed
// from its three sums by mpm_node_velocity (the plain _grid_update's
// operations at that node, by the node's own (x, y)), once a block: the
// block takes the box of the in-grid nodes its particles gather (warp
// min/max reductions, a barrier, and one more reduction of the warps'
// boxes) and, where the box holds at most FST_MPM_G2P_WINDOW nodes, its
// threads form the box's velocities into a window in shared memory, one
// node a thread, and the particles gather from it after a second
// barrier.  A block whose particles spread wider (particles in no spatial
// order) forms each node where a particle gathers it, from the three sums
// in L1/L2: the same operations, so the same bits, with up to 9 updates of
// a node.  The choice is the block's own, from its particles.  Then per
// particle the 9 nodes (ox outer, oy inner; an out-of-grid node weighs 0
// and reads 0), v += w g and C += 4 inv_dx ((w g) dpos), and the new pos,
// vel, F and Jp go to fresh outputs: it never writes its input.  The 2 x 2
// products are written out in the plain version's order; with -fmad=false
// the outputs are bitwise those of g2p_plain (the G2P of
// grid_update_plain's velocities).
//
// Why one launch: the grid update alone was a launch of ~8 operations a
// node, shorter than a launch's ramp at 96^2, whose only reader was the
// G2P right after it (3 grids in, 2 out, the 2 in again).  Here no node
// velocity reaches device memory and a step makes one launch, and one
// wrapper call, fewer.  Why the window (NVIDIA H100 80GB HBM3 at 700 W,
// PERF.md): forming every gathered node where it is gathered (27 gathers
// and up to 18 true divisions a particle) made it instruction-bound,
// 0.0444 ms at 2^20 particles against 0.0038 + 0.0278 for the two
// launches it replaced; a window a warp filled some warps' windows in
// several serial passes and left the warps across a row's end to the
// per-gather path, the pace of a one-wave launch at 32,768.  A state's
// particles keep the spatial order of the init's raster, so 256 of them
// gather ~130-230 nodes, one a thread.  The F and Jp loads stay after the
// window: loaded first, they held registers through it (0.0414 against
// 0.0348 ms at 2^20).
//
// What bounds it on an H100: bytes, at large particle counts.  A particle
// reads 7 values and writes 9 (64 bytes at f32: 2.1 MB at 32,768 and
// 67 MB at 2^20, ~20 us at 3.35 TB/s) and the three grids are read once
// from device memory (the windows of neighbouring blocks overlap in L2).
// What holds it back: its two barriers, at which a block's warps wait for
// the slowest position load and then for the window, where the parent
// design's warps ran on their own (0.034-0.035 ms at 2^20 against 0.0278
// for its G2P).  At 32,768 particles (128 blocks) it is one dependent
// chain a thread through the two barriers: latency.  Consecutive threads
// read and write consecutive particles.
#include <cuda_runtime.h>

#include <climits>

#include "mpm.cuh"

namespace fst {
namespace {

// Threads a block (whole warps), and the nodes a block's window holds.
#ifndef FST_MPM_G2P_THREADS
#define FST_MPM_G2P_THREADS 256
#endif
#ifndef FST_MPM_G2P_WINDOW
#define FST_MPM_G2P_WINDOW 1024
#endif
constexpr int kMPMG2PThreads = FST_MPM_G2P_THREADS;
constexpr int kMPMG2PWindow = FST_MPM_G2P_WINDOW;

template <typename T>
struct G2PArgs {
  const T* pos;    // (np, 2)
  const T* F;      // (np, 2, 2)
  const T* Jp;     // (np,)
  const T* mass;   // (Gy, Gx), the P2G sums
  const T* mom_x;
  const T* mom_y;
  T* pos_out;      // (np, 2)
  T* vel_out;      // (np, 2)
  T* F_out;        // (np, 2, 2)
  T* Jp_out;       // (np,)
  long long np;
  MPMConsts<T> c;
};

template <typename T>
__global__ void __launch_bounds__(kMPMG2PThreads, 1) mpm_g2p_kernel(
    G2PArgs<T> p) {
  __shared__ T win_u[kMPMG2PWindow], win_v[kMPMG2PWindow];
  __shared__ int box[4][kMPMG2PThreads / 32];
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = k < p.np;
  const MPMConsts<T> c = p.c;
  T px = T(0), py = T(0), fx = T(0), fy = T(0);
  int bx = -3, by = -3;
  if (live) {
    px = __ldg(p.pos + 2 * k);
    py = __ldg(p.pos + 2 * k + 1);
    bx = mpm_base(px, c.inv_dx, c.gx, fx);
    by = mpm_base(py, c.inv_dx, c.gy, fy);
  }

  // The block's window: the box of the in-grid nodes its particles gather
  // (a particle with none, or past np, adds nothing).
  int x0 = max(bx, 0), x1 = min(bx + 2, c.gx - 1);
  int y0 = max(by, 0), y1 = min(by + 2, c.gy - 1);
  if (x0 > x1 || y0 > y1) {
    x0 = y0 = INT_MAX;
    x1 = y1 = INT_MIN;
  }
  const unsigned all = 0xffffffffu;
  x0 = __reduce_min_sync(all, x0);
  x1 = __reduce_max_sync(all, x1);
  y0 = __reduce_min_sync(all, y0);
  y1 = __reduce_max_sync(all, y1);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    box[0][warp] = x0;
    box[1][warp] = x1;
    box[2][warp] = y0;
    box[3][warp] = y1;
  }
  __syncthreads();
  // The block's box: every warp folds the warps' boxes, one a lane.
  const int lane = threadIdx.x % 32;
  const bool has = lane < (int)(blockDim.x / 32);
  x0 = __reduce_min_sync(all, has ? box[0][lane] : INT_MAX);
  x1 = __reduce_max_sync(all, has ? box[1][lane] : INT_MIN);
  y0 = __reduce_min_sync(all, has ? box[2][lane] : INT_MAX);
  y1 = __reduce_max_sync(all, has ? box[3][lane] : INT_MIN);
  // The same on every thread of the block, so both branches below are
  // taken by the whole block.
  const bool windowed =
      x0 <= x1 && y0 <= y1 &&
      (long long)(x1 - x0 + 1) * (y1 - y0 + 1) <= kMPMG2PWindow;
  const int ww = windowed ? x1 - x0 + 1 : 0;
  if (windowed) {
    const int nodes = ww * (y1 - y0 + 1);
    for (int i = threadIdx.x; i < nodes; i += blockDim.x) {
      const int x = x0 + i % ww, y = y0 + i / ww;
      const size_t node = (size_t)y * c.gx + x;
      T u, v;
      mpm_node_velocity(__ldg(p.mass + node), __ldg(p.mom_x + node),
                        __ldg(p.mom_y + node), x, y, c, u, v);
      win_u[i] = u;
      win_v[i] = v;
    }
    __syncthreads();
  }
  if (!live) return;

  T wx[3], wy[3];
  mpm_bspline(fx, wx);
  mpm_bspline(fy, wy);
  T nvx = T(0), nvy = T(0);
  T C00 = T(0), C01 = T(0), C10 = T(0), C11 = T(0);
#pragma unroll
  for (int ox = 0; ox < 3; ++ox) {
    const int ix = bx + ox;
    const bool okx = ix >= 0 && ix < c.gx;
    const T dposx = (T(ox) - fx) * c.dx;
#pragma unroll
    for (int oy = 0; oy < 3; ++oy) {
      const int iy = by + oy;
      const bool ok = okx && iy >= 0 && iy < c.gy;
      const T w = ok ? wx[ox] * wy[oy] : T(0);
      T gvx = T(0), gvy = T(0);
      if (ok && windowed) {
        const int i = (iy - y0) * ww + (ix - x0);
        gvx = win_u[i];
        gvy = win_v[i];
      } else if (ok) {
        const size_t node = (size_t)iy * c.gx + ix;
        mpm_node_velocity(__ldg(p.mass + node), __ldg(p.mom_x + node),
                          __ldg(p.mom_y + node), ix, iy, c, gvx, gvy);
      }
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
int launch_g2p(const T* pos, const T* F, const T* Jp, const T* mass,
               const T* mom_x, const T* mom_y, T* pos_out, T* vel_out,
               T* F_out, T* Jp_out, long long np, const MPMConsts<T>& c,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const G2PArgs<T> args{pos,     F,       Jp,    mass,   mom_x, mom_y,
                        pos_out, vel_out, F_out, Jp_out, np,    c};
  const long long blocks = (np + kMPMG2PThreads - 1) / kMPMG2PThreads;
  mpm_g2p_kernel<T><<<(unsigned)blocks, kMPMG2PThreads, 0,
                      (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_mpm_g2p_f32(const float* pos, const float* F, const float* Jp,
                    const float* mass, const float* mom_x, const float* mom_y,
                    float* pos_out, float* vel_out, float* F_out,
                    float* Jp_out, long long np,
                    const fst::MPMConsts<float>* c, int device,
                    void* stream) {
  return fst::launch_g2p<float>(pos, F, Jp, mass, mom_x, mom_y, pos_out,
                                vel_out, F_out, Jp_out, np, *c, device,
                                stream);
}

int fst_mpm_g2p_f64(const double* pos, const double* F, const double* Jp,
                    const double* mass, const double* mom_x,
                    const double* mom_y, double* pos_out, double* vel_out,
                    double* F_out, double* Jp_out, long long np,
                    const fst::MPMConsts<double>* c, int device,
                    void* stream) {
  return fst::launch_g2p<double>(pos, F, Jp, mass, mom_x, mom_y, pos_out,
                                 vel_out, F_out, Jp_out, np, *c, device,
                                 stream);
}

}  // extern "C"
