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
// the samples of csrc/flip.cuh, the blend (1 - flip) new + flip (vel +
// new - old), the affine terms (0.5 (s(+h) - s(-h))) / h as true
// divisions, x + v dt with v *= -0.35 where x leaves [0.01, 0.99] and x
// clipped there, and the raster count at (int)(x n) clipped, by int32
// atomicAdd into a zeroed (n, n) grid (exact in any order).  flip is a
// launch argument (1 - flip rounded once from double, as the plain
// version's Python arithmetic does).  With -fmad=false the particle
// outputs are bitwise those of the plain version for equal grids.
//
// Each node is loaded once.  The five samples of the projected field (the
// centre and +-h along x and y) share nodes: about the centre's base node
// (j0, i0) they lie in a plus-shaped window of 12, rows j0 and j1 over
// columns i0 - 1 .. i0 + 2 and columns i0 and i0 + 1 over rows j0 - 1 and
// j0 + 2 (G2PWindow), loaded where the window is centred (1 <= i0 <= n -
// 3); the pre-projection sample reads its 4 nodes.  Every sample still
// computes its own clipped coordinate, floor, far node and fraction as
// flip_axis does.  A sample shifted by one node takes its nodes from
// fixed window slots where its base node is the centre's +-1 and its far
// node the next, and all four from memory otherwise, as every sample of a
// particle whose window is not centred does: rounding of (p +- h)(n - 1)
// can put a floor on or two nodes from the centre's, and the wall clip
// can collapse nodes.  A value from the window is the one memory holds
// there, so only where a value comes from changes, never the arithmetic or
// its order.  (Picking each node by its index from all 12 slots held 122
// registers a thread at f32 and ran slower than the parent.)
//
// Particle I/O at vector width: (x, y) pairs as one float2 / double2
// access a thread (the wrapper hands over pointers aligned to a pair).
// The raster adds are grouped by warp: __match_any_sync finds the lanes
// of one cell, and the lowest adds their count with one atomicAdd.
//
// What bounds it on an H100: not bytes.  A particle reads 4 values and
// writes 8 (48 bytes at f32: 50 MB at 2^20, ~15 us at 3.35 TB/s; the grids
// come from L1/L2, neighbouring particles sampling neighbouring nodes),
// but at 2^20 a launch takes ~41 us (NVIDIA H100 80GB HBM3, 700 W; PERF.md
// row 18): ~230 floating-point operations, 4 true divisions and the
// address arithmetic of 32 gathers a particle, at 80 registers a thread
// (24 warps an SM), set the pace.  Consecutive threads read and write
// consecutive (x, y) pairs.
#include <cuda_runtime.h>

#include "flip.cuh"
#include "tiles.cuh"

// Threads a block, float and double (tools/tune_tiles_torch.py sweep --set
// g2p builds other values with -D).
#ifndef FST_G2P_THREADS
#define FST_G2P_THREADS 64
#endif
#ifndef FST_G2P_F64_THREADS
#define FST_G2P_F64_THREADS 256
#endif

namespace fst {
namespace {

template <typename T>
struct G2PThreads {
  static constexpr int value =
      sizeof(T) == 4 ? FST_G2P_THREADS : FST_G2P_F64_THREADS;
  static_assert(value % 32 == 0, "G2P blocks are whole warps");
};

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

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

// One projected field's window about the centre sample's base node
// (cy.i0, cx.i0), loaded where the window is centred (1 <= cx.i0 <= n - 3:
// its four columns cx.i0 - 1 .. cx.i0 + 2 lie in the grid and cx.i1 is
// cx.i0 + 1): x0[k], x1[k] at rows cy.i0, cy.i1 and column cx.i0 - 1 + k;
// ya[b], yb[b] at rows cy.i0 - 1, cy.i0 + 2 (clamped to the grid, used
// only where they lie in it) and column cx.i0 + b.  Each row's values sit
// at fixed offsets from one address.
template <typename T>
struct G2PWindow {
  T x0[4], x1[4], ya[2], yb[2];
};

template <typename T>
__device__ __forceinline__ G2PWindow<T> g2p_window(const T* __restrict__ f,
                                                   const FlipAxis<T>& x,
                                                   const FlipAxis<T>& y,
                                                   int n) {
  G2PWindow<T> w;
  const T* r0 = f + (size_t)y.i0 * n + (x.i0 - 1);
  const T* r1 = f + (size_t)y.i1 * n + (x.i0 - 1);
  const T* ra = f + (size_t)flip_clampi(y.i0 - 1, 0, n - 1) * n + x.i0;
  const T* rb = f + (size_t)flip_clampi(y.i0 + 2, 0, n - 1) * n + x.i0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w.x0[k] = __ldg(r0 + k);
    w.x1[k] = __ldg(r1 + k);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    w.ya[k] = __ldg(ra + k);
    w.yb[k] = __ldg(rb + k);
  }
  return w;
}

// The four nodes f00 (y.i0, x.i0), f01 (y.i1, x.i0), f10 (y.i0, x.i1) and
// f11 (y.i1, x.i1) of a sample, from memory.
template <typename T>
__device__ __forceinline__ void nodes_of(const T* __restrict__ f,
                                         const FlipAxis<T>& x,
                                         const FlipAxis<T>& y, int n,
                                         T (&q)[4]) {
  const T* r0 = f + (size_t)y.i0 * n;
  const T* r1 = f + (size_t)y.i1 * n;
  q[0] = __ldg(r0 + x.i0);
  q[1] = __ldg(r1 + x.i0);
  q[2] = __ldg(r0 + x.i1);
  q[3] = __ldg(r1 + x.i1);
}

// The samples shifted by D = +-1 node along x (p = px +- h) keep the
// centre's rows.  Where the sample's base node is the centre's + D and its
// far node the next, its nodes are the window's columns 1 + D and 2 + D of
// rows x0, x1; otherwise (rounding put the floor elsewhere, or the wall
// clip collapsed the nodes) all four come from memory.
template <int D, typename T>
__device__ __forceinline__ void shifted_x(const T* __restrict__ f,
                                          const G2PWindow<T>& w,
                                          bool from_window,
                                          const FlipAxis<T>& x,
                                          const FlipAxis<T>& y, int n,
                                          T (&q)[4]) {
  if (from_window) {
    q[0] = w.x0[1 + D];
    q[1] = w.x1[1 + D];
    q[2] = w.x0[2 + D];
    q[3] = w.x1[2 + D];
  } else {
    nodes_of(f, x, y, n, q);
  }
}

// The samples shifted by D = +-1 node along y keep the centre's columns.
// Where the sample's base row is the centre's + D, its far row the next
// and the centre's far column cx.i0 + 1: D = +1 reads rows cy.i1 (x1) and
// cy.i0 + 2 (yb), D = -1 rows cy.i0 - 1 (ya) and cy.i0 (x0); otherwise
// memory.
template <int D, typename T>
__device__ __forceinline__ void shifted_y(const T* __restrict__ f,
                                          const G2PWindow<T>& w,
                                          bool from_window,
                                          const FlipAxis<T>& x,
                                          const FlipAxis<T>& y, int n,
                                          T (&q)[4]) {
  if (from_window) {
    q[0] = D > 0 ? w.x1[1] : w.ya[0];
    q[1] = D > 0 ? w.yb[0] : w.x0[1];
    q[2] = D > 0 ? w.x1[2] : w.ya[1];
    q[3] = D > 0 ? w.yb[1] : w.x0[2];
  } else {
    nodes_of(f, x, y, n, q);
  }
}

// Whether a sample shifted by D from the centre c takes its nodes from
// the centred window: its base node c.i0 + D and its far node the next.
template <int D, typename T>
__device__ __forceinline__ bool in_window(const FlipAxis<T>& a,
                                          const FlipAxis<T>& c,
                                          bool centred) {
  return centred && a.i0 == c.i0 + D && a.i1 == a.i0 + 1;
}

// One projected field's five samples: the centre and the four shifted
// ones, from the window where it is centred (the centre's columns its
// slots 1 and 2), all from memory otherwise.
template <typename T>
__device__ __forceinline__ void projected_samples(
    const T* __restrict__ f, const FlipAxis<T>& cx, const FlipAxis<T>& cy,
    const FlipAxis<T>& xp, const FlipAxis<T>& xm, const FlipAxis<T>& yp,
    const FlipAxis<T>& ym, bool centred, bool in_xp, bool in_xm, bool in_yp,
    bool in_ym, int n, T& centre, T& sxp, T& sxm, T& syp, T& sym) {
  T q[4];
  if (centred) {
    const G2PWindow<T> w = g2p_window(f, cx, cy, n);
    centre = flip_blend(cx, cy, w.x0[1], w.x1[1], w.x0[2], w.x1[2]);
    shifted_x<1>(f, w, in_xp, xp, cy, n, q);
    sxp = flip_blend(xp, cy, q[0], q[1], q[2], q[3]);
    shifted_x<-1>(f, w, in_xm, xm, cy, n, q);
    sxm = flip_blend(xm, cy, q[0], q[1], q[2], q[3]);
    shifted_y<1>(f, w, in_yp, cx, yp, n, q);
    syp = flip_blend(cx, yp, q[0], q[1], q[2], q[3]);
    shifted_y<-1>(f, w, in_ym, cx, ym, n, q);
    sym = flip_blend(cx, ym, q[0], q[1], q[2], q[3]);
  } else {
    nodes_of(f, cx, cy, n, q);
    centre = flip_blend(cx, cy, q[0], q[1], q[2], q[3]);
    nodes_of(f, xp, cy, n, q);
    sxp = flip_blend(xp, cy, q[0], q[1], q[2], q[3]);
    nodes_of(f, xm, cy, n, q);
    sxm = flip_blend(xm, cy, q[0], q[1], q[2], q[3]);
    nodes_of(f, cx, yp, n, q);
    syp = flip_blend(cx, yp, q[0], q[1], q[2], q[3]);
    nodes_of(f, cx, ym, n, q);
    sym = flip_blend(cx, ym, q[0], q[1], q[2], q[3]);
  }
}

// The explicit minimum of 1 block an SM is not the default's equal: with
// it ptxas gives the float kernel 80 registers for 72, ~2% faster at 2^20
// particles (PERF.md row 18).
template <typename T>
__global__ void __launch_bounds__(G2PThreads<T>::value, 1)
    g2p_kernel(G2PArgs<T> p) {
  using P2 = typename Pair<T>::type;
  const long long k =
      (long long)blockIdx.x * G2PThreads<T>::value + threadIdx.x;
  // the lanes of this warp that hold a particle, for the raster's groups
  const unsigned live = __ballot_sync(0xffffffffu, k < p.np);
  if (k >= p.np) return;
  const int n = p.n;
  const T nm1 = T(n - 1), h = p.h, hi = p.hi, half = T(0.5);
  const P2 pk = __ldg(reinterpret_cast<const P2*>(p.pos) + k);
  const P2 vk = __ldg(reinterpret_cast<const P2*>(p.vel) + k);
  const T px = pk.x, py = pk.y;

  T new_u, new_v, old_u, old_v, ux1, vx1, ux0, vx0, uy1, vy1, uy0, vy0;
  const FlipAxis<T> cx = flip_axis(px, nm1, hi, n);
  const FlipAxis<T> cy = flip_axis(py, nm1, hi, n);
  {
    T q[4];
    nodes_of(p.u_prev, cx, cy, n, q);
    old_u = flip_blend(cx, cy, q[0], q[1], q[2], q[3]);
    nodes_of(p.v_prev, cx, cy, n, q);
    old_v = flip_blend(cx, cy, q[0], q[1], q[2], q[3]);
  }
  const FlipAxis<T> xp = flip_axis(px + h, nm1, hi, n);
  const FlipAxis<T> xm = flip_axis(px - h, nm1, hi, n);
  const FlipAxis<T> yp = flip_axis(py + h, nm1, hi, n);
  const FlipAxis<T> ym = flip_axis(py - h, nm1, hi, n);
  const bool centred = cx.i0 >= 1 && cx.i0 <= n - 3;
  const bool in_xp = in_window<1>(xp, cx, centred);
  const bool in_xm = in_window<-1>(xm, cx, centred);
  const bool in_yp = in_window<1>(yp, cy, centred);
  const bool in_ym = in_window<-1>(ym, cy, centred);
  projected_samples(p.u_proj, cx, cy, xp, xm, yp, ym, centred, in_xp, in_xm,
                    in_yp, in_ym, n, new_u, ux1, ux0, uy1, uy0);
  projected_samples(p.v_proj, cx, cy, xp, xm, yp, ym, centred, in_xp, in_xm,
                    in_yp, in_ym, n, new_v, vx1, vx0, vy1, vy0);
  const T flip_u = (vk.x + new_u) - old_u;
  const T flip_v = (vk.y + new_v) - old_v;
  T vel_x = p.one_m_flip * new_u + p.flip * flip_u;
  T vel_y = p.one_m_flip * new_v + p.flip * flip_v;

  const T lo_w = T(0.01), hi_w = T(0.99), rest = T(-0.35);
  T nx = px + vel_x * p.dt;
  T ny = py + vel_y * p.dt;
  if (nx < lo_w || nx > hi_w) vel_x = vel_x * rest;
  if (ny < lo_w || ny > hi_w) vel_y = vel_y * rest;
  nx = flip_clip(nx, lo_w, hi_w);
  ny = flip_clip(ny, lo_w, hi_w);

  P2 o;
  o.x = nx;
  o.y = ny;
  reinterpret_cast<P2*>(p.pos_out)[k] = o;
  o.x = vel_x;
  o.y = vel_y;
  reinterpret_cast<P2*>(p.vel_out)[k] = o;
  o.x = (half * (ux1 - ux0)) / h;
  o.y = (half * (vx1 - vx0)) / h;
  reinterpret_cast<P2*>(p.ax_out)[k] = o;
  o.x = (half * (uy1 - uy0)) / h;
  o.y = (half * (vy1 - vy0)) / h;
  reinterpret_cast<P2*>(p.ay_out)[k] = o;

  const T tn = T(n);
  const int rx = flip_clampi((int)(nx * tn), 0, n - 1);
  const int ry = flip_clampi((int)(ny * tn), 0, n - 1);
  const int cell = ry * n + rx;
  const unsigned peers = __match_any_sync(live, cell);
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(p.density + cell, __popc(peers));
}

template <typename T>
long long g2p_blocks(long long np) {
  return (np + G2PThreads<T>::value - 1) / G2PThreads<T>::value;
}

template <typename T>
int launch_g2p(const T* pos, const T* vel, const T* u_prev, const T* v_prev,
               const T* u_proj, const T* v_proj, T* pos_out, T* vel_out,
               T* ax_out, T* ay_out, int* density, long long np, int n,
               double flip, double dt, int device, void* stream) {
  if (n < 4) return (int)cudaErrorInvalidValue;  // the window's 4 columns
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const G2PArgs<T> args{pos,     vel,     u_prev,  v_prev,  u_proj,
                        v_proj,  pos_out, vel_out, ax_out,  ay_out,
                        density, np,      n,       T((double)n - 1.001),
                        T(1.0 / (double)(n - 1)),  T(flip), T(1.0 - flip),
                        T(dt)};
  g2p_kernel<T><<<(unsigned)g2p_blocks<T>(np), G2PThreads<T>::value, 0,
                  (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

// The launch for np particles: blocks and threads a block.
int fst_flip_g2p_blocks_f32(long long np, fst::TileLaunch* out) {
  *out = fst::TileLaunch{(int)fst::g2p_blocks<float>(np),
                         fst::G2PThreads<float>::value, 0, 0, 0, 0};
  return 0;
}

int fst_flip_g2p_blocks_f64(long long np, fst::TileLaunch* out) {
  *out = fst::TileLaunch{(int)fst::g2p_blocks<double>(np),
                         fst::G2PThreads<double>::value, 0, 0, 0, 0};
  return 0;
}

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
