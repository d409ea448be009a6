// Particle-to-grid transfer of FLIP/APIC, for float and double: each
// particle adds its hat-weighted mass and APIC momentum to the 3 x 3 grid
// nodes around its base node, into three (n, n) grids that the launch
// zeroes itself.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/flip_pallas.py::
// _p2g_kernel (pallas_call at :271).  The TPU has no fast scatter, so that
// kernel read particles binned into a (14, K, cells) slab, K slots a cell
// (particles past K dropped), and summed the 9 offsets' weight products
// over K as dense row windows.  This kernel keeps the reference's k_p2g
// (tau_flip_apic.cu:105-131) as JAX's exact scatter engine writes it
// (solvers/flip_apic.py::_p2g): no capacity, no particle dropped.  For
// each offset the target index is clipped to [0, n - 1] (at a wall the
// out-of-grid offset folds onto the wall node with the clipped index's
// weight, as the reference's clip does), wt = w1(gx - i) w1(gy - j), r =
// (node - g) / (n - 1) a true division (formed once a column and once a
// row), vv = vel + apic (a_x rx + a_y ry), and wt, wt vvx, wt vvy are added
// where wt > 0.  apic is a launch argument, so a per-call override needs
// no other build.  Adds land in no fixed order, so a node's sum matches
// the plain version's `index_add_` to rounding, not bitwise (nor does
// index_add_ repeat itself on the card).
//
// Two designs (csrc/p2g_tiles.cuh), the wrapper's pick from the particles
// (FST_P2G_TILED_FROM).  The first, atomic one: one thread a particle, a
// global atomicAdd for each field at each target where wt > 0, after a
// memset of the grids.  What bounds it: the adds, resolved in L2, where
// the lanes of a warp hit the same nodes (0.1628-0.1641 ms of device time
// at 2^20 particles on 512^2, 15x its bound, NVIDIA H100 80GB HBM3 at
// 700 W, PERF.md).  The tiled one, from 2^18 particles: binned by tile of
// 16 x 16 shifted base nodes (the base clamped to [-1, n], plus 1), chunks
// of 512 sorted by cell, one global add a target for each run of a cell's
// particles in a warp.  What bounds it now: the chunks' phase, staging
// (two dependent gathers and a sort a chunk) and the segmented scans, then
// the passes that bin (0.0848-0.0856 ms at 2^20).  The tile, chunk and
// threads come from the sweep of tools/tune_tiles_torch.py (`--set p2g`,
// builds with -DFST_FLIP_P2G_...): chunks of 256 (0.0911 ms) and 1024
// (0.0955), 128 threads (0.1003) and 8x8 tiles (0.1204) ran slower.
#include <cuda_runtime.h>

#include "flip.cuh"
#include "p2g_tiles.cuh"

namespace fst {
namespace {

// The tile of base nodes, particles a chunk and threads a block.
#ifndef FST_FLIP_P2G_TILE_X
#define FST_FLIP_P2G_TILE_X 16
#endif
#ifndef FST_FLIP_P2G_TILE_Y
#define FST_FLIP_P2G_TILE_Y 16
#endif
#ifndef FST_FLIP_P2G_CHUNK
#define FST_FLIP_P2G_CHUNK 512
#endif
#ifndef FST_FLIP_P2G_THREADS
#define FST_FLIP_P2G_THREADS 256
#endif
constexpr int kFlipP2GTileX = FST_FLIP_P2G_TILE_X;
constexpr int kFlipP2GTileY = FST_FLIP_P2G_TILE_Y;
constexpr int kFlipP2GChunk = FST_FLIP_P2G_CHUNK;
constexpr int kFlipP2GThreads = FST_FLIP_P2G_THREADS;

// The FLIP particles of a launch and what p2g_tiled_kernel asks of them.
template <typename T>
struct FlipParticles {
  static constexpr int kFields = 8;  // pos, vel, affine_x, affine_y: 2 each
  const T* pos;   // (np, 2)
  const T* vel;
  const T* ax;    // APIC d(vel)/dx
  const T* ay;    // APIC d(vel)/dy
  int n;
  T apic;

  // A coordinate's base node, clamped to [-1, n]: a base past it clips to
  // the same targets, and the clamp keeps base + offset from overflowing
  // for non-finite input.
  __device__ __forceinline__ int base(T g) const {
    return flip_clampi((int)floor(g), -1, n);
  }

  // The base node of position (px, py) shifted by (1, 1), into [0, n + 2)
  // along each axis (every particle has targets: clipped ones).
  __device__ __forceinline__ bool shifted_base(T px, T py, int& sx,
                                               int& sy) const {
    const T nm1 = T(n - 1);
    sx = base(px * nm1) + 1;
    sy = base(py * nm1) + 1;
    return true;
  }

  __device__ __forceinline__ int tile_of(long long k,
                                         const P2GTiling& t) const {
    int sx, sy;
    shifted_base(__ldg(pos + 2 * k), __ldg(pos + 2 * k + 1), sx, sy);
    return p2g_tile(t, sx, sy);
  }

  // Particle k's fields into s[0], s[fs], ..., s[7 fs].
  __device__ __forceinline__ void stage(int k, T* s, int fs) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s[i * fs] = __ldg(pos + 2 * k + i);
      s[(2 + i) * fs] = __ldg(vel + 2 * k + i);
      s[(4 + i) * fs] = __ldg(ax + 2 * k + i);
      s[(6 + i) * fs] = __ldg(ay + 2 * k + i);
    }
  }

  // A staged particle's 9 targets, oy outer and ox inner: wt, wt vvx, wt
  // vvy at each clipped target, added where wt > 0.
  __device__ __forceinline__ void scatter(const T* s, int fs,
                                          P2GTargets<T>& q) const {
    const T nm1 = T(n - 1);
    const T gx = s[0] * nm1;
    const T gy = s[fs] * nm1;
    const T vx = s[2 * fs], vy = s[3 * fs];
    const T ax0 = s[4 * fs], ax1 = s[5 * fs];
    const T ay0 = s[6 * fs], ay1 = s[7 * fs];
    const int bx = base(gx), by = base(gy);
    // the three columns' index, weight and rx, each formed once
    int col[3];
    T wx[3], rx[3];
#pragma unroll
    for (int ox = -1; ox <= 1; ++ox) {
      col[ox + 1] = flip_clampi(bx + ox, 0, n - 1);
      wx[ox + 1] = flip_w1(gx - T(col[ox + 1]));
      rx[ox + 1] = (T(col[ox + 1]) - gx) / nm1;
    }
#pragma unroll
    for (int oy = -1; oy <= 1; ++oy) {
      const int j = flip_clampi(by + oy, 0, n - 1);
      const T wy = flip_w1(gy - T(j));
      const T ry = (T(j) - gy) / nm1;
#pragma unroll
      for (int ox = 0; ox < 3; ++ox) {
        const int k = 3 * (oy + 1) + ox;
        const T wt = wx[ox] * wy;
        const T vvx = vx + apic * (ax0 * rx[ox] + ay0 * ry);
        const T vvy = vy + apic * (ax1 * rx[ox] + ay1 * ry);
        q.inside[k] = true;
        q.use[k] = wt > T(0);
        q.node[k] = j * n + col[ox];
        q.v[k][0] = wt;
        q.v[k][1] = wt * vvx;
        q.v[k][2] = wt * vvy;
      }
    }
  }
};

template <typename T>
auto kernel() {
  return p2g_tiled_kernel<T, FlipParticles<T>, kFlipP2GThreads>;
}

template <typename T>
int query(long long np, int n, int design, int device, P2GLaunch* out) {
  return p2g_query<T>(kernel<T>(), np, n, n, design, kFlipP2GTileX,
                      kFlipP2GTileY, kFlipP2GChunk, kFlipP2GThreads,
                      FlipParticles<T>::kFields, device, out);
}

template <typename T>
int launch_p2g(const T* pos, const T* vel, const T* ax, const T* ay, T* mass,
               T* mom_u, T* mom_v, int* scratch, unsigned long long* words,
               long long np, int n, double apic, int design, int grid,
               int device, void* stream) {
  P2GLaunch l;
  P2GTiling t;
  const int err = p2g_shape<T>(np, n, n, design, kFlipP2GTileX,
                               kFlipP2GTileY, kFlipP2GChunk, kFlipP2GThreads,
                               FlipParticles<T>::kFields, &l, &t);
  if (err != 0) return err;
  if (n < 2) return (int)cudaErrorInvalidValue;
  const P2GArgs<T, FlipParticles<T>> args{
      {pos, vel, ax, ay, n, T(apic)}, mass, mom_u, mom_v, scratch, words,
      (int)np, t};
  return p2g_launch(kernel<T>(), args, l, grid, device, stream);
}

}  // namespace
}  // namespace fst

extern "C" {

// The launch of `design` (-1: the one the size picks, 0 atomic, 1 tiled)
// for np particles on an (n, n) grid on `device` (fst::P2GLaunch: design,
// blocks, threads, tile, chunk, dynamic shared memory, grid syncs, scratch
// words): the wrapper asks once per (np, n, dtype, device, design) and
// passes the design and blocks to every launch.
int fst_flip_p2g_blocks_f32(long long np, int n, int design, int device,
                            fst::P2GLaunch* out) {
  return fst::query<float>(np, n, design, device, out);
}

int fst_flip_p2g_blocks_f64(long long np, int n, int design, int device,
                            fst::P2GLaunch* out) {
  return fst::query<double>(np, n, design, device, out);
}

// scratch holds the query's scratch_ints words, zero when first used (a
// tiled launch leaves its tile counts at 0); `words` kTileWords words, the
// launch leaves the count of its grid syncs in the last.  mom_u and mom_v
// right after mass (as one (3, n, n) buffer) take one memset in the atomic
// design.
int fst_flip_p2g_f32(const float* pos, const float* vel, const float* ax,
                     const float* ay, float* mass, float* mom_u, float* mom_v,
                     int* scratch, unsigned long long* words, long long np,
                     int n, double apic, int design, int grid, int device,
                     void* stream) {
  return fst::launch_p2g<float>(pos, vel, ax, ay, mass, mom_u, mom_v, scratch,
                                words, np, n, apic, design, grid, device,
                                stream);
}

int fst_flip_p2g_f64(const double* pos, const double* vel, const double* ax,
                     const double* ay, double* mass, double* mom_u,
                     double* mom_v, int* scratch, unsigned long long* words,
                     long long np, int n, double apic, int design, int grid,
                     int device, void* stream) {
  return fst::launch_p2g<double>(pos, vel, ax, ay, mass, mom_u, mom_v,
                                 scratch, words, np, n, apic, design, grid,
                                 device, stream);
}

}  // extern "C"
