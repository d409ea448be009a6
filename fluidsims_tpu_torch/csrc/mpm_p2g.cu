// Particle-to-grid transfer of MLS-MPM, for float and double: each particle
// adds its quadratic-B-spline-weighted mass, and its momentum plus the
// stress force, to the 3 x 3 grid nodes from its base node, into three
// (Gy, Gx) grids that the launch zeroes itself.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/mpm_pallas.py::_p2g_kernel
// (pallas_call at :190).  The TPU has no fast scatter, so that kernel read
// particles binned into a (16, K, rows * 128) slab, K slots a cell (the
// particles past K dropped), and summed the 9 offsets as lane shifts of
// dense rows.  This kernel keeps the reference's k_p2g (tau_mpm.cu:
// 123-183) as JAX's exact scatter engine writes it (solvers/mpm.py::_p2g):
// no capacity, no particle dropped.  Per particle: the base node and
// fraction, the weights, Fe and the stress inline (csrc/mpm.cuh); per
// offset (ox outer, oy inner) the target is dropped where it lies outside
// the grid (JAX's mode="drop"; FLIP's P2G clips instead), w = wx wy,
// dpos = (o - f) dx, force = stress dpos, and w pm, w (pm vx + fx), w (pm
// vy + fy) are added.  Adds land in no fixed order, and exp and log are
// CUDA's, so a node's sum matches the plain version's to rounding, not
// bitwise.
//
// Two designs (csrc/p2g_tiles.cuh), the wrapper's pick from the particles
// (FST_P2G_TILED_FROM).  The first, atomic one: one thread a particle, 27
// global atomicAdds, after a memset of the grids.  What bounds it: the
// adds, resolved in L2, where ~19 particles a cell add to the same nodes
// and the lanes of a warp, neighbours in the raster order the state keeps,
// hit the same few (0.1385-0.1389 ms of device time at 2^20 particles on
// 512^2, 11x its bound, NVIDIA H100 80GB HBM3 at 700 W, PERF.md).  The
// tiled one, from 2^18 particles: binned by tile of 16 x 16 shifted base
// nodes, chunks of 512 sorted by cell, one global add a target for each
// run of a cell's particles in a warp (about one a cell where the atomic
// design makes one a particle); a particle whose base leaves every target
// outside the grid (base -3 or g, as mpm_base clamps it, also a
// non-finite position) joins no tile.  What bounds it now: the chunks'
// phase, latency-bound staging (two dependent gathers and a sort a chunk)
// and the instructions of the segmented scans over 27 values a lane, then
// the two passes over the particles that bin them (0.0906-0.0915 ms at
// 2^20).  Below 2^18 particles its four phases and three grid syncs cost
// more than the atomic design's adds.  The tile, chunk and threads come
// from the sweep of tools/tune_tiles_torch.py (`--set p2g`, builds with
// -DFST_MPM_P2G_...): 8x8 tiles, chunks of 128, 256 or 1024 and 512
// threads ran no faster at 2^20.
#include <cuda_runtime.h>

#include "mpm.cuh"
#include "p2g_tiles.cuh"

namespace fst {
namespace {

// The tile of base nodes, particles a chunk and threads a block.
#ifndef FST_MPM_P2G_TILE_X
#define FST_MPM_P2G_TILE_X 16
#endif
#ifndef FST_MPM_P2G_TILE_Y
#define FST_MPM_P2G_TILE_Y 16
#endif
#ifndef FST_MPM_P2G_CHUNK
#define FST_MPM_P2G_CHUNK 512
#endif
#ifndef FST_MPM_P2G_THREADS
#define FST_MPM_P2G_THREADS 256
#endif
constexpr int kMPMP2GTileX = FST_MPM_P2G_TILE_X;
constexpr int kMPMP2GTileY = FST_MPM_P2G_TILE_Y;
constexpr int kMPMP2GChunk = FST_MPM_P2G_CHUNK;
constexpr int kMPMP2GThreads = FST_MPM_P2G_THREADS;

// The MPM particles of a launch and what p2g_tiled_kernel asks of them.
template <typename T>
struct MPMParticles {
  static constexpr int kFields = 9;  // pos 2, vel 2, F 4, Jp 1
  const T* pos;   // (np, 2)
  const T* vel;   // (np, 2)
  const T* F;     // (np, 2, 2)
  const T* Jp;    // (np,)
  MPMConsts<T> c;

  // The base node of position (px, py) shifted by (2, 2), into [0, g + 2)
  // along each axis; false where no target lies inside the grid (base -3
  // or g, as mpm_base clamps it: also a non-finite position).
  __device__ __forceinline__ bool shifted_base(T px, T py, int& sx,
                                               int& sy) const {
    T f;
    sx = mpm_base(px, c.inv_dx, c.gx, f) + 2;
    sy = mpm_base(py, c.inv_dx, c.gy, f) + 2;
    return sx >= 0 && sx < c.gx + 2 && sy >= 0 && sy < c.gy + 2;
  }

  // The tile of particle k, -1 where no target lies inside the grid.
  __device__ __forceinline__ int tile_of(long long k,
                                         const P2GTiling& t) const {
    int sx, sy;
    return shifted_base(__ldg(pos + 2 * k), __ldg(pos + 2 * k + 1), sx, sy)
               ? p2g_tile(t, sx, sy)
               : -1;
  }

  // Particle k's fields into s[0], s[fs], ..., s[8 fs].
  __device__ __forceinline__ void stage(int k, T* s, int fs) const {
    s[0] = __ldg(pos + 2 * k);
    s[fs] = __ldg(pos + 2 * k + 1);
    s[2 * fs] = __ldg(vel + 2 * k);
    s[3 * fs] = __ldg(vel + 2 * k + 1);
#pragma unroll
    for (int i = 0; i < 4; ++i) s[(4 + i) * fs] = __ldg(F + 4 * k + i);
    s[8 * fs] = __ldg(Jp + k);
  }

  // A staged particle's 9 targets, ox outer and oy inner: w pm, w (pm vx
  // + fx), w (pm vy + fy), those outside the grid dropped.
  __device__ __forceinline__ void scatter(const T* s, int fs,
                                          P2GTargets<T>& q) const {
    T fx, fy;
    const int bx = mpm_base(s[0], c.inv_dx, c.gx, fx);
    const int by = mpm_base(s[fs], c.inv_dx, c.gy, fy);
    T wx[3], wy[3];
    mpm_bspline(fx, wx);
    mpm_bspline(fy, wy);
    const Mat2<T> F{s[4 * fs], s[5 * fs], s[6 * fs], s[7 * fs]};
    const Mat2<T> st = mpm_stress(mpm_elastic(F, c), s[8 * fs], c);
    const T mvx = c.pm * s[2 * fs];
    const T mvy = c.pm * s[3 * fs];
#pragma unroll
    for (int ox = 0; ox < 3; ++ox) {
      const int ix = bx + ox;
      const bool in_x = ix >= 0 && ix < c.gx;
      const T dposx = (T(ox) - fx) * c.dx;
#pragma unroll
      for (int oy = 0; oy < 3; ++oy) {
        const int j = 3 * ox + oy, iy = by + oy;
        const T w = wx[ox] * wy[oy];
        const T dposy = (T(oy) - fy) * c.dx;
        const T fcx = st.a00 * dposx + st.a01 * dposy;
        const T fcy = st.a10 * dposx + st.a11 * dposy;
        q.inside[j] = in_x && iy >= 0 && iy < c.gy;
        q.use[j] = true;
        q.node[j] = iy * c.gx + ix;
        q.v[j][0] = w * c.pm;
        q.v[j][1] = w * (mvx + fcx);
        q.v[j][2] = w * (mvy + fcy);
      }
    }
  }
};

template <typename T>
auto kernel() {
  return p2g_tiled_kernel<T, MPMParticles<T>, kMPMP2GThreads>;
}

template <typename T>
int query(long long np, int gx, int gy, int design, int device,
          P2GLaunch* out) {
  return p2g_query<T>(kernel<T>(), np, gx, gy, design, kMPMP2GTileX,
                      kMPMP2GTileY, kMPMP2GChunk, kMPMP2GThreads,
                      MPMParticles<T>::kFields, device, out);
}

template <typename T>
int launch_p2g(const T* pos, const T* vel, const T* F, const T* Jp, T* mass,
               T* mom_x, T* mom_y, int* scratch, unsigned long long* words,
               long long np, const MPMConsts<T>& c, int design, int grid,
               int device, void* stream) {
  P2GLaunch l;
  P2GTiling t;
  const int err = p2g_shape<T>(np, c.gx, c.gy, design, kMPMP2GTileX,
                               kMPMP2GTileY, kMPMP2GChunk, kMPMP2GThreads,
                               MPMParticles<T>::kFields, &l, &t);
  if (err != 0) return err;
  const P2GArgs<T, MPMParticles<T>> args{
      {pos, vel, F, Jp, c}, mass, mom_x, mom_y, scratch, words, (int)np, t};
  return p2g_launch(kernel<T>(), args, l, grid, device, stream);
}

}  // namespace
}  // namespace fst

extern "C" {

// The launch of `design` (-1: the one the size picks, 0 atomic, 1 tiled)
// for np particles on a (gy, gx) grid on `device` (fst::P2GLaunch: design,
// blocks, threads, tile, chunk, dynamic shared memory, grid syncs, scratch
// words): the wrapper asks once per (np, grid, dtype, device, design) and
// passes the design and blocks to every launch.
int fst_mpm_p2g_blocks_f32(long long np, int gx, int gy, int design,
                           int device, fst::P2GLaunch* out) {
  return fst::query<float>(np, gx, gy, design, device, out);
}

int fst_mpm_p2g_blocks_f64(long long np, int gx, int gy, int design,
                           int device, fst::P2GLaunch* out) {
  return fst::query<double>(np, gx, gy, design, device, out);
}

// scratch holds the query's scratch_ints words, zero when first used (a
// tiled launch leaves its tile counts at 0); `words` kTileWords words, the
// launch leaves the count of its grid syncs in the last.  mom_x and mom_y
// right after mass (as one (3, Gy, Gx) buffer) take one memset in the
// atomic design.
int fst_mpm_p2g_f32(const float* pos, const float* vel, const float* F,
                    const float* Jp, float* mass, float* mom_x, float* mom_y,
                    int* scratch, unsigned long long* words, long long np,
                    const fst::MPMConsts<float>* c, int design, int grid,
                    int device, void* stream) {
  return fst::launch_p2g<float>(pos, vel, F, Jp, mass, mom_x, mom_y, scratch,
                                words, np, *c, design, grid, device, stream);
}

int fst_mpm_p2g_f64(const double* pos, const double* vel, const double* F,
                    const double* Jp, double* mass, double* mom_x,
                    double* mom_y, int* scratch, unsigned long long* words,
                    long long np, const fst::MPMConsts<double>* c,
                    int design, int grid, int device, void* stream) {
  return fst::launch_p2g<double>(pos, vel, F, Jp, mass, mom_x, mom_y,
                                 scratch, words, np, *c, design, grid,
                                 device, stream);
}

}  // extern "C"
