// The grid phase of FLIP/APIC in one launch, for float and double: from the
// P2G grids (mass, mom_u, mom_v) to u_prev, v_prev (normalized, gravity,
// wall clamps) and the projected u_proj, v_proj, through the divergence
// and `jacobi` Jacobi pressure sweeps from p = 0, on any (n, n) grid.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/flip_pallas.py::
// _grid_kernel (pallas_call at :287), which held the 128^2 grids in VMEM
// and ran every phase there.
//
// The arithmetic is JAX's XLA function (solvers/flip_apic.py::_grid_phase,
// :181-224), not the Pallas kernel's (which multiplies by 0.5/(n - 1)):
//   u = mom_u / max(mass, 1e-8) where mass > 1e-8 (else mom_u), v likewise
//   minus gravity*dt; u = 0 on the columns 0 and n - 1, v = 0 on those
//   rows; div = -0.5 (n - 1) ((u_E - u_W) + v_N - v_S) on the interior;
//   p <- 0.25 ((((div + p_W) + p_E) + p_S) + p_N) on the interior, the
//   ring 0; u_proj = u - (0.5 (p_E - p_W)) / (n - 1), v_proj likewise, a
//   true division, and a zero ring.
// With those orders and -fmad=false the result is bitwise that of the
// plain version; the first sweep adds the zeros of p = 0 as the plain
// version does (a -0 divergence turns +0 there).
//
// What bounded the first design: a block of an H100 cannot hold the f64
// grids (or a large n), so it spread each phase over the card as a
// grid-stride loop and separated the phases by grid syncs: jacobi + 2 a
// launch, 50 at 48 sweeps, ~1.5 us each, for a few hundred operations a
// cell (0.077 ms at 128^2, 0.136 ms at 512^2).
//
// The design: temporal blocking, as csrc/stam2d_lin_solve.cu.  Each block
// owns tiles (a persistent cooperative grid, grid_reduce.cuh, walks them
// when there are more tiles than resident blocks).  The sweeps run in
// phases of h (the last phase takes the rest, jacobi - h (phases - 1),
// also when jacobi < h); one grid sync separates two phases:
// max(ceil(jacobi / h), 1) - 1 a launch (5 at 48 sweeps with h = 8),
// counted by the kernel (tiles.cuh CountedGrid).  A phase of `count`
// sweeps works on its tile's window, the tile and a halo of count + r
// cells (r = 1 in the last phase, whose p must be right one cell past the
// tile for the projection, else 0), in shared memory; sweep k is right on
// the window less a ring of k cells, and the sweeps are separated by
// __syncthreads.
//   * The first phase fuses normalize and divergence: it loads mass and
//     momentum on the window, forms u and v there (the wall clamps on
//     global coordinates; cells past the grid hold 0, read by no interior
//     cell), writes u_prev and v_prev of the tile, forms div on the window
//     less its ring (and writes the tile's div when later phases need
//     it), sets p = 0 and runs its sweeps.
//   * A later phase loads p (the phase before's) and div on its window.
//   * A phase that is not the last writes p of the tile's interior cells
//     from its last sweep; the last one projects the tile from its p and
//     u_prev, v_prev (the first phase's, in shared memory when it is also
//     the last) and writes u_proj, v_proj.
// Window cells outside the interior [1, n - 2]^2 hold p = 0, as the
// plain version's ring: they are loaded as 0, set to 0 by every sweep and
// never written.  p ping-pongs between two scratch fields across phases;
// div is a third.  Fields written during the launch are read with plain
// loads, not __ldg: the read-only cache is not coherent with other
// blocks' writes.
//
// h is kFlipSweeps; the tile and the threads a block are picked from n
// before the launch (one value for float and double): kFlipSmall* at
// n <= kFlipSmallN, where the grid has few cells and small tiles keep most
// SMs busy (16 x 8 at 128^2: 128 tiles), else kFlip* (64 x 32 at 512^2:
// 128 tiles); the grid query reports them (fst_flip_grid_blocks_*).  The
// constants come from the measurements of tools/tune_tiles_torch.py
// (`--set flip`, which builds variants with -DFST_FLIP_...): h = 6, 12, 16
// or 24, 16x16, 8x8 and 32x16 tiles at 128^2, and 32x32, 64x16 or 64x64 at
// 512^2 ran slower.
//
// What bounds it now: the bytes stay few (3 grids in, 4 out: 448 KiB at
// 128^2 f32, ~0.13 us at 3.35 TB/s) and the sweeps' work in shared memory
// is ~2-4x the tile's cells (the halos shrink sweep by sweep); what sets
// the pace is the chain of jacobi dependent sweeps, each a round of
// shared-memory loads and a block barrier, plus a grid sync a phase
// (0.033 ms a launch at 128^2, ~0.7 us a sweep; 0.075 ms at 512^2).
#include <cuda_runtime.h>

#include "tiles.cuh"

namespace fst {
namespace {

// The sweeps a phase (h, both size classes), and the tiles and threads a
// block for n > kFlipSmallN and for n <= kFlipSmallN.
#ifndef FST_FLIP_TILE_X
#define FST_FLIP_TILE_X 64
#endif
#ifndef FST_FLIP_TILE_Y
#define FST_FLIP_TILE_Y 32
#endif
#ifndef FST_FLIP_SWEEPS
#define FST_FLIP_SWEEPS 8
#endif
#ifndef FST_FLIP_THREADS
#define FST_FLIP_THREADS 512
#endif
#ifndef FST_FLIP_SMALL_N
#define FST_FLIP_SMALL_N 256
#endif
#ifndef FST_FLIP_SMALL_TILE_X
#define FST_FLIP_SMALL_TILE_X 16
#endif
#ifndef FST_FLIP_SMALL_TILE_Y
#define FST_FLIP_SMALL_TILE_Y 8
#endif
#ifndef FST_FLIP_SMALL_THREADS
#define FST_FLIP_SMALL_THREADS 256
#endif
constexpr int kFlipTileX = FST_FLIP_TILE_X;
constexpr int kFlipTileY = FST_FLIP_TILE_Y;
constexpr int kFlipSweeps = FST_FLIP_SWEEPS;
constexpr int kFlipThreads = FST_FLIP_THREADS;
constexpr int kFlipSmallN = FST_FLIP_SMALL_N;
constexpr int kFlipSmallTileX = FST_FLIP_SMALL_TILE_X;
constexpr int kFlipSmallTileY = FST_FLIP_SMALL_TILE_Y;
constexpr int kFlipSmallThreads = FST_FLIP_SMALL_THREADS;
constexpr int kFlipMaxThreads =
    kFlipThreads > kFlipSmallThreads ? kFlipThreads : kFlipSmallThreads;
// Shared-memory windows a block: u, v, div and the p ping-pong.
constexpr int kFlipWindows = 5;

template <typename T>
struct GridArgs {
  const T* mass;
  const T* mom_u;
  const T* mom_v;
  T* u_prev;
  T* v_prev;
  T* u_proj;
  T* v_proj;
  T* div;     // scratch (n, n): the divergence (interior only)
  T* pa;      // scratch (n, n) x 2: the pressure ping-pong (interior only)
  T* pb;
  unsigned long long* words;  // kTileWords; the last takes the sync count
  int n;
  int jacobi;
  int sweeps;                 // h: sweeps a phase
  int tile_x, tile_y;         // the tile, clipped to the grid
  int tiles_x, tiles, window; // window: cells of a window of halo h + 1
  T gdt;                      // gravity * dt, rounded once from double
};

template <typename T>
__global__ void __launch_bounds__(kFlipMaxThreads)
grid_kernel(GridArgs<T> p) {
  CountedGrid grid = counted_grid();
  extern __shared__ __align__(16) unsigned char fst_smem[];
  T* sU = reinterpret_cast<T*>(fst_smem);
  T* sV = sU + p.window;
  T* sD = sV + p.window;
  T* sP[2] = {sD + p.window, sD + 2 * p.window};
  const int n = p.n;
  const T zero = T(0), eps = T(1e-8), nm1 = T(n - 1);
  const T cdiv = T(-0.5 * (double)(n - 1)), quarter = T(0.25),
          half = T(0.5);
  const auto interior = [n](int j, int i) {
    return j >= 1 && j <= n - 2 && i >= 1 && i <= n - 2;
  };
  const int phases =
      p.jacobi > 0 ? (p.jacobi + p.sweeps - 1) / p.sweeps : 1;
  const T* src = p.pa;  // p of the phase before (unread by the first)
  for (int ph = 0; ph < phases; ++ph) {
    const bool last = ph + 1 == phases;
    const int count = last ? p.jacobi - ph * p.sweeps : p.sweeps;
    const int halo = count + (last ? 1 : 0);
    T* dst = (ph % 2 == 0) ? p.pa : p.pb;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const Window w = window_of(tile, p.tiles_x, p.tile_x, p.tile_y, halo);
      const int wx = w.wx, wy = w.wy;
      const auto in_tile = [&](int ly, int lx) {
        return ly >= halo && ly < wy - halo && lx >= halo && lx < wx - halo;
      };
      if (ph == 0) {
        // normalize + gravity + wall clamps (k_normalize_forces, :133-150)
        for_region(0, wy, 0, wx, wx, [&](int ly, int lx, int c) {
          const int j = w.oy + ly, i = w.ox + lx;
          T u = zero, v = zero;
          if (j >= 0 && j < n && i >= 0 && i < n) {
            const long long s = (long long)j * n + i;
            const T m = __ldg(p.mass + s);
            const T mm = m < eps ? eps : m;  // torch.clamp_min: NaN passes
            const bool has = m > eps;
            const T mu = __ldg(p.mom_u + s), mv = __ldg(p.mom_v + s);
            u = has ? mu / mm : mu;
            v = has ? mv / mm - p.gdt : mv;
            if (i == 0 || i == n - 1) u = zero;
            if (j == 0 || j == n - 1) v = zero;
            if (in_tile(ly, lx)) {
              p.u_prev[s] = u;
              p.v_prev[s] = v;
            }
          }
          sU[c] = u;
          sV[c] = v;
          sP[0][c] = zero;
        });
        __syncthreads();
        if (count > 0) {
          // divergence on the interior (k_divergence, :152-161)
          for_region(1, wy - 1, 1, wx - 1, wx, [&](int ly, int lx, int c) {
            const int j = w.oy + ly, i = w.ox + lx;
            T d = zero;
            if (interior(j, i)) {
              d = cdiv * (((sU[c + 1] - sU[c - 1]) + sV[c + wx]) - sV[c - wx]);
              if (!last && in_tile(ly, lx)) p.div[(long long)j * n + i] = d;
            }
            sD[c] = d;
          });
          __syncthreads();
        }
      } else {
        const T* const g[2] = {src, p.div};
        T* const sd[2] = {sP[0], sD};
        load_window<2>(wy, wx, [&](int ly, int lx) {
          const int j = w.oy + ly, i = w.ox + lx;
          return interior(j, i) ? (long long)j * n + i : -1ll;
        }, g, sd);
        __syncthreads();
      }
      // Jacobi pressure (k_jacobi, :162-172); the ring stays 0
      for (int k = 1; k <= count; ++k) {
        const T* ps = sP[(k - 1) & 1];
        T* pd = sP[k & 1];
        const bool out = !last && k == count;
        for_region(k, wy - k, k, wx - k, wx, [&](int ly, int lx, int c) {
          const int j = w.oy + ly, i = w.ox + lx;
          const bool in = interior(j, i);
          const T val =
              in ? quarter *
                       ((((sD[c] + ps[c - 1]) + ps[c + 1]) + ps[c - wx]) +
                        ps[c + wx])
                 : zero;
          if (out) {  // the tile: its interior cells into the next phase's p
            if (in) dst[(long long)j * n + i] = val;
            return;
          }
          pd[c] = val;
        });
        __syncthreads();
      }
      if (last) {
        // projection on the interior (k_project, :173-184); zero ring
        const T* ps = sP[count & 1];
        for_region(halo, wy - halo, halo, wx - halo, wx,
                   [&](int ly, int lx, int c) {
          const int j = w.oy + ly, i = w.ox + lx;
          if (j >= n || i >= n) return;  // past a ragged tile's edge
          const long long s = (long long)j * n + i;
          T up = zero, vp = zero;
          if (interior(j, i)) {
            const T u = ph == 0 ? sU[c] : p.u_prev[s];
            const T v = ph == 0 ? sV[c] : p.v_prev[s];
            up = u - (half * (ps[c + 1] - ps[c - 1])) / nm1;
            vp = v - (half * (ps[c + wx] - ps[c - wx])) / nm1;
          }
          p.u_proj[s] = up;
          p.v_proj[s] = vp;
        });
        __syncthreads();
      }
    }
    if (!last) grid.sync();
    src = dst;
  }
  grid.write_syncs(p.words);
}

// The kernel's args (pointers and jacobi aside), its threads a block and
// dynamic shared memory on an (n, n) grid: the tile, sweeps and threads of
// n's size class; cudaErrorInvalidValue for a grid it does not take.
template <typename T>
int make_args(int n, GridArgs<T>* a, int* threads, size_t* smem) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const bool small = n <= kFlipSmallN;
  a->n = n;
  a->sweeps = kFlipSweeps;
  a->tile_x = tile_of(small ? kFlipSmallTileX : kFlipTileX, n);
  a->tile_y = tile_of(small ? kFlipSmallTileY : kFlipTileY, n);
  a->tiles_x = (n + a->tile_x - 1) / a->tile_x;
  a->tiles = a->tiles_x * ((n + a->tile_y - 1) / a->tile_y);
  const int reach = 2 * (a->sweeps + 1);
  a->window = (a->tile_x + reach) * (a->tile_y + reach);
  *threads = small ? kFlipSmallThreads : kFlipThreads;
  *smem = (size_t)kFlipWindows * a->window * sizeof(T);
  return threads_ok(*threads, kFlipMaxThreads) ? 0
                                                : (int)cudaErrorInvalidValue;
}

// The launch on an (n, n) grid: make_args's tile, threads and shared
// memory, the sweeps a phase as the halo, and the blocks of a cooperative
// launch over the tiles.
template <typename T>
int grid_launch(int n, int device, TileLaunch* out) {
  GridArgs<T> a{};
  int threads = 0;
  size_t smem = 0;
  const int err = make_args(n, &a, &threads, &smem);
  if (err != 0) return err;
  *out = {0, threads, a.tile_x, a.tile_y, a.sweeps, (int)smem};
  return cooperative_blocks(grid_kernel<T>, a.tiles, device, &out->grid,
                            smem, threads);
}

template <typename T>
int launch_grid(const T* mass, const T* mom_u, const T* mom_v, T* u_prev,
                T* v_prev, T* u_proj, T* v_proj, T* scratch,
                unsigned long long* words, int n, int jacobi, double gdt,
                int grid, int device, void* stream) {
  GridArgs<T> args{};
  int threads = 0;
  size_t smem = 0;
  const int err = make_args(n, &args, &threads, &smem);
  if (err != 0) return err;
  if (jacobi < 0) return (int)cudaErrorInvalidValue;
  const size_t cells = (size_t)n * n;
  args.mass = mass;
  args.mom_u = mom_u;
  args.mom_v = mom_v;
  args.u_prev = u_prev;
  args.v_prev = v_prev;
  args.u_proj = u_proj;
  args.v_proj = v_proj;
  args.div = scratch;
  args.pa = scratch + cells;
  args.pb = scratch + 2 * cells;
  args.words = words;
  args.jacobi = jacobi;
  args.gdt = T(gdt);
  return on_device(device, [&] {
    return launch_cooperative_on(grid_kernel<T>, args, grid, device, stream,
                                 smem, threads);
  });
}

}  // namespace
}  // namespace fst

extern "C" {

// The launch on an (n, n) grid on `device` (fst::TileLaunch: blocks,
// threads, tile, sweeps a phase as the halo, dynamic shared memory): the
// wrapper asks once per (n, dtype, device) and passes the grid to every
// launch.
int fst_flip_grid_blocks_f32(int n, int device, fst::TileLaunch* out) {
  return fst::grid_launch<float>(n, device, out);
}

int fst_flip_grid_blocks_f64(int n, int device, fst::TileLaunch* out) {
  return fst::grid_launch<double>(n, device, out);
}

// scratch holds 3 (n, n) fields; `words` kTileWords words, the launch
// leaves the count of its grid syncs in the last.
int fst_flip_grid_f32(const float* mass, const float* mom_u,
                      const float* mom_v, float* u_prev, float* v_prev,
                      float* u_proj, float* v_proj, float* scratch,
                      unsigned long long* words, int n, int jacobi,
                      double gdt, int grid, int device, void* stream) {
  return fst::launch_grid<float>(mass, mom_u, mom_v, u_prev, v_prev, u_proj,
                                 v_proj, scratch, words, n, jacobi, gdt, grid,
                                 device, stream);
}

int fst_flip_grid_f64(const double* mass, const double* mom_u,
                      const double* mom_v, double* u_prev, double* v_prev,
                      double* u_proj, double* v_proj, double* scratch,
                      unsigned long long* words, int n, int jacobi,
                      double gdt, int grid, int device, void* stream) {
  return fst::launch_grid<double>(mass, mom_u, mom_v, u_prev, v_prev, u_proj,
                                  v_proj, scratch, words, n, jacobi, gdt,
                                  grid, device, stream);
}

}  // extern "C"
