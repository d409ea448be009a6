// The whole Jacobi solve of the 2-D stable fluids in one launch, for float
// and double: `iters` sweeps out = (b + a * sum4(x)) / c over an (ny, nx)
// interior whose zero ring is implicit on all four sides (neighbours
// outside read 0).  The one-device solve's field is square (ny = nx = n);
// the x-slab runner (parallel/stam2d_sharded.py) solves rounds of a few
// sweeps on its slab of n rows, extended by exchanged columns on each side
// that has a neighbour, so that on a domain edge the implicit ring is the
// global one.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/stam2d_pallas.py::
// _lin_solve_kernel (pallas_call at :80), which held x and b in VMEM and
// ran every sweep there, so that only x, b and the result crossed HBM.
//
// What bounds it on an H100.  The bytes a solve must move are few: x and b
// read and the result written (3 MiB at 512^2 f32, ~0.94 us at 3.35
// TB/s); 40 sweeps are ~10 M operations.  What the first design lost: a
// block of an H100 cannot hold a 512^2 field, so it spread each sweep
// over the card as a grid-stride loop and separated the sweeps by grid
// syncs, iters - 1 a solve (39 at 40 sweeps, ~3.9 us each: 155.59 us a
// solve, 166x the bound), each sweep reading its neighbours from L2.
//
// The design: temporal blocking.  Each block owns tiles of tile_x x
// tile_y cells (a persistent cooperative grid, grid_reduce.cuh, walks
// them when there are more tiles than resident blocks).  A phase of `h`
// sweeps loads the tile and a halo of h cells of x (the previous phase's
// result) and b into shared memory, once; runs the h sweeps there,
// separated by __syncthreads, the valid region shrinking by one cell a
// sweep (sweep j is right on the window less a ring of j cells: a cell's
// update reads its four neighbours); and writes the tile.  One grid sync
// separates two phases: ceil(iters / h) - 1 syncs a solve (4 at the
// default 40 sweeps with h = 8).  The last phase runs the sweeps left
// (iters - h (phases - 1), also when iters < h).  The tile, h and the
// threads a block are constants (kSolveTileX x kSolveTileY = 64 x 32,
// each clipped to its axis of the field, h = kSolveSweeps = 8, 512
// threads; the grid query reports them), one value for float and double,
// from the measurements of
// tools/tune_tiles_torch.py.  The kernel counts its grid syncs (tiles.cuh
// CountedGrid), which chip_smoke.py reads back and holds to ceil(iters /
// h) - 1.  What bounds it now:
// the sweeps' own work in shared memory, ~1.5x the cells of the tiles
// (the halos shrink sweep by sweep) with a true division a cell, ~11 us a
// phase at 512^2, against ~1.5 us a grid sync.  Window cells outside
// [0, ny) x [0, nx) are the zero ring: they are loaded as 0, set to 0 by
// every sweep, and never written.
//
// The phases ping-pong between out and one scratch field, the first
// reading x, with the parity chosen so that the last phase writes out: x,
// the state's warm start, is never written.  A phase writes the buffer the
// phase before it did not, and reads the one it did, across the grid sync
// between them.  a and c are launch arguments, as the Pallas kernel's SMEM
// scalars are, so the diffusion and pressure solves share one build.
// sum4 is summed in the plain version's order (rows j-1, j+1, then columns
// i-1, i+1, zeros added where the ring is; solvers/stam2d.py::_sum4) and c
// divides truly, so with -fmad=false every cell is computed by the plain
// version's operations on the plain version's inputs: the result is
// bitwise that of the plain version.  Fields written during the launch
// are read with plain loads, not __ldg: the read-only cache is not
// coherent with other blocks' writes.
#include <cuda_runtime.h>

#include "tiles.cuh"

namespace fst {
namespace {

// The solve's tile, sweeps a phase (its halo) and threads a block: one
// value for float and double, from the sweep of tools/tune_tiles_torch.py
// (which builds variants with -DFST_SOLVE_TILE_X=... and so on).
#ifndef FST_SOLVE_TILE_X
#define FST_SOLVE_TILE_X 64
#endif
#ifndef FST_SOLVE_TILE_Y
#define FST_SOLVE_TILE_Y 32
#endif
#ifndef FST_SOLVE_SWEEPS
#define FST_SOLVE_SWEEPS 8
#endif
#ifndef FST_SOLVE_THREADS
#define FST_SOLVE_THREADS 512
#endif
constexpr int kSolveTileX = FST_SOLVE_TILE_X;
constexpr int kSolveTileY = FST_SOLVE_TILE_Y;
constexpr int kSolveSweeps = FST_SOLVE_SWEEPS;
constexpr int kSolveThreads = FST_SOLVE_THREADS;

template <typename T>
struct LinSolveArgs {
  const T* x;     // warm start, read by the first phase only
  const T* b;
  T* out;
  T* scratch;     // the other ping-pong field (unused with one phase)
  unsigned long long* words;  // kTileWords; the last takes the sync count
  int ny, nx;
  int iters;
  int tile_x, tile_y;  // the tile, clipped to the field
  int tiles_x, tiles, window;
  T a;
  T c;
};

template <typename T>
__global__ void __launch_bounds__(kSolveThreads)
lin_solve_kernel(LinSolveArgs<T> p) {
  CountedGrid grid = counted_grid();
  extern __shared__ __align__(16) unsigned char fst_smem[];
  T* sB = reinterpret_cast<T*>(fst_smem);
  T* sX[2] = {sB + p.window, sB + 2 * p.window};
  const int ny = p.ny, nx = p.nx;
  const int phases = (p.iters + kSolveSweeps - 1) / kSolveSweeps;
  const T* src = p.x;
  for (int ph = 0; ph < phases; ++ph) {
    const int count = p.iters - ph * kSolveSweeps < kSolveSweeps
                          ? p.iters - ph * kSolveSweeps
                          : kSolveSweeps;
    T* dst = ((phases - 1 - ph) % 2 == 0) ? p.out : p.scratch;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const Window w = window_of(tile, p.tiles_x, p.tile_x, p.tile_y, count);
      const int wx = w.wx;
      {
        const T* const g[2] = {src, p.b};
        T* const sd[2] = {sX[0], sB};
        load_window<2>(w.wy, wx, [&](int ly, int lx) {
          const int j = w.oy + ly, i = w.ox + lx;
          return j >= 0 && j < ny && i >= 0 && i < nx ? (long long)j * nx + i
                                                      : -1ll;
        }, g, sd);
      }
      __syncthreads();
      for (int k = 1; k <= count; ++k) {
        const T* xs = sX[(k - 1) & 1];
        T* xd = sX[k & 1];
        const bool last = k == count;
        for_region(k, w.wy - k, k, wx - k, wx, [&](int ly, int lx, int c) {
          const int j = w.oy + ly, i = w.ox + lx;
          const bool in = j >= 0 && j < ny && i >= 0 && i < nx;
          if (last) {  // the tile: write its cells inside the grid
            if (in)
              dst[(long long)j * nx + i] =
                  (sB[c] + p.a * (xs[c - wx] + xs[c + wx] + xs[c - 1] +
                                  xs[c + 1])) / p.c;
            return;
          }
          xd[c] = in ? (sB[c] + p.a * (xs[c - wx] + xs[c + wx] + xs[c - 1] +
                                       xs[c + 1])) / p.c
                     : T(0);
        });
        __syncthreads();
      }
    }
    if (ph + 1 < phases) grid.sync();
    src = dst;
  }
  grid.write_syncs(p.words);
}

// The kernel's args (pointers aside) and dynamic shared memory;
// cudaErrorInvalidValue for a field it does not take.
template <typename T>
int make_args(int ny, int nx, LinSolveArgs<T>* a, size_t* smem) {
  if (ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  a->ny = ny;
  a->nx = nx;
  a->tile_x = tile_of(kSolveTileX, nx);
  a->tile_y = tile_of(kSolveTileY, ny);
  a->tiles_x = (nx + a->tile_x - 1) / a->tile_x;
  a->tiles = a->tiles_x * ((ny + a->tile_y - 1) / a->tile_y);
  a->window = (a->tile_x + 2 * kSolveSweeps) * (a->tile_y + 2 * kSolveSweeps);
  *smem = (size_t)3 * a->window * sizeof(T);
  return 0;
}

// The launch of a solve on an (ny, nx) field: make_args's tile and shared
// memory, the sweeps a phase as the halo, and the blocks of kSolveThreads.
template <typename T>
int lin_solve_grid(int ny, int nx, int device, TileLaunch* out) {
  LinSolveArgs<T> a{};
  size_t smem = 0;
  const int err = make_args(ny, nx, &a, &smem);
  if (err != 0) return err;
  *out = {0, kSolveThreads, a.tile_x, a.tile_y, kSolveSweeps, (int)smem};
  return cooperative_blocks(lin_solve_kernel<T>, a.tiles, device, &out->grid,
                            smem, kSolveThreads);
}

template <typename T>
int launch_lin_solve(const T* x, const T* b, T* out, T* scratch,
                     unsigned long long* words, int ny, int nx, double a,
                     double c, int iters, int grid, int device,
                     void* stream) {
  LinSolveArgs<T> args{};
  size_t smem = 0;
  const int err = make_args(ny, nx, &args, &smem);
  if (err != 0) return err;
  if (iters < 1) return (int)cudaErrorInvalidValue;
  args.x = x;
  args.b = b;
  args.out = out;
  args.scratch = scratch;
  args.words = words;
  args.iters = iters;
  args.a = T(a);
  args.c = T(c);
  return on_device(device, [&] {
    return launch_cooperative_on(lin_solve_kernel<T>, args, grid, device,
                                 stream, smem, kSolveThreads);
  });
}

}  // namespace
}  // namespace fst

extern "C" {

// The launch of a solve on an (ny, nx) field on `device`
// (fst::TileLaunch): the wrapper asks once per (ny, nx, dtype, device) and
// passes the grid to every launch.
int fst_stam2d_lin_solve_grid_f32(int ny, int nx, int device,
                                  fst::TileLaunch* out) {
  return fst::lin_solve_grid<float>(ny, nx, device, out);
}

int fst_stam2d_lin_solve_grid_f64(int ny, int nx, int device,
                                  fst::TileLaunch* out) {
  return fst::lin_solve_grid<double>(ny, nx, device, out);
}

// `words`: kTileWords words; the launch leaves the count of its grid syncs
// in the last.
int fst_stam2d_lin_solve_f32(const float* x, const float* b, float* out,
                             float* scratch, unsigned long long* words,
                             int ny, int nx, double a, double c, int iters,
                             int grid, int device, void* stream) {
  return fst::launch_lin_solve<float>(x, b, out, scratch, words, ny, nx, a,
                                      c, iters, grid, device, stream);
}

int fst_stam2d_lin_solve_f64(const double* x, const double* b, double* out,
                             double* scratch, unsigned long long* words,
                             int ny, int nx, double a, double c, int iters,
                             int grid, int device, void* stream) {
  return fst::launch_lin_solve<double>(x, b, out, scratch, words, ny, nx, a,
                                       c, iters, grid, device, stream);
}

}  // extern "C"
