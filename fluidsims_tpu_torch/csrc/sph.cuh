// Device math and layout shared by the three SPH kernels (sph_bin.cu,
// sph_density.cu, sph_forces.cu): the per-pair form of the plain versions
// in fluidsims_tpu_torch/kernels/sph_cuda.py, which in turn follow the
// TPU kernels of fluidsims_tpu/kernels/sph_pallas.py.
//
// Layout.  The bin kernel sorts the particles by cell, and inside a cell by
// particle index, into `fields` (n, 4) = (x, y, vx, vy); `starts` (M + 1)
// holds each cell's first position in that order.  Every member of a cell
// is a neighbour in the pair sums of the particles of the 3x3 cells around
// it: there is no cell capacity, so no pair is dropped however full a cell
// gets, as in the reference's linked lists (tau_sph.cu:165-176).  A
// particle's position in the sorted order minus its cell's start is its
// rank in the cell.  The 3x3 cells around a cell, or around a run of cells
// of one row, are three contiguous ranges of that order, one a neighbour
// row (NeighbourRows), which a block of the density or the forces kernel
// stages into shared memory in chunks (stage_chunk); a cell's own 3x3
// cells are a contiguous part of each (cell_entries).
//
// Rules that keep the kernels equal to the plain versions (as in
// euler2d.cuh): literals cast to T before they meet a T value; constants
// the Python code forms from Python floats alone arrive in double from the
// host and are rounded once to T; max propagates NaN; the library is built
// with -fmad=false, so no multiply-add is contracted.
#pragma once

#include <cuda_runtime.h>

namespace fst {

// Host-side parameters, in double, formed by kernels/sph_cuda.py::_params.
// The cells are a window of whole columns of the grid: Gx columns from
// global column gx0 (the whole grid: gx0 = 0, Gx its width), every row;
// the n particles all lie in it.  The walls keep the whole box.
struct SPHParams {
  int n, Gx, Gy, gx0;
  int use_visc, use_grav, gamma_is_one;
  double cell;        // cell side (2h)
  double inv_h;       // 1 / h
  double alpha;       // 10 / (7 pi h^2)
  double alpha_q;     // alpha * 0.25
  double mass;
  double inv_rho0;    // 1 / rho0
  double c0sq_rho0;   // c0^2 * rho0
  double gamma_eos;
  double four_h2;     // (2h)^2
  double two_h;       // 2h
  double visc_coef;   // -visc_alpha * c0 * h
  double eps_h2;      // 0.01 * h^2
  double gravity;
  double box_x, box_y;
};

template <typename T>
struct alignas(4 * sizeof(T)) V4 {
  T x, y, vx, vy;
};

template <typename T>
struct alignas(2 * sizeof(T)) V2 {
  T a, b;
};

template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// Flat cell id gy * Gx + gx in the window: floor(x / cell) with an IEEE
// division, less the window's first column, clamped to the window
// (ops/cell_dense.py::_cid on the whole grid).
template <typename T>
__device__ __forceinline__ int cell_of(T x, T y, const SPHParams& p) {
  const T cell = T(p.cell);
  int gx = (int)floor(x / cell) - p.gx0;
  int gy = (int)floor(y / cell);
  gx = min(max(gx, 0), p.Gx - 1);
  gy = min(max(gy, 0), p.Gy - 1);
  return gy * p.Gx + gx;
}

// The members of cell (gx, gy): [*b, *e).  False outside the grid.
__device__ __forceinline__ bool cell_range(const int* __restrict__ starts,
                                           int gx, int gy, const SPHParams& p,
                                           int* b, int* e) {
  if (gx < 0 || gx >= p.Gx || gy < 0 || gy >= p.Gy) return false;
  const int c = gy * p.Gx + gx;
  *b = __ldg(starts + c);
  *e = __ldg(starts + c + 1);
  return true;
}

// The members of the cells of rows gy - 1 .. gy + 1 and columns gx0 - 1
// .. gx1 + 1 (clipped to the grid), as three contiguous ranges of the
// sorted order, one a row ([b[r], b[r] + len[r]); empty for a row outside
// the grid): for gx0 = gx1 the 3x3 cells around (gx0, gy), for a run of
// cells gx0 .. gx1 of row gy the union of their 3x3 cells.  List entry k,
// 0 <= k < total, walks the ranges in row order; off(r) is row r's first
// entry.
struct NeighbourRows {
  int b[3], len[3], total;

  __device__ __forceinline__ int off(int r) const {
    return r == 0 ? 0 : (r == 1 ? len[0] : len[0] + len[1]);
  }

  __device__ __forceinline__ int at(int k) const {
    if (k < len[0]) return b[0] + k;
    k -= len[0];
    if (k < len[1]) return b[1] + k;
    return b[2] + (k - len[1]);
  }
};

__device__ __forceinline__ NeighbourRows neighbour_rows(
    const int* __restrict__ starts, int gx0, int gx1, int gy,
    const SPHParams& p) {
  NeighbourRows r;
  r.total = 0;
  const int x0 = max(gx0 - 1, 0), x1 = min(gx1 + 1, p.Gx - 1);
  for (int o = 0; o < 3; ++o) {
    const int y = gy - 1 + o;
    r.b[o] = 0;
    r.len[o] = 0;
    if (y < 0 || y >= p.Gy) continue;
    r.b[o] = __ldg(starts + y * p.Gx + x0);
    r.len[o] = __ldg(starts + y * p.Gx + x1 + 1) - r.b[o];
    r.total += r.len[o];
  }
  return r;
}

// The list entries [*a, *e) of `rows` (built for a run of row gy's cells
// that holds column gx) that are the members of the 3x3 cells around
// (gx, gy) in neighbour row o: a contiguous part of row o's range.
__device__ __forceinline__ void cell_entries(const NeighbourRows& rows,
                                             const int* __restrict__ starts,
                                             int o, int gx, int gy,
                                             const SPHParams& p, int* a,
                                             int* e) {
  const int y = gy - 1 + o;
  if (y < 0 || y >= p.Gy) {
    *a = *e = 0;
    return;
  }
  const int base = rows.off(o) - rows.b[o];
  *a = base + __ldg(starts + y * p.Gx + max(gx - 1, 0));
  *e = base + __ldg(starts + y * p.Gx + min(gx + 1, p.Gx - 1) + 1);
}

// Stages list entries [k0, k0 + count) of `rows` into shared memory, spread
// over the block's threads (consecutive threads, consecutive entries):
// put(i, j) stores what the kernel keeps of sorted position j (the forces
// kernel: (x, y, vx, vy) and (rho, p / rho^2); the density kernel: (x, y))
// at slot i of the chunk.
template <typename Put>
__device__ __forceinline__ void stage_chunk(const NeighbourRows& rows, int k0,
                                            int count, Put put) {
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    put(i, rows.at(k0 + i));
}

// What the grid queries of the density and forces kernels report of their
// blocks (mirrored by kernels/sph_cuda.py BlockShape): threads a block,
// lanes a particle, candidates a staged chunk, dynamic shared memory a
// block.
struct SPHBlockShape {
  int threads, lanes, chunk, smem_bytes;
};

// The lanes a particle of a launch over n particles: the largest power of
// two in [fewest, most] whose n x lanes stays within lane_threads.
inline int lanes_for(int n, int fewest, int most, long long lane_threads) {
  int lanes = 1;
  while (lanes < fewest) lanes *= 2;
  while (lanes * 2 <= most && (long long)n * lanes * 2 <= lane_threads)
    lanes *= 2;
  return lanes;
}

// The blocks of the density or the forces kernel over receivers [r0, r1):
// the blocks of kGroup sorted positions of the whole range [0, n) that
// hold one of them (the kernels start at block r0 / kGroup).
inline unsigned range_blocks(int r0, int r1, int group) {
  return (unsigned)((r1 + group - 1) / group - r0 / group);
}

}  // namespace fst
