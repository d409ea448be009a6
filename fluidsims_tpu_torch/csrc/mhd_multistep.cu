// K steps of 2-D ideal MHD with GLM divergence cleaning per launch, edge
// clamped, for float and double: the per-cell form of
// fluidsims_tpu_torch/solvers/mhd.py::step_core with its default hooks,
// both flux signs (the reference's anti-diffusive one and stable_hll).
//
// Replaces the TPU kernel fluidsims_tpu/kernels/mhd_resident_pallas.py::
// make_multistep_pallas.kernel (pallas_call at :120): the 7-field state
// edge-copied to (ceil8(ny), ceil128(nx)) and resident in VMEM, grid=(),
// K steps in a fori_loop with pltpu.roll shifts.  No padding here: the
// window of a tile clamps its indices, as shift_clamped does (inside the
// face bands no clamp is ever active), and the bands are index tests on
// global coordinates.
//
// What bounds it on an H100.  Neither bytes nor syncs: the dependent
// arithmetic.  A cell-step is ~830 operations (per axis 7 MC slopes, the
// face states and one HLL face of two primitive decodes, two fast speeds
// and two GLM fluxes; the update, damping, the revert test and the next
// step's wavespeed) with ~33 IEEE divisions and ~12 square roots under
// -fmad=false, ~0.05 ms a step at the f32 peak at 2048^2, against the 7
// fields read and written once (~0.07 ms at 3.35 TB/s); a step measured
// ~0.46 ms there.  Each phase of a tile is a chain of those divisions
// between block barriers, and the tile and threads that keep an SM's
// warps busy across the barriers set the pace (tools/tune_tiles_torch.py
// sweep, PERF.md).
//
// What the first design lost.  It was a grid-stride loop over the cells
// with whole-grid phases, 1 + 2K grid syncs a launch: the wavespeed max,
// a sync, every x and y face flux into a 14-field scratch in device
// memory, a sync, the update.  Each face's four cells formed both MC
// slopes they need, so every slope was computed twice (28 a cell for the
// 14 the step needs), and a step streamed ~49 field-passes through device
// memory (~0.82 GB at 2048^2 f32, against ~16 for the state in and out).
// Each face was solved once, as here: the two designs make the same HLL
// solves, and the tiles gained 1.1-1.3x a launch (PERF.md), not the ~3x
// the bytes promised.
//
// The design (tiles.cuh, as burgers_multistep.cu).  The grid is cut into
// tiles of MHDTile<T> cells (16 x 15 float, 16 x 7 double: FST_MHD_TILE_*,
// FST_MHD_F64_TILE_*, clipped to the grid); a persistent cooperative grid
// of kMHDThreads-thread blocks (128) walks them.  A step of a tile runs in
// shared memory:
//   1. load the 7 fields of the tile and a halo of 2 (the face between
//      cells i and i + 1 reads cells i - 1 .. i + 2), coalesced along rows,
//      indices clamped to the grid; cells past the grid's edge in a ragged
//      tile hold the clamped cell's value;
//   2. each cell's 7 MC slopes along x once (the tile's rows, the window's
//      columns but its outermost);
//   3. each x face once: L and R from the slopes, HLL with the configured
//      sign, zero outside default_face_masks' band in global coordinates;
//   4. the x part of the update on the tile, U - dt_dx (fx - fxm), into a
//      buffer of its own, while the y slopes overwrite the x slopes;
//   5. each y face once, into the face buffer;
//   6. the y part, psi damping and the revert of an invalid new state
//      (non-finite field, rho or p at the floor) to the old one; the new
//      state goes to the other buffer of the ping-pong, and the cell's
//      hypot(u, v) + max(cf_x, cf_y) of the bits just written (the old
//      value where it reverted) is folded into the next step's max slot,
//      one atomic a block.
// Axis by axis keeps the plain order (U - dt_dx (fx - fxm)) - dt_dy (fy -
// fym) and a window's shared memory at 3 x 7 fields of the window and 7 of
// the tile.
//
// One grid sync a step.  A launch clears the three max slots, syncs, folds
// the input's max into slot 0, and syncs (2 syncs); step s reads its max
// from slot s % 3, folds the max of the state it writes into slot (s + 1)
// % 3, clears slot (s + 2) % 3, and ends with one sync (none after the
// last step): K + 1 syncs a launch, counted by the kernel (tiles.cuh
// CountedGrid) into the slot word kSyncCountWord.  The state ping-pongs
// between the output and a scratch copy, so that the last step lands in
// the output and the input is never written; why the slots and buffers
// are safe with one sync a step: burgers_multistep.cu.
//
// Same bits.  Every value is formed by the first design's operations in
// their order (the same prim, fast_speed, glm_flux, hll_glm, mc_slope, exp
// and hypot, -fmad=false), and the max is exact, so the kernel gives the
// first design's bits, and one launch of K steps is bitwise equal to K
// launches of one.  hypot and exp are CUDA's, the rest correctly rounded,
// so a step agrees with the plain version to a few ulps (a cell at the
// revert threshold may then revert in one and not the other).
#include "tiles.cuh"

namespace fst {

// Host-side parameters, in double, formed by kernels/mhd_cuda.py.
struct MHDParams {
  int ny, nx, k, stable;
  double gamma, gm1;      // gamma, gamma - 1
  double cfl_min;         // cfl * min(dx, dy)
  double dx, dy, min_dxdy;
  double neg_alpha;       // -GLM_ALPHA
};

namespace {

constexpr int kF = 7;               // rho, mx, my, E, Bx, By, psi
constexpr double kEpsRho = 1e-8;    // solvers/mhd.py EPS_RHO
constexpr double kEpsP = 1e-8;      // solvers/mhd.py EPS_P
constexpr int kHalo = 2;            // the MC slopes' and faces' reach

// The tile of each dtype, tile_x x tile_y cells (clipped to the grid), the
// threads a block and the blocks an SM the registers must allow
// (__launch_bounds__' second argument, which caps a thread's registers at
// 65536 / (threads x blocks)): what tools/tune_tiles_torch.py's sweep
// chose (-D; PERF.md).  A 16 x 15 tile has 255 x faces and 256 y faces, two
// rounds of 128 threads each; float at 5 blocks an SM (<= 102 registers)
// beat 4 and 2, double at 3 (<= 170) beat 4, which spilled.
#ifndef FST_MHD_TILE_X
#define FST_MHD_TILE_X 16
#endif
#ifndef FST_MHD_TILE_Y
#define FST_MHD_TILE_Y 15
#endif
#ifndef FST_MHD_F64_TILE_X
#define FST_MHD_F64_TILE_X 16
#endif
#ifndef FST_MHD_F64_TILE_Y
#define FST_MHD_F64_TILE_Y 7
#endif
#ifndef FST_MHD_THREADS
#define FST_MHD_THREADS 128
#endif
#ifndef FST_MHD_MIN_BLOCKS
#define FST_MHD_MIN_BLOCKS 5
#endif
#ifndef FST_MHD_F64_MIN_BLOCKS
#define FST_MHD_F64_MIN_BLOCKS 3
#endif
constexpr int kMHDThreads = FST_MHD_THREADS;

template <typename T>
struct MHDTile {
  static constexpr int x = FST_MHD_TILE_X, y = FST_MHD_TILE_Y;
  static constexpr int min_blocks = FST_MHD_MIN_BLOCKS;
};
template <>
struct MHDTile<double> {
  static constexpr int x = FST_MHD_F64_TILE_X, y = FST_MHD_F64_TILE_Y;
  static constexpr int min_blocks = FST_MHD_F64_MIN_BLOCKS;
};

template <typename T>
struct MHDArgs {
  const T* in[kF];
  const T* t_in;
  T* out[kF];
  T* t_out;
  T* scratch;  // the state's other buffer: 7 fields of ny * nx
  unsigned long long* slots;  // kTileWords words
  int ny, nx, k, stable;
  int tile_x, tile_y, tiles_x, tiles, wx, wy, window;
  T gamma, gm1, cfl_min, dx, dy, min_dxdy, neg_alpha;
};

template <typename T>
struct Prim {
  T rho, u, v, p;
};

// cons_to_prim
template <typename T>
__device__ __forceinline__ Prim<T> prim(const T gm1, const T U[kF]) {
  Prim<T> q;
  q.rho = nan_max(U[0], T(kEpsRho));
  q.u = U[1] / q.rho;
  q.v = U[2] / q.rho;
  const T ek = (T(0.5) * q.rho) * (q.u * q.u + q.v * q.v);
  const T em = T(0.5) * (U[4] * U[4] + U[5] * U[5]);
  q.p = nan_max(gm1 * ((U[3] - ek) - em), T(kEpsP));
  return q;
}

// fast_speed
template <typename T>
__device__ __forceinline__ T fast_speed(const T gamma, const Prim<T>& q,
                                        T Bx, T By, bool xdir) {
  const T a2 = (gamma * q.p) / q.rho;
  const T b2 = (Bx * Bx + By * By) / q.rho;
  const T bn = xdir ? Bx : By;
  const T bn2 = (bn * bn) / q.rho;
  const T disc =
      nan_max((a2 + b2) * (a2 + b2) - (T(4) * a2) * bn2, T(0));
  return sqrt(T(0.5) * ((a2 + b2) + sqrt(disc)));
}

// The step's wavespeed of a cell: hypot(u, v) + max(cf_x, cf_y).
template <typename T>
__device__ __forceinline__ T cell_speed(const MHDArgs<T>& a, const T U[kF]) {
  const Prim<T> q = prim(a.gm1, U);
  return hypot(q.u, q.v) + nan_max(fast_speed(a.gamma, q, U[4], U[5], true),
                                   fast_speed(a.gamma, q, U[4], U[5], false));
}

// glm_flux, from U and its primitives
template <typename T>
__device__ __forceinline__ void glm_flux(const T U[kF], const Prim<T>& q,
                                         T ch2, bool xdir, T F[kF]) {
  const T Bx = U[4], By = U[5];
  const T pt = q.p + T(0.5) * (Bx * Bx + By * By);
  const T vb = q.u * Bx + q.v * By;
  if (xdir) {
    F[0] = U[1];
    F[1] = (U[1] * q.u + pt) - Bx * Bx;
    F[2] = U[2] * q.u - Bx * By;
    F[3] = (U[3] + pt) * q.u - Bx * vb;
    F[4] = U[6];
    F[5] = q.u * By - q.v * Bx;
    F[6] = ch2 * Bx;
  } else {
    F[0] = U[2];
    F[1] = U[1] * q.v - By * Bx;
    F[2] = (U[2] * q.v + pt) - By * By;
    F[3] = (U[3] + pt) * q.v - By * vb;
    F[4] = q.v * Bx - q.u * By;
    F[5] = U[6];
    F[6] = ch2 * By;
  }
}

// hlld_glm_flux: the HLL flux with the configured sign.
template <typename T>
__device__ __forceinline__ void hll_glm(const MHDArgs<T>& a, const T UL[kF],
                                        const T UR[kF], T ch, bool xdir,
                                        T F[kF]) {
  const Prim<T> L = prim(a.gm1, UL), R = prim(a.gm1, UR);
  const T unL = xdir ? L.u : L.v;
  const T unR = xdir ? R.u : R.v;
  const T cfL = fast_speed(a.gamma, L, UL[4], UL[5], xdir);
  const T cfR = fast_speed(a.gamma, R, UR[4], UR[5], xdir);
  const T SL = nan_min(nan_min(unL - cfL, unR - cfR), -ch);
  const T SR = nan_max(nan_max(unL + cfL, unR + cfR), ch);
  T FL[kF], FR[kF];
  glm_flux(UL, L, ch * ch, xdir, FL);
  glm_flux(UR, R, ch * ch, xdir, FR);
  const T inv = T(1) / (SR - SL);
  const T sgnSLSR = ((a.stable ? SL : -SL) * SR);
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    const T fh = ((SR * FL[f] - SL * FR[f]) + sgnSLSR * (UR[f] - UL[f])) * inv;
    F[f] = SL >= T(0) ? FL[f] : (SR <= T(0) ? FR[f] : fh);
  }
}

template <typename T>
__device__ __forceinline__ T minmod(T a, T b) {
  return a * b > T(0) ? (fabs(a) < fabs(b) ? a : b) : T(0);
}

// _mc on (f - fm, 0.5 (fp - fm), fp - f)
template <typename T>
__device__ __forceinline__ T mc_slope(T fm, T f, T fp) {
  const T dl = f - fm, dc = T(0.5) * (fp - fm), dr = fp - f;
  return minmod(minmod(dl, dr), minmod(dc, minmod(T(2) * dl, T(2) * dr)));
}

// The shared-memory buffers of a block, each field f at [f * size, (f + 1)
// * size): the window's state (sU), one axis's slopes (sS) and faces (sF),
// on window cells, and the x part of the update on the tile (sA).
template <typename T>
struct Smem {
  T *U, *S, *F, *A;
};

// Slopes along one axis (d = 1: x, d = wx: y) of window cells [y0, y1) x
// [x0, x1).
template <typename T>
__device__ __forceinline__ void slopes(const Smem<T>& sm, int W, int y0,
                                       int y1, int x0, int x1, int wx,
                                       int d) {
  for_region(y0, y1, x0, x1, wx, [&](int, int, int c) {
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const T* u = sm.U + f * W;
      sm.S[f * W + c] = mc_slope(u[c - d], u[c], u[c + d]);
    }
  });
}

// The faces between window cells c and c + d of [y0, y1) x [x0, x1): HLL
// from the slopes' L and R states inside the band (global rows [by0, by1],
// columns [bx0, bx1]), zero outside.
template <typename T>
__device__ __forceinline__ void faces(const MHDArgs<T>& a, const Smem<T>& sm,
                                      const Window& w, int y0, int y1,
                                      int x0, int x1, int d, bool xdir,
                                      T ch, int by1, int bx1) {
  const int W = a.window;
  for_region(y0, y1, x0, x1, a.wx, [&](int ly, int lx, int c) {
    const int gy = w.oy + ly, gx = w.ox + lx;
    T F[kF];
    if (gy >= 1 && gy <= by1 && gx >= 1 && gx <= bx1) {
      T qL[kF], qR[kF];
#pragma unroll
      for (int f = 0; f < kF; ++f) {
        const T* u = sm.U + f * W;
        const T* s = sm.S + f * W;
        qL[f] = u[c] + T(0.5) * s[c];
        qR[f] = u[c + d] - T(0.5) * s[c + d];
      }
      hll_glm(a, qL, qR, ch, xdir, F);
    } else {
#pragma unroll
      for (int f = 0; f < kF; ++f) F[f] = T(0);
    }
#pragma unroll
    for (int f = 0; f < kF; ++f) sm.F[f * W + c] = F[f];
  });
}

template <typename T>
__global__ void __launch_bounds__(kMHDThreads, MHDTile<T>::min_blocks)
mhd_multistep_kernel(MHDArgs<T> a) {
  CountedGrid grid = counted_grid();
  extern __shared__ __align__(16) unsigned char fst_smem[];
  const int W = a.window, C = a.tile_x * a.tile_y;
  Smem<T> sm;
  sm.U = reinterpret_cast<T*>(fst_smem);
  sm.S = sm.U + kF * W;
  sm.F = sm.S + kF * W;
  sm.A = sm.F + kF * W;

  const int ny = a.ny, nx = a.nx, wx = a.wx, wy = a.wy, H = kHalo;
  const size_t n = (size_t)ny * nx;
  const size_t gtid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;

  if (gtid == 0)
    for (int j = 0; j < kMaxSlots; ++j) grid_max_clear(a.slots, j);
  grid.sync();
  {
    LocalMax<T> lm;
    for (size_t i = gtid; i < n; i += stride) {
      T U[kF];
#pragma unroll
      for (int f = 0; f < kF; ++f) U[f] = a.in[f][i];
      lm.add(cell_speed(a, U));
    }
    block_max_add(a.slots, 0, lm);
  }
  grid.sync();

  T t = *a.t_in;
  const T* cur[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) cur[f] = a.in[f];
  for (int s = 0; s < a.k; ++s) {
    const bool to_out = ((a.k - 1 - s) & 1) == 0;
    T* nxt[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f)
      nxt[f] = to_out ? a.out[f] : a.scratch + f * n;
    const bool more = s + 1 < a.k;  // the next step needs this one's max
    const T maxs =
        nan_max(slot_max_read<T>(a.slots, s % kMaxSlots), T(1e-6));
    const T ch = maxs;
    const T dt = a.cfl_min / nan_max(maxs + ch, T(1e-6));
    const T dt_dx = dt / a.dx, dt_dy = dt / a.dy;
    const T damp = exp(((a.neg_alpha * ch) * dt) / a.min_dxdy);
    if (gtid == 0) grid_max_clear(a.slots, (s + 2) % kMaxSlots);
    LocalMax<T> lm;

    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      const Window w = window_of(tile, a.tiles_x, a.tile_x, a.tile_y, H);
      load_clamped<kF>(w, ny, nx, cur, sm.U, W);
      __syncthreads();
      // x: slopes of the tile's rows, faces between window columns
      // [1, wx - 2) and their right neighbours, the x part of the update
      slopes(sm, W, H, wy - H, 1, wx - 1, wx, 1);
      __syncthreads();
      faces(a, sm, w, H, wy - H, 1, wx - 2, 1, true, ch, ny - 2, nx - 3);
      __syncthreads();
      for_region(H, wy - H, H, wx - H, wx, [&](int ly, int lx, int c) {
        const int i = (ly - H) * a.tile_x + (lx - H);
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          const T* F = sm.F + f * W;
          sm.A[f * C + i] = sm.U[f * W + c] - dt_dx * (F[c] - F[c - 1]);
        }
      });
      // y: slopes of the tile's columns (the x slopes are consumed), faces
      // between window rows [1, wy - 2) and the rows below them
      slopes(sm, W, 1, wy - 1, H, wx - H, wx, wx);
      __syncthreads();
      faces(a, sm, w, 1, wy - 2, H, wx - H, wx, false, ch, ny - 3, nx - 2);
      __syncthreads();
      // the y part, damping, revert; write, and fold the next step's max
      for_region(H, wy - H, H, wx - H, wx, [&](int ly, int lx, int c) {
        const long long gi = owned_index(w, ly, lx, ny, nx);
        if (gi < 0) return;
        const int i = (ly - H) * a.tile_x + (lx - H);
        T U[kF], Un[kF];
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          const T* F = sm.F + f * W;
          U[f] = sm.U[f * W + c];
          Un[f] = sm.A[f * C + i] - dt_dy * (F[c] - F[c - wx]);
        }
        Un[6] = Un[6] * damp;
        const Prim<T> qn = prim(a.gm1, Un);
        bool ok = isfinite(Un[3]) && qn.rho > T(kEpsRho) && qn.p > T(kEpsP);
#pragma unroll
        for (int f = 0; f < kF; ++f) ok = ok && isfinite(Un[f]);
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          Un[f] = ok ? Un[f] : U[f];
          nxt[f][gi] = Un[f];
        }
        if (more) lm.add(cell_speed(a, Un));
      });
      __syncthreads();  // the next tile's load overwrites the buffers
    }

    if (more) {
      block_max_add(a.slots, (s + 1) % kMaxSlots, lm);
      grid.sync();
    }
    t = t + dt;
#pragma unroll
    for (int f = 0; f < kF; ++f) cur[f] = nxt[f];
  }
  if (gtid == 0) *a.t_out = t;
  grid.write_syncs(a.slots);
}

// Dynamic shared memory of a block: sU, sS, sF on the window, sA on the
// tile.
template <typename T>
size_t smem_bytes(int tile_x, int tile_y) {
  const size_t window =
      (size_t)(tile_x + 2 * kHalo) * (tile_y + 2 * kHalo);
  return (3 * window + (size_t)tile_x * tile_y) * kF * sizeof(T);
}

// The launch's args and dynamic shared memory from the host parameters;
// cudaErrorInvalidValue for parameters the kernel does not take.
template <typename T>
int make_args(const MHDParams* p, MHDArgs<T>* a, size_t* smem) {
  if (p->k < 1 || p->ny < 1 || p->nx < 1) return (int)cudaErrorInvalidValue;
  const int tile_x = tile_of(MHDTile<T>::x, p->nx);
  const int tile_y = tile_of(MHDTile<T>::y, p->ny);
  a->ny = p->ny;
  a->nx = p->nx;
  a->k = p->k;
  a->stable = p->stable;
  a->tile_x = tile_x;
  a->tile_y = tile_y;
  a->tiles_x = (p->nx + tile_x - 1) / tile_x;
  a->tiles = a->tiles_x * ((p->ny + tile_y - 1) / tile_y);
  a->wx = tile_x + 2 * kHalo;
  a->wy = tile_y + 2 * kHalo;
  a->window = a->wx * a->wy;
  a->gamma = T(p->gamma);
  a->gm1 = T(p->gm1);
  a->cfl_min = T(p->cfl_min);
  a->dx = T(p->dx);
  a->dy = T(p->dy);
  a->min_dxdy = T(p->min_dxdy);
  a->neg_alpha = T(p->neg_alpha);
  *smem = smem_bytes<T>(tile_x, tile_y);
  return 0;
}

// The launch of these parameters: make_args's tile, halo and shared memory,
// and the resident blocks of kMHDThreads threads, at most one a tile.
template <typename T>
int grid_for(const MHDParams* p, int device, TileLaunch* out) {
  MHDArgs<T> a{};
  size_t smem = 0;
  const int err = make_args(p, &a, &smem);
  if (err != 0) return err;
  *out = {0, kMHDThreads, a.tile_x, a.tile_y, kHalo, (int)smem};
  return cooperative_blocks(mhd_multistep_kernel<T>, a.tiles, device,
                            &out->grid, smem, kMHDThreads);
}

template <typename T>
int launch(const T* const* in, const T* t, T* const* out, T* t_out,
           T* scratch, unsigned long long* slots, const MHDParams* p,
           int grid, int threads, int device, void* stream) {
  MHDArgs<T> a{};
  size_t smem = 0;
  const int err = make_args(p, &a, &smem);
  if (err != 0) return err;
  if (threads != kMHDThreads || grid < 1) return (int)cudaErrorInvalidValue;
  for (int f = 0; f < kF; ++f) {
    a.in[f] = in[f];
    a.out[f] = out[f];
  }
  a.t_in = t;
  a.t_out = t_out;
  a.scratch = scratch;
  a.slots = slots;
  return on_device(device, [&] {
    return launch_cooperative_on(mhd_multistep_kernel<T>, a, grid, device,
                                 stream, smem, threads);
  });
}

}  // namespace
}  // namespace fst

extern "C" {

// The launch of these parameters on `device` (fst::TileLaunch): the wrapper
// asks once per (config, device) and passes the grid and threads to every
// launch.
int fst_mhd_multistep_grid_f32(const fst::MHDParams* p, int device,
                               fst::TileLaunch* out) {
  return fst::grid_for<float>(p, device, out);
}

int fst_mhd_multistep_grid_f64(const fst::MHDParams* p, int device,
                               fst::TileLaunch* out) {
  return fst::grid_for<double>(p, device, out);
}

// in, out: arrays of the 7 field pointers (rho, mx, my, E, Bx, By, psi);
// scratch: 7 fields of ny * nx; `slots`: kTileWords words, the launch
// leaves the count of its grid syncs in the last.
int fst_mhd_multistep_f32(const float* const* in, const float* t,
                          float* const* out, float* t_out, float* scratch,
                          unsigned long long* slots, const fst::MHDParams* p,
                          int grid, int threads, int device, void* stream) {
  return fst::launch<float>(in, t, out, t_out, scratch, slots, p, grid,
                            threads, device, stream);
}

int fst_mhd_multistep_f64(const double* const* in, const double* t,
                          double* const* out, double* t_out, double* scratch,
                          unsigned long long* slots, const fst::MHDParams* p,
                          int grid, int threads, int device, void* stream) {
  return fst::launch<double>(in, t, out, t_out, scratch, slots, p, grid,
                             threads, device, stream);
}

}  // extern "C"
