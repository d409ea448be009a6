// K τ-clock steps of 2-D shallow water in log depth per launch, periodic in
// x and y, for float and double: the per-cell form of
// fluidsims_tpu_torch/solvers/shallow_water.py::step, with and without
// viscosity.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/resident_multistep.py::
// make_resident_multistep.kernel (pallas_call at :72) as instantiated for
// shallow water (sw_resident_pallas.py:47-52): the (sigma, u, v) state
// resident in VMEM, grid=(), K steps in a fori_loop, periodic wraps as
// pltpu.rolls, the CFL max an exact global reduction each step.
//
// What bounds it on an H100.  Arithmetic issue, as in
// burgers_multistep.cu: the state is 3 MB at 512^2 (in the 50 MB L2) and
// 192 MB at 4096^2 (~0.12 ms a step read and written once at 3.35 TB/s),
// but a cell-step issues a few hundred instructions (two HLL faces with
// two square roots and a division each, exp, log, three divisions in the
// update and the floor, the viscosity), all with -fmad=false; the one grid
// sync a step and the wait for the slowest block add a few us at 512^2.
//
// What the first design lost.  A grid-stride loop over the cells with a
// grid sync between phases: 1 + K (2 + visc) syncs a launch (25 at K = 8
// with viscosity), the depth and the updated velocities written to device
// memory for the next phase to read back (~8 fields a step past L2), and
// each HLL face solved by both its cells.
//
// The design, as burgers_multistep.cu's (the kTileX x kTileY tiles and
// windows of tiles.cuh, a persistent cooperative grid over the tiles, 512
// or 256 threads a block as tile_grid picks).  A step of a tile runs in shared
// memory: load h, u, v of the tile and a halo of `halo` cells (periodic,
// wrap1), where h = exp(sigma) is the depth the step before carried on
// (step 0: the input's, made by the launch's prologue); each x and y HLL
// face once; the conservative update, the H_EPS floor, sigma2 = log(h2), u2
// = mx2 / h2, v2 = my2 / h2 on the tile plus a ring of one cell when nu >
// 0; then (nu > 0) u2 + nu dt lap(u2), v2 likewise on the tile; fold the
// wavespeed max of the new state (c from exp(sigma2), the depth the next
// step reads) into the next step's slot, one atomic a block; write
// exp(sigma2), u2, v2 to the other buffer, sigma2 itself on the last step.
// A cell-step makes one exp and one log, as the first design did.  The halo
// is the HLL stencil's reach, 1 (a cell's update reads the faces on both
// its sides, a face its two cells), plus 1 for the viscosity's Laplacian
// when nu > 0: halo = 1 + (nu > 0).  Cells past the grid's edge, and window
// cells of a grid narrower than the halo, hold the wrapped cell's value and
// are computed as it is; only cells inside the grid are written.
//
// One grid sync a step, as in burgers_multistep.cu, whose note proves it: a
// launch clears the max slots and syncs, folds the input's max into slot 0
// (and writes the input's depth to the buffer of "step -1") and syncs; step
// s reads slot s % 3, folds the max of the state it writes into slot (s +
// 1) % 3, clears slot (s + 2) % 3 and ends with one sync (none after the
// last): K + 1 syncs a launch, as the kernel counts them (tiles.cuh
// CountedGrid; chip_smoke.py holds the count to K + 1).  The state ping-pongs between the output and
// a scratch copy, the last step landing in the output; the input is never
// written.  Fields written during the launch are read with plain loads, not
// __ldg.
//
// Same bits.  Every operation is the plain version's, in its order, with
// -fmad=false, each face once with the bits both its cells computed
// before; exp, log and sqrt are CUDA's (sqrt correctly rounded), so a step
// agrees with the plain version to a few ulps; the max is exact, so one
// launch of K steps is bitwise equal to K launches of one.
#include "tiles.cuh"

namespace fst {

// Host-side parameters, in double, formed by kernels/shallow_water_cuda.py.
struct SWParams {
  int ny, nx, k, visc;  // visc: nu > 0
  double g, half_g;     // g and 0.5 * g as Python forms them
  double cfl_min;       // cfl * min(dx, dy)
  double dtau;
  double inv_dx, inv_dy, inv_dx2, inv_dy2;
  double nu;
};

namespace {

constexpr double kHEps = 1e-6;  // solvers/shallow_water.py H_EPS
constexpr int kSWFields = 9;    // shared-memory fields of a window

template <typename T>
struct SWArgs {
  const T *sig_in, *u_in, *v_in, *t_in, *tau_in;
  T *sig_out, *u_out, *v_out, *t_out, *tau_out;
  T* scratch;  // S_sig, S_u, S_v, each ny * nx
  unsigned long long* slots;  // kTileWords words
  int ny, nx, k, visc;
  int tile_x, tile_y, tiles_x, tiles, halo, window;
  T g, half_g, cfl_min, dtau, inv_dx, inv_dy, inv_dx2, inv_dy2, nu;
};

// HLL flux of (h, hu, hv) through a face with states L and R; x faces when
// xdir, else y faces (solvers/shallow_water.py::_hll).
template <typename T>
__device__ __forceinline__ void hll(const SWArgs<T>& a, bool xdir, T hL,
                                    T uL, T vL, T hR, T uR, T vR, T F[3]) {
  const T nL = xdir ? uL : vL;
  const T nR = xdir ? uR : vR;
  const T cL = sqrt(a.g * hL);
  const T cR = sqrt(a.g * hR);
  const T sL = nan_min(nL - cL, nR - cR);
  const T sR = nan_max(nL + cL, nR + cR);
  const T mL = hL * uL, mR = hR * uR;
  const T nLh = hL * vL, nRh = hR * vR;
  T FL[3], FR[3];
  if (xdir) {
    FL[0] = mL;
    FL[1] = mL * uL + (a.half_g * hL) * hL;
    FL[2] = mL * vL;
    FR[0] = mR;
    FR[1] = mR * uR + (a.half_g * hR) * hR;
    FR[2] = mR * vR;
  } else {
    FL[0] = nLh;
    FL[1] = mL * vL;
    FL[2] = nLh * vL + (a.half_g * hL) * hL;
    FR[0] = nRh;
    FR[1] = mR * vR;
    FR[2] = nRh * vR + (a.half_g * hR) * hR;
  }
  const T UL[3] = {hL, mL, nLh};
  const T UR[3] = {hR, mR, nRh};
  const T inv = T(1) / (sR - sL);
  const T sRL = sR * sL;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const T mid = ((sR * FL[f] - sL * FR[f]) + sRL * (UR[f] - UL[f])) * inv;
    F[f] = sL >= T(0) ? FL[f] : (sR <= T(0) ? FR[f] : mid);
  }
}

// A cell's wavespeed, max(|u| + c, |v| + c), c = sqrt(g h).
template <typename T>
__device__ __forceinline__ T wavespeed(const SWArgs<T>& a, T h, T u, T v) {
  const T c = sqrt(a.g * h);
  return nan_max(fabs(u) + c, fabs(v) + c);
}

template <typename T>
__global__ void __launch_bounds__(kTileThreadsWide, TileBlocksPerSM<T>::value)
sw_multistep_kernel(SWArgs<T> a) {
  CountedGrid grid = counted_grid();
  extern __shared__ __align__(16) unsigned char fst_smem[];
  T* sm = reinterpret_cast<T*>(fst_smem);
  T* sH = sm;  // h, then (with viscosity) the new sigma
  T* sU = sm + a.window;
  T* sV = sm + 2 * a.window;
  T* sF[3] = {sm + 3 * a.window, sm + 4 * a.window, sm + 5 * a.window};
  T* sG[3] = {sm + 6 * a.window, sm + 7 * a.window, sm + 8 * a.window};

  const int ny = a.ny, nx = a.nx;
  const size_t n = (size_t)ny * nx;
  const size_t gtid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  T* S[3] = {a.scratch, a.scratch + n, a.scratch + 2 * n};
  // The steps pass the depth h = exp(sigma) on, not sigma: only the last
  // step writes sigma (buffer of step s: the output when K - 1 - s is
  // even, else the scratch copy; the input's depth is "step -1")
  T* h_in = (a.k & 1) == 0 ? a.sig_out : S[0];

  if (gtid == 0)
    for (int j = 0; j < kMaxSlots; ++j) grid_max_clear(a.slots, j);
  grid.sync();
  {
    LocalMax<T> lm;
    for (size_t i = gtid; i < n; i += stride) {
      const T h = exp(a.sig_in[i]);
      h_in[i] = h;
      lm.add(wavespeed(a, h, a.u_in[i], a.v_in[i]));
    }
    block_max_add(a.slots, 0, lm);
  }
  grid.sync();

  T t = *a.t_in, tau = *a.tau_in;
  const T growth = exp(a.dtau);
  const T* hs = h_in;
  const T* u = a.u_in;
  const T* v = a.v_in;
  for (int s = 0; s < a.k; ++s) {
    const bool to_out = ((a.k - 1 - s) & 1) == 0;
    T* nsig = to_out ? a.sig_out : S[0];
    T* nu_ = to_out ? a.u_out : S[1];
    T* nv_ = to_out ? a.v_out : S[2];
    const bool more = s + 1 < a.k;  // the next step needs this one's max
    const T cmax =
        nan_max(slot_max_read<T>(a.slots, s % kMaxSlots), T(1e-12));
    const T dt = nan_min(t * a.dtau, a.cfl_min / cmax);
    const T coef = a.nu * dt;
    if (gtid == 0) grid_max_clear(a.slots, (s + 2) % kMaxSlots);
    LocalMax<T> lm;

    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      const Window w =
          window_of(tile, a.tiles_x, a.tile_x, a.tile_y, a.halo);
      const int wx = w.wx, wy = w.wy, h = a.halo;
      {
        const T* const g[3] = {hs, u, v};
        T* const sd[3] = {sH, sU, sV};
        load_periodic<3>(w, ny, nx, g, sd);
      }
      __syncthreads();
      // x face c is between cells c and c + 1, y face c between c and
      // c + wx: the faces of the update region [1, wy - 1) x [1, wx - 1)
      for_region(1, wy - 1, 0, wx - 1, wx, [&](int, int, int c) {
        T F[3];
        hll(a, true, sH[c], sU[c], sV[c], sH[c + 1], sU[c + 1], sV[c + 1],
            F);
        for (int f = 0; f < 3; ++f) sF[f][c] = F[f];
      });
      for_region(0, wy - 1, 1, wx - 1, wx, [&](int, int, int c) {
        T G[3];
        hll(a, false, sH[c], sU[c], sV[c], sH[c + wx], sU[c + wx],
            sV[c + wx], G);
        for (int f = 0; f < 3; ++f) sG[f][c] = G[f];
      });
      __syncthreads();
      // the update; without viscosity its region is the tile
      for_region(1, wy - 1, 1, wx - 1, wx, [&](int ly, int lx, int c) {
        const T hc = sH[c], uc = sU[c], vc = sV[c];
        const T mx = hc * uc, my = hc * vc;
        T h2 = hc - dt * ((sF[0][c] - sF[0][c - 1]) * a.inv_dx +
                          (sG[0][c] - sG[0][c - wx]) * a.inv_dy);
        const T mx2 = mx - dt * ((sF[1][c] - sF[1][c - 1]) * a.inv_dx +
                                 (sG[1][c] - sG[1][c - wx]) * a.inv_dy);
        const T my2 = my - dt * ((sF[2][c] - sF[2][c - 1]) * a.inv_dx +
                                 (sG[2][c] - sG[2][c - wx]) * a.inv_dy);
        h2 = nan_max(h2, T(kHEps));
        const T sig2 = log(h2);
        const T u2 = mx2 / h2, v2 = my2 / h2;
        if (a.visc) {
          sH[c] = sig2;
          sU[c] = u2;
          sV[c] = v2;
          return;
        }
        const long long i = owned_index(w, ly, lx, ny, nx);
        if (i < 0) return;
        const T hn = more ? exp(sig2) : sig2;  // the next step's depth
        nsig[i] = hn;
        nu_[i] = u2;
        nv_[i] = v2;
        if (more) lm.add(wavespeed(a, hn, u2, v2));
      });
      __syncthreads();
      if (a.visc) {
        // viscosity on the updated velocities, on the tile
        for_region(h, wy - h, h, wx - h, wx, [&](int ly, int lx, int c) {
          const long long i = owned_index(w, ly, lx, ny, nx);
          if (i < 0) return;
          const T uc = sU[c], vc = sV[c];
          const T lap_u = ((sU[c + 1] - T(2) * uc) + sU[c - 1]) * a.inv_dx2 +
                          ((sU[c + wx] - T(2) * uc) + sU[c - wx]) * a.inv_dy2;
          const T lap_v = ((sV[c + 1] - T(2) * vc) + sV[c - 1]) * a.inv_dx2 +
                          ((sV[c + wx] - T(2) * vc) + sV[c - wx]) * a.inv_dy2;
          const T un = uc + coef * lap_u;
          const T vn = vc + coef * lap_v;
          const T hn = more ? exp(sH[c]) : sH[c];  // the next step's depth
          nsig[i] = hn;
          nu_[i] = un;
          nv_[i] = vn;
          if (more) lm.add(wavespeed(a, hn, un, vn));
        });
        __syncthreads();
      }
    }

    if (more) {
      block_max_add(a.slots, (s + 1) % kMaxSlots, lm);
      grid.sync();
    }
    t = t * growth;
    tau = tau + a.dtau;
    hs = nsig;
    u = nu_;
    v = nv_;
  }
  if (gtid == 0) {
    *a.t_out = t;
    *a.tau_out = tau;
  }
  grid.write_syncs(a.slots);
}

// Dynamic shared memory of a block: the window's fields.
template <typename T>
size_t smem_bytes(int tile_x, int tile_y, int halo) {
  return (size_t)kSWFields * (tile_x + 2 * halo) * (tile_y + 2 * halo) *
         sizeof(T);
}

// The launch's args and dynamic shared memory from the host parameters;
// cudaErrorInvalidValue for parameters the kernel does not take.
template <typename T>
int make_args(const SWParams* p, SWArgs<T>* a, size_t* smem) {
  if (p->k < 1 || p->ny < 1 || p->nx < 1) return (int)cudaErrorInvalidValue;
  const int halo = 1 + (p->visc ? 1 : 0);
  const int tile_x = tile_of(kTileX, p->nx), tile_y = tile_of(kTileY, p->ny);
  const int window = (tile_x + 2 * halo) * (tile_y + 2 * halo);
  a->ny = p->ny;
  a->nx = p->nx;
  a->k = p->k;
  a->visc = p->visc;
  a->tile_x = tile_x;
  a->tile_y = tile_y;
  a->tiles_x = (p->nx + tile_x - 1) / tile_x;
  a->tiles = a->tiles_x * ((p->ny + tile_y - 1) / tile_y);
  a->halo = halo;
  a->window = window;
  a->g = T(p->g);
  a->half_g = T(p->half_g);
  a->cfl_min = T(p->cfl_min);
  a->dtau = T(p->dtau);
  a->inv_dx = T(p->inv_dx);
  a->inv_dy = T(p->inv_dy);
  a->inv_dx2 = T(p->inv_dx2);
  a->inv_dy2 = T(p->inv_dy2);
  a->nu = T(p->nu);
  *smem = smem_bytes<T>(tile_x, tile_y, halo);
  return 0;
}

// The launch of these parameters: make_args's tile, halo and shared memory,
// and tile_grid's blocks and threads.
template <typename T>
int grid_for(const SWParams* p, int device, TileLaunch* out) {
  SWArgs<T> a{};
  size_t smem = 0;
  const int err = make_args(p, &a, &smem);
  if (err != 0) return err;
  *out = {0, 0, a.tile_x, a.tile_y, a.halo, (int)smem};
  return tile_grid(sw_multistep_kernel<T>, a.tiles, smem, device, out);
}

template <typename T>
int launch(const T* sig, const T* u, const T* v, const T* t, const T* tau,
           T* sig_out, T* u_out, T* v_out, T* t_out, T* tau_out, T* scratch,
           unsigned long long* slots, const SWParams* p, int grid,
           int threads, int device, void* stream) {
  SWArgs<T> a{};
  size_t smem = 0;
  const int err = make_args(p, &a, &smem);
  if (err != 0) return err;
  if (!threads_ok(threads, kTileThreadsWide))
    return (int)cudaErrorInvalidValue;
  a.sig_in = sig;
  a.u_in = u;
  a.v_in = v;
  a.t_in = t;
  a.tau_in = tau;
  a.sig_out = sig_out;
  a.u_out = u_out;
  a.v_out = v_out;
  a.t_out = t_out;
  a.tau_out = tau_out;
  a.scratch = scratch;
  a.slots = slots;
  return on_device(device, [&] {
    return launch_cooperative_on(sw_multistep_kernel<T>, a, grid, device,
                                 stream, smem, threads);
  });
}

}  // namespace
}  // namespace fst

extern "C" {

// The launch of these parameters on `device` (fst::TileLaunch): the wrapper
// asks once per (config, device) and passes the grid and threads to every
// launch.
int fst_sw_multistep_grid_f32(const fst::SWParams* p, int device,
                              fst::TileLaunch* out) {
  return fst::grid_for<float>(p, device, out);
}

int fst_sw_multistep_grid_f64(const fst::SWParams* p, int device,
                              fst::TileLaunch* out) {
  return fst::grid_for<double>(p, device, out);
}

// `slots`: kTileWords words; the launch leaves the count of its grid syncs
// in the last.
int fst_sw_multistep_f32(const float* sig, const float* u, const float* v,
                         const float* t, const float* tau, float* sig_out,
                         float* u_out, float* v_out, float* t_out,
                         float* tau_out, float* scratch,
                         unsigned long long* slots, const fst::SWParams* p,
                         int grid, int threads, int device, void* stream) {
  return fst::launch<float>(sig, u, v, t, tau, sig_out, u_out, v_out, t_out,
                            tau_out, scratch, slots, p, grid, threads, device,
                            stream);
}

int fst_sw_multistep_f64(const double* sig, const double* u, const double* v,
                         const double* t, const double* tau, double* sig_out,
                         double* u_out, double* v_out, double* t_out,
                         double* tau_out, double* scratch,
                         unsigned long long* slots, const fst::SWParams* p,
                         int grid, int threads, int device, void* stream) {
  return fst::launch<double>(sig, u, v, t, tau, sig_out, u_out, v_out, t_out,
                             tau_out, scratch, slots, p, grid, threads,
                             device, stream);
}

}  // extern "C"
