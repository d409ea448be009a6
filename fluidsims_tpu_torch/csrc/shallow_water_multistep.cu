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
// Here: one cooperative launch (grid_reduce.cuh), grid-stride loops over
// the cells, the phases of a step separated by grid syncs:
//
//   A  h = exp(sigma) into scratch (two copies, by step parity, so that a
//      step's writes never race the previous step's neighbour reads); each
//      thread's max of max(|u| + c, |v| + c), c = sqrt(g h), folded into
//      the step's grid-max slot;
//   -- sync --
//   B  every thread forms dt = min(t dtau, cfl min(dx, dy) / max(cmax,
//      1e-12)) from the slot itself;
//   C  the HLL fluxes of the cell's four faces (each face computed by both
//      its cells, with the same bits), the conservative update, the H_EPS
//      floor, u2 = mx2 / h2, v2 = my2 / h2, sigma2 = log(h2);
//   -- sync -- (nu > 0 only) u2 + nu dt lap(u2), v2 likewise, which read
//      the updated neighbours;
//   the clock t <- t exp(dtau), tau <- tau + dtau in registers.
//
// A cell is always handled by the same thread, so a phase reads its own
// cells' values from the previous phase without a sync.  The state
// ping-pongs between the output and a scratch copy so that the last step
// lands in the output; the input is never written.  Every operation is the
// plain version's, in its order, with -fmad=false; exp, log and sqrt are
// CUDA's (sqrt correctly rounded), so a step agrees with the plain version
// to a few ulps; the max is exact, so one launch of K steps is bitwise
// equal to K launches of one.
//
// What bounds it on an H100: at 512^2 the state is 3 MB and the scratch
// 8-10 MB, inside the 50 MB L2; a step is ~250 operations a cell (four HLL
// solves with a sqrt each, exp, log): ~66 M operations, ~1 us of f32 issue
// over 132 SMs, against 1-2 grid syncs a step and the launch.  So syncs and
// launches set the pace at the reference size; at 4096^2 (192 MB of state)
// the ~8 fields a step streamed through device memory do.
#include "grid_reduce.cuh"

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

template <typename T>
struct SWArgs {
  const T *sig_in, *u_in, *v_in, *t_in, *tau_in;
  T *sig_out, *u_out, *v_out, *t_out, *tau_out;
  T* scratch;  // S_sig, S_u, S_v, H0, H1[, U2, V2], each ny * nx
  unsigned long long* slots;  // 2 * kMaxSlots words
  int ny, nx, k, visc;
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

template <typename T>
__global__ void __launch_bounds__(kStepThreads)
sw_multistep_kernel(SWArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  const int ny = a.ny, nx = a.nx;
  const size_t n = (size_t)ny * nx;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  T* S[3] = {a.scratch, a.scratch + n, a.scratch + 2 * n};
  T* Hs[2] = {a.scratch + 3 * n, a.scratch + 4 * n};
  T* U2 = a.scratch + 5 * n;
  T* V2 = a.scratch + 6 * n;

  if (first == 0)
    for (int j = 0; j < kMaxSlots; ++j) grid_max_clear(a.slots, j);
  grid.sync();

  T t = *a.t_in, tau = *a.tau_in;
  const T growth = exp(a.dtau);
  const T* sig = a.sig_in;
  const T* u = a.u_in;
  const T* v = a.v_in;
  for (int s = 0; s < a.k; ++s) {
    const bool to_out = ((a.k - 1 - s) & 1) == 0;
    T* nsig = to_out ? a.sig_out : S[0];
    T* nu_ = to_out ? a.u_out : S[1];
    T* nv_ = to_out ? a.v_out : S[2];
    T* H = Hs[s & 1];
    const int slot = s % kMaxSlots;

    // A: depth, wavespeed max
    if (first == 0) grid_max_clear(a.slots, (s + 1) % kMaxSlots);
    LocalMax<T> lm;
    for (size_t i = first; i < n; i += stride) {
      const T h = exp(sig[i]);
      H[i] = h;
      const T c = sqrt(a.g * h);
      lm.add(nan_max(fabs(u[i]) + c, fabs(v[i]) + c));
    }
    grid_max_add(a.slots, slot, lm);
    grid.sync();

    // B: dt
    const T cmax = nan_max(grid_max_read<T>(a.slots, slot), T(1e-12));
    const T dt = nan_min(t * a.dtau, a.cfl_min / cmax);

    // C: fluxes, update, floor, log
    for (size_t i = first; i < n; i += stride) {
      const int y = (int)(i / nx), x = (int)(i - (size_t)y * nx);
      const size_t row = (size_t)y * nx;
      const size_t r = row + wrap1(x + 1, nx), l = row + wrap1(x - 1, nx);
      const size_t d = (size_t)wrap1(y + 1, ny) * nx + x;
      const size_t up = (size_t)wrap1(y - 1, ny) * nx + x;
      const T hc = H[i], uc = u[i], vc = v[i];
      T F[3], Fm[3], G[3], Gm[3];
      hll(a, true, hc, uc, vc, H[r], u[r], v[r], F);
      hll(a, true, H[l], u[l], v[l], hc, uc, vc, Fm);
      hll(a, false, hc, uc, vc, H[d], u[d], v[d], G);
      hll(a, false, H[up], u[up], v[up], hc, uc, vc, Gm);
      const T mx = hc * uc, my = hc * vc;
      T h2 = hc - dt * ((F[0] - Fm[0]) * a.inv_dx + (G[0] - Gm[0]) * a.inv_dy);
      const T mx2 =
          mx - dt * ((F[1] - Fm[1]) * a.inv_dx + (G[1] - Gm[1]) * a.inv_dy);
      const T my2 =
          my - dt * ((F[2] - Fm[2]) * a.inv_dx + (G[2] - Gm[2]) * a.inv_dy);
      h2 = nan_max(h2, T(kHEps));
      nsig[i] = log(h2);
      const T u2 = mx2 / h2, v2 = my2 / h2;
      if (a.visc) {
        U2[i] = u2;
        V2[i] = v2;
      } else {
        nu_[i] = u2;
        nv_[i] = v2;
      }
    }

    // D: viscosity on the updated velocities
    if (a.visc) {
      grid.sync();
      const T coef = a.nu * dt;
      for (size_t i = first; i < n; i += stride) {
        const int y = (int)(i / nx), x = (int)(i - (size_t)y * nx);
        const size_t row = (size_t)y * nx;
        const size_t r = row + wrap1(x + 1, nx), l = row + wrap1(x - 1, nx);
        const size_t d = (size_t)wrap1(y + 1, ny) * nx + x;
        const size_t up = (size_t)wrap1(y - 1, ny) * nx + x;
        const T uc = U2[i], vc = V2[i];
        const T lap_u = ((U2[r] - T(2) * uc) + U2[l]) * a.inv_dx2 +
                        ((U2[d] - T(2) * uc) + U2[up]) * a.inv_dy2;
        const T lap_v = ((V2[r] - T(2) * vc) + V2[l]) * a.inv_dx2 +
                        ((V2[d] - T(2) * vc) + V2[up]) * a.inv_dy2;
        nu_[i] = uc + coef * lap_u;
        nv_[i] = vc + coef * lap_v;
      }
    }

    t = t * growth;
    tau = tau + a.dtau;
    sig = nsig;
    u = nu_;
    v = nv_;
  }
  if (first == 0) {
    *a.t_out = t;
    *a.tau_out = tau;
  }
}

template <typename T>
int launch(const T* sig, const T* u, const T* v, const T* t, const T* tau,
           T* sig_out, T* u_out, T* v_out, T* t_out, T* tau_out, T* scratch,
           unsigned long long* slots, const SWParams* p, int device,
           void* stream) {
  if (p->k < 1) return (int)cudaErrorInvalidValue;
  SWArgs<T> a{sig, u, v, t, tau, sig_out, u_out, v_out, t_out, tau_out,
              scratch, slots, p->ny, p->nx, p->k, p->visc, T(p->g),
              T(p->half_g), T(p->cfl_min), T(p->dtau), T(p->inv_dx),
              T(p->inv_dy), T(p->inv_dx2), T(p->inv_dy2), T(p->nu)};
  return launch_cooperative(sw_multistep_kernel<T>, a,
                            (long long)p->ny * p->nx, device, stream);
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_sw_multistep_f32(const float* sig, const float* u, const float* v,
                         const float* t, const float* tau, float* sig_out,
                         float* u_out, float* v_out, float* t_out,
                         float* tau_out, float* scratch,
                         unsigned long long* slots, const fst::SWParams* p,
                         int device, void* stream) {
  return fst::launch<float>(sig, u, v, t, tau, sig_out, u_out, v_out, t_out,
                            tau_out, scratch, slots, p, device, stream);
}

int fst_sw_multistep_f64(const double* sig, const double* u, const double* v,
                         const double* t, const double* tau, double* sig_out,
                         double* u_out, double* v_out, double* t_out,
                         double* tau_out, double* scratch,
                         unsigned long long* slots, const fst::SWParams* p,
                         int device, void* stream) {
  return fst::launch<double>(sig, u, v, t, tau, sig_out, u_out, v_out, t_out,
                             tau_out, scratch, slots, p, device, stream);
}

}  // extern "C"
