// K steps of 2-D ideal MHD with GLM divergence cleaning per launch, edge
// clamped, for float and double: the per-cell form of
// fluidsims_tpu_torch/solvers/mhd.py::step_core with its default hooks,
// both flux signs (the reference's anti-diffusive one and stable_hll).
//
// Replaces the TPU kernel fluidsims_tpu/kernels/mhd_resident_pallas.py::
// make_multistep_pallas.kernel (pallas_call at :120): the 7-field state
// edge-copied to (ceil8(ny), ceil128(nx)) and resident in VMEM, grid=(),
// K steps in a fori_loop with pltpu.roll shifts.  No padding here: the
// neighbour indices are clamped, as shift_clamped does (inside the face
// bands no clamp is ever active), and the bands are index tests.
//
// One cooperative launch (grid_reduce.cuh), grid-stride loops over the
// cells, the phases of a step separated by grid syncs:
//
//   A  primitives; each thread's max of hypot(u, v) + max(cf_x, cf_y),
//      folded into the step's grid-max slot;
//   -- sync --
//   B  every thread forms maxs = max(., 1e-6), ch = maxs, dt = cfl
//      min(dx, dy) / max(maxs + ch, 1e-6), dt/dx, dt/dy and the psi damping
//      exp(-alpha ch dt / min(dx, dy)) from the slot itself;
//   C  the cell's x face (to x + 1) and y face (to y + 1) fluxes into
//      scratch Fx, Fy (7 fields each): MC-limited conserved slopes, the
//      HLL flux with the configured sign, zero outside the face bands
//      (default_face_masks);
//   -- sync --
//   D  the pair update from Fx[x], Fx[x-1], Fy[y], Fy[y-1] (zero at x = 0,
//      y = 0), psi damping, and the revert of an invalid new state (non-
//      finite field, rho or p at the floor) to the old one;
//   t <- t + dt in registers.
//
// A cell is always handled by the same thread, so a phase reads its own
// cells' values from the previous phase without a sync.  The state
// ping-pongs between the output and a scratch copy so that the last step
// lands in the output; the input is never written.  Every operation is the
// plain version's, in its order, with -fmad=false; hypot and exp are
// CUDA's, the rest correctly rounded, so a step agrees with the plain
// version to a few ulps (a cell at the revert threshold may then revert in
// one and not the other); the max is exact, so one launch of K steps is
// bitwise equal to K launches of one.
//
// What bounds it on an H100: at 320x220 the state is 2 MB and the face
// scratch 4 MB, in L2; a step is ~1,100 operations a cell (two HLL faces of
// four primitive decodes, two fast speeds and two GLM fluxes each, 28 MC
// slopes, the update and the revert test): ~77 M operations, ~1 us of f32
// issue, against 2 grid syncs a step and the launch, which set the pace.
// At 2048^2 the operations (~4.6 G a step, ~70 us at the f32 peak) and
// the 7 + 14 fields streamed through device memory a step (~0.35 ms at
// 3.35 TB/s) bound it.
#include "grid_reduce.cuh"

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

template <typename T>
struct Fields {
  const T* f[kF];
};

template <typename T>
struct MHDArgs {
  Fields<T> in;
  const T* t_in;
  T* out[kF];
  T* t_out;
  T* scratch;  // S (7), Fx (7), Fy (7), each ny * nx
  unsigned long long* slots;  // 2 * kMaxSlots words
  int ny, nx, k, stable;
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

__device__ __forceinline__ int clampi(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// The flux through the face between cell c and its neighbour c + 1 along
// one axis, for the cells c - 1, c, c + 1, c + 2 at flat indices i0..i3.
template <typename T>
__device__ __forceinline__ void face(const MHDArgs<T>& a, const Fields<T>& U,
                                     size_t i0, size_t i1, size_t i2,
                                     size_t i3, T ch, bool xdir, T F[kF]) {
  T qL[kF], qR[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    const T* p = U.f[f];
    const T u0 = p[i0], u1 = p[i1], u2 = p[i2], u3 = p[i3];
    qL[f] = u1 + T(0.5) * mc_slope(u0, u1, u2);
    qR[f] = u2 - T(0.5) * mc_slope(u1, u2, u3);
  }
  hll_glm(a, qL, qR, ch, xdir, F);
}

template <typename T>
__global__ void __launch_bounds__(kStepThreads)
mhd_multistep_kernel(MHDArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  const int ny = a.ny, nx = a.nx;
  const size_t n = (size_t)ny * nx;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  T* Fx[kF];
  T* Fy[kF];
  Fields<T> S;
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    S.f[f] = a.scratch + (size_t)f * n;
    Fx[f] = a.scratch + (size_t)(kF + f) * n;
    Fy[f] = a.scratch + (size_t)(2 * kF + f) * n;
  }

  if (first == 0)
    for (int j = 0; j < kMaxSlots; ++j) grid_max_clear(a.slots, j);
  grid.sync();

  T t = *a.t_in;
  Fields<T> cur = a.in;
  for (int s = 0; s < a.k; ++s) {
    const bool to_out = ((a.k - 1 - s) & 1) == 0;
    T* nxt[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f)
      nxt[f] = to_out ? a.out[f] : const_cast<T*>(S.f[f]);
    const int slot = s % kMaxSlots;

    // A: wavespeed max
    if (first == 0) grid_max_clear(a.slots, (s + 1) % kMaxSlots);
    LocalMax<T> lm;
    for (size_t i = first; i < n; i += stride) {
      T U[kF];
#pragma unroll
      for (int f = 0; f < kF; ++f) U[f] = cur.f[f][i];
      const Prim<T> q = prim(a.gm1, U);
      lm.add(hypot(q.u, q.v) +
             nan_max(fast_speed(a.gamma, q, U[4], U[5], true),
                     fast_speed(a.gamma, q, U[4], U[5], false)));
    }
    grid_max_add(a.slots, slot, lm);
    grid.sync();

    // B: maxs, ch, dt, damping
    const T maxs = nan_max(grid_max_read<T>(a.slots, slot), T(1e-6));
    const T ch = maxs;
    const T dt = a.cfl_min / nan_max(maxs + ch, T(1e-6));
    const T dt_dx = dt / a.dx, dt_dy = dt / a.dy;
    const T damp = exp(((a.neg_alpha * ch) * dt) / a.min_dxdy);

    // C: face fluxes in the bands, zero outside
    for (size_t i = first; i < n; i += stride) {
      const int y = (int)(i / nx), x = (int)(i - (size_t)y * nx);
      const size_t row = (size_t)y * nx;
      T F[kF];
      if (y >= 1 && y <= ny - 2 && x >= 1 && x <= nx - 3) {
        face(a, cur, row + clampi(x - 1, nx), i, row + clampi(x + 1, nx),
             row + clampi(x + 2, nx), ch, true, F);
      } else {
#pragma unroll
        for (int f = 0; f < kF; ++f) F[f] = T(0);
      }
#pragma unroll
      for (int f = 0; f < kF; ++f) Fx[f][i] = F[f];
      if (y >= 1 && y <= ny - 3 && x >= 1 && x <= nx - 2) {
        face(a, cur, (size_t)clampi(y - 1, ny) * nx + x, i,
             (size_t)clampi(y + 1, ny) * nx + x,
             (size_t)clampi(y + 2, ny) * nx + x, ch, false, F);
      } else {
#pragma unroll
        for (int f = 0; f < kF; ++f) F[f] = T(0);
      }
#pragma unroll
      for (int f = 0; f < kF; ++f) Fy[f][i] = F[f];
    }
    grid.sync();

    // D: pair update, psi damping, revert
    for (size_t i = first; i < n; i += stride) {
      const int y = (int)(i / nx), x = (int)(i - (size_t)y * nx);
      T U[kF], Un[kF];
#pragma unroll
      for (int f = 0; f < kF; ++f) {
        U[f] = cur.f[f][i];
        const T fx = Fx[f][i], fy = Fy[f][i];
        const T fxm = x > 0 ? Fx[f][i - 1] : T(0);
        const T fym = y > 0 ? Fy[f][i - nx] : T(0);
        Un[f] = (U[f] - dt_dx * (fx - fxm)) - dt_dy * (fy - fym);
      }
      Un[6] = Un[6] * damp;
      const Prim<T> qn = prim(a.gm1, Un);
      bool ok = isfinite(Un[3]) && qn.rho > T(kEpsRho) && qn.p > T(kEpsP);
#pragma unroll
      for (int f = 0; f < kF; ++f) ok = ok && isfinite(Un[f]);
#pragma unroll
      for (int f = 0; f < kF; ++f) nxt[f][i] = ok ? Un[f] : U[f];
    }

    t = t + dt;
#pragma unroll
    for (int f = 0; f < kF; ++f) cur.f[f] = nxt[f];
  }
  if (first == 0) *a.t_out = t;
}

template <typename T>
int launch(const T* const* in, const T* t, T* const* out, T* t_out,
           T* scratch, unsigned long long* slots, const MHDParams* p,
           int device, void* stream) {
  if (p->k < 1) return (int)cudaErrorInvalidValue;
  MHDArgs<T> a;
  for (int f = 0; f < kF; ++f) {
    a.in.f[f] = in[f];
    a.out[f] = out[f];
  }
  a.t_in = t;
  a.t_out = t_out;
  a.scratch = scratch;
  a.slots = slots;
  a.ny = p->ny;
  a.nx = p->nx;
  a.k = p->k;
  a.stable = p->stable;
  a.gamma = T(p->gamma);
  a.gm1 = T(p->gm1);
  a.cfl_min = T(p->cfl_min);
  a.dx = T(p->dx);
  a.dy = T(p->dy);
  a.min_dxdy = T(p->min_dxdy);
  a.neg_alpha = T(p->neg_alpha);
  return launch_cooperative(mhd_multistep_kernel<T>, a,
                            (long long)p->ny * p->nx, device, stream);
}

}  // namespace
}  // namespace fst

extern "C" {

// in, out: arrays of the 7 field pointers (rho, mx, my, E, Bx, By, psi).
int fst_mhd_multistep_f32(const float* const* in, const float* t,
                          float* const* out, float* t_out, float* scratch,
                          unsigned long long* slots, const fst::MHDParams* p,
                          int device, void* stream) {
  return fst::launch<float>(in, t, out, t_out, scratch, slots, p, device,
                            stream);
}

int fst_mhd_multistep_f64(const double* const* in, const double* t,
                          double* const* out, double* t_out, double* scratch,
                          unsigned long long* slots, const fst::MHDParams* p,
                          int device, void* stream) {
  return fst::launch<double>(in, t, out, t_out, scratch, slots, p, device,
                             stream);
}

}  // extern "C"
