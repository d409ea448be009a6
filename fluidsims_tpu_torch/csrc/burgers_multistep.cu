// K τ-clock steps of 2-D viscous Burgers per launch, periodic in x and y,
// for float and double: the per-cell form of
// fluidsims_tpu_torch/solvers/burgers.py::step, MUSCL, Cole–Hopf (1-D) and
// any number of viscosity substeps included.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/resident_multistep.py::
// make_resident_multistep.kernel (pallas_call at :72) as instantiated for
// Burgers (burgers_resident_pallas.py:46-54): the whole (phi_u, phi_v)
// state resident in VMEM, grid=(), fori_loop over K steps, periodic wraps
// as pltpu.rolls, the CFL max an exact global reduction each step.
//
// Here: one cooperative launch (grid_reduce.cuh), grid-stride loops over
// the cells, the phases of a step separated by grid syncs:
//
//   A  decode u0 = u0c sinh(phi) into scratch; each thread's max of
//      |u|/dx + |v| inv_dy, folded into the step's grid-max slot;
//   -- sync --
//   B  every thread forms dt = min(t dtau, cfl / max(smax, 1e-12)) from
//      the slot itself (no second sync, no host read);
//   C  the Rusanov x and y fluxes of both faces of the cell (MUSCL faces
//      from phi when on; each face is computed by both its cells, with the
//      same bits) and the convective update into scratch W;
//   -- sync -- viscosity substep (reads updated neighbours), -- sync --
//      ..., the last substep encoding asinh(u / u0c) into the next phi;
//   the clock t <- t exp(dtau), tau <- tau + dtau in registers.
//
// A cell is always handled by the same thread, so a phase may read its own
// cells' values from the previous phase without a sync.  phi ping-pongs
// between the output and a scratch copy so that the last step lands in the
// output; the input is never written.  Every operation is the plain
// version's, in its order; the library is built with -fmad=false.  sinh
// and asinh are CUDA's, not PyTorch's, so a step agrees with the plain
// version to a few ulps, not bitwise; the max is exact, so one launch of K
// steps is bitwise equal to K launches of one.
//
// What bounds it on an H100: at 512^2 the state is 2 MB and the scratch
// 6-8 MB, all inside the 50 MB L2, and a step is ~200 operations a cell
// (the four transcendentals counted at ~25 each): ~52 M operations, under
// 1 us of f32 issue over 132 SMs.  Against that stand 1 + visc_substeps
// grid syncs a step and the launch itself, so syncs and launches, not
// bytes or operations, set the pace at the reference size; a faster
// version would cut syncs (fuse the decode into the previous step's last
// phase) and launches (larger K, a CUDA graph).  At 4096^2 the state
// (128 MB) and scratch leave L2 and each step streams ~10 fields through
// device memory, which bounds it there.
#include "grid_reduce.cuh"

namespace fst {

// Host-side parameters, in double, formed by kernels/burgers_cuda.py.
struct BurgersParams {
  int ny, nx, k;
  int muscl, one_d, visc_substeps;
  double u0;       // velocity scale of the codec
  double dx, dy;   // divisors of the wavespeed and the flux differences
  double inv_dy;   // 0 in 1-D mode or for ny = 1
  double cfl, dtau;
  double inv_dx2, inv_dy2;  // viscosity (inv_dy2 = 0 in 1-D mode)
  double nu;
};

namespace {

template <typename T>
struct BurgersArgs {
  const T *pu_in, *pv_in, *t_in, *tau_in;
  T *pu_out, *pv_out, *t_out, *tau_out;
  T* scratch;  // Pu, Pv, U0, V0, Wa_u, Wa_v[, Wb_u, Wb_v], each ny * nx
  unsigned long long* slots;  // 2 * kMaxSlots words
  int ny, nx, k, muscl, one_d, nsub;
  T u0, dx, dy, inv_dy, cfl, dtau, inv_dx2, inv_dy2, nu, nsub_t;
};

template <typename T>
__device__ __forceinline__ T minmod(T a, T b) {
  return a * b > T(0) ? (fabs(a) < fabs(b) ? a : b) : T(0);
}

// MUSCL face states of the face between q0 and qp (qm left of q0, qpp
// right of qp): (left state, right state), as _muscl_faces.
template <typename T>
__device__ __forceinline__ void muscl(T qm, T q0, T qp, T qpp, T* l, T* r) {
  const T sL = T(0.5) * minmod(q0 - qm, qp - q0);
  const T sR = T(0.5) * minmod(qpp - qp, qp - q0);
  *l = q0 + sL;
  *r = qp - sR;
}

// Rusanov flux of (u, v) through a face with states L and R; x faces when
// xdir, else y faces (_rusanov_faces).
template <typename T>
__device__ __forceinline__ void rusanov(bool xdir, T uL, T vL, T uR, T vR,
                                        T* Fu, T* Fv) {
  T FLu, FLv, FRu, FRv, a;
  if (xdir) {
    FLu = (T(0.5) * uL) * uL;
    FLv = uL * vL;
    FRu = (T(0.5) * uR) * uR;
    FRv = uR * vR;
    a = nan_max(fabs(uL), fabs(uR));
  } else {
    FLu = uL * vL;
    FLv = (T(0.5) * vL) * vL;
    FRu = uR * vR;
    FRv = (T(0.5) * vR) * vR;
    a = nan_max(fabs(vL), fabs(vR));
  }
  *Fu = T(0.5) * (FLu + FRu) - (T(0.5) * a) * (uR - uL);
  *Fv = T(0.5) * (FLv + FRv) - (T(0.5) * a) * (vR - vL);
}

// Flux through the face between cells i0 and i1 along one axis; im is left
// of i0 and ip right of i1 (for MUSCL).
template <typename T>
__device__ __forceinline__ void face_flux(const BurgersArgs<T>& a, bool xdir,
                                          const T* pu, const T* pv,
                                          const T* U0, const T* V0, size_t im,
                                          size_t i0, size_t i1, size_t ip,
                                          T* Fu, T* Fv) {
  T uL, vL, uR, vR;
  if (a.muscl) {
    T pUL, pUR, pVL, pVR;
    muscl(pu[im], pu[i0], pu[i1], pu[ip], &pUL, &pUR);
    muscl(pv[im], pv[i0], pv[i1], pv[ip], &pVL, &pVR);
    uL = a.u0 * sinh(pUL);
    vL = a.u0 * sinh(pVL);
    uR = a.u0 * sinh(pUR);
    vR = a.u0 * sinh(pVR);
  } else {
    uL = U0[i0];
    vL = V0[i0];
    uR = U0[i1];
    vR = V0[i1];
  }
  rusanov(xdir, uL, vL, uR, vR, Fu, Fv);
}

template <typename T>
__global__ void __launch_bounds__(kStepThreads)
burgers_multistep_kernel(BurgersArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  const int ny = a.ny, nx = a.nx;
  const size_t n = (size_t)ny * nx;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  T* Pu = a.scratch;
  T* Pv = Pu + n;
  T* U0 = Pv + n;
  T* V0 = U0 + n;
  T* W[2][2] = {{V0 + n, V0 + 2 * n}, {V0 + 3 * n, V0 + 4 * n}};

  if (first == 0)
    for (int j = 0; j < kMaxSlots; ++j) grid_max_clear(a.slots, j);
  grid.sync();

  T t = *a.t_in, tau = *a.tau_in;
  const T growth = exp(a.dtau);
  const T* pu = a.pu_in;
  const T* pv = a.pv_in;
  for (int s = 0; s < a.k; ++s) {
    const bool to_out = ((a.k - 1 - s) & 1) == 0;
    T* qu = to_out ? a.pu_out : Pu;
    T* qv = to_out ? a.pv_out : Pv;
    const int slot = s % kMaxSlots;

    // A: decode, wavespeed max
    if (first == 0) grid_max_clear(a.slots, (s + 1) % kMaxSlots);
    LocalMax<T> lm;
    for (size_t i = first; i < n; i += stride) {
      const T u = a.u0 * sinh(pu[i]);
      const T v = a.u0 * sinh(pv[i]);
      U0[i] = u;
      V0[i] = v;
      lm.add(fabs(u) / a.dx + fabs(v) * a.inv_dy);
    }
    grid_max_add(a.slots, slot, lm);
    grid.sync();

    // B: dt
    const T smax = nan_max(grid_max_read<T>(a.slots, slot), T(1e-12));
    const T dt = nan_min(t * a.dtau, a.cfl / smax);
    const T coef = a.nu * (dt / a.nsub_t);

    // C: fluxes and the convective update
    for (size_t i = first; i < n; i += stride) {
      const int y = (int)(i / nx), x = (int)(i - (size_t)y * nx);
      const size_t row = (size_t)y * nx;
      const size_t xm2 = row + wrap1(x - 2, nx), xm1 = row + wrap1(x - 1, nx);
      const size_t xp1 = row + wrap1(x + 1, nx), xp2 = row + wrap1(x + 2, nx);
      T Fu, Fv, Fum, Fvm;
      face_flux(a, true, pu, pv, U0, V0, xm1, i, xp1, xp2, &Fu, &Fv);
      face_flux(a, true, pu, pv, U0, V0, xm2, xm1, i, xp1, &Fum, &Fvm);
      T u = U0[i] - (dt * (Fu - Fum)) / a.dx;
      T v = V0[i] - (dt * (Fv - Fvm)) / a.dx;
      if (!a.one_d) {
        const size_t ym2 = (size_t)wrap1(y - 2, ny) * nx + x;
        const size_t ym1 = (size_t)wrap1(y - 1, ny) * nx + x;
        const size_t yp1 = (size_t)wrap1(y + 1, ny) * nx + x;
        const size_t yp2 = (size_t)wrap1(y + 2, ny) * nx + x;
        face_flux(a, false, pu, pv, U0, V0, ym1, i, yp1, yp2, &Fu, &Fv);
        face_flux(a, false, pu, pv, U0, V0, ym2, ym1, i, yp1, &Fum, &Fvm);
        u = u - (dt * (Fu - Fum)) / a.dy;
        v = v - (dt * (Fv - Fvm)) / a.dy;
      }
      W[0][0][i] = u;
      W[0][1][i] = v;
    }

    // viscosity substeps; the last one encodes into the next phi
    for (int j = 0; j < a.nsub; ++j) {
      grid.sync();
      const T* su = W[j & 1][0];
      const T* sv = W[j & 1][1];
      const bool last = j == a.nsub - 1;
      T* du = last ? qu : W[(j + 1) & 1][0];
      T* dv = last ? qv : W[(j + 1) & 1][1];
      for (size_t i = first; i < n; i += stride) {
        const int y = (int)(i / nx), x = (int)(i - (size_t)y * nx);
        const size_t row = (size_t)y * nx;
        const size_t r = row + wrap1(x + 1, nx), l = row + wrap1(x - 1, nx);
        const size_t d = (size_t)wrap1(y + 1, ny) * nx + x;
        const size_t up = (size_t)wrap1(y - 1, ny) * nx + x;
        const T uc = su[i], vc = sv[i];
        const T lap_u = ((su[r] - T(2) * uc) + su[l]) * a.inv_dx2 +
                        ((su[d] - T(2) * uc) + su[up]) * a.inv_dy2;
        const T lap_v = ((sv[r] - T(2) * vc) + sv[l]) * a.inv_dx2 +
                        ((sv[d] - T(2) * vc) + sv[up]) * a.inv_dy2;
        const T un = uc + coef * lap_u;
        const T vn = vc + coef * lap_v;
        du[i] = last ? asinh(un / a.u0) : un;
        dv[i] = last ? asinh(vn / a.u0) : vn;
      }
    }

    t = t * growth;
    tau = tau + a.dtau;
    pu = qu;
    pv = qv;
  }
  if (first == 0) {
    *a.t_out = t;
    *a.tau_out = tau;
  }
}

template <typename T>
int launch(const T* pu, const T* pv, const T* t, const T* tau, T* pu_out,
           T* pv_out, T* t_out, T* tau_out, T* scratch,
           unsigned long long* slots, const BurgersParams* p, int device,
           void* stream) {
  if (p->k < 1 || p->visc_substeps < 1) return (int)cudaErrorInvalidValue;
  BurgersArgs<T> a{pu, pv, t, tau, pu_out, pv_out, t_out, tau_out, scratch,
                   slots, p->ny, p->nx, p->k, p->muscl, p->one_d,
                   p->visc_substeps, T(p->u0), T(p->dx), T(p->dy),
                   T(p->inv_dy), T(p->cfl), T(p->dtau), T(p->inv_dx2),
                   T(p->inv_dy2), T(p->nu), T(p->visc_substeps)};
  return launch_cooperative(burgers_multistep_kernel<T>, a,
                            (long long)p->ny * p->nx, device, stream);
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_burgers_multistep_f32(const float* pu, const float* pv,
                              const float* t, const float* tau, float* pu_out,
                              float* pv_out, float* t_out, float* tau_out,
                              float* scratch, unsigned long long* slots,
                              const fst::BurgersParams* p, int device,
                              void* stream) {
  return fst::launch<float>(pu, pv, t, tau, pu_out, pv_out, t_out, tau_out,
                            scratch, slots, p, device, stream);
}

int fst_burgers_multistep_f64(const double* pu, const double* pv,
                              const double* t, const double* tau,
                              double* pu_out, double* pv_out, double* t_out,
                              double* tau_out, double* scratch,
                              unsigned long long* slots,
                              const fst::BurgersParams* p, int device,
                              void* stream) {
  return fst::launch<double>(pu, pv, t, tau, pu_out, pv_out, t_out, tau_out,
                             scratch, slots, p, device, stream);
}

}  // extern "C"
