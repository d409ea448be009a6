// One cell update of the flagship 2-D hypersonic solver: BC padding +
// MUSCL-Hancock predict + HLLC faces + conservative update + 4th-order
// diffusion + positivity repair, i.e. `pad_bc` + `step_core_padded` of
// fluidsims_tpu_torch/solvers/hypersonic2d.py, for float and double.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/hypersonic2d_pallas.py::
// _band_kernel (pallas_call at :156).  That kernel ran the same core on a
// VMEM-resident row band whose halo-2 padded copy the host built each step
// (Pallas blocks cannot overlap); here no padded copy exists: `load_bc`
// resolves the boundary conditions by index arithmetic with exactly the
// pad_bc semantics (y edge-clamped for fields and mask; x < 0 the inflow
// constant; x >= nx the last column; the mask False in the x pads).
//
// Design: one thread per interior cell.  Each thread predicts the face
// states of itself and its four neighbours along the two axes (6 MUSCL-
// Hancock predicts) and solves its own four faces with HLLC, so every face
// is solved twice and every predict three times.  Solid cells return their
// input at once, and the predict of a solid neighbour, which the wall
// ghost replaces, is skipped.  dt is read from a one-element device tensor.
//
// What bounds it on an H100: arithmetic, not bytes.  At 2048^2 f32 a step
// streams ~67 MB of fields + 4 MB of mask in and 67 MB out (~41 us at
// 3.35 TB/s), while each cell runs 6 predicts and 4 HLLC solves with ~130
// IEEE divisions and 8 square roots, unfused (-fmad=false) — the redundant
// recomputation is the price of needing no shared memory or second pass.
// Registers limit occupancy (ptxas' counts are in the build log, which
// chip_smoke.py prints, and in PERF.md); __launch_bounds__(128) keeps
// 128-thread blocks resident.
// Tiling faces through shared memory to drop the recomputation is the
// first thing a faster version would do.
#include "euler2d.cuh"

namespace fst {
namespace {

template <typename T>
struct StepArgs {
  const T* __restrict__ f[4];          // rho, mx, my, E  (ny, nx) row-major
  const uint8_t* __restrict__ mask;    // bool (ny, nx), 1 = solid
  const T* __restrict__ dt;            // one element, on the device
  T* __restrict__ out[4];
  int ny, nx;
  Gas<T> gas;
  T visc_rho, visc_nu, visc_e;
  Q4<T> infl;
};

// Field value at logical (y, x) with the BCs of pad_bc; x in [-2, nx+1].
template <typename T>
__device__ __forceinline__ Q4<T> load_bc(const StepArgs<T>& A, int y, int x) {
  if (x < 0) return A.infl;
  const int yc = min(max(y, 0), A.ny - 1);
  const int xc = min(x, A.nx - 1);
  const size_t i = (size_t)yc * A.nx + xc;
  return {__ldg(A.f[0] + i), __ldg(A.f[1] + i), __ldg(A.f[2] + i),
          __ldg(A.f[3] + i)};
}

template <typename T>
__device__ __forceinline__ bool solid_bc(const StepArgs<T>& A, int y, int x) {
  if (x < 0 || x >= A.nx) return false;
  const int yc = min(max(y, 0), A.ny - 1);
  return __ldg(A.mask + (size_t)yc * A.nx + x) != 0;
}

template <typename T>
__device__ __forceinline__ T slope(T m, T c, T p) {
  return mc_limiter(c - m, T(0.5) * (p - m), p - c);
}

template <typename T>
__device__ __forceinline__ Q4<T> blend(Q4<T> a, Q4<T> c) {
  return {T(0.5) * (a.r + c.r), T(0.5) * (a.a + c.a), T(0.5) * (a.b + c.b),
          T(0.5) * (a.e + c.e)};
}

template <typename T>
__device__ __forceinline__ Q4<T> half_step(Q4<T> q, Q4<T> dF, T half_dt,
                                           Gas<T> g) {
  Q4<T> c = prim_to_cons(q, g);
  c = {c.r - half_dt * dF.r, c.a - half_dt * dF.a, c.b - half_dt * dF.b,
       c.e - half_dt * dF.e};
  return clamp_prim(cons_to_prim(c, g));
}

// MUSCL-Hancock predicted (low, high) face states, in conserved variables,
// of the cell at logical (y, x) along AXIS (predict_axis of the solver).
template <typename T, int AXIS>
__device__ void predict(const StepArgs<T>& A, int y, int x, T half_dt,
                        Q4<T>* lo, Q4<T>* hi) {
  const Gas<T> g = A.gas;
  const int dy = AXIS == 1, dx = AXIS == 0;
  const Q4<T> qc = cons_to_prim(load_bc(A, y, x), g);
  const Q4<T> ghost = prim_to_cons(wall_ghost(qc), g);
  const Q4<T> qm = cons_to_prim(
      solid_bc(A, y - dy, x - dx) ? ghost : load_bc(A, y - dy, x - dx), g);
  const Q4<T> qp = cons_to_prim(
      solid_bc(A, y + dy, x + dx) ? ghost : load_bc(A, y + dy, x + dx), g);

  // reconstruct_faces: MC-limited slopes to the two faces ...
  const T sr = slope(qm.r, qc.r, qp.r), sa = slope(qm.a, qc.a, qp.a);
  const T sb = slope(qm.b, qc.b, qp.b), se = slope(qm.e, qc.e, qp.e);
  Q4<T> qL = {qc.r - T(0.5) * sr, qc.a - T(0.5) * sa, qc.b - T(0.5) * sb,
              qc.e - T(0.5) * se};
  Q4<T> qR = {qc.r + T(0.5) * sr, qc.a + T(0.5) * sa, qc.b + T(0.5) * sb,
              qc.e + T(0.5) * se};
  // ... then enforce_positive_faces.  The Python version runs 8 masked
  // rounds; a round leaves a valid pair untouched and it stays valid, so
  // stopping at the first valid round gives the same values.
  for (int it = 0; it < 8; ++it) {
    const bool bad = (qL.r <= eps_rho<T>()) || (qR.r <= eps_rho<T>()) ||
                     (qL.e <= eps_p<T>()) || (qR.e <= eps_p<T>());
    if (!bad) break;
    qL = blend(qL, qc);
    qR = blend(qR, qc);
  }
  qL = clamp_prim(qL);
  qR = clamp_prim(qR);

  const Q4<T> cL = prim_to_cons(qL, g), cR = prim_to_cons(qR, g);
  const Q4<T> FL = flux_of<T, AXIS>(cL, cons_to_prim(cL, g));
  const Q4<T> FR = flux_of<T, AXIS>(cR, cons_to_prim(cR, g));
  const Q4<T> dF = {FR.r - FL.r, FR.a - FL.a, FR.b - FL.b, FR.e - FL.e};
  *lo = prim_to_cons(clamp_prim(half_step(qL, dF, half_dt, g)), g);
  *hi = prim_to_cons(clamp_prim(half_step(qR, dF, half_dt, g)), g);
}

// Both faces of the fluid cell (y, x) along AXIS: F[0] the low face, F[1]
// the high.  A solid neighbour's side of a face is the wall ghost of this
// cell (`ghost`), and its predict is skipped; with a fluid centre no face
// here has two solid sides, so none is zeroed.
template <typename T, int AXIS>
__device__ void faces(const StepArgs<T>& A, int y, int x, T half_dt,
                      Q4<T> ghost, Q4<T> F[2]) {
  const int dy = AXIS == 1, dx = AXIS == 0;
  Q4<T> junk, lo, hi, c_lo, c_hi;
  predict<T, AXIS>(A, y, x, half_dt, &c_lo, &c_hi);
  if (solid_bc(A, y - dy, x - dx)) lo = ghost;
  else predict<T, AXIS>(A, y - dy, x - dx, half_dt, &junk, &lo);
  if (solid_bc(A, y + dy, x + dx)) hi = ghost;
  else predict<T, AXIS>(A, y + dy, x + dx, half_dt, &hi, &junk);
  F[0] = hllc<T, AXIS>(lo, c_lo, A.gas);
  F[1] = hllc<T, AXIS>(c_hi, hi, A.gas);
}

// Diffusion neighbour: a solid neighbour takes the centre's wall ghost.
template <typename T>
__device__ __forceinline__ Q4<T> dnbr(const StepArgs<T>& A, int y, int x,
                                      Q4<T> ghost_c) {
  return solid_bc(A, y, x) ? ghost_c : load_bc(A, y, x);
}

template <typename T>
__device__ __forceinline__ T d2(T a, T b, T c, T d, T e) {
  return (-a + T(16) * b - T(30) * c + T(16) * d - e) * T(1.0 / 12.0);
}

template <typename T>
__global__ void __launch_bounds__(128)
step_kernel(const StepArgs<T> A) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= A.nx || y >= A.ny) return;
  const size_t i = (size_t)y * A.nx + x;
  const Q4<T> Uc = load_bc(A, y, x);
  if (A.mask[i]) {  // solid cells keep their state
    A.out[0][i] = Uc.r; A.out[1][i] = Uc.a; A.out[2][i] = Uc.b;
    A.out[3][i] = Uc.e;
    return;
  }
  const Gas<T> g = A.gas;
  const T dt = *A.dt;
  const T half_dt = T(0.5) * dt;
  // the centre's no-slip wall ghost: what a solid neighbour shows this
  // cell, in the face fluxes and in the diffusion stencil
  const Q4<T> ghost_c = prim_to_cons(wall_ghost(cons_to_prim(Uc, g)), g);

  Q4<T> Fx[2], Gy[2];
  faces<T, 0>(A, y, x, half_dt, ghost_c, Fx);
  faces<T, 1>(A, y, x, half_dt, ghost_c, Gy);

  // conservative update
  Q4<T> Un = {
      Uc.r - dt * (Fx[1].r - Fx[0].r) - dt * (Gy[1].r - Gy[0].r),
      Uc.a - dt * (Fx[1].a - Fx[0].a) - dt * (Gy[1].a - Gy[0].a),
      Uc.b - dt * (Fx[1].b - Fx[0].b) - dt * (Gy[1].b - Gy[0].b),
      Uc.e - dt * (Fx[1].e - Fx[0].e) - dt * (Gy[1].e - Gy[0].e)};

  // diffusion (4th-order 5-tap, halo 2)
  const Q4<T> xm2 = dnbr(A, y, x - 2, ghost_c), xm1 = dnbr(A, y, x - 1, ghost_c);
  const Q4<T> xp1 = dnbr(A, y, x + 1, ghost_c), xp2 = dnbr(A, y, x + 2, ghost_c);
  const Q4<T> ym2 = dnbr(A, y - 2, x, ghost_c), ym1 = dnbr(A, y - 1, x, ghost_c);
  const Q4<T> yp1 = dnbr(A, y + 1, x, ghost_c), yp2 = dnbr(A, y + 2, x, ghost_c);
  const Q4<T> lap = {
      d2(xm2.r, xm1.r, Uc.r, xp1.r, xp2.r) + d2(ym2.r, ym1.r, Uc.r, yp1.r, yp2.r),
      d2(xm2.a, xm1.a, Uc.a, xp1.a, xp2.a) + d2(ym2.a, ym1.a, Uc.a, yp1.a, yp2.a),
      d2(xm2.b, xm1.b, Uc.b, xp1.b, xp2.b) + d2(ym2.b, ym1.b, Uc.b, yp1.b, yp2.b),
      d2(xm2.e, xm1.e, Uc.e, xp1.e, xp2.e) + d2(ym2.e, ym1.e, Uc.e, yp1.e, yp2.e)};
  Un.r = Un.r + (A.visc_rho * dt) * lap.r;
  Un.a = Un.a + (A.visc_nu * dt) * lap.a;
  Un.b = Un.b + (A.visc_nu * dt) * lap.b;
  Un.e = Un.e + (A.visc_e * dt) * lap.e;

  // positivity / finiteness repair
  Un.r = nmax(Un.r, eps_rho<T>());
  const Q4<T> pp = cons_to_prim(Un, g);
  const bool bad = (pp.e <= eps_p<T>()) || !isfinite(pp.e) ||
                   !isfinite(pp.r) || !isfinite(pp.a) || !isfinite(pp.b);
  if (bad) Un = prim_to_cons(clamp_prim(pp), g);

  A.out[0][i] = Un.r; A.out[1][i] = Un.a; A.out[2][i] = Un.b;
  A.out[3][i] = Un.e;
}

template <typename T>
int launch_step(const T* rho, const T* mx, const T* my, const T* E,
                const uint8_t* mask, const T* dt, T* o_rho, T* o_mx, T* o_my,
                T* o_E, const Hyp2DParams* p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  StepArgs<T> A;
  A.f[0] = rho; A.f[1] = mx; A.f[2] = my; A.f[3] = E;
  A.mask = mask;
  A.dt = dt;
  A.out[0] = o_rho; A.out[1] = o_mx; A.out[2] = o_my; A.out[3] = o_E;
  A.ny = p->ny;
  A.nx = p->nx;
  A.gas = {T(p->gamma), T(p->gm1)};
  A.visc_rho = T(p->visc_rho);
  A.visc_nu = T(p->visc_nu);
  A.visc_e = T(p->visc_e);
  A.infl = {T(p->infl[0]), T(p->infl[1]), T(p->infl[2]), T(p->infl[3])};
  const dim3 block(32, 4);
  const dim3 grid((p->nx + block.x - 1) / block.x,
                  (p->ny + block.y - 1) / block.y);
  step_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_hyp2d_step_f32(const float* rho, const float* mx, const float* my,
                       const float* E, const uint8_t* mask, const float* dt,
                       float* o_rho, float* o_mx, float* o_my, float* o_E,
                       const fst::Hyp2DParams* p, int device, void* stream) {
  return fst::launch_step<float>(rho, mx, my, E, mask, dt, o_rho, o_mx, o_my,
                                 o_E, p, device, stream);
}

int fst_hyp2d_step_f64(const double* rho, const double* mx, const double* my,
                       const double* E, const uint8_t* mask, const double* dt,
                       double* o_rho, double* o_mx, double* o_my, double* o_E,
                       const fst::Hyp2DParams* p, int device, void* stream) {
  return fst::launch_step<double>(rho, mx, my, E, mask, dt, o_rho, o_mx, o_my,
                                  o_E, p, device, stream);
}

const char* fst_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
