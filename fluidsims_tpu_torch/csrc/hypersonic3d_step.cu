// One cell update of the 3-D hypersonic solver: WENO5 faces -> HLLC with
// wall mirroring -> conservative update -> repair -> Landau-Teller ->
// sponges, i.e. `step_core_padded` of fluidsims_tpu_torch/solvers/
// hypersonic3d.py (slab sponges), for float and double.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/hypersonic3d_pallas.py::
// _band_kernel (pallas_call at :135).  That kernel ran the same core on
// a VMEM-resident z band assembled from three overlapping blocks, with
// y tiles padded to 8 rows and dense wall fluxes and sponges, all forced
// by Mosaic.  None of that is carried over: this kernel reads the halo-3
// padded primitives that `_padded_prims` builds in torch, computes the
// function per cell, and applies each sponge only in its x slab.
//
// Design: one thread per interior cell (x fastest, then y, then z, as the
// (z, y, x) arrays are laid out).  Along each axis the thread reads the
// 7-cell line i-3 .. i+3 of each field and forms the four WENO5 face
// values it needs (left/right state at its minus and plus face) one field
// at a time, so only 4 x 6 face values stay live, not 7 x 6 samples.
// Then per face: the floors, stencil degradation (any solid among the six
// cells -2..+3 around the face -> the floored first-order pair), HLLC.  A
// face touching a solid cell takes this cell's own mirrored problem
// instead (minus face: hllc_wall_flux(q, left=false), plus face: left=
// true).  So every interior face is solved twice, once from each side, as
// the reference's k_step does.  Then dU (x, then y, then z), U1 = U0 +
// dt dU, the repair to inflow, Landau-Teller and the sponges.  dt and the
// inflow gain are read from one-element device tensors.
//
// What bounds it on an H100: arithmetic.  Counting each face once (the
// work of the JAX function) a cell costs ~2,300 operations: per axis 6
// WENO pairs of ~76 (3 divisions per cell for the smoothness weights, 2
// per face for the weighted sums), the floors and one HLLC of ~250, and
// ~150 for the update, repair, Landau-Teller and sponges (HYP3D_STEP_OPS_
// PER_CELL in chip_smoke.py).  At 256^3 f32 that is ~39 GFLOP, 0.58 ms at
// 67 TFLOP/s, against ~0.85 GB of traffic (0.25 ms at 3.35 TB/s).
// Solving each face twice doubles the face work.  Registers limit
// occupancy (ptxas' counts are in the build log, which chip_smoke.py
// prints, and in PERF.md); staging the face values of a tile in shared
// memory to solve each face once is the first thing a faster version would
// do.
#include "hypersonic3d.cuh"

namespace fst {
namespace {

template <typename T>
struct Step3Args {
  const T* __restrict__ q[6];          // padded prims (nz+6, ny+6, nx+6)
  const uint8_t* __restrict__ solid;   // padded solid mask, 1 = solid
  const T* __restrict__ dt;            // one element, on the device
  const T* __restrict__ gain;          // one element, on the device
  T* __restrict__ out[6];              // (nz, ny, nx)
  int nz, ny, nx;                      // interior cells
  int nx_global, x0, sponge_n, sponge_out_n;
  Gas3<T> gas;
  T inv_d[3];
  T infl[6];
  T tau_vib, sponge_strength, sponge_out_strength, tgt_r, tgt_p, tgt_ev;
  T inflow_vel[3];
};

// All of one cell's work along AXIS: adds -(Fp - Fm) * inv_d to dU.
template <typename T, int AXIS>
__device__ void axis_update(const Step3Args<T>& A, ptrdiff_t c,
                            ptrdiff_t stride,
                            const Q6<T>& qc, Q6<T>& dU) {
  const Gas3<T>& g = A.gas;
  // solid flags of the line i-3 .. i+3
  bool s[7];
#pragma unroll
  for (int k = 0; k < 7; ++k)
    s[k] = __ldg(A.solid + c + (k - 3) * stride) != 0;
  const bool wall_m = s[2] || s[3];      // minus face touches a solid
  const bool wall_p = s[3] || s[4];
  const bool deg_m = s[0] || s[1] || s[2] || s[3] || s[4] || s[5];
  const bool deg_p = s[1] || s[2] || s[3] || s[4] || s[5] || s[6];

  Q6<T> Lm, Rm, Lp, Rp;
  if (!(wall_m && wall_p)) {
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      T v[7];
#pragma unroll
      for (int k = 0; k < 7; ++k)
        v[k] = __ldg(A.q[f] + c + (k - 3) * stride);
      if (deg_m || deg_p) {  // first-order pairs (floored below)
        Lm.f[f] = v[2];
        Rm.f[f] = v[3];
        Lp.f[f] = v[3];
        Rp.f[f] = v[4];
      }
      if (!(deg_m && deg_p)) {
        const WenoFaces<T> w = weno_pair(v);
        if (!deg_m) { Lm.f[f] = w.Lm; Rm.f[f] = w.Rm; }
        if (!deg_p) { Lp.f[f] = w.Lp; Rp.f[f] = w.Rp; }
      }
    }
  }
  const Q6<T> Fm = wall_m ? hllc_wall_flux<T, AXIS>(qc, false, g)
                          : hllc_flux<T, AXIS>(floor_prim(Lm), floor_prim(Rm), g);
  const Q6<T> Fp = wall_p ? hllc_wall_flux<T, AXIS>(qc, true, g)
                          : hllc_flux<T, AXIS>(floor_prim(Lp), floor_prim(Rp), g);
  const T inv_d = A.inv_d[AXIS];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const T contrib = (-(Fp.f[k] - Fm.f[k])) * inv_d;
    dU.f[k] = AXIS == 0 ? contrib : dU.f[k] + contrib;
  }
}

template <typename T>
__global__ void __launch_bounds__(128)
step3_kernel(const Step3Args<T> A) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= A.nx || y >= A.ny) return;
  const ptrdiff_t pnx = (ptrdiff_t)A.nx + 6, pny = (ptrdiff_t)A.ny + 6;
  const ptrdiff_t c = ((ptrdiff_t)(z + 3) * pny + (y + 3)) * pnx + (x + 3);
  const Gas3<T>& g = A.gas;

  Q6<T> qc;
#pragma unroll
  for (int f = 0; f < 6; ++f) qc.f[f] = __ldg(A.q[f] + c);

  Q6<T> dU;
  axis_update<T, 0>(A, c, 1, qc, dU);
  axis_update<T, 1>(A, c, pnx, qc, dU);
  axis_update<T, 2>(A, c, pnx * pny, qc, dU);

  const T dt = *A.dt;
  const Q6<T> U0 = prim_to_cons(qc, g);
  Q6<T> U1;
#pragma unroll
  for (int k = 0; k < 6; ++k) U1.f[k] = U0.f[k] + dt * dU.f[k];
  Q6<T> q = cons_to_prim(U1, g);

  // non-finite / non-physical repair -> inflow
  bool bad = (q.f[R_] <= T(0)) || (q.f[P_] <= T(0)) || (q.f[EV_] < T(0));
#pragma unroll
  for (int k = 0; k < 6; ++k) bad = bad || !isfinite(q.f[k]);
  if (bad) {
#pragma unroll
    for (int k = 0; k < 6; ++k) q.f[k] = A.infl[k];
  }

  // Landau-Teller relaxation
  const T T1 = q.f[P_] / (q.f[R_] * g.R);
  const T ev_eq = evib_eq(T1, g);
  const T relax = dt / A.tau_vib;
  q.f[EV_] = nmax(q.f[EV_] + (ev_eq - q.f[EV_]) * relax, T(0));

  // sponges, each in its slab of global x
  const int xg = A.x0 + x;
  if (A.sponge_n > 0 && xg >= 0 && xg < A.sponge_n) {
    const T sramp = clip01(T(1) - T(xg) / T(A.sponge_n));
    const T k = A.sponge_strength * (sramp * sramp);
    const T gain = *A.gain;
    q.f[R_] = nmax(q.f[R_] + k * (A.tgt_r - q.f[R_]), rp_floor<T>());
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T tgt = gain * A.inflow_vel[a];
      q.f[1 + a] = q.f[1 + a] + k * (tgt - q.f[1 + a]);
    }
    q.f[P_] = nmax(q.f[P_] + k * (A.tgt_p - q.f[P_]), rp_floor<T>());
    q.f[EV_] = nmax(q.f[EV_] + k * (A.tgt_ev - q.f[EV_]), T(0));
  }
  const int out_lo = A.nx_global - A.sponge_out_n;
  if (A.sponge_out_n > 0 && xg >= out_lo && xg < A.nx_global) {
    const T xo = T(xg) - T(out_lo);
    const T oramp = clip01(xo / T(A.sponge_out_n));  // xo >= 0 in the slab
    const T k = A.sponge_out_strength * (oramp * oramp);
    q.f[R_] = nmax(q.f[R_] + k * (A.tgt_r - q.f[R_]), rp_floor<T>());
#pragma unroll
    for (int a = 1; a <= 3; ++a) q.f[a] = q.f[a] + k * (T(0) - q.f[a]);
    q.f[P_] = nmax(q.f[P_] + k * (A.tgt_p - q.f[P_]), rp_floor<T>());
    q.f[EV_] = nmax(q.f[EV_] + k * (A.tgt_ev - q.f[EV_]), T(0));
  }

  const size_t o = ((size_t)z * A.ny + y) * A.nx + x;
#pragma unroll
  for (int k = 0; k < 6; ++k) A.out[k][o] = q.f[k];
}

template <typename T>
int launch_step3(const T* const* q, const uint8_t* solid, const T* dt,
                 const T* gain, T* const* out, const Hyp3DParams* p,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Step3Args<T> A;
  for (int k = 0; k < 6; ++k) {
    A.q[k] = q[k];
    A.out[k] = out[k];
    A.infl[k] = T(p->infl[k]);
  }
  A.solid = solid;
  A.dt = dt;
  A.gain = gain;
  A.nz = p->nz;
  A.ny = p->ny;
  A.nx = p->nx;
  A.nx_global = p->nx_global;
  A.x0 = p->x0;
  A.sponge_n = p->sponge_n;
  A.sponge_out_n = p->sponge_out_n;
  A.gas = gas3_of<T>(*p);
  for (int a = 0; a < 3; ++a) A.inv_d[a] = T(p->inv_d[a]);
  A.tau_vib = T(p->tau_vib);
  A.sponge_strength = T(p->sponge_strength);
  A.sponge_out_strength = T(p->sponge_out_strength);
  A.tgt_r = T(p->tgt_r);
  A.tgt_p = T(p->tgt_p);
  A.tgt_ev = T(p->tgt_ev);
  for (int a = 0; a < 3; ++a) A.inflow_vel[a] = T(p->infl[1 + a]);
  const dim3 block(32, 4, 1);
  const dim3 grid((p->nx + block.x - 1) / block.x,
                  (p->ny + block.y - 1) / block.y, p->nz);
  step3_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_hyp3d_step_f32(const float* r, const float* u, const float* v,
                       const float* w, const float* p, const float* ev,
                       const uint8_t* solid, const float* dt,
                       const float* gain, float* o_r, float* o_u, float* o_v,
                       float* o_w, float* o_p, float* o_ev,
                       const fst::Hyp3DParams* prm, int device, void* stream) {
  const float* q[6] = {r, u, v, w, p, ev};
  float* out[6] = {o_r, o_u, o_v, o_w, o_p, o_ev};
  return fst::launch_step3<float>(q, solid, dt, gain, out, prm, device, stream);
}

int fst_hyp3d_step_f64(const double* r, const double* u, const double* v,
                       const double* w, const double* p, const double* ev,
                       const uint8_t* solid, const double* dt,
                       const double* gain, double* o_r, double* o_u,
                       double* o_v, double* o_w, double* o_p, double* o_ev,
                       const fst::Hyp3DParams* prm, int device, void* stream) {
  const double* q[6] = {r, u, v, w, p, ev};
  double* out[6] = {o_r, o_u, o_v, o_w, o_p, o_ev};
  return fst::launch_step3<double>(q, solid, dt, gain, out, prm, device,
                                   stream);
}

}  // extern "C"
