// The prologue of a 3-D hypersonic step, for float and double: the six
// log-space state fields (xi, phi_x, phi_y, phi_z, lambda, zeta) mapped
// straight to the six halo-3 padded, boundary-resolved primitive fields
// that the step kernel (hypersonic3d_step.cu) reads, i.e.
// `_padded_prims(cfg, _decode(...), solid_pad)` of fluidsims_tpu_torch/
// solvers/hypersonic3d.py.
//
// The TPU build has no Pallas kernel for this part: the JAX step forms it
// in XLA ahead of the Pallas cell update (fluidsims_tpu/solvers/
// hypersonic3d.py, `_decode` and `_padded_prims`), and the plain PyTorch
// version is ~75 torch ops (three `cat`s a field, the outflow column,
// the wall state and six `where`s).
//
// For each padded cell (z', y', x') one thread computes, in this order:
//  * the source row: z' - 3 and y' - 3 wrapped periodically within the
//    arrays it is given (a z-slab of the sharded runner wraps within its
//    own extended slab, as the plain version does);
//  * x' < 3: the inflow state, which arrives in Hyp3DParams::infl (double,
//    rounded to T once here, as torch rounds it into a 0-d tensor);
//  * x' >= nx + 3: the outflow ghost g = x' - nx - 2 in 1..3, formed in
//    the thread from the decoded last column (transmissive: subsonic
//    pressure relaxation, reversed flow snapped to inflow) or last two
//    columns (characteristic: the g-fold extrapolation, LODI waves gated
//    on the signs of un - a, un and un + a), as `_outflow_transmissive`
//    and `_outflow_characteristic` form it;
//  * otherwise the decode of the source cell: exp, u_ref * sinh;
//  * last, where the padded mask is set, the isothermal wall state of
//    `_pwall` from that value's pressure, its e_vib the float chain of
//    `evib_eq` at T(Twall).
// Each expression keeps the Python version's order and rounds every
// constant to T once (hypersonic3d.cuh's rules; -fmad=false), so the
// result is bitwise the plain version's.
//
// What bounds it on an H100: bytes.  It reads six encoded fields and the
// padded mask and writes six padded fields (at 256^3 f32: 6 x 67.1 MB +
// 18.0 MB read, 6 x 71.9 MB written, 852 MB, 0.254 ms at 3.35 TB/s).  A
// cell costs three exp, three sinh and a few compares; a ghost column
// decodes one or two source cells more.  Threads run along x' in warps
// of 32 consecutive cells of one row, so every load and store of a warp
// is one contiguous run; a block is kPadRows rows of a z' plane.  Each
// thread loads its mask byte together with its fields.  Measured at
// 256^3 on an H100 (f32 / f64 ms a launch): 4 rows a block 0.372 /
// 0.734, 8 rows 0.381 / 0.796, 16 rows 0.396 / 0.824; the mask loaded
// after the decode, 8 rows, 0.396 / 0.821.
#include "hypersonic3d.cuh"

namespace fst {

// The constants of the prologue that Hyp3DParams does not carry, in
// double (mirrored by kernels/hypersonic3d_cuda.py _PadParams).
struct Hyp3DPadParams {
  double u_ref;
  double p_amb;     // max(inflow_p, 1e-30), the transmissive relaxation's
  double wall_div;  // R * max(Twall, 1e-6), the wall density's divisor
  double Twall;
  int characteristic;  // outflow: 0 transmissive, 1 characteristic
};

namespace {

constexpr int kPadX = 32;
constexpr int kPadRows = 4;
constexpr int kHalo3 = 3;

__device__ __forceinline__ float dsinh(float x) { return sinhf(x); }
__device__ __forceinline__ double dsinh(double x) { return sinh(x); }

template <typename T>
struct Pad3Args {
  const T* enc[6];  // xi, phi_x, phi_y, phi_z, lambda, zeta: (nz, ny, nx)
  const uint8_t* solid;  // (nz + 6, ny + 6, nx + 6)
  T* out[6];             // r, u, v, w, p, ev: (nz + 6, ny + 6, nx + 6)
  int nz, ny, nx;
  int characteristic;
  T infl[6];
  T u_ref, p_amb, wall_div, Twall;
  Gas3<T> gas;
};

// The primitives of source cell i (_decode).
template <typename T>
__device__ __forceinline__ Q6<T> decode(const Pad3Args<T>& A, size_t i) {
  Q6<T> q;
  q.f[R_] = dexp(A.enc[0][i]);
  q.f[U_] = A.u_ref * dsinh(A.enc[1][i]);
  q.f[V_] = A.u_ref * dsinh(A.enc[2][i]);
  q.f[W_] = A.u_ref * dsinh(A.enc[3][i]);
  q.f[P_] = dexp(A.enc[4][i]);
  q.f[EV_] = dexp(A.enc[5][i]);
  return q;
}

// _outflow_transmissive at one cell of the last column.
template <typename T>
__device__ __forceinline__ Q6<T> outflow_transmissive(const Pad3Args<T>& A,
                                                      const Q6<T>& qR) {
  const T un = qR.f[U_];
  if (un < T(0)) {  // reversed flow snaps to inflow
    Q6<T> q;
#pragma unroll
    for (int k = 0; k < 6; ++k) q.f[k] = A.infl[k];
    return q;
  }
  const T aR = soundspeed(qR.f[R_], qR.f[P_], A.gas);
  const T relax_p =
      nmax(qR.f[P_] + T(0.05) * (A.p_amb - qR.f[P_]), rp_floor<T>());
  const T p_out = un < aR ? relax_p : qR.f[P_];
  Q6<T> q = qR;
  q.f[R_] = nmax(qR.f[R_], rp_floor<T>());
  q.f[P_] = nmax(p_out, rp_floor<T>());
  q.f[EV_] = nmax(qR.f[EV_], T(0));
  return q;
}

// Ghost g of _outflow_characteristic, from the last (qR) and second-last
// (qL) cells of the row.
template <typename T>
__device__ __forceinline__ Q6<T> outflow_characteristic(
    const Pad3Args<T>& A, const Q6<T>& qR, const Q6<T>& qL, int g) {
  const T a = soundspeed(qR.f[R_], qR.f[P_], A.gas);
  const T a2 = a * a;
  const T rho_ref = nmax(qR.f[R_], rp_floor<T>());
  const T un = qR.f[U_];
  const T gf = T(g);
  Q6<T> ex;
#pragma unroll
  for (int k = 0; k < 6; ++k)
    ex.f[k] = qR.f[k] + gf * (qR.f[k] - qL.f[k]);
  ex.f[R_] = nmax(ex.f[R_], rp_floor<T>());
  ex.f[P_] = nmax(ex.f[P_], rp_floor<T>());
  ex.f[EV_] = nmax(ex.f[EV_], T(0));
  const T* qT = A.infl;
  const T drho = ex.f[R_] - qT[R_];
  const T du = ex.f[U_] - qT[U_];
  const T dp = ex.f[P_] - qT[P_];
  const T dpa2 = dp / a2;
  const T rdua = (rho_ref * du) / a;
  T L1 = T(0.5) * (dpa2 - rdua);
  T L5 = T(0.5) * (dpa2 + rdua);
  T L2 = drho - dpa2;
  T L3 = ex.f[V_] - qT[V_];
  T L4 = ex.f[W_] - qT[W_];
  T L6 = ex.f[EV_] - qT[EV_];
  if (un - a < T(0)) L1 = T(0);
  if (un < T(0)) L2 = L3 = L4 = L6 = T(0);
  if (un + a < T(0)) L5 = T(0);
  Q6<T> q;
  q.f[R_] = nmax(((qT[R_] + L1) + L2) + L5, rp_floor<T>());
  q.f[U_] = qT[U_] + (L5 - L1) / nmax(rho_ref * a, denom_eps<T>());
  q.f[V_] = qT[V_] + L3;
  q.f[W_] = qT[W_] + L4;
  q.f[P_] = nmax(qT[P_] + a2 * (L1 + L5), rp_floor<T>());
  q.f[EV_] = nmax(qT[EV_] + L6, T(0));
  return q;
}

template <typename T>
__global__ void __launch_bounds__(kPadX * kPadRows)
    pad3_kernel(const Pad3Args<T> A) {
  const int nxp = A.nx + 2 * kHalo3, nyp = A.ny + 2 * kHalo3;
  const int xp = blockIdx.x * kPadX + threadIdx.x;
  const int yp = blockIdx.y * kPadRows + threadIdx.y;
  const int zp = blockIdx.z;
  if (xp >= nxp || yp >= nyp) return;
  int zs = zp - kHalo3, ys = yp - kHalo3;
  zs += zs < 0 ? A.nz : 0;
  zs -= zs >= A.nz ? A.nz : 0;
  ys += ys < 0 ? A.ny : 0;
  ys -= ys >= A.ny ? A.ny : 0;
  const size_t row = ((size_t)zs * A.ny + ys) * A.nx;
  const size_t o = ((size_t)zp * nyp + yp) * nxp + xp;
  const bool solid = A.solid[o];  // loaded with the fields, not after

  Q6<T> q;
  if (xp < kHalo3) {
#pragma unroll
    for (int k = 0; k < 6; ++k) q.f[k] = A.infl[k];
  } else if (xp < A.nx + kHalo3) {
    q = decode(A, row + (xp - kHalo3));
  } else {
    const Q6<T> qR = decode(A, row + (A.nx - 1));
    if (A.characteristic) {
      const Q6<T> qL = A.nx > 1 ? decode(A, row + (A.nx - 2)) : qR;
      q = outflow_characteristic(A, qR, qL, xp - A.nx - kHalo3 + 1);
    } else {
      q = outflow_transmissive(A, qR);
    }
  }

  if (solid) {  // _pwall
    const T p_keep = nmax(q.f[P_], rp_floor<T>());
    q.f[R_] = nmax(p_keep / A.wall_div, rp_floor<T>());
    q.f[U_] = q.f[V_] = q.f[W_] = T(0);
    q.f[P_] = p_keep;
    q.f[EV_] = evib_eq(A.Twall, A.gas);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) A.out[k][o] = q.f[k];
}

template <typename T>
int launch_pad3(const T* const* enc, const uint8_t* solid, T* const* out,
                const Hyp3DParams* p, const Hyp3DPadParams* pp, int device,
                void* stream) {
  if (p->nz < kHalo3 || p->ny < kHalo3 || p->nx < 1)
    return (int)cudaErrorInvalidValue;
  const int nxp = p->nx + 2 * kHalo3, nyp = p->ny + 2 * kHalo3,
            nzp = p->nz + 2 * kHalo3;
  const dim3 grid((nxp + kPadX - 1) / kPadX, (nyp + kPadRows - 1) / kPadRows,
                  nzp);
  if (grid.y > 65535u || grid.z > 65535u)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Pad3Args<T> A;
  for (int k = 0; k < 6; ++k) {
    A.enc[k] = enc[k];
    A.out[k] = out[k];
    A.infl[k] = T(p->infl[k]);
  }
  A.solid = solid;
  A.nz = p->nz;
  A.ny = p->ny;
  A.nx = p->nx;
  A.characteristic = pp->characteristic;
  A.u_ref = T(pp->u_ref);
  A.p_amb = T(pp->p_amb);
  A.wall_div = T(pp->wall_div);
  A.Twall = T(pp->Twall);
  A.gas = gas3_of<T>(*p);
  pad3_kernel<T><<<grid, dim3(kPadX, kPadRows), 0, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_hyp3d_pad_f32(const float* xi, const float* phix, const float* phiy,
                      const float* phiz, const float* lam, const float* zet,
                      const uint8_t* solid_pad, float* o_r, float* o_u,
                      float* o_v, float* o_w, float* o_p, float* o_ev,
                      const fst::Hyp3DParams* prm,
                      const fst::Hyp3DPadParams* pad, int device,
                      void* stream) {
  const float* enc[6] = {xi, phix, phiy, phiz, lam, zet};
  float* out[6] = {o_r, o_u, o_v, o_w, o_p, o_ev};
  return fst::launch_pad3<float>(enc, solid_pad, out, prm, pad, device,
                                 stream);
}

int fst_hyp3d_pad_f64(const double* xi, const double* phix,
                      const double* phiy, const double* phiz,
                      const double* lam, const double* zet,
                      const uint8_t* solid_pad, double* o_r, double* o_u,
                      double* o_v, double* o_w, double* o_p, double* o_ev,
                      const fst::Hyp3DParams* prm,
                      const fst::Hyp3DPadParams* pad, int device,
                      void* stream) {
  const double* enc[6] = {xi, phix, phiy, phiz, lam, zet};
  double* out[6] = {o_r, o_u, o_v, o_w, o_p, o_ev};
  return fst::launch_pad3<double>(enc, solid_pad, out, prm, pad, device,
                                  stream);
}

}  // extern "C"
