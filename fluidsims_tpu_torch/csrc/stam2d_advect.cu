// Semi-Lagrangian advection of the 2-D stable fluids by the exact bilinear
// back-trace in eta-space, for float and double, of one or two (n, n)
// fields that share one velocity (uu, vv); the zero ring is implicit.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/stam2d_pallas.py::
// _advect_kernel (pallas_call at :243).  Mosaic has no 2-D gather, so that
// kernel gathered columns exactly with 128-lane takes but walked source
// rows over a band of +-advect_band cells, clamping (and counting) the
// back-traces that left it, and could emit the box of those cells for a
// repair.  Hopper gathers from L1/L2, so this kernel computes the
// reference's k_adv (js_cuda.cu:82-103) as JAX's exact XLA path writes it
// (solvers/stam2d.py::_backtrace_coords and _bilinear): bx = eta_i -
// dt*u/xp_i, by = eta_j - dt*v/yp_j, s = (b - eta_min)/deta + 0.5 clamped
// to [0.5, n + 0.5], floor, the 4 corners (zero outside the interior),
// and the blend s0*(t0*q00 + t1*q01) + s1*(t0*q10 + t1*q11).  No band, no
// clamp count, no box: exact at any displacement.  eta, xp and yp come in
// as 1-D tensors built by the plain version's own torch ops, deta and
// eta_min from the config (not from eta's entries), every division is
// true and the library is built with -fmad=false, so the result is
// bitwise that of the plain version.  The pair form serves the velocity
// step, which advects u0 and v0 by (u0, v0) itself: the coordinates are
// computed once for both fields, and the outputs are new buffers.
//
// What bounds it on an H100: bytes.  A cell reads uu, vv and, per field,
// its 4 corners (mostly from L1/L2: neighbouring cells trace to
// neighbouring sources) and writes one value per field: at least 16 bytes
// a cell for two f32 fields, ~1.25 us at 512^2 and 3.35 TB/s.  ~40
// operations a cell are far below the card's rate.  Rows of 32 threads
// along x keep the loads and stores of uu, vv and out coalesced.
#include <cuda_runtime.h>

#include <stddef.h>

namespace fst {
namespace {

template <typename T>
struct AdvectArgs {
  const T* qa;
  const T* qb;    // the second field, or null
  const T* uu;
  const T* vv;
  const T* eta;   // (n,) cell-centre eta
  const T* xp;    // (n,) x0 e^eta
  const T* yp;    // (n,) y0 e^eta
  T* outa;
  T* outb;        // null with qb
  int n;
  T dt;
  T eta_min;
  T deta;
};

// q at padded-space (jj, ii) in [0, n + 1]^2: the interior cell
// (jj - 1, ii - 1), or the zero ring.
template <typename T>
__device__ __forceinline__ T corner(const T* q, int jj, int ii, int n) {
  if (jj < 1 || jj > n || ii < 1 || ii > n) return T(0);
  return __ldg(q + (size_t)(jj - 1) * n + (ii - 1));
}

template <typename T>
__device__ __forceinline__ T blend(const T* q, int j0, int i0, int n, T s0,
                                   T s1, T t0, T t1) {
  const T q00 = corner(q, j0, i0, n);
  const T q01 = corner(q, j0 + 1, i0, n);
  const T q10 = corner(q, j0, i0 + 1, n);
  const T q11 = corner(q, j0 + 1, i0 + 1, n);
  return s0 * (t0 * q00 + t1 * q01) + s1 * (t0 * q10 + t1 * q11);
}

template <typename T>
__global__ void __launch_bounds__(256) advect_kernel(AdvectArgs<T> p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;   // column
  const int j = blockIdx.y * blockDim.y + threadIdx.y;   // row
  const int n = p.n;
  if (i >= n || j >= n) return;
  const size_t s = (size_t)j * n + i;
  const T half = T(0.5), hi = T((double)n + 0.5), one = T(1);
  const T bx = __ldg(p.eta + i) - p.dt * __ldg(p.uu + s) / __ldg(p.xp + i);
  const T by = __ldg(p.eta + j) - p.dt * __ldg(p.vv + s) / __ldg(p.yp + j);
  T sx = (bx - p.eta_min) / p.deta + half;
  T ty = (by - p.eta_min) / p.deta + half;
  sx = sx < half ? half : (sx > hi ? hi : sx);
  ty = ty < half ? half : (ty > hi ? hi : ty);
  const int i0 = (int)floor(sx);   // padded space, in [0, n]
  const int j0 = (int)floor(ty);
  const T s1 = sx - T(i0), t1 = ty - T(j0);
  const T s0 = one - s1, t0 = one - t1;
  p.outa[s] = blend(p.qa, j0, i0, n, s0, s1, t0, t1);
  if (p.qb != nullptr) p.outb[s] = blend(p.qb, j0, i0, n, s0, s1, t0, t1);
}

template <typename T>
int launch_advect(const T* qa, const T* qb, const T* uu, const T* vv,
                  const T* eta, const T* xp, const T* yp, T* outa, T* outb,
                  int n, double dt, double eta_min, double deta, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const AdvectArgs<T> args{qa, qb, uu, vv, eta, xp, yp, outa, outb, n,
                           T(dt), T(eta_min), T(deta)};
  const dim3 block(32, 8);
  const dim3 grid((n + block.x - 1) / block.x, (n + block.y - 1) / block.y);
  advect_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

// qb and outb are null for one field.
int fst_stam2d_advect_f32(const float* qa, const float* qb, const float* uu,
                          const float* vv, const float* eta, const float* xp,
                          const float* yp, float* outa, float* outb, int n,
                          double dt, double eta_min, double deta, int device,
                          void* stream) {
  return fst::launch_advect<float>(qa, qb, uu, vv, eta, xp, yp, outa, outb,
                                   n, dt, eta_min, deta, device, stream);
}

int fst_stam2d_advect_f64(const double* qa, const double* qb,
                          const double* uu, const double* vv,
                          const double* eta, const double* xp,
                          const double* yp, double* outa, double* outb, int n,
                          double dt, double eta_min, double deta, int device,
                          void* stream) {
  return fst::launch_advect<double>(qa, qb, uu, vv, eta, xp, yp, outa, outb,
                                    n, dt, eta_min, deta, device, stream);
}

}  // extern "C"
