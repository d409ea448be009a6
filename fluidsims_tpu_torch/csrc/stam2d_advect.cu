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
// Over a column window (the x-slab runner, parallel/stam2d_sharded.py, as
// JAX's fluidsims_tpu/parallel/stam2d_sharded.py::_advect_sharded does
// it): the launch writes n_loc columns from global column col_off on, and
// reads the fields from their exchanged slab of n_loc + 2h columns (the
// first at padded-space column lo = col_off + 1 - h, zero past the domain
// edges).  The back-trace's column i0 is clamped to [lo, lo + n_loc + 2h -
// 2], so that i0 + 1 stays in the slab; s1 = clip(s - i0, 0, 1); rows stay
// exact.  Each clamped cell adds one to a device int32 for every field
// the launch advects (JAX advects the velocity pair in two calls and counts
// each): a warp adds its clamps with one atomicAdd, and nothing is read
// back to the host.  Unclamped, the clip is no operation, so a window's
// cells have the whole field's bits.  The whole field (h = 0 at the C
// interface) reads the n interior columns, the ring columns as 0, with the
// clamp [0, n], which never fires, and counts nothing.
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
  const T* qa;    // (n, w) slab of the first field
  const T* qb;    // the second field's slab, or null
  const T* uu;    // (n, n_loc)
  const T* vv;
  const T* eta_x; // (n_loc,) cell-centre eta of the output's columns
  const T* xp;    // (n_loc,) x0 e^eta of the output's columns
  const T* eta_y; // (n,) cell-centre eta of the rows
  const T* yp;    // (n,) y0 e^eta of the rows
  T* outa;        // (n, n_loc)
  T* outb;        // null with qb
  int* ovf;       // clamped cells, added to; null: not counted
  int n;          // the global grid's n (rows, and padded-space [0, n + 1])
  int n_loc;      // output columns
  int w;          // slab columns
  int c0;         // padded-space column of the slab's first column
  int lo, hi;     // the clamp of the back-trace's column
  T dt;
  T eta_min;
  T deta;
};

// q at padded-space (jj, ii): the slab's cell (jj - 1, ii - c0) where it
// holds one inside the interior [1, n]^2, else the zero ring (or the
// slab's zero fill past a domain edge, the same value).
template <typename T>
__device__ __forceinline__ T corner(const AdvectArgs<T>& p, const T* q,
                                    int jj, int ii) {
  const int c = ii - p.c0;
  if (jj < 1 || jj > p.n || ii < 1 || ii > p.n || c < 0 || c >= p.w)
    return T(0);
  return __ldg(q + (size_t)(jj - 1) * p.w + c);
}

template <typename T>
__device__ __forceinline__ T blend(const AdvectArgs<T>& p, const T* q,
                                   int j0, int i0, T s0, T s1, T t0, T t1) {
  const T q00 = corner(p, q, j0, i0);
  const T q01 = corner(p, q, j0 + 1, i0);
  const T q10 = corner(p, q, j0, i0 + 1);
  const T q11 = corner(p, q, j0 + 1, i0 + 1);
  return s0 * (t0 * q00 + t1 * q01) + s1 * (t0 * q10 + t1 * q11);
}

template <typename T>
__global__ void __launch_bounds__(256) advect_kernel(AdvectArgs<T> p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;   // local column
  const int j = blockIdx.y * blockDim.y + threadIdx.y;   // row
  bool clamped = false;
  if (i < p.n_loc && j < p.n) {
    const size_t s = (size_t)j * p.n_loc + i;
    const T half = T(0.5), hi = T((double)p.n + 0.5), zero = T(0),
            one = T(1);
    const T bx = __ldg(p.eta_x + i) - p.dt * __ldg(p.uu + s) / __ldg(p.xp + i);
    const T by = __ldg(p.eta_y + j) - p.dt * __ldg(p.vv + s) / __ldg(p.yp + j);
    T sx = (bx - p.eta_min) / p.deta + half;
    T ty = (by - p.eta_min) / p.deta + half;
    sx = sx < half ? half : (sx > hi ? hi : sx);
    ty = ty < half ? half : (ty > hi ? hi : ty);
    const int i0 = (int)floor(sx);   // padded space, in [0, n]
    const int j0 = (int)floor(ty);
    const int i0c = i0 < p.lo ? p.lo : (i0 > p.hi ? p.hi : i0);
    clamped = i0c != i0;
    T s1 = sx - T(i0c);
    s1 = s1 < zero ? zero : (s1 > one ? one : s1);
    const T t1 = ty - T(j0);
    const T s0 = one - s1, t0 = one - t1;
    p.outa[s] = blend(p, p.qa, j0, i0c, s0, s1, t0, t1);
    if (p.qb != nullptr) p.outb[s] = blend(p, p.qb, j0, i0c, s0, s1, t0, t1);
  }
  if (p.ovf != nullptr) {
    // a warp is 32 columns of one row (blocks of 32 x 8): one add a warp
    const unsigned m = __ballot_sync(0xffffffffu, clamped);
    if (m != 0u && (threadIdx.x & 31) == 0)
      atomicAdd(p.ovf, __popc(m) * (p.qb != nullptr ? 2 : 1));
  }
}

template <typename T>
int launch_advect(const AdvectArgs<T>& args, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (args.n < 1 || args.n_loc < 1 || args.w < 1 || args.lo > args.hi)
    return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((args.n_loc + block.x - 1) / block.x,
                  (args.n + block.y - 1) / block.y);
  advect_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

// The window of n_loc columns from global column col_off, on a slab of
// n_loc + 2h columns; h = 0 is the whole field (n_loc = n, col_off = 0)
// on its n interior columns.
template <typename T>
int advect(const T* qa, const T* qb, const T* uu, const T* vv,
           const T* eta_x, const T* xp, const T* eta_y, const T* yp, T* outa,
           T* outb, int* ovf, int n, int n_loc, int col_off, int h,
           double dt, double eta_min, double deta, int device, void* stream) {
  AdvectArgs<T> a{qa, qb, uu, vv, eta_x, xp, eta_y, yp, outa, outb, ovf, n,
                  n_loc, 0, 0, 0, 0, T(dt), T(eta_min), T(deta)};
  if (h == 0) {
    if (n_loc != n || col_off != 0) return (int)cudaErrorInvalidValue;
    a.w = n;
    a.c0 = 1;
    a.lo = 0;
    a.hi = n;
  } else {
    a.w = n_loc + 2 * h;
    a.c0 = a.lo = col_off + 1 - h;
    a.hi = a.lo + n_loc + 2 * h - 2;
  }
  return launch_advect(a, device, stream);
}

}  // namespace
}  // namespace fst

extern "C" {

// qb and outb are null for one field; ovf null for no count.  h = 0: the
// whole (n, n) field; else the window of n_loc columns from col_off on a
// slab of n_loc + 2h columns.
int fst_stam2d_advect_f32(const float* qa, const float* qb, const float* uu,
                          const float* vv, const float* eta_x,
                          const float* xp, const float* eta_y,
                          const float* yp, float* outa, float* outb, int* ovf,
                          int n, int n_loc, int col_off, int h, double dt,
                          double eta_min, double deta, int device,
                          void* stream) {
  return fst::advect<float>(qa, qb, uu, vv, eta_x, xp, eta_y, yp, outa, outb,
                            ovf, n, n_loc, col_off, h, dt, eta_min, deta,
                            device, stream);
}

int fst_stam2d_advect_f64(const double* qa, const double* qb,
                          const double* uu, const double* vv,
                          const double* eta_x, const double* xp,
                          const double* eta_y, const double* yp,
                          double* outa, double* outb, int* ovf, int n,
                          int n_loc, int col_off, int h, double dt,
                          double eta_min, double deta, int device,
                          void* stream) {
  return fst::advect<double>(qa, qb, uu, vv, eta_x, xp, eta_y, yp, outa,
                             outb, ovf, n, n_loc, col_off, h, dt, eta_min,
                             deta, device, stream);
}

}  // extern "C"
