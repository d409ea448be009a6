// Semi-Lagrangian advection of the 3-D stable fluids by the exact
// trilinear gather, for float and double: out = q0 sampled at the
// backtrace of every interior cell; the ghost ring of q0 passes through.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/stam3d_pallas.py::
// _advect_kernel (pallas_call at :227).  The TPU has no fast gather, so
// that kernel summed hat-weighted shifted copies of a z window over the
// (2K+1)^3 offsets around each cell, which is exact only while no
// backtrace moves more than K cells and caps the rest.  Hopper gathers
// from L1/L2, so this kernel computes the reference's k_adv3d
// (js_cuda3d.cu:192-237) as JAX's exact path writes it (solvers/stam3d.py
// ::_advect at advect_k = 0): the backtrace clamped to [0.5, n + 0.5],
// floor, the 8 corners, and the blend along x, then y, then z, each
// operation rounded on its own as in the plain version, so the result is
// bitwise that of the plain version and exact at any displacement.
//
// What bounds it on an H100: bytes.  A cell reads u, v, w and its own q0
// and writes out (20 bytes at f32); the 8 corners lie around the
// backtrace, mostly in L1/L2, and ~30 operations a cell are far below the
// card's rate.  At 192^3 f32 a launch moves ~146 MB, ~44 us at 3.35 TB/s.
#include <cuda_runtime.h>

#include <stddef.h>

namespace fst {
namespace {

template <typename T>
__global__ void __launch_bounds__(256)
advect_kernel(const T* __restrict__ q0, const T* __restrict__ u,
              const T* __restrict__ v, const T* __restrict__ w,
              T* __restrict__ out, int n, T dt, T hi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  const int N = n + 2;
  if (i >= N || j >= N) return;
  const size_t sy = N, sz = (size_t)N * N;
  const size_t s = (size_t)k * sz + (size_t)j * sy + i;
  if (i == 0 || i == N - 1 || j == 0 || j == N - 1 || k == 0 || k == N - 1) {
    out[s] = __ldg(q0 + s);
    return;
  }
  const T lo = T(0.5);
  T x = T(i) - dt * __ldg(u + s);
  T y = T(j) - dt * __ldg(v + s);
  T z = T(k) - dt * __ldg(w + s);
  x = x < lo ? lo : (x > hi ? hi : x);
  y = y < lo ? lo : (y > hi ? hi : y);
  z = z < lo ? lo : (z > hi ? hi : z);
  const int i0 = (int)floor(x), j0 = (int)floor(y), k0 = (int)floor(z);
  const T sx = x - T(i0), sy_ = y - T(j0), sz_ = z - T(k0);
  const T* b = q0 + (size_t)k0 * sz + (size_t)j0 * sy + i0;
  const T c000 = __ldg(b), c100 = __ldg(b + 1);
  const T c010 = __ldg(b + sy), c110 = __ldg(b + sy + 1);
  const T c001 = __ldg(b + sz), c101 = __ldg(b + sz + 1);
  const T c011 = __ldg(b + sz + sy), c111 = __ldg(b + sz + sy + 1);
  const T one = T(1);
  const T c00 = (one - sx) * c000 + sx * c100;
  const T c10 = (one - sx) * c010 + sx * c110;
  const T c01 = (one - sx) * c001 + sx * c101;
  const T c11 = (one - sx) * c011 + sx * c111;
  const T c0 = (one - sy_) * c00 + sy_ * c10;
  const T c1 = (one - sy_) * c01 + sy_ * c11;
  out[s] = (one - sz_) * c0 + sz_ * c1;
}

template <typename T>
int launch_advect(const T* q0, const T* u, const T* v, const T* w, T* out,
                  int n, double dt, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int N = n + 2;
  const dim3 block(32, 8);
  const dim3 grid((N + block.x - 1) / block.x, (N + block.y - 1) / block.y,
                  N);
  advect_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      q0, u, v, w, out, n, T(dt), T((double)n + 0.5));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_stam3d_advect_f32(const float* q0, const float* u, const float* v,
                          const float* w, float* out, int n, double dt,
                          int device, void* stream) {
  return fst::launch_advect<float>(q0, u, v, w, out, n, dt, device, stream);
}

int fst_stam3d_advect_f64(const double* q0, const double* u, const double* v,
                          const double* w, double* out, int n, double dt,
                          int device, void* stream) {
  return fst::launch_advect<double>(q0, u, v, w, out, n, dt, device, stream);
}

}  // extern "C"
